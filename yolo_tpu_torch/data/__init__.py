"""Datasets and loaders of the detect validator (counterpart of yolo_tpu/data/, its validation half)."""

from yolo_tpu_torch.data.build import DataLoader, build_dataloader, build_yolo_dataset
from yolo_tpu_torch.data.dataset import YOLODataset, check_det_dataset, collate_batch, img2label_path

__all__ = ["DataLoader", "YOLODataset", "build_dataloader", "build_yolo_dataset", "check_det_dataset", "collate_batch", "img2label_path"]
