"""The YAML → module builder and the detection model (counterpart of yolo_tpu/nn/)."""

from yolo_tpu_torch.nn.tasks import DetectionModel, parse_model, yaml_model_load

__all__ = ["DetectionModel", "parse_model", "yaml_model_load"]
