"""The validation loader (counterpart of yolo_tpu/data/build.py): a few host threads
read, letterbox and collate batches while the card runs the one before, and the
consumer receives them in dataset order. Shuffling and the training transforms
are not ported."""

from __future__ import annotations

import queue
import threading

from yolo_tpu_torch.data.dataset import YOLODataset, collate_batch


def build_yolo_dataset(cfg, img_path, data: dict, stride: int = 32) -> YOLODataset:
    """The validation dataset of a split from the settings (`imgsz`, `single_cls`, `cache`) and the dataset dict."""
    return YOLODataset(
        img_path,
        imgsz=cfg.imgsz if isinstance(cfg.imgsz, int) else max(cfg.imgsz),
        stride=stride,
        single_cls=cfg.single_cls,
        cache=getattr(cfg, "cache", None) or None,
        names=data.get("names"),
    )


class DataLoader:
    """Batches of `batch_size` consecutive samples (the last one partial), made by
    `workers` threads, yielded in order; a worker's exception is raised in the consumer."""

    def __init__(self, dataset: YOLODataset, batch_size: int = 16, workers: int = 4, max_boxes: int = 64):
        self.dataset = dataset
        self.batch_size = batch_size
        self.workers = max(1, workers)
        self.max_boxes = max_boxes

    def __len__(self):
        return -(-len(self.dataset) // self.batch_size)

    def __iter__(self):
        n = len(self.dataset)
        batches = [range(i, min(i + self.batch_size, n)) for i in range(0, n, self.batch_size)]
        out_q: queue.Queue = queue.Queue(maxsize=self.workers * 2)
        stop = threading.Event()

        def put(item) -> bool:
            """Queue `item` unless the consumer has gone (a closed or failed loop): then no thread waits forever."""
            while not stop.is_set():
                try:
                    out_q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def producer(worker_id: int):
            try:
                for bi in range(worker_id, len(batches), self.workers):
                    if not put((bi, collate_batch([self.dataset[j] for j in batches[bi]], self.max_boxes))):
                        return
            except BaseException as e:  # handed to the consumer, which would otherwise wait for this batch forever
                put(("error", e))

        for w in range(self.workers):
            threading.Thread(target=producer, args=(w,), daemon=True).start()
        try:
            buffered, next_bi = {}, 0
            while next_bi < len(batches):
                bi, batch = out_q.get()
                if bi == "error":
                    raise RuntimeError("DataLoader worker failed") from batch
                buffered[bi] = batch
                while next_bi in buffered:
                    yield buffered.pop(next_bi)
                    next_bi += 1
        finally:
            stop.set()


def _derive_max_boxes(dataset) -> int:
    """The per-image label capacity of the fixed-shape batches: twice the densest
    image's label count rounded up to 8, at least 64 and at most 256."""
    mx = max((len(lb["cls"]) for lb in getattr(dataset, "labels", [])), default=0)
    if not mx:
        return 64
    return int(min(max(64, -(-int(mx * 2) // 8) * 8), 256))


def build_dataloader(dataset, batch: int, workers: int = 4, max_boxes: int | None = None) -> DataLoader:
    """The ordered validation loader over `dataset`; `max_boxes` defaults to `_derive_max_boxes`."""
    return DataLoader(dataset, batch_size=batch, workers=workers, max_boxes=max_boxes or _derive_max_boxes(dataset))
