"""The loaders (counterpart of yolo_tpu/data/build.py): a few host threads read,
transform and collate batches while the card runs the one before, and the
consumer receives them in order.

Training shuffles with `random.Random(seed + epoch)` and gives worker w the
augmentation RNG `random.Random(seed * 1000003 + epoch * 131 + w)`; worker w
makes batches w, w + workers, ..., so the batches depend on the worker count,
as in the JAX package, and equal its batches for the same settings.
"""

from __future__ import annotations

import inspect
import queue
import random
import threading

from yolo_tpu_torch.data.dataset import YOLODataset, collate_batch


def build_yolo_dataset(cfg, img_path, data: dict, mode: str = "val", stride: int = 32) -> YOLODataset:
    """The dataset of a split from the settings and the dataset dict: augmented with the
    settings as `hyp` (and `fraction` applied) when `mode` is 'train', letterboxed otherwise;
    the dict's `kpt_shape` and `flip_idx` for a pose dataset; the settings' `task` ('obb' reads DOTA rows)."""
    return YOLODataset(
        img_path,
        imgsz=cfg.imgsz if isinstance(cfg.imgsz, int) else max(cfg.imgsz),
        augment=mode == "train",
        hyp=cfg,
        stride=stride,
        single_cls=cfg.single_cls,
        fraction=cfg.fraction if mode == "train" else 1.0,
        cache=getattr(cfg, "cache", None) or None,
        names=data.get("names"),
        kpt_shape=data.get("kpt_shape"),
        flip_idx=data.get("flip_idx"),
        task=getattr(cfg, "task", "detect") or "detect",
    )


def _accepts_rng(fn) -> bool:
    try:
        return "rng" in inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return False


class DataLoader:
    """Batches of `batch_size` samples, in dataset order or shuffled by seed and epoch
    (`set_epoch`), the last one dropped when short with `drop_last`; made by `workers`
    threads, each with its own augmentation RNG when the transforms take one, and
    yielded in order; a worker's exception is raised in the consumer."""

    def __init__(self, dataset: YOLODataset, batch_size: int = 16, shuffle: bool = False, workers: int = 4, seed: int = 0,
                 max_boxes: int = 64, drop_last: bool = False, overlap_mask: bool = True, mask_ratio: int = 4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.workers = max(1, workers)
        self.seed = seed
        self.max_boxes = max_boxes
        self.drop_last = drop_last
        self.overlap_mask, self.mask_ratio = overlap_mask, mask_ratio  # the masks of polygon labels (collate_batch)
        self.epoch = 0

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _batches(self) -> list:
        idx = list(range(len(self.dataset)))
        if self.shuffle:
            random.Random(self.seed + self.epoch).shuffle(idx)
        batches = [idx[i : i + self.batch_size] for i in range(0, len(idx), self.batch_size)]
        return [b for b in batches if len(b) == self.batch_size] if self.drop_last else batches

    def _sample(self, j: int, rng):
        ds = self.dataset
        return ds.transforms(ds.load_raw(j), rng) if _accepts_rng(ds.transforms) else ds[j]

    def __iter__(self):
        batches = self._batches()
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
            rng = random.Random(self.seed * 1000003 + self.epoch * 131 + worker_id)
            try:
                for bi in range(worker_id, len(batches), self.workers):
                    samples = [self._sample(j, rng) for j in batches[bi]]
                    if not put((bi, collate_batch(samples, self.max_boxes, self.overlap_mask, self.mask_ratio))):
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


def build_dataloader(dataset, batch: int, workers: int = 4, shuffle: bool = False, seed: int = 0,
                     max_boxes: int | None = None, drop_last: bool = False, overlap_mask: bool = True,
                     mask_ratio: int = 4) -> DataLoader:
    """The loader over `dataset` (the validator's form unless `shuffle` / `drop_last` are set);
    `max_boxes` defaults to `_derive_max_boxes`; `overlap_mask` and `mask_ratio` shape the masks of
    polygon labels (`collate_batch`)."""
    return DataLoader(dataset, batch_size=batch, shuffle=shuffle, workers=workers, seed=seed,
                      max_boxes=max_boxes or _derive_max_boxes(dataset), drop_last=drop_last,
                      overlap_mask=overlap_mask, mask_ratio=mask_ratio)
