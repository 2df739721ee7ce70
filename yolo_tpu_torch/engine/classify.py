"""The classify task's dataset, trainer and validator (counterpart of yolo_tpu/engine/classify.py).

    YOLO("yolov8n-cls.yaml").train(data="root", epochs=10, imgsz=224, batch=32)  # root/train/<class>/*.jpg
    YOLO("runs/classify/train/weights/best.npz").val(data="root")                # {top1, top5, fitness}

`ClassificationDataset` reads a folder per class (root/<class>/*.jpg, sorted), resizes
each image square to `imgsz` with cv2 and, when training, augments it with
RandAugment (`auto_augment`), a left-right flip (`fliplr`) and random erasing
(`erasing`), every draw from numpy's global RNG in the JAX package's order.
`ClassificationTrainer` trains a ClassificationModel's train form with
cross-entropy on the f32 logits: AdamW (weight decay on the conv and linear
kernels, gradients clipped at a global norm of 10), the BN running moments
updated after each step (momentum 0.03), a linear lr per epoch from lr0 to
lr0 · lrf, bf16 with `amp` and f32 without; after each epoch it validates
the weights in f32 through the inference form (the C2f kernel on the card)
and keeps the best top-1's as best.npz. The dropout of the Classify head
(`dropout`) draws its mask from a torch.Generator seeded per step by the JAX
trainer's formula (seed · 100003 + epoch · 9973 + batch); JAX draws with
jax.random, whose bits torch cannot reproduce, so only a rate of 0 trains
the same weights as the JAX package.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from yolo_tpu_torch.cfg import DEFAULT_CFG_DICT, get_cfg, get_save_dir
from yolo_tpu_torch.device import resolve_device
from yolo_tpu_torch.nn.tasks import ClassificationModel, install_params, load_train_params, params_to_jax, train_leaves
from yolo_tpu_torch.utils import LOGGER, yaml_save

IMG_EXTS = {".bmp", ".jpg", ".jpeg", ".png", ".tif", ".tiff", ".webp"}


class ClassificationDataset:
    """root/<class_name>/*.jpg (torchvision's ImageFolder layout); class ids in sorted folder order."""

    def __init__(self, root, imgsz: int = 224, augment: bool = False, fliplr: float = 0.5,
                 erasing: float = 0.0, auto_augment: str | None = None):
        root = Path(root)
        classes = sorted(d.name for d in root.iterdir() if d.is_dir())
        if not classes:
            raise FileNotFoundError(f"no class folders under {root}")
        self.names = dict(enumerate(classes))
        self.samples = []
        for ci, c in enumerate(classes):
            for f in sorted((root / c).rglob("*")):
                if f.suffix.lower() in IMG_EXTS:
                    self.samples.append((str(f), ci))
        self.imgsz = imgsz
        self.augment = augment
        self.fliplr = fliplr
        self.erasing = erasing
        self.auto_augment = auto_augment

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        """(uint8 BGR image, imgsz x imgsz, the class id)."""
        import cv2

        from yolo_tpu_torch.utils.files import imread

        path, cls = self.samples[i]
        img = imread(path)
        if img is None:
            raise FileNotFoundError(f"unreadable image {path}")
        img = cv2.resize(img, (self.imgsz, self.imgsz), interpolation=cv2.INTER_LINEAR)
        if self.augment:
            if self.auto_augment:
                from yolo_tpu_torch.data.augment import rand_augment

                img = rand_augment(img, np.random)
            if np.random.random() < self.fliplr:
                img = np.fliplr(img)
            if self.erasing > 0 and np.random.random() < self.erasing:
                # random erasing: area 2-33%, aspect 0.3-3.3, up to 10 tries to fit
                img = np.ascontiguousarray(img)
                H, W = img.shape[:2]
                for _ in range(10):
                    area = np.random.uniform(0.02, 0.33) * H * W
                    ar = np.exp(np.random.uniform(np.log(0.3), np.log(3.3)))
                    eh, ew = int(round(np.sqrt(area * ar))), int(round(np.sqrt(area / ar)))
                    if eh < H and ew < W:
                        y0, x0 = np.random.randint(0, H - eh), np.random.randint(0, W - ew)
                        img[y0 : y0 + eh, x0 : x0 + ew] = 0
                        break
        return np.ascontiguousarray(img), cls

    def batches(self, batch_size: int, shuffle: bool = True, seed: int = 0, epoch: int = 0, drop_last: bool = True):
        """(images (B, imgsz, imgsz, 3) uint8 BGR, labels (B,) int32), shuffled by
        np.random.default_rng(seed + epoch). With drop_last=False the last partial batch is
        padded to batch_size with zero images labelled -1, so validation scores every image."""
        idx = np.arange(len(self))
        if shuffle:
            np.random.default_rng(seed + epoch).shuffle(idx)
        end = len(idx) if not drop_last else len(idx) - batch_size + 1
        for s in range(0, max(end, 1 if not drop_last and len(idx) else 0), batch_size):
            sel = idx[s : s + batch_size]
            if not len(sel):
                break
            imgs = np.stack([self[i][0] for i in sel])
            labels = np.array([self.samples[i][1] for i in sel], np.int32)
            if len(sel) < batch_size:  # pad; -1 labels never match predictions
                pad = batch_size - len(sel)
                imgs = np.concatenate([imgs, np.zeros((pad,) + imgs.shape[1:], imgs.dtype)])
                labels = np.concatenate([labels, np.full((pad,), -1, np.int32)])
            yield imgs, labels


def _split_dirs(root: Path) -> tuple:
    """(train dir, val dir) of a classify dataset: root/train and root/val where they exist."""
    train = root / "train" if (root / "train").exists() else root
    val = root / "val" if (root / "val").exists() else train
    return train, val


class ClassificationTrainer:
    """Cross-entropy training of a ClassificationModel, on the card unless `device` names another."""

    def __init__(self, overrides: dict | None = None, model=None, params=None):
        overrides = {k: v for k, v in (overrides or {}).items() if k in DEFAULT_CFG_DICT}
        self.args = get_cfg(overrides=overrides)
        self.device = resolve_device(self.args.device or None)
        self.args.device = str(self.device)
        self.save_dir = get_save_dir(self.args)
        self.model = model
        self.params = params
        self.metrics = None
        self.best_params = None
        self.losses: list[float] = []  # the mean loss of each epoch

    def train(self) -> dict:
        from yolo_tpu_torch.utils.optim import AdamW, apply_bn_stats

        args = self.args
        train_dir, val_dir = _split_dirs(Path(args.data))
        train_ds = ClassificationDataset(train_dir, imgsz=args.imgsz, augment=True, fliplr=args.fliplr,
                                         erasing=float(args.erasing or 0.0), auto_augment=args.auto_augment)
        val_ds = ClassificationDataset(val_dir, imgsz=args.imgsz)
        nc = len(train_ds.names)
        if self.model is None:
            self.model = ClassificationModel(args.model or "yolov8n-cls.yaml", nc=nc, device=self.device)
            self.params = self.model.init(args.seed)
        elif self.model.nc != nc:  # a head for the dataset's classes, from a fresh initial tree
            self.model = ClassificationModel(self.model.yaml, nc=nc, device=self.device)
            self.params = self.model.init(args.seed)
        self.model.names = train_ds.names
        model = self.model
        if model.device != self.device:
            model.device = self.device
            model.to(self.device)

        load_train_params(model, self.params)
        model.train()
        named = [(k, t) for k, t in train_leaves(model).items() if isinstance(t, torch.nn.Parameter)]
        opt = AdamW(named, weight_decay=args.weight_decay)
        dtype = torch.bfloat16 if args.amp else torch.float32
        dropout = float(args.dropout or 0.0)

        best_top1 = -1.0
        self.save_dir.mkdir(parents=True, exist_ok=True)
        yaml_save(self.save_dir / "args.yaml", vars(args))
        t0 = time.time()
        for epoch in range(args.epochs):
            lr = args.lr0 * ((1 - epoch / args.epochs) * (1 - args.lrf) + args.lrf)
            losses = []
            for bi, (imgs, labels) in enumerate(train_ds.batches(min(args.batch, len(train_ds)), seed=args.seed, epoch=epoch)):
                if dropout > 0:
                    gen = torch.Generator(device=self.device).manual_seed(args.seed * 100003 + epoch * 9973 + bi)
                    model.head.drop = (dropout, gen)
                x = torch.from_numpy(imgs).to(self.device).flip(-1).to(dtype) / 255.0
                y = torch.from_numpy(labels).long().to(self.device)
                logp = torch.log_softmax(model.forward_features(x).float(), -1)
                loss = -logp.gather(1, y[:, None]).mean()
                for p in opt.params:
                    p.grad = None
                loss.backward()
                opt.step(lr, 0.9)
                apply_bn_stats(model)
                losses.append(loss.detach())
            model.head.drop = None
            self.losses.append(float(torch.stack(losses).mean()) if losses else float("nan"))
            tree = params_to_jax(model)
            self.metrics = self.validate(tree, val_ds)
            LOGGER.info(f"epoch {epoch + 1}/{args.epochs} loss {self.losses[-1]:.4f} "
                        f"top1 {self.metrics['top1']:.3f} top5 {self.metrics['top5']:.3f}")
            if self.metrics["top1"] > best_top1:
                best_top1 = self.metrics["top1"]
                self.best_params = tree
        model.eval()
        self.params = params_to_jax(model)
        if self.best_params is None:
            self.best_params = self.params
        if args.save:
            from yolo_tpu_torch.engine.exporter import save_npz

            (self.save_dir / "weights").mkdir(exist_ok=True)
            save_npz(model, self.best_params, self.save_dir / "weights" / "best.npz")
        LOGGER.info(f"classify training done in {time.time() - t0:.1f}s; best top1 {best_top1:.3f}")
        self.metrics["fitness"] = best_top1
        return self.metrics

    def validate(self, params, dataset, plain: bool = False) -> dict:
        """{top1, top5} of a parameter tree on a dataset: f32 probabilities through the inference
        form (the C2f kernel on the card; `plain`: its twin), the padded tail's rows not counted."""
        install_params(self.model, params, self.device, torch.float32)
        top1 = top5 = n = 0
        for imgs, labels in dataset.batches(min(self.args.batch, len(dataset)), shuffle=False, drop_last=False):
            x = torch.from_numpy(imgs).to(self.device).flip(-1).float() / 255.0
            probs = self.model.predict(x, plain=plain).cpu().numpy()
            real = labels >= 0
            order = np.argsort(-probs, axis=-1)
            top1 += ((order[:, 0] == labels) & real).sum()
            top5 += (np.any(order[:, :5] == labels[:, None], axis=-1) & real).sum()
            n += int(real.sum())
        return {"top1": top1 / max(n, 1), "top5": top5 / max(n, 1)}


class ClassificationValidator:
    """top1 / top5 / fitness of a classify model on a dataset's val folder (root/val, else
    root/train, else root), with the validator call convention `YOLO.val` uses. `args` are cfg
    settings (other keys are ignored) and `plain`, which runs the C2f kernel's twin."""

    def __init__(self, args=None, data=None):
        args = dict(args or {})
        self.plain = bool(args.pop("plain", False))
        self.args = get_cfg(overrides={k: v for k, v in args.items() if k in DEFAULT_CFG_DICT})

    def __call__(self, model, params) -> dict:
        _, val_dir = _split_dirs(Path(self.args.data))
        ds = ClassificationDataset(val_dir, imgsz=self.args.imgsz)
        t = ClassificationTrainer(overrides=vars(self.args), model=model, params=params)
        metrics = t.validate(params, ds, plain=self.plain)
        LOGGER.info(f"classify val: top1 {metrics['top1']:.3f} top5 {metrics['top5']:.3f} ({len(ds)} images)")
        metrics["fitness"] = metrics["top1"]
        return metrics
