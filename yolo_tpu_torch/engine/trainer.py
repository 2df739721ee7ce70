"""Detection trainer, and the segment, pose and obb tasks' (counterpart of yolo_tpu/engine/trainer.py DetectionTrainer).

One step: upload the uint8 batch, /255 in the compute dtype (bf16 with `amp`,
else f32; no fp16 and no loss scaler, as in the JAX package), the train-form
forward (`DetectionModel.forward_features`, torch convs: the JAX step runs no
Pallas kernel either), `v8DetectionLoss`, backward, the optimizer (AdamW or
SGD, clipped at a global norm of 10), frozen layers put back, the BN running
moments updated (momentum 0.03, unbiased variance), then the EMA with the ramp
d = 0.9999 · (1 − exp(−updates / 2000)). Nothing is read back to the host until
the epoch ends, when the loss components' means are.

The loop follows the JAX one: per-step warmup of lr, bias lr and momentum over
max(round(warmup_epochs · batches), 100) steps, a linear or cosine epoch
schedule to lrf, close_mosaic, validation of the EMA weights with the port's
DetectionValidator each epoch (the C2f, head and NMS kernels on the card),
best.npz / last.npz (both packages' format), epoch<N>.npz every save_period,
results.csv with the JAX columns, args.yaml and early stopping on fitness.
The full train state goes to weights/train_state/state.pt, which `resume`
reads with last.npz.

The JAX trainer's other settings: `multi_scale` (each batch resized on the host by
a factor of the static ladder 0.5-1.5 drawn from np.random.default_rng(step)),
`remat` (every layer but the head under torch.utils.checkpoint), `batch=-1` (the
largest power-of-two batch whose train step fits, utils/profilers.autobatch with
this trainer's step as the probe), `cache='ram'` (data/dataset.py) and the
integration callbacks (TensorBoard under save_dir/tb, and the trackers whose SDK
imports). YOLO_TPU_TRAIN_S2D=4 is taken with the JAX trainer's checks and
warning and trains the standard stem: the JAX package's space-to-depth train
stem computes the same activations and was slower a step on the H100 (ROADMAP.md).
A segment model trains with `v8SegmentationLoss` (components box / seg / cls / dfl), the
loader drawing its polygons as masks (`overlap_mask`, `mask_ratio`), multi_scale skipped
for batches that carry masks, and `SegmentationValidator` each epoch, as in the JAX trainer.
A pose model trains with `v8PoseLoss` (components box / pose / kobj / cls / dfl) on the loader's
keypoints and validates with `PoseValidator`; a dataset whose `kpt_shape` differs from the model
yaml's rebuilds the model at the dataset's (the tensors whose shape survives kept when pretrained).
An obb model trains with `v8OBBLoss` (components box / cls / dfl) on DOTA rows collated as
xywhr, and validates with `OBBValidator`, as in the JAX trainer.
A yolov10 model (the end-to-end v10Detect head) trains with `E2EDetectLoss`, each branch's box / cls / dfl
logged apart (`box_o2m` ... `dfl_o2o`), as the JAX trainer logs them.
A YOLO-World or YOLOE model fine-tunes close-set, as the JAX trainer's hooks do: after any resume, the data's class
names are embedded by the CLIP text tower (`clip_ckpt`'s weights, else the seeded tower) and become its prompts,
straight for World and through the head's SwiGLU residual for YOLOE; `v8DetectionLoss` at the prompts' nc. A YOLOE
segment model raises NotImplementedError, as JAX's fails on its (preds, protos) pair.
An RT-DETR model trains with `RTDETRDetectionLoss` (components giou / cls / l1; the Hungarian match on the host),
each batch with its contrastive-denoising queries (utils/cdn.py: the noise drawn from a numpy Generator seeded by
`seed`, the JAX trainer's unseeded), and validates with `RTDETRValidator`. Its bf16 check is skipped and bf16 kept,
as the JAX trainer's check fails on it (its 64² probe has fewer anchors than queries) and keeps bf16.
Not ported, raising NotImplementedError: n_devices > 1 (the mesh, ROADMAP item 3).
"""

from __future__ import annotations

import csv
import math
import os
import time
from pathlib import Path

import numpy as np
import torch

from yolo_tpu_torch.cfg import DEFAULT_CFG_DICT, get_cfg, get_save_dir
from yolo_tpu_torch.data.build import build_dataloader, build_yolo_dataset
from yolo_tpu_torch.data.dataset import check_det_dataset
from yolo_tpu_torch.device import resolve_device
from yolo_tpu_torch.nn.tasks import (
    load_train_params,
    model_class_for,
    params_to_jax,
    refuse_prompted_segment,
    train_leaves,
    tree_from_leaves,
    validate_s2d_stem,
    yaml_model_load,
)
from yolo_tpu_torch.utils import LOGGER, yaml_save
from yolo_tpu_torch.utils.callbacks import add_integration_callbacks, default_callbacks, run_callbacks
from yolo_tpu_torch.utils.cdn import cdn_attn_mask, make_cdn_batch
from yolo_tpu_torch.utils.detr_loss import RTDETRDetectionLoss
from yolo_tpu_torch.utils.loss import E2EDetectLoss, v8DetectionLoss, v8OBBLoss, v8PoseLoss, v8SegmentationLoss
from yolo_tpu_torch.utils.optim import apply_bn_stats, build_optimizer

COMPONENTS = {"detect": ("box", "cls", "dfl"), "segment": ("box", "seg", "cls", "dfl"), "pose": ("box", "pose", "kobj", "cls", "dfl"),
              "obb": ("box", "cls", "dfl")}
LOSSES = {"detect": v8DetectionLoss, "segment": v8SegmentationLoss, "pose": v8PoseLoss, "obb": v8OBBLoss}


class EarlyStopping:
    """Stop when fitness has not improved for `patience` epochs."""

    def __init__(self, patience: int = 100):
        self.best_fitness = 0.0
        self.best_epoch = 0
        self.patience = patience or float("inf")

    def __call__(self, epoch: int, fitness: float | None) -> bool:
        if fitness is None:
            return False
        if fitness >= self.best_fitness:
            self.best_epoch = epoch
            self.best_fitness = fitness
        stop = (epoch - self.best_epoch) >= self.patience
        if stop:
            LOGGER.info(f"early stopping at epoch {epoch} (best epoch {self.best_epoch})")
        return stop


def _transfer_matching(old: dict, new: dict):
    """Copy every leaf of `old` into `new` where the path exists and the shape matches (the
    head convs that depend on nc start anew) → (tree, kept, total)."""
    kept = total = 0

    def count(t):
        return sum(count(v) for v in t.values()) if isinstance(t, dict) else 1

    def walk(o, n):
        nonlocal kept, total
        out = {}
        for k, v in n.items():
            ov = o.get(k) if isinstance(o, dict) else None
            if isinstance(v, dict):
                out[k] = walk(ov, v) if isinstance(ov, dict) else v
                if not isinstance(ov, dict):
                    total += count(v)
            else:
                total += 1
                if ov is not None and not isinstance(ov, dict) and np.shape(ov) == np.shape(v):
                    out[k] = ov
                    kept += 1
                else:
                    out[k] = v
        return out

    return walk(old, new), kept, total


def _frozen_layers(fz) -> frozenset:
    """`freeze`: n (the first n layers), a list of indices, or their CLI string form → layer keys."""
    if isinstance(fz, str):
        fz = [int(x) for x in fz.replace("[", "").replace("]", "").split(",") if x.strip()]
    return frozenset(str(int(i)) for i in (range(int(fz)) if isinstance(fz, (int, float)) else fz or []))


class DetectionTrainer:
    """Trains a DetectionModel on a YOLO-format dataset, on the card unless `device` names another."""

    def __init__(self, overrides: dict | None = None, model=None, params=None):
        overrides = {k: v for k, v in (overrides or {}).items() if k in DEFAULT_CFG_DICT}
        self.args = get_cfg(overrides=overrides)
        if (self.args.n_devices or 1) > 1:
            raise NotImplementedError(f"n_devices={self.args.n_devices}: data-parallel training over a mesh is not ported (ROADMAP item 3)")
        self.device = resolve_device(self.args.device or None)
        self.args.device = str(self.device)
        self.save_dir = get_save_dir(self.args)
        self.wdir = self.save_dir / "weights"
        self.callbacks = add_integration_callbacks(dict(default_callbacks()))
        self.metrics = None
        self.best_fitness = 0.0
        self.best_params = None
        self.epoch_time = None
        # per step of the last epoch: the host clock at its loader wait ("start", s), and ms of the
        # loader wait (host), forward + loss, backward, optimizer + BN + EMA (CUDA events on the card)
        self.timings: list[dict] = []

        self.data = check_det_dataset(self.args.data) if self.args.data else None
        nc = self.data["nc"] if self.data else None
        pretrained = model is not None and params is not None
        if model is not None:
            self.model = model
            self.params = params if params is not None else model.init(self.args.seed)
        else:
            name = self.args.model or "yolov8n.yaml"
            self.model = model_class_for(yaml_model_load(name))(name, nc=nc, device=self.device)
            self.params = self.model.init(self.args.seed)
        refuse_prompted_segment(self.model, "training")
        if getattr(self.model, "task", "detect") not in COMPONENTS:
            raise NotImplementedError(f"training the {self.model.task} task is not ported (only detect, segment, pose and obb)")
        self.args.task = self.model.task  # the datasets read the task's label rows (DOTA rows for obb)
        if isinstance(self.args.pretrained, str):  # initialise from a checkpoint's weights, shape by shape
            from yolo_tpu_torch.engine.exporter import load_npz

            self.params, kept, total = _transfer_matching(load_npz(self.args.pretrained, device="cpu")[1], self.params)
            LOGGER.info(f"transferred {kept}/{total} tensors from pretrained {self.args.pretrained}")
            pretrained = True
        if self.data and self.model.nc != self.data["nc"]:
            old = self.params
            self.model = type(self.model)(self.model.yaml, nc=self.data["nc"], device=self.device)  # keeps the task
            self.params = self.model.init(self.args.seed)
            if pretrained:  # keep every tensor whose shape survives the nc change
                self.params, kept, total = _transfer_matching(old, self.params)
                LOGGER.info(f"transferred {kept}/{total} pretrained tensors (nc {self.model.nc} head re-initialized)")
        kpt_shape = self.data.get("kpt_shape") if self.data else None
        if kpt_shape and getattr(self.model.head, "kpt_shape", None) not in (None, tuple(kpt_shape)):
            old = self.params  # the dataset's kpt_shape overrides the model yaml's
            self.model = type(self.model)({**self.model.yaml, "kpt_shape": list(kpt_shape)}, nc=self.data["nc"], device=self.device)
            self.params = self.model.init(self.args.seed)
            if pretrained:
                self.params, kept, total = _transfer_matching(old, self.params)
                LOGGER.info(f"transferred {kept}/{total} pretrained tensors (kpt head re-initialized)")
        if self.data:
            self.model.names = self.data["names"]
        self.loss_fn = self._make_loss()
        self.cdn_rng = np.random.default_rng(self.args.seed)  # RT-DETR's denoising noise
        self.stopper = EarlyStopping(self.args.patience)
        self.start_epoch = 0
        self._check_resume()
        if self.model.device != self.device:
            self.model.device = self.device
            self.model.to(self.device)
        # after resume, which rebuilds the model with its placeholder prompts: the data's class names embedded by the
        # text tower, straight for World, through the head's SwiGLU residual (its weights of this tree) for YOLOE
        if self.data and (getattr(self.model, "is_world", False) or getattr(self.model, "is_yoloe", False)):
            names = list(self.data["names"].values())
            if getattr(self.model, "is_world", False):
                self.model.set_classes(names, clip_ckpt=self.args.clip_ckpt)
            else:
                self.model.set_classes(names, params=self.params, clip_ckpt=self.args.clip_ckpt)

    def _check_train_s2d(self) -> None:
        """YOLO_TPU_TRAIN_S2D (0 off a TPU in JAX, the default here): the JAX trainer's checks, r = 4
        only, the yolov8 stem, layers 0-1 feeding no skip, no multi_scale, each warning where it fails.
        Either way the standard stem trains (the module docstring)."""
        r = int(os.environ.get("YOLO_TPU_TRAIN_S2D", "0") or 0)
        if not r:
            return
        try:
            if r != 4:
                raise ValueError(f"train s2d supports r=4 only, got {r}")
            validate_s2d_stem(self.model)
            if any(i < 2 for i in self.model.save):
                raise ValueError("layers 0-1 are skip sources")
            if self.args.multi_scale:
                raise ValueError("multi_scale resizes per step")
        except ValueError as e:
            LOGGER.warning(f"train s2d stem disabled: {e}")

    def _check_resume(self) -> None:
        """Resume the weights and the epoch from last.npz (the full state, where saved, in `train`)."""
        resume = self.args.resume
        if not resume:
            return
        from yolo_tpu_torch.engine.exporter import load_npz

        ckpt = Path(resume if isinstance(resume, str) and resume not in ("True", "true") else self.wdir / "last.npz")
        if not ckpt.exists():
            raise FileNotFoundError(f"resume checkpoint not found: {ckpt}")
        self.model, self.params, meta = load_npz(ckpt, device=self.device)
        self.loss_fn = self._make_loss()
        self.start_epoch = int(meta.get("epoch", -1)) + 1
        LOGGER.info(f"resuming from {ckpt} at epoch {self.start_epoch}")

    @property
    def task(self) -> str:
        return getattr(self.model, "task", "detect")

    @property
    def end2end(self) -> bool:
        return self.task == "detect" and getattr(self.model, "end2end", False)

    @property
    def rtdetr(self) -> bool:
        return getattr(self.model, "is_rtdetr", False)

    def _make_loss(self):
        if self.rtdetr:
            return RTDETRDetectionLoss(self.model, self.args)
        return E2EDetectLoss(self.model, self.args) if self.end2end else LOSSES[self.task](self.model, self.args)

    def build_optimizer(self, named_params, iterations: int):
        """SGD or AdamW by name, or 'auto': SGD (lr 0.01) past 10,000 iterations, else AdamW at
        lr 0.002 · 5 / (4 + nc) with no bias warmup; weight decay scaled by batch / nbs."""
        name, lr0, momentum = self.args.optimizer, self.args.lr0, self.args.momentum
        if name == "auto":
            lr_fit = round(0.002 * 5 / (4 + self.model.nc), 6)
            name, lr0, momentum = ("SGD", 0.01, 0.9) if iterations > 10000 else ("AdamW", lr_fit, 0.9)
            self.args.warmup_bias_lr = 0.0
            LOGGER.info(f"optimizer=auto → {name}(lr={lr0}, momentum={momentum})")
        self.args.lr0, self.args.momentum = lr0, momentum
        accumulate = max(round(self.args.nbs / max(self.args.batch, 1)), 1)
        decay = self.args.weight_decay * self.args.batch * accumulate / self.args.nbs
        return build_optimizer(name, named_params, decay)

    def lr_lambda(self, epoch: int) -> float:
        """The epoch's lr factor: cosine or linear from 1 to lrf."""
        e, lrf = self.args.epochs, self.args.lrf
        if self.args.cos_lr:
            return ((1 - math.cos(epoch * math.pi / e)) / 2) * (lrf - 1) + 1
        return (1 - epoch / e) * (1.0 - lrf) + lrf

    # --- one step ---------------------------------------------------------------------

    def _upload(self, batch: dict):
        """The uint8 images and the targets (with the masks or keypoints a segment or pose batch carries) on the device."""
        x = torch.from_numpy(batch["img"])
        targets = {k: torch.from_numpy(batch[k]) for k in ("cls", "bboxes", "mask_gt", "masks", "keypoints") if k in batch}
        if self.device.type == "cuda":
            x = x.pin_memory()
            targets = {k: v.pin_memory() for k, v in targets.items()}
        return x.to(self.device, non_blocking=True), {k: v.to(self.device, non_blocking=True) for k, v in targets.items()}

    def _features(self, img: torch.Tensor, dn: dict | None = None):
        """The train forward of a uint8 batch: /255 in the compute dtype, then the walk (remat as set); an RT-DETR
        model's with the denoising queries of `dn`."""
        x = img.to(self.dtype) / 255.0
        if self.rtdetr:
            return self.model.forward_features(x, remat=bool(self.args.remat), dn=dn)
        return self.model.forward_features(x, remat=bool(self.args.remat))

    def _denoising(self, batch: dict, targets: dict) -> dict:
        """An RT-DETR batch's denoising queries (utils/cdn.py) on the device, the attention mask beside them; the
        loss reads `dn_cls` from `targets` to split them off."""
        dn = make_cdn_batch(batch, self.model.nc, self.cdn_rng)
        D, N = dn["dn_cls"].shape[1], np.asarray(batch["cls"]).shape[1]
        key = (D // (2 * N), N, self.model.head.nq)
        if getattr(self, "_cdn_mask", (None,))[0] != key:
            self._cdn_mask = (key, torch.from_numpy(cdn_attn_mask(*key)).to(self.device))
        out = {k: torch.from_numpy(dn[k]).to(self.device, non_blocking=True) for k in ("dn_cls", "dn_bbox", "dn_valid")}
        targets["dn_cls"] = out["dn_cls"]
        return {**out, "attn_mask": self._cdn_mask[1]}

    def _autobatch(self, trainset) -> int:
        """batch=-1: `utils.profilers.autobatch` with this trainer's step as the probe: the train forward
        (remat as set), the loss over the loader's label capacity, every label valid, and the backward, in
        the compute dtype, at the largest side a step takes (x1.5 under multi_scale) → the largest
        power-of-two batch from 8 to 512 whose step fits."""
        from yolo_tpu_torch.data.build import _derive_max_boxes
        from yolo_tpu_torch.utils.profilers import autobatch

        args = self.args
        stride = int(max(self.model.stride))
        side = args.imgsz if isinstance(args.imgsz, int) else max(args.imgsz)
        if args.multi_scale:
            side = max(int(side * 1.5) // stride * stride, stride)
        n = _derive_max_boxes(trainset)
        load_train_params(self.model, self.params)
        self.model.train()
        g = torch.Generator().manual_seed(0)

        def step(b: int) -> None:
            wh = torch.full((b, n, 2), 0.05)
            targets = {"cls": torch.zeros((b, n)), "bboxes": torch.cat([torch.rand((b, n, 2), generator=g) * 0.9 + 0.05, wh], -1),
                       "mask_gt": torch.ones((b, n))}
            if self.task == "segment":  # an overlap-index map at the loader's mask ratio
                r = int(args.mask_ratio or 4)
                targets["masks"] = torch.zeros((b, side // r, side // r))
            if self.task == "pose":
                targets["keypoints"] = torch.zeros((b, n, *self.model.head.kpt_shape))
            if self.task == "obb":
                targets["bboxes"] = torch.cat([targets["bboxes"], torch.zeros((b, n, 1))], -1)
            img = torch.zeros((b, side, side, 3), dtype=torch.uint8, device=self.device)
            total, _ = self.loss_fn(self._features(img), {k: v.to(self.device) for k, v in targets.items()})
            total.backward()

        try:
            return autobatch(step, self.device)
        finally:
            for p in self.model.parameters():
                p.grad = None

    @staticmethod
    def multi_scale(batch: dict, ni: int, stride: int) -> dict:
        """The batch's images resized on the host (cv2) by one factor of the static ladder (0.5, 0.75,
        1, 1.25, 1.5), drawn by np.random.default_rng(ni), each side rounded down to the stride; the
        labels are normalized and stay. The JAX trainer's multi_scale."""
        import cv2

        bh, bw = batch["img"].shape[1:3]
        ladder = (0.5, 0.75, 1.0, 1.25, 1.5)
        sf = ladder[np.random.default_rng(ni).integers(len(ladder))]
        sh = max(int(bh * sf) // stride * stride, stride)
        sw = max(int(bw * sf) // stride * stride, stride)
        if (sh, sw) == (bh, bw):
            return batch
        resized = (cv2.resize(im, (sw, sh)) for im in batch["img"])  # cv2 drops a trailing 1-channel axis
        return {**batch, "img": np.stack([r[..., None] if r.ndim == 2 else r for r in resized])}

    def _build_state(self, iterations: int) -> None:
        """Load the tree into the train form and set up the optimizer, the frozen layers and the EMA."""
        load_train_params(self.model, self.params)
        self.model.train()
        self.leaves = train_leaves(self.model)
        named = [(k, t) for k, t in self.leaves.items() if isinstance(t, torch.nn.Parameter)]
        self.opt = self.build_optimizer(named, iterations)
        frozen = _frozen_layers(getattr(self.args, "freeze", None))
        if frozen:
            LOGGER.info(f"freezing layers {sorted(frozen, key=int)}")
        self.frozen_params = [t for k, t in named if k.split("/")[1] in frozen]
        self.ema_list = [t.detach().clone() for t in self.leaves.values()]
        self.ema_updates = 0

    @torch.no_grad()
    def _update(self, lr: float, mom: float, lr_bias: float) -> None:
        """After the backward: the optimizer, the frozen layers put back (their moments still move,
        as in the JAX step), the BN running moments, then the EMA of every leaf."""
        keep = [(p, p.detach().clone()) for p in self.frozen_params]
        self.opt.step(lr, mom, lr_bias=lr_bias)
        for p, v in keep:
            p.copy_(v)
        apply_bn_stats(self.model)
        self.ema_updates += 1
        d = 0.9999 * (1 - math.exp(-self.ema_updates / 2000.0))
        torch._foreach_mul_(self.ema_list, d)
        torch._foreach_add_(self.ema_list, list(self.leaves.values()), alpha=1 - d)

    def _step(self, batch: dict, lr: float, mom: float, lr_bias: float, marks: list) -> torch.Tensor:
        """Forward and loss, backward, `_update` → the detached (box, cls, dfl) components on the
        device. `marks` gets a time mark (a CUDA event on the card, the host clock elsewhere) after each."""
        img, targets = self._upload(batch)
        dn = self._denoising(batch, targets) if self.rtdetr else None
        total, comps = self.loss_fn(self._features(img, dn), targets)
        marks.append(self._mark())
        for p in self.opt.params:
            p.grad = None
        total.backward()
        marks.append(self._mark())
        self._update(lr, mom, lr_bias)
        marks.append(self._mark())
        return comps

    def _mark(self):
        if self.device.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    @staticmethod
    def _ms(a, b) -> float:
        return a.elapsed_time(b) if isinstance(a, torch.cuda.Event) else (b - a) * 1e3

    # --- the loop -----------------------------------------------------------------------

    def train(self):
        args = self.args
        if self.data is None:
            raise ValueError("trainer needs data=<dataset.yaml>")
        self.save_dir.mkdir(parents=True, exist_ok=True)
        self.wdir.mkdir(parents=True, exist_ok=True)
        yaml_save(self.save_dir / "args.yaml", vars(args))

        stride = int(max(self.model.stride))
        trainset = build_yolo_dataset(args, self.data["train"], self.data, mode="train", stride=stride)
        if args.plots:
            try:
                from yolo_tpu_torch.utils.plotting import plot_labels

                all_b = np.concatenate([lb["bboxes"] for lb in trainset.labels]) if trainset.labels else np.zeros((0, 4))
                all_c = np.concatenate([lb["cls"] for lb in trainset.labels]) if trainset.labels else np.zeros((0,))
                plot_labels(all_b, all_c, names=self.data.get("names", {}), save_path=self.save_dir / "labels.png")
            except Exception as e:
                LOGGER.warning(f"label plot failed: {e}")
        if args.amp and self.rtdetr:
            LOGGER.warning("AMP sanity check skipped: RT-DETR selects more queries than the 64x64 probe has anchors")
        elif args.amp:
            from yolo_tpu_torch.utils.checks import check_amp

            if not check_amp(self.model, self.params):
                LOGGER.warning("AMP sanity check failed — training with float32")
                args.amp = False
        self.dtype = torch.bfloat16 if args.amp else torch.float32
        if args.batch == -1:
            args.batch = self._autobatch(trainset)
        self.train_loader = build_dataloader(trainset, args.batch, workers=args.workers, shuffle=True, seed=args.seed,
                                             drop_last=len(trainset) > args.batch, overlap_mask=bool(args.overlap_mask),
                                             mask_ratio=int(args.mask_ratio or 4))
        nb = max(len(self.train_loader), 1)
        iterations = math.ceil(len(trainset) / max(args.batch, args.nbs)) * args.epochs

        model = self.model
        self._check_train_s2d()
        self._build_state(iterations)
        leaves = self.leaves
        state_dir = self.wdir / "train_state"
        if args.resume and (state_dir / "state.pt").exists():
            from yolo_tpu_torch.engine.exporter import load_train_state

            st = load_train_state(state_dir, self.device)
            with torch.no_grad():
                torch._foreach_copy_(list(leaves.values()), st["params"])
                torch._foreach_copy_(self.ema_list, st["ema"])
            self.opt.load_state(st["opt"])
            self.ema_updates = int(st["ema_updates"])
            LOGGER.info(f"restored the full train state (optimizer + EMA) from {state_dir}")

        nw = max(round(args.warmup_epochs * nb), 100) if args.warmup_epochs > 0 else -1
        run_callbacks(self.callbacks, "on_pretrain_routine_start", self)
        run_callbacks(self.callbacks, "on_train_start", self)
        csv_rows = []
        t_train = time.time()
        ni = self.start_epoch * nb
        comp_names = ("giou", "cls", "l1") if self.rtdetr else COMPONENTS[self.task]
        if self.end2end:  # the two branches' components apart, as the JAX trainer logs them
            comp_names = tuple(f"{n}_o2m" for n in comp_names) + tuple(f"{n}_o2o" for n in comp_names)
        last_comps = np.zeros(len(comp_names))
        for epoch in range(self.start_epoch, args.epochs):
            run_callbacks(self.callbacks, "on_train_epoch_start", self)
            self.epoch = epoch
            if args.close_mosaic and epoch >= max(args.epochs - args.close_mosaic, 0) \
                    and getattr(trainset.transforms, "mosaic_enabled", False):
                LOGGER.info("closing mosaic/mixup augmentation")
                trainset.close_mosaic()
            self.train_loader.set_epoch(epoch)
            lr_epoch = args.lr0 * self.lr_lambda(epoch)
            t0 = time.time()
            comps, steps = [], []
            batches = iter(self.train_loader)
            while True:
                t_wait = time.perf_counter()
                batch = next(batches, None)
                if batch is None:
                    break
                t_got = time.perf_counter()
                if args.plots and epoch == self.start_epoch and ni - self.start_epoch * nb < 3:
                    try:
                        from yolo_tpu_torch.utils.plotting import plot_images

                        plot_images(batch, fname=self.save_dir / f"train_batch{ni - self.start_epoch * nb}.jpg",
                                    names=getattr(model, "names", {}))
                    except Exception as e:
                        LOGGER.warning(f"train-batch plot failed: {e}")
                if ni <= nw:
                    xi = [0, nw]
                    lr = float(np.interp(ni, xi, [0.0, lr_epoch]))
                    lr_bias = float(np.interp(ni, xi, [args.warmup_bias_lr, lr_epoch]))
                    mom = float(np.interp(ni, xi, [args.warmup_momentum, args.momentum]))
                else:
                    lr, mom, lr_bias = lr_epoch, args.momentum, lr_epoch
                if args.multi_scale and "masks" not in batch:  # as in JAX: a batch with masks keeps its size
                    batch = self.multi_scale(batch, ni, stride)
                marks = [self._mark()]
                comps.append(self._step(batch, lr, mom, lr_bias, marks))
                steps.append((t_wait, t_got, marks))
                ni += 1
            if comps:
                last_comps = torch.stack(comps).double().mean(0).cpu().numpy()  # the epoch's one read of the losses
            self.epoch_time = time.time() - t0
            self.timings = [
                {"start": tw, "loader": (tg - tw) * 1e3, "forward": self._ms(m[0], m[1]), "backward": self._ms(m[1], m[2]),
                 "optimizer": self._ms(m[2], m[3])}
                for tw, tg, m in steps
            ]
            run_callbacks(self.callbacks, "on_train_epoch_end", self)

            fitness = None
            t_val = time.time()
            ema_tree = tree_from_leaves(model, dict(zip(leaves, self.ema_list)))
            if args.val:
                self.metrics = self.validate(ema_tree)
                fitness = self.metrics.get("fitness", 0.0)
                if fitness >= self.best_fitness:
                    self.best_fitness = fitness
                    self.best_params = ema_tree
                    self.save_checkpoint(self.wdir / "best.npz", ema_tree)
            self.val_time = time.time() - t_val
            comp_str = " ".join(f"{n} {v:.4f}" for n, v in zip(comp_names, last_comps))
            LOGGER.info(f"epoch {epoch + 1}/{args.epochs} {comp_str} lr {lr_epoch:.5f} {self.epoch_time:.1f}s"
                        + (f" fitness {fitness:.4f}" if fitness is not None else ""))
            row = {
                "epoch": epoch,
                "time": time.time() - t_train,
                **{f"train/{n}_loss": float(v) for n, v in zip(comp_names, last_comps)},
                "lr": lr_epoch,
                **{f"metrics/{k}": v for k, v in (self.metrics or {}).items()},
            }
            self._last_row = row
            csv_rows.append(row)
            self._write_csv(csv_rows)
            if args.save:
                from yolo_tpu_torch.engine.exporter import save_train_state

                self.save_checkpoint(self.wdir / "last.npz", ema_tree, extra={"epoch": epoch})
                save_train_state(state_dir, {"params": list(leaves.values()), "opt": self.opt.state(),
                                             "ema": self.ema_list, "ema_updates": self.ema_updates})
                if args.save_period > 0 and (epoch + 1) % args.save_period == 0:
                    self.save_checkpoint(self.wdir / f"epoch{epoch}.npz", ema_tree)
                run_callbacks(self.callbacks, "on_model_save", self)
            run_callbacks(self.callbacks, "on_fit_epoch_end", self)
            if self.stopper(epoch, fitness):
                break

        model.eval()
        self.params = params_to_jax(model)
        self.ema_params = tree_from_leaves(model, dict(zip(leaves, self.ema_list)))
        if self.best_params is None:
            self.best_params = self.ema_params
        run_callbacks(self.callbacks, "on_train_end", self)
        LOGGER.info(f"training done in {(time.time() - t_train) / 3600:.2f}h; best fitness {self.best_fitness:.4f}")
        return self.metrics

    def validate(self, params: dict) -> dict:
        """The port's validator of the model's task (DetectionValidator, SegmentationValidator, PoseValidator, OBBValidator)
        on a parameter tree (the EMA's) with the run's settings."""
        from yolo_tpu_torch.engine.validator import validator_for

        return validator_for(self.model)(args={**vars(self.args), "mode": "val"}, data=self.data)(model=self.model, params=params)

    def save_checkpoint(self, path, params: dict, extra: dict | None = None) -> None:
        from yolo_tpu_torch.engine.exporter import save_npz

        save_npz(self.model, params, path, meta={"args": vars(self.args), **(extra or {})})

    def _write_csv(self, rows: list) -> None:
        keys = sorted({k for r in rows for k in r}, key=lambda k: (k != "epoch", k))
        with open(self.save_dir / "results.csv", "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=keys)
            w.writeheader()
            w.writerows(rows)
