"""Fused detect+track over fixed-size chunks of frames, on the card.

Counterpart of yolo_tpu/pipeline/fused.py::FusedDetectTrack:

    frames (T, H, W, C) uint8
      → yolov8-small (P2) forward, DFL decode → NMS          [batch-parallel]
      → the batched Kalman step over the T frames            [sequential]
      → one packed (T, N, 12) f32 tensor per chunk + contract stats

- The /255 fold (conv(x / 255, W) == conv(x, W / 255)) goes into the stem
  weights, so uint8 frames feed the stem as a bare cast. Single-channel frames
  also take the grayscale fold (conv(broadcast(x, 3), W) == conv(x, sum_c W));
  3-channel frames are BGR and are flipped to RGB.
- The contract stats (detection / prediction frame counts, state changes,
  including the status edge between two chunks) stay on the device.
- `run_clip` uploads each chunk from a ring of `prefetch` pinned buffers on a
  side stream, enqueues every chunk without waiting, and synchronises once at
  the end; `put_frames` stages one chunk for `process_chunk_device`.

The JAX package's signature, each setting off unless asked for, as there:
- `pallas_head2=True` sends the Detect levels through the channel-major head
  kernel (ops/cuda_head_cm.py);
- `int8=True` (nn/quantize.py): PTQ convs, static activation scales and the
  int8-resident flow when `int8_calib` frames are given (calibrated on the
  gray-folded tree, the /255 fold skipped), dynamic scales otherwise; no C2f or
  head kernel takes int8, the NMS kernel runs;
- `neck_opt` (None: on for a fused float tree, off for int8);
- `s2d=4|8`, `sparse_head=True` (or YOLO_TPU_SPARSE_HEAD=1), lazy decode
  (YOLO_TPU_LAZY_DECODE=1), `pallas_head`, `pallas_c2f` and `unroll` are taken,
  with the JAX package's argument checks, and run the default route: the JAX
  package's space-to-depth stem, sparse box head and lazy decode compute the
  default route's outputs in another order, and on the H100 none of them was
  faster than it (ROADMAP.md); the port's kernels are always its route, and its
  step loop runs frame by frame.
`mesh` raises NotImplementedError: sharding over cards is ROADMAP item 3.
A ReLU head (yolov6, YOLO-NAS) walks its convs, which no head kernel takes, and
`pallas_head2=True` refuses it (NotImplementedError); a model whose layer 0 has no
conv to fold the input into (yolov9e's nn.Identity) raises NotImplementedError, and so does an RT-DETR model.
"""

from __future__ import annotations

import copy
import warnings

import numpy as np
import torch

from yolo_tpu_torch.device import resolve_device
from yolo_tpu_torch.kalman.batched import STATUS_DETECTED, STATUS_NONE, STATUS_PREDICTED, init_state, make_step
from yolo_tpu_torch.nn.quantize import calibrate_act_scales, params_are_fused_float, quantize_params
from yolo_tpu_torch.nn.tasks import (
    EXTRA_OUTPUT_TASKS,
    fuse,
    params_are_fused,
    params_from_jax,
    refuse_prompted_segment,
    validate_s2d_stem,
)
from yolo_tpu_torch.ops.nms import non_max_suppression_parts

# packed (T, N, 12) column layout; track_num rides an f32 column, exact up to 2^24 ids
_COLS = dict(bbox=slice(0, 4), confidence=4, emit=5, status=6, time_since_update=7, track_num=8, velocity=slice(9, 11), det_count=11)


def _unpack(packed: np.ndarray) -> dict:
    """(T, N, 12) f32 → the per-frame output dict (host side)."""
    return {
        "bbox": packed[..., _COLS["bbox"]],
        "confidence": packed[..., _COLS["confidence"]],
        "emit": packed[..., _COLS["emit"]] > 0.5,
        "status": packed[..., _COLS["status"]].astype(np.int32),
        "time_since_update": packed[..., _COLS["time_since_update"]].astype(np.int32),
        "track_num": packed[..., _COLS["track_num"]].astype(np.int32),
        "velocity": packed[..., _COLS["velocity"]],
        "det_count": packed[:, 0, _COLS["det_count"]].astype(np.int32),
    }


def init_stats(n_max: int, device=None) -> dict:
    """Fresh on-device stats accumulator (the prev_* carry crosses chunk edges)."""
    dev = resolve_device(device)
    z = torch.zeros((), dtype=torch.int32, device=dev)
    return {
        "frames": z.clone(),
        "detection_frames": z.clone(),
        "prediction_frames": z.clone(),
        "state_changes": z.clone(),
        "prev_status": torch.full((n_max,), STATUS_NONE, dtype=torch.int32, device=dev),
        "prev_nums": torch.zeros((n_max,), dtype=torch.int32, device=dev),
    }


def _fold_stem(params: dict, gray: bool, norm: bool = True) -> dict:
    """For single-channel frames the gray fold (conv(broadcast(x, 3), W) == conv(x, sum_c W)),
    and with `norm` the /255 fold, into the (fused) stem conv of a JAX parameter tree."""
    stem = params["model"]["0"]["conv"]
    w = np.asarray(stem["weight"], np.float32)
    if gray and w.shape[2] == 3:
        w = w.sum(axis=2, keepdims=True)
    model = dict(params["model"])
    model["0"] = {**params["model"]["0"], "conv": {**stem, "weight": w / 255.0 if norm else w}}
    return {**params, "model": model}


class FusedDetectTrack:
    """Chunked fused detect+track over a fixed frame geometry.

    `model` is a DetectionModel (its structure; this object keeps its own copy),
    `params` a JAX parameter tree (fused or not). `dtype` is the compute dtype
    of the forward (bf16 by default). `plain=True` runs the kernels' plain
    PyTorch twins instead of the CUDA kernels: the reference on the card.
    The other settings are the JAX package's (the module docstring)."""

    def __init__(
        self,
        model,
        params,
        frame_hw=(512, 640),
        channels: int = 1,
        chunk: int = 128,
        conf: float = 0.15,
        iou: float = 0.6,
        max_lost_frames: int = 150,
        min_hits: int = 1,
        iou_threshold: float = 0.1,
        n_max: int = 64,
        d_max: int = 16,
        dtype=None,
        int8: bool = False,
        int8_calib=None,
        mesh=None,
        s2d: int = 0,
        max_nms: int = 0,
        pallas_head: bool = False,
        neck_opt: bool | None = None,
        pallas_c2f: bool = False,
        unroll: int | None = None,
        sparse_head: bool | None = None,
        pallas_head2: bool = False,
        device=None,
        plain: bool = False,
    ):
        task = getattr(model, "task", "detect")
        if getattr(model, "is_rtdetr", False):
            raise NotImplementedError("FusedDetectTrack runs the Detect parts and the fixed-shape NMS; RT-DETR's decoder "
                                      "has no parts path (the JAX package asserts): use YOLO.predict or YOLO.track "
                                      "(ROADMAP item 5b)")
        refuse_prompted_segment(model, "FusedDetectTrack")
        if task in EXTRA_OUTPUT_TASKS:
            raise NotImplementedError(f"FusedDetectTrack with a {task} model is not ported (the JAX package's fast path takes plain Detect heads only)")
        if channels not in (1, 3):
            raise ValueError(f"frames have 1 (IR) or 3 (BGR) channels, got {channels}")
        if mesh is not None:
            raise NotImplementedError("FusedDetectTrack(mesh=...): sharding the pipeline over cards is not ported (ROADMAP item 3)")
        if s2d:
            if int8:
                raise ValueError("s2d and int8 are mutually exclusive")
            if frame_hw[0] % s2d or frame_hw[1] % s2d:
                raise ValueError(f"frame {tuple(frame_hw)} not divisible by s2d={s2d}")
            validate_s2d_stem(model)
        if sparse_head and int8:
            raise ValueError("the sparse box head takes fused float weights, not int8")
        head = model.layers[-1]
        if getattr(head, "end2end", False):
            raise NotImplementedError("FusedDetectTrack runs the Detect parts and the fixed-shape NMS; the end-to-end "
                                      "v10Detect head has no parts path (the JAX package asserts): use YOLO.predict or "
                                      "YOLO.track")
        if pallas_head2 and head.legacy:
            head.check_cm()  # a ReLU head: NotImplementedError (a non-legacy one raises at its first chunk, as in JAX)
        if "conv" not in params["model"]["0"]:  # yolov9e's layer 0 is nn.Identity
            raise NotImplementedError(f"FusedDetectTrack folds the gray and /255 input into layer 0's conv; this model's "
                                      f"layer 0 is {type(model.layers[0]).__name__}, which has none (the JAX package "
                                      "fails on it with a KeyError too; ROADMAP item 5)")
        self.device = resolve_device(device)
        if not params_are_fused(params):
            params = fuse(params)
        # the gray fold runs before quantization (int8 rows summed could overflow ±127); the /255
        # fold is skipped for int8 (its scales calibrate on /255 inputs)
        self.norm_folded = not int8
        params = _fold_stem(params, gray=channels == 1, norm=self.norm_folded)
        self.channels = channels
        self.pallas_head2 = pallas_head2
        self.model = copy.deepcopy(model)
        self.model.device = self.device
        self.dtype = dtype or torch.bfloat16
        if int8:
            scales = None
            if int8_calib is not None:  # static scales from representative uint8 frames (B, H, W, C)
                cal = np.asarray(int8_calib).astype(np.float32) / 255.0
                in_ch = np.asarray(params["model"]["0"]["conv"]["weight"]).shape[2]
                if cal.shape[-1] == 1 and in_ch == 3:
                    cal = np.broadcast_to(cal, cal.shape[:-1] + (3,))
                elif cal.shape[-1] == 3 and in_ch == 1:
                    cal = cal.mean(axis=-1, keepdims=True)
                scales = calibrate_act_scales(self.model, params, cal)
            params = quantize_params(params, act_scales=scales, flow_paths=self.model.int8_flow_paths())
        if neck_opt is None:
            neck_opt = not int8 and params_are_fused_float(params)
        elif neck_opt and int8:
            raise ValueError("neck_opt needs fused float weights, not int8")
        self.neck_opt = neck_opt
        self.int8 = int8
        params_from_jax(self.model, params, self.dtype)
        self.frame_hw = tuple(frame_hw)
        self.chunk = chunk
        self.conf = conf
        self.iou = iou
        self.n_max = n_max
        self.d_max = d_max
        self.plain = plain
        # NMS candidate slots: 4x the track capacity (as the JAX pipeline)
        self.max_nms = max_nms or max(4 * d_max, 64)
        self._step = make_step(n_max, d_max, max_lost_frames, min_hits, iou_threshold, device=self.device)
        self.timings = None  # set to a list to record per-chunk CUDA events of each stage
        self.reset()

    def reset(self):
        self.state = init_state(self.n_max, self.device)
        self.stats = init_stats(self.n_max, self.device)

    def _mark(self, marks, name):
        if marks is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append((name, ev))

    @torch.no_grad()
    def process_chunk_device(self, frames: torch.Tensor) -> torch.Tensor:
        """One chunk of uint8 frames (T, H, W, C) on the device → the packed
        (T, N, 12) device tensor, without synchronising with the host."""
        if tuple(frames.shape) != (self.chunk, *self.frame_hw, self.channels):
            raise ValueError(f"a chunk is {(self.chunk, *self.frame_hw, self.channels)} frames, got {tuple(frames.shape)}")
        marks = [] if self.timings is not None and frames.is_cuda else None
        self._mark(marks, "start")
        x = frames.to(self.dtype)
        if not self.norm_folded:
            x = x / 255.0
        if self.channels == 3:
            x = x.flip(-1)  # BGR → RGB
        parts = self.model.predict_parts(x, plain=self.plain, head_cm=self.pallas_head2, neck_opt=self.neck_opt)
        self._mark(marks, "forward")
        det = non_max_suppression_parts(*parts, conf_thres=self.conf, iou_thres=self.iou, max_det=self.d_max,
                                        max_nms=self.max_nms, plain=self.plain)
        self._mark(marks, "nms")
        det_boxes = det["boxes"]
        det_mask = det["valid"] & (det["scores"] > self.conf)

        state, outs = self.state, []
        for t in range(frames.shape[0]):
            state, out = self._step(state, det_boxes[t], det_mask[t])
            outs.append(out)
        self.state = state
        outs = {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
        self._mark(marks, "tracker")

        T = det_boxes.shape[0]
        status = torch.where(outs["emit"], outs["status"], STATUS_NONE).to(torch.int32)
        nums = outs["track_num"]
        st = self.stats
        full_status = torch.cat([st["prev_status"][None], status])
        full_nums = torch.cat([st["prev_nums"][None], nums])
        changed = (
            (full_status[1:] != full_status[:-1])
            & (full_status[1:] != STATUS_NONE)
            & (full_status[:-1] != STATUS_NONE)
            & (full_nums[1:] == full_nums[:-1])
        )
        self.stats = {
            "frames": st["frames"] + T,
            "detection_frames": st["detection_frames"] + (status == STATUS_DETECTED).sum(),
            "prediction_frames": st["prediction_frames"] + (status == STATUS_PREDICTED).sum(),
            "state_changes": st["state_changes"] + changed.sum(),
            "prev_status": status[-1],
            "prev_nums": nums[-1],
        }
        f32 = torch.float32
        packed = torch.cat(
            [
                outs["bbox"].to(f32),
                outs["confidence"].to(f32)[..., None],
                outs["emit"].to(f32)[..., None],
                outs["status"].to(f32)[..., None],
                outs["time_since_update"].to(f32)[..., None],
                outs["track_num"].to(f32)[..., None],
                outs["velocity"].to(f32),
                det_mask.sum(-1).to(f32)[:, None, None].expand(T, self.n_max, 1),
            ],
            -1,
        )
        self._mark(marks, "pack")
        if marks is not None:
            self.timings.append(marks)
        return packed

    def put_frames(self, frames) -> torch.Tensor:
        """Stage a uint8 chunk (T, H, W, C) on the device, through pinned memory on a card (the
        copy is asynchronous); `process_chunk_device` takes the result."""
        host = torch.from_numpy(np.ascontiguousarray(frames))
        if self.device.type != "cuda":
            return host
        return host.pin_memory().to(self.device, non_blocking=True)

    def process_chunk(self, frames: np.ndarray) -> dict:
        """frames: (T, H, W, C) uint8 with T == chunk → dict of per-frame outputs."""
        return _unpack(self.process_chunk_device(self.put_frames(frames)).cpu().numpy())

    def run_clip(self, clip: np.ndarray, collect_stats: bool = True, collect_outputs: bool = True, prefetch: int = 2):
        """Stream a whole clip → (list of per-chunk output dicts, contract stats).

        On the card each chunk is copied into one of `prefetch` (at least one) pinned host
        buffers and uploaded on a side stream; the compute stream waits for that upload only.
        The host waits only before it refills a pinned buffer whose upload may still be
        running, and once at the end. `collect_outputs=False` keeps no packed output (the
        list is empty) and `collect_stats=False` returns {} for the stats; the stats still
        accumulate on the device."""
        T = self.chunk
        n_chunks = len(clip) // T
        if len(clip) % T:
            warnings.warn(
                f"run_clip: dropping the last {len(clip) % T} frames; the pipeline runs fixed {T}-frame chunks",
                stacklevel=2,
            )
        packed_all = []
        if self.device.type == "cuda":
            depth = max(1, prefetch)
            main = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            shape = (T,) + tuple(clip.shape[1:])
            pinned = [torch.empty(shape, dtype=torch.uint8, pin_memory=True) for _ in range(depth)]
            uploaded = [None] * depth
            for ci in range(n_chunks):
                k = ci % depth
                if uploaded[k] is not None:
                    uploaded[k].synchronize()  # the upload that read pinned[k] is done
                pinned[k].numpy()[...] = clip[ci * T : (ci + 1) * T]
                with torch.cuda.stream(side):
                    dev = pinned[k].to(self.device, non_blocking=True)
                    uploaded[k] = torch.cuda.Event()
                    uploaded[k].record(side)
                main.wait_event(uploaded[k])
                dev.record_stream(main)
                packed = self.process_chunk_device(dev)
                if collect_outputs:
                    packed_all.append(packed)
            torch.cuda.synchronize(self.device)
        else:
            for ci in range(n_chunks):
                packed = self.process_chunk_device(self.put_frames(clip[ci * T : (ci + 1) * T]))
                if collect_outputs:
                    packed_all.append(packed)
        outs = [_unpack(p.cpu().numpy()) for p in packed_all]
        stats = {k: int(v) for k, v in self.stats.items() if not k.startswith("prev_")} if collect_stats else {}
        return outs, stats
