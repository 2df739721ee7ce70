#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`yolo_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py            # from the repository root; needs one CUDA card
    python3 chip_smoke.py --profile  # adds a torch.profiler breakdown of one bf16 chunk, the C2f and
                                     # head plan sweeps, both kernels' per-stage cycle counts and
                                     # the val loader-thread sweep

Phases (any failure stops the run with a non-zero exit code):
1. build the hand-written CUDA kernels from yolo_tpu_torch/csrc (nvcc, sm_90a);
2. hold every kernel against its plain PyTorch twin on the card, in f32 and
   bf16, at the main path's shapes (the C2f instances, four Detect levels
   through both head kernels, NMS at K=64 over a 128-frame chunk and at
   K=1024 over one frame at conf 0.15, as each predict runs it, and over 8
   frames at conf 0.01), with activations captured from the trained model on real-size
   frames; print each kernel's time, its plain twin's, a cuDNN conv walk of
   the same block (`library_ms`, a yardstick the port never calls) and the
   least time the card could take (`bound_ms`); the C2f lines also print
   what the kernel's plan chose for the instance, and hold the instance again
   cut to one frame, as `[predict]` gives it (another plan). `[c2f edges]` then holds
   the C2f kernel against its twin at shapes the main path lacks (B = 1, odd
   and undivided maps, n = 1 and 3, c = 12, 64 and 96, c1 = 288, both shortcut
   settings, upconcat with 48 and 192 small channels). Each captured Detect
   level is also held cut to one frame through both head kernels, and `[head
   edges]` holds both against their twins at the port's head edge shapes
   (B = 1 and 3, an odd map, a map narrower than the tile, P5's C = 192,
   c3 = 192, nc = 3, 17, the stock yolov8.yaml nc = 80 level, and yolov8x's
   c2 = 80 at C = 320 and 512); `[nms edges]` holds the NMS kernel against
   its twin, bit for bit, at B = 1 and 128 and K = 1, 33, 64, 1024, 1200 and
   4096, and at B = 1 and K = 1280 and 1281, the last K of one launch and the
   first of two (both forms of its plan, printed per shape);
3. `[pipeline]`: run FusedDetectTrack (the demo's trained yolov8-small P2,
   scale n, demos/artifacts/train/weights/best.npz) on a seeded synthetic
   512-frame 640x512 IR clip with moving targets and dropout gaps: in f32
   through the kernels and in f32 through the plain twins (tracks, ids and
   stats must be equal, boxes close), then in bf16, timed, with the per-stage
   split and the launch count of every kernel in that run;
4. `[pipeline head_cm]`: the same with `pallas_head2=True`, the Detect levels
   through the channel-major head kernel (16 launches per 512 frames, none of
   the default head kernel);
5. `[pipeline bgr]`: one chunk of 3-channel BGR frames through
   `FusedDetectTrack(channels=3)`, f32 kernels against f32 twins, then bf16;
   `[batched tracker]`: `BatchedMultiTargetTracker.update` / `scan_frames` on
   the card against the CPU on a seeded detection sequence;
6. `[predict]`: `YOLO(best.npz).predict` frame by frame on 64 3-channel frames
   of the clip into the per-object Kalman clip loop, in f32 through the
   kernels and through the twins (equal detections and stats), then in bf16,
   timed;
7. `[track bytetrack]`: `YOLO(best.npz).track(frame, persist=True,
   tracker="bytetrack.yaml")` on the same 64 BGR frames, one per call, at the
   track defaults (conf 0.1, max_det 300, imgsz 640; the host BYTETracker):
   f32 kernels against f32 twins (rows and ids equal per frame, boxes 1e-2 px,
   conf 1e-4), then bf16, timed (predict and tracker host ms/frame);
8. `[track botsort]`: the same with a BoT-SORT yaml whose gmc_method is none,
   written to a temporary path (the only form a machine without cv2 runs);
   where cv2 imports, `[track botsort sparseOptFlow]` runs the default
   botsort.yaml, the GMC on;
9. `[track device]`: the bytetrack run with YOLO_TPU_DEVICE_TRACKER=1, the
   batched ByteTrack twin on the card: rows equal the host tracker's under the
   JAX package's contract (ids exact, 2e-2), then its bf16 ms/frame at d_max /
   n_max 320 / 512 (the defaults) and 16 / 64;
10. `[byte scan]`: the 512-frame clip in 128-frame chunks already on the card:
   the bf16 forward, NMS at d_max 16, xyxy → xywh with cls 0, then
   `BatchedBYTETracker(n_max=64, d_max=16).scan_frames`; equal to `update`
   frame by frame and to the same scan on the CPU (ids exact, 1e-4); frames/s
   and the per-chunk event split (forward, NMS, byte step);
11. config 5 (camera-motion compensation and grayscale recovery; needs cv2, and
   fails without it): the 649-frame 640x512 panning clip (a copy of
   demos/motion_comp_bench.py::make_panning_clip, seed 7) through the chunked
   config-5 detector (gray frames, /255, broadcast to the stem, predict_parts
   and NMS at conf 0.15, iou 0.6, max_det 16, 128-frame chunks).
   `[motion kernels]`: f32 kernels against f32 twins (equal detection counts
   per frame, boxes 1e-2 px, conf 1e-4), then the optical-flow
   MotionCompensatedMultiTracker on both detection sequences (equal stats and
   per-frame track lists by position). `[motion optical_flow]`, `[motion
   feature_matching]`, `[motion hybrid]`: the bf16 chunked detector, then the
   host loop: fps_batched = frames / (detect s + host s), device ms/frame
   (CUDA events), host ms/frame split into motion detection and tracker,
   events, resets and launches; optical_flow also with the detector called
   once a frame. `[motion compare]`: `motion.compare_motion_methods` over the
   clip's first 128 frames as an mp4v file, the bf16 detector once a frame.
   `[grayscale]`: 128 frames of the IR clip as an mp4v file through
   `GrayscaleTracker.process_video(test_range=(32, 80))`, its own YOLO set to
   f32 against a plain-twin f32 detector (equal stats and tracks), then the
   default (bf16) tracker timed. `[grayscale scorer]`: `predict_center_torch`
   on 256 seeded 40x40 ROIs on the card against the numpy scorer (same
   index, score rel 1e-5), timed.
12. serving (needs cv2): `[serve kernels]`: a DetectionServer (yolo_tpu_torch/serve.py) on
   127.0.0.1 with lane 0 from best.npz and lane 1 from the .pt the port's `YOLO.export(format="pt")`
   writes, both f32 through the kernels, and a second server f32 through the twins (`plain`);
   4 client threads x 16 frames of the clip (1- or 3-channel by thread), each frame to both lanes:
   every reply status 0, no lane out of service, kernels against twins and lane 1 against lane 0
   at the f32 gates (1e-2 px, conf 1e-4, same counts and classes), kernels 1, 2, 3 and 5 launched
   and none by the twins' server. `[serve letterbox]`: one 640x512 frame's native and cv2
   letterbox on the main thread. `[serve run 1]`, `[serve run 2]` (timed, bf16, the default): 8
   v2 client threads x 64 frames plus one v1 client of 64: frames/s over all clients, request
   latency p50 / p99, the histogram of padded batch sizes, the worker's split per batch (host:
   letterbox + assembly, enqueue, wait, Results; CUDA events: upload, device), the device's idle
   share, the first batch at each B against its median, the launches (kernels 1, 2, 3, 5; not 4);
   every frame must have gone through the native letterbox. `[remote]`: `YOLO("tcp://...")` over
   an mp4v file and a PNG directory equals raw v2 replies, and `track` attaches ids.
   `[predict sources]`: `YOLO(best.npz).predict` over a PNG directory, a glob and a video with
   save, save_txt and save_crop (the files written), and a 300x500 frame through the native
   letterbox, f32 kernels against f32 twins;
13. `[val kernels]` (needs cv2): `YOLO(best.npz).val` at imgsz 640, batch 16, on the
   demo's held-out split (32 frames of 640x512, seed 10,000, written by a copy of
   demos/ir_end_to_end.py::_write_split, letterboxed to 640x640): f32 through the
   kernels against f32 through the twins (P, R, mAP50, mAP50-95 and fitness within
   1e-4, equal confusion matrices, equal detections per image with boxes within 1e-2
   px and conf 1e-4), the f32 mAP beside the JAX demo's recorded one, then bf16 and its
   difference; then kernels 1, 2, 3 and 5 against their twins at TOL on activations
   captured from the first val batch (B = 16, 640x640; NMS at conf 0.001, K = 1024);
14. `[val]`: the same on a 512-frame split (seed 20,000) in f32 and bf16 at batch 16
   and 32: images/s by the host clock over the `.val(...)` call of a model already warmed
   at that batch and dtype (built and on the card before the clock), the per-batch split (loader
   wait, the host's enqueue, upload + forward + NMS in CUDA events, the copy-back wait,
   host matching), each kernel's launches (6 c2f, 3 c2f_upconcat, 4 head_level, 1
   nms_keep a batch), and at batch 16 a profiled call: the device's busy time and idle
   share, the top device kernels and host ops.
15. training (needs cv2): the demo's 64-frame training split (seed 0) and its held-out split
   (the 32 frames of `[val kernels]`), written by the copy of _write_split. `[train]`:
   YOLO("yolov8-small.yaml").train with the IR recipe of train_small_targets.py:16-45
   (TRAIN_RECIPE: imgsz 640, batch 16, AdamW lr0 8e-4, bf16 `amp`, 8 loader threads; epochs
   3 and close_mosaic 1 instead of 150 and 20): per epoch the losses, P, R, mAP50, mAP50-95,
   epoch and validation seconds; train images/s, the per-step split (loader wait; forward +
   loss, backward, optimizer + BN + EMA in CUDA events), peak memory and the launches of
   check_amp and the validations. `[train step f32]`: one f32 step on the card and on the
   CPU from the same tree and batch, held to TRAIN_STEP_TOL. `[train finetune]` (report
   only): YOLO(best.npz), the demo's trained weights, one epoch of the recipe, mAP before
   and after. `[train val kernels]`: both trained models validated in f32 through the
   kernels and the twins, held as `[val kernels]` holds them.
16. the newer paths, each with best.npz at full width and each f32 run through the kernels held
   against the same run through the twins at the f32 gates (1e-2 px, conf 1e-4), kernels 1, 2, 3
   and 5 held against their twins on one frame's activations at the path's shapes (TOL, NMS bit
   for bit; `hold_path_kernels`): `[pipeline options]` (right after `[pipeline]`): `run_clip` in
   bf16 with collect_outputs=False and with prefetch 1 and 4, stats equal to `[pipeline]`'s;
   `[tiled]`: the clip's first 64 frames as BGR through `ops.tiling.tiled_predict` (tile 256,
   overlap 0.25: 9 tiles a frame in one batch, padded to B = 16), f32 then bf16 timed; `[tta]`:
   the 64 frames through `predict(augment=True, imgsz=640)` (640, 544 and 448 square on the
   device), the launches per shape; `[ensemble]`: `YOLO([best.npz, last.npz])` over them;
   `[embed]`: `YOLO.embed` of them (vectors within 1e-4), ms/frame; `[enhance]`:
   `otherplan.enhance_small_targets_torch` on 128 frames on the card against the host's cv2
   enhancement and against itself on the CPU (1e-3, equal `classical_detect` boxes); `[detect_only]`
   and `[single target]`: the clip's first 128 frames as an mp4v file through
   `otherplan.detect_only` and `run_single_target_tracking` with the port's YOLO as the detector.
17. the detect task's last settings (`int8_pipeline_phase`, right after `[pipeline options]`):
   `[pipeline int8]` (calibrated on the clip's first chunk) on the 512-frame clip: f32 through the
   NMS kernel against f32 through its twin (tracks, ids, statuses, detection counts and stats
   equal, boxes 1e-2 px), the frames whose detection count differs from `[pipeline]`'s f32 run
   (reported), then bf16 timed beside `[pipeline]`'s frames/s with its launches (kernel 5 only).
   After `[predict]`: `[predict int8]`, `[predict visualize]` (the files written) and `[predict
   show]` (no display: one warning, the same Results). Last, `[train settings]`: a 4-step epoch
   each of the default, remat and multi_scale + RAM cache + mosaic9 + cutmix (losses, device ms a
   step, peak memory), then `train(batch=-1)` at 640: autobatch's pick with the trainer's step as
   its probe, and one epoch of full batches at that pick (finite losses, peak memory).
18. the slice of YOLO.benchmark, YOLO.tune, COCOeval and the classify task: `[track botsort reid]`
   (after `[track botsort]`): the BoT-SORT run with its crop-and-embed ReID encoder on
   (`model: yolov8n.yaml`, the GMC off), f32 kernels (detector and encoder) against the twins, then
   bf16 timed with the encoder's host ms/frame; `[benchmark]` (after `[detect_only]`): best.npz's
   decoded forward at 640², B = 8 and 32, f32 kernels against twins with kernels 1, 2, 3 and 5 held
   at those activations, then `YOLO.benchmark(imgsz=640)` in bf16 and f32 and `benchmark_formats`;
   `[val coco]` (after `[val]`): the 512-frame split with a COCO annotations file, `save_json=True`,
   the COCOeval keys against a rerun on the written files; `[tune]` (after `[train settings]`): two
   iterations of `YOLO("yolov8-small.yaml").tune` on a 32-frame split at 640; `[classify]` (last):
   yolov8n-cls at full width, predict f32 kernel against twin then bf16, the C2f kernel held at its
   four instances (f32 and bf16, B = 1 and 32), 3 epochs of training on a seeded 4-class folder
   dataset (top1 >= 0.9) and `val` through the kernel against the twin.
19. the segment task (last; `segment_phases`), on a seeded polygon dataset (`write_seg_split`: 256 train and
   64 val 640x512 IR-like frames as BGR, 1-4 bright ellipses each, some overlapping, nc 1): `[segment train]`
   (YOLO("yolov8n-seg.yaml") from the JAX package's init(0), rebuilt at nc 1, SEG_RUN: 3 epochs at batch 16,
   640, bf16, AdamW lr0 8e-4: losses and box / mask metrics per epoch, images/s over the call, the step's split,
   peak memory), `[segment train step f32]` (one f32 step on the card against the CPU, TRAIN_STEP_TOL),
   `[segment val kernels]` (f32 kernels against twins: every box and mask key within 1e-4; then bf16 images/s),
   `[segment predict]` (the 64 val frames one per call, each frame's ten best detections, f32 kernels against
   twins with retina_masks off and on: boxes 1e-2 px, conf 1e-4, each mask's IoU >= 0.99; then bf16 frames/s
   with the host split) and `[segment forward]` (yolov8n-seg at full width, nc 80, 640², B = 8 and 32: preds,
   coefficients and prototypes of the kernels against the twins, NMS with the coefficients as extras, kernels
   1, 2, 3 and 5 held at those activations). Each phase launches kernels 1, 2, 3 and 5.
20. the pose task (last; `pose_phases`), on a seeded keypoint dataset (`write_pose_split`: 256 train and 64 val
   640x512 IR-like frames as BGR, 1-3 bright stick figures each with COCO's 17 keypoints in coco8-pose.yaml's order
   and flip_idx, some at visibility 1 and some at 0, nc 1): `[pose train]` (YOLO("yolov8n-pose.yaml") from the JAX
   package's init(0), POSE_RUN: 3 epochs at batch 16, 640, bf16, AdamW lr0 8e-4: the five losses and box / pose
   metrics per epoch, images/s over the call, the step's split, peak memory), `[pose train step f32]` (one f32 step
   on the card against the CPU, TRAIN_STEP_TOL), `[pose val kernels]` (f32 kernels against twins: every box and
   `pose_` key within 1e-4; then bf16 images/s), `[pose predict]` (the 64 val frames one per call, each frame's ten
   best, f32 kernels against twins: boxes 1e-2 px, conf 1e-4, keypoint x, y 1e-2 px, visibility 1e-4; then bf16
   frames/s with the host split), `[pose forward]` (yolov8n-pose at full width, nc 1, 640², B = 8 and 32: preds of
   the kernels against the twins, NMS with the 51 keypoint rows as extras kernel against twin bit for bit, kernels
   1, 2, 3 and 5 held at those activations) and `[pose track]` (YOLO.track of the trained model over the 64 frames,
   ByteTrack at thresholds fitted to its scores: rows, ids and each track's keypoints of the kernels equal the twins';
   `[segment track]` the same with the segment phases' model and each track's mask; then bf16 frames/s). Each phase
   launches kernels 1, 2, 3 and 5.
21. the obb task (last; `obb_phases`), on a seeded rotated dataset (`write_obb_split`: 256 train and 64 val 640x512
   IR-like frames as BGR, 1-4 bright rotated rectangles each, elongated like aircraft (aspect 2-6, 20-160 px long) at
   uniform angles, two classes (solid and hollow), a third of the frames with an overlapping pair; DOTA rows):
   `[obb train]` (YOLO("yolov8n-obb.yaml") from the JAX package's init(0), rebuilt at nc 2, OBB_RUN: 3 epochs at batch
   16, 640, bf16, AdamW lr0 8e-4: the three losses and the metrics per epoch, images/s over the call, the step's split,
   peak memory), `[obb train step f32]` (one f32 step on the card against the CPU, TRAIN_STEP_TOL), `[obb val kernels]`
   (f32 kernels against twins: every key within 1e-4; then bf16 images/s), `[obb predict]` (the 64 val frames one per
   call, each frame's ten best, f32 kernels against twins: centres and sizes 1e-2 px, angles 1e-4 rad, conf 1e-4; then
   bf16 frames/s with the host split), `[obb forward]` (yolov8n-obb at full width, nc 15 as DOTAv1, 640², B = 8 and 32:
   preds of the kernels against the twins, kernels 1, 2 and 3 held at those activations, the card's rotated NMS at
   K = 1024 against the same function on the CPU, and its time beside the forward's) and `[obb track]` (YOLO.track of
   the trained model over a clip of the 64 frames, ByteTrack at thresholds fitted to its scores: rows (xywhr), ids
   and classes of the kernels equal the twins'; then bf16 frames/s). Each phase launches kernels 1, 2 and 3 and not
   kernel 5: the rotated NMS is plain torch (it is not greedy).
With `--profile`, after the torch.profiler table: `[c2f plans]` launches the
C2f kernel with every candidate tile and ring step the plan's cost model rates
within 3x of its choice (at most 40), per instance, dtype and batch (128 and
1), and prints the model's choice beside the fastest measured one, and what
the model would choose with each of its constants set to a neutral value;
`[c2f trace]` builds the kernel with its cycle counters compiled in and prints
where one interior block's first warp spends its cycles, stage by stage;
`[head plans]` and `[head trace]` do the same for the head kernel's plan (the
four captured levels, B = 128 and 1) and its stages; `[val workers]` times the bf16 `[val]`
call with 1 to 16 loader threads, and the validator's device pass alone; `[train profile]`
records the device's work over one epoch of `[train]` (the device only: host tracing slows
the steps tenfold) and sets it against an unprofiled step: the device's idle share.
Every kernel of a path must have been launched in that path's run. The last
three lines are the `kernels` JSON line, the card's name and power limit, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WEIGHTS = ROOT / "demos" / "artifacts" / "train" / "weights" / "best.npz"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}  # dense bf16 tensor cores; f32 outside them
# kernel vs plain twin, (atol, rtol): f32 differs only in summation order;
# bf16 rounds every intermediate map, and a one-ulp flip travels down a C2f chain
TOL = {"float32": (1e-3, 1e-3), "bfloat16": (6e-2, 6e-2)}
# the channel-major head's cls output is a sigmoid score, far below 1e-3 on background
# pixels: it is held to a tighter absolute tolerance than the maps and distances, and
# again as a logit, where background and target pixels weigh alike (bf16: two ulps of
# the logit the kernel rounded before its sigmoid, 2 * 2^-7 of its size)
CLS_TOL = {"float32": (1e-5, 1e-3), "bfloat16": (2e-3, 6e-2)}
LOGIT_TOL = {"float32": (1e-3, 0.0), "bfloat16": (6e-2, 1.6e-2)}
FRAMES, CHUNK, HW = 512, 128, (512, 640)
PREDICT_FRAMES = 64
TRACK_FRAMES = 64
MOTION_FRAMES = 649  # config 5: the reference's clip length (demos/motion_comp_bench.py)
MOTION_COMPARE_FRAMES = 128
GRAY_FRAMES, GRAY_TEST_RANGE = 128, (32, 80)
VAL_HELDOUT, VAL_FRAMES = (32, 10_000), (512, 20_000)  # validation splits: frames, seed
KERNEL_ROWS = {  # name → (route, source, the TPU kernel's entry it replaces)
    "c2f": ("cuda", "yolo_tpu_torch/csrc/c2f.cu", "yolo_tpu/ops/pallas_c2f.py:264"),
    "c2f_upconcat": ("cuda", "yolo_tpu_torch/csrc/c2f.cu", "yolo_tpu/ops/pallas_c2f.py:290"),
    "head_level": ("cuda", "yolo_tpu_torch/csrc/head.cu", "yolo_tpu/ops/pallas_head.py:203"),
    "head_level_cm": ("cuda", "yolo_tpu_torch/csrc/head_cm.cu", "yolo_tpu/ops/pallas_head2.py:117"),
    "nms_keep": ("cuda", "yolo_tpu_torch/csrc/nms.cu", "yolo_tpu/ops/pallas_nms.py:56"),
}


def cv2_version() -> str | None:
    """cv2's version where it imports, else None."""
    try:
        import cv2
    except ImportError:
        return None
    return cv2.__version__


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True, check=True
    )
    return out.stdout.strip().splitlines()[0]


def compute_dtype(half: bool) -> str:
    """The predict setting that goes with `half`: predict computes in bf16 unless asked for f32."""
    return "bfloat16" if half else "float32"


def log(tag: str, card: str, msg: str) -> None:
    """One result line, tagged with the card it was measured on."""
    print(f"[{tag} | {card}] {msg}")


def cuda_ms(fn, iters: int = 5, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(call, reps: int = 20) -> float:
    """The device's time per call of `call`, without the host's: `reps` calls
    captured in one CUDA graph, whose replays are timed by events."""
    import torch

    call()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            call()
    return cuda_ms(g.replay, iters=10, warmup=2) / reps


def make_clip(n: int, h: int, w: int, seed: int = 0):
    """Seeded synthetic IR clip made on the card: smooth cloudy background, sensor
    noise and three bright 4-px-sigma targets on straight tracks, two of them
    hidden for a stretch (the tracker must coast). → (n, h, w, 1) uint8 numpy."""
    import torch
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(seed)
    bg = torch.randn((1, 1, h // 16, w // 16), generator=g, device="cuda") * 10 + 30
    bg = F.interpolate(bg, size=(h, w), mode="bicubic", align_corners=False)[0, 0]
    yy, xx = torch.meshgrid(torch.arange(h, device="cuda"), torch.arange(w, device="cuda"), indexing="ij")
    targets = [  # x0, y0, vx, vy, hidden frames
        (60.0, 100.0, 0.9, 0.3, range(150, 200)),
        (560.0, 420.0, -0.8, -0.4, range(300, 330)),
        (320.0, 60.0, 0.1, 0.6, range(0)),
    ]
    frames = torch.empty((n, h, w), dtype=torch.uint8, device="cuda")
    for f in range(n):
        img = bg + torch.randn((h, w), generator=g, device="cuda") * 2
        for x0, y0, vx, vy, hidden in targets:
            if f not in hidden:
                cx, cy = x0 + vx * f, y0 + vy * f
                img = img + 170 * torch.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * 4.0**2))
        frames[f] = img.clamp(0, 255).to(torch.uint8)
    return frames.cpu().numpy()[..., None]


# ---------------------------------------------------------------- phase 2 --


def capture_instances(model, x):
    """Run the plain forward once and record every kernel call's inputs, in order."""
    from yolo_tpu_torch.ops import cuda_c2f, cuda_head

    rec = []
    originals = (cuda_c2f.c2f_plain, cuda_c2f.c2f_upconcat_plain, cuda_head.head_level_plain)

    def c2f(x, kw, shortcut):
        rec.append(("c2f", (x, kw, shortcut)))
        return originals[0](x, kw, shortcut)

    def up(small, skip, kw, shortcut):
        rec.append(("c2f_upconcat", (small, skip, kw, shortcut)))
        return originals[1](small, skip, kw, shortcut)

    def head(x, kw):
        rec.append(("head_level", (x, kw)))
        return originals[2](x, kw)

    cuda_c2f.c2f_plain, cuda_c2f.c2f_upconcat_plain, cuda_head.head_level_plain = c2f, up, head
    try:
        boxes, scores = model.predict_parts(x, plain=True)
    finally:
        cuda_c2f.c2f_plain, cuda_c2f.c2f_upconcat_plain, cuda_head.head_level_plain = originals
    return rec, boxes, scores


def _oihw(w_flat, k, dtype):
    import torch

    cout = w_flat.shape[-1]
    return w_flat.reshape(k, k, -1, cout).permute(3, 2, 0, 1).to(dtype).contiguous(memory_format=torch.channels_last)


def library_c2f(kw, shortcut, dtype):
    """cuDNN conv walk of one C2f on NCHW channels_last maps (bias inside the conv)."""
    import torch
    import torch.nn.functional as F

    w1, wm, w2 = _oihw(kw.w1, 1, dtype), [_oihw(w, 3, dtype) for w in kw.wm], _oihw(kw.w2, 1, dtype)
    b1, bm, b2 = kw.b1.to(dtype), kw.bm.to(dtype), kw.b2.to(dtype)

    def walk(x):
        y = F.silu(F.conv2d(x, w1, b1))
        parts = list(y.chunk(2, 1))
        for i in range(kw.n):
            t = F.silu(F.conv2d(parts[-1], wm[2 * i], bm[2 * i], padding=1))
            t = F.silu(F.conv2d(t, wm[2 * i + 1], bm[2 * i + 1], padding=1))
            parts.append(parts[-1] + t if shortcut else t)
        return F.silu(F.conv2d(torch.cat(parts, 1), w2, b2))

    return walk


def library_head(kw, dtype):
    import torch.nn.functional as F

    w0, w1r, w1c = _oihw(kw.w0, 3, dtype), _oihw(kw.w1r, 3, dtype), _oihw(kw.w1c, 3, dtype)
    w2r, w2c = _oihw(kw.w2r, 1, dtype), _oihw(kw.w2c, 1, dtype)
    b = [t.to(dtype) for t in (kw.b0, kw.b1r, kw.b1c, kw.b2r, kw.b2c)]
    proj = kw.proj.to(dtype)

    def walk(x):
        u = F.silu(F.conv2d(x, w0, b[0], padding=1))
        r = F.silu(F.conv2d(u[:, : kw.c2], w1r, b[1], padding=1))
        c = F.silu(F.conv2d(u[:, kw.c2 :], w1c, b[2], padding=1))
        bins = F.conv2d(r, w2r, b[3])
        B, _, H, W = bins.shape
        dist = F.softmax(bins.reshape(B, 4, kw.reg_max, H, W).float(), 2).to(dtype).transpose(2, 4) @ proj
        return dist, F.conv2d(c, w2c, b[4])

    return walk


def library_head_cm(kw, dtype):
    """The channel-major level as library calls: the conv walk + softmax DFL, then the sigmoid."""
    import torch

    walk = library_head(kw, dtype)

    def walk_cm(x):
        dist, logits = walk(x)
        return dist, torch.sigmoid(logits.float())

    return walk_cm


def _nchw(x):
    import torch

    return x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def _logit(score):
    """Sigmoid scores (f32) → their logits, in f64."""
    import torch

    s = score.double().clamp(1e-38, 1 - 2.0**-24)
    return torch.log(s) - torch.log1p(-s)


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _bound(nbytes: int, ops: float, dtype_name: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def nms_candidates(boxes_xywh, scores, conf, max_nms):
    """The suppression tail's inputs, as ops/nms.non_max_suppression_parts forms them."""
    import torch

    from yolo_tpu_torch.ops.boxes import xywh2xyxy
    from yolo_tpu_torch.ops.nms import MAX_WH

    c, cls_id = scores.max(-1)
    c = torch.where(c > conf, c, -1.0)
    top, idx = torch.sort(c, dim=1, descending=True, stable=True)
    top, idx = top[:, :max_nms].contiguous(), idx[:, :max_nms]
    b = xywh2xyxy(torch.gather(boxes_xywh, 1, idx[..., None].expand(-1, -1, 4)))
    off = torch.gather(cls_id, 1, idx).to(b.dtype) * MAX_WH
    return (b + off[..., None]).contiguous(), top


def nms_iou_count(boxes, thr) -> int:
    """IoU evaluations the greedy walk needs on these candidates: K-1-i for every
    candidate i that is not suppressed when its turn comes."""
    import torch

    from yolo_tpu_torch.ops.boxes import box_iou

    B, K, _ = boxes.shape
    over = box_iou(boxes, boxes) > thr
    later = torch.arange(K, device=boxes.device)
    sup = torch.zeros((B, K), dtype=torch.bool, device=boxes.device)
    for i in range(K):
        sup |= over[:, i, :] & (later > i) & ~sup[:, i : i + 1]
    return int(((~sup).float() * (K - 1 - later).float()).sum())


def nms_edges_phase(card):
    """`[nms edges]`: the NMS kernel against its twin, bit for bit, at the port's
    edge shapes (ops/cuda_nms.py NMS_EDGES: B = 1 and 128, K = 1 to 4096, both
    forms of the plan) on seeded candidates with ties, duplicates and padding.
    The twin takes 16 images at a time (its IoU matrix is B x K x K floats)."""
    import torch

    from yolo_tpu_torch.ops import cuda_nms

    for B, K in cuda_nms.NMS_EDGES:
        boxes, scores = cuda_nms.edge_candidates(B, K, seed=K, device="cuda")
        got = cuda_nms.nms_keep(boxes, scores, 0.5)
        want = torch.cat([cuda_nms.nms_keep_plain(boxes[i : i + 16], scores[i : i + 16], 0.5) for i in range(0, B, 16)])
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"nms edges: B={B} K={K}: keep mask differs from the twin in {int((got != want).sum())} slots")
        ms = cuda_ms(lambda: cuda_nms.nms_keep(boxes, scores, 0.5), iters=20, warmup=2)
        log("nms edges", card, f"B={B:<3d} K={K:<4d} kept={int(got.sum())} valid={int((scores > 0).sum())} equal to the twin; "
            f"{cuda_nms.plan_text(B, K)} kernel_ms={ms:.4f}")


def c2f_plan_text(B, H, W, c1, cs, kw, dtype) -> str:
    from yolo_tpu_torch.ops import cuda_c2f

    p = cuda_c2f.plan(B, H, W, c1, cs, kw.c, kw.w2.shape[1], kw.n, dtype)
    text = (f"tile={p['tile'][0]}x{p['tile'][1]} blocks={p['blocks']} cluster={p['cluster']} per_sm={p['blocks_per_sm']} "
            f"smem={p['smem']}B {p['instruction']}")
    return text + (f" item={p['item_px']}px ring={p['ring_steps']}x{p['step_slices']}" if p["ring_steps"] else "")


def c2f_edges_phase(card):
    """The C2f kernel against its plain twin, f32 and bf16, on seeded random
    weights and inputs at the port's list of edge shapes. A disagreement raises."""
    import numpy as np
    import torch

    from yolo_tpu_torch.nn import modules as PM
    from yolo_tpu_torch.ops import cuda_c2f

    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        atol, rtol = TOL[dn]
        for c1, c2, n, shortcut, cs, B, H, W in cuda_c2f.EDGE_SHAPES:
            rng = np.random.default_rng(0)
            mod = PM.C2f(c1, c2, n=n, shortcut=shortcut)
            for m in mod.modules():
                if isinstance(m, PM.ConvBNAct):
                    fan_in = m.weight[0].numel()
                    m.weight = torch.from_numpy(rng.uniform(-1, 1, tuple(m.weight.shape)) / np.sqrt(fan_in)).float().to("cuda", dtype)
                    m.bias = torch.from_numpy(rng.normal(0, 0.1, tuple(m.bias.shape))).float().to("cuda", dtype)
            kw = mod.kernel_weights()
            skip = torch.from_numpy(rng.normal(0, 1, (B, H, W, c1 - cs))).float().to("cuda", dtype)
            if cs:
                small = torch.from_numpy(rng.normal(0, 1, (B, H // 2, W // 2, cs))).float().to("cuda", dtype)
                got, want = cuda_c2f.fused_c2f_upconcat(small, skip, kw, shortcut), cuda_c2f.c2f_upconcat_plain(small, skip, kw, shortcut)
            else:
                got, want = cuda_c2f.fused_c2f(skip, kw, shortcut), cuda_c2f.c2f_plain(skip, kw, shortcut)
            torch.cuda.synchronize()
            desc = f"B={B} {H}x{W} {f'up({cs})+{c1 - cs}' if cs else c1}->{c2} n={n}{' shortcut' if shortcut else ''}"
            err = float((got.float() - want.float()).abs().max())
            if got.shape != want.shape or not torch.isfinite(got).all() or not torch.allclose(got.float(), want.float(), atol=atol, rtol=rtol):
                raise AssertionError(f"c2f edges {dn}: {desc} disagrees with the plain twin (atol {atol}, rtol {rtol}), max |err| {err}")
            log(f"c2f edges {dn}", card, f"{desc:44s} max_abs_err={err:.3e} {c2f_plan_text(B, H, W, c1, cs, kw, dtype)}")


def head_plan_text(B, H, W, C, kw, dtype) -> str:
    from yolo_tpu_torch.ops import cuda_head

    p = cuda_head.plan(B, H, W, C, kw.c2, kw.c3, kw.nc, dtype)
    text = (f"tile={p['tile'][0]}x{p['tile'][1]} blocks={p['blocks']} tiles={p['tiles']} per_sm={p['blocks_per_sm']} "
            f"smem={p['smem']}B {p['instruction']}")
    return text + (f" ring={p['ring_steps']}x{p['slot_bytes']}B" if p["ring_steps"] else "")


def head_fns(name):
    """(kernel wrapper, plain twin) of a head kernel by its KERNEL_ROWS name."""
    from yolo_tpu_torch.ops import cuda_head, cuda_head_cm

    if name == "head_level_cm":
        return cuda_head_cm.head_level_cm, cuda_head_cm.head_level_cm_plain
    return cuda_head.fused_head_level, cuda_head.head_level_plain


def hold(name, desc, dn, got, want) -> dict:
    """Hold a kernel's outputs against its twin's at the stated tolerances (the
    channel-major head's scores also as logits) → max |err| by output; raises."""
    import torch

    got, want = (got,) if torch.is_tensor(got) else got, (want,) if torch.is_tensor(want) else want
    atol, rtol = TOL[dn]
    held = [(f"output {i}", g_.float(), w_.float(), atol, rtol) for i, (g_, w_) in enumerate(zip(got, want))]
    if name == "head_level_cm":
        held = [("dist", *held[0][1:]), ("cls", *held[1][1:3], *CLS_TOL[dn]),
                ("cls as logit", _logit(got[1]), _logit(want[1]), *LOGIT_TOL[dn])]
    errs = {}
    for label, g_, w_, at, rt in held:
        if g_.shape != w_.shape or not torch.isfinite(g_).all():
            raise AssertionError(f"{name} {desc} {dn}: {label}: shape {tuple(g_.shape)} vs {tuple(w_.shape)} or non-finite")
        errs[label] = float((g_ - w_).abs().max())
        if not torch.allclose(g_, w_, atol=at, rtol=rt):
            raise AssertionError(f"{name} {desc} {dn}: {label} disagrees with the plain twin "
                                 f"(atol {at}, rtol {rt}), max |err| {errs[label]}")
    return errs


def head_edges_phase(card):
    """`[head edges]`: both head kernels against their twins, f32 and bf16, on
    seeded random levels at the port's list of edge shapes (ops/cuda_head.py
    HEAD_EDGES). A disagreement raises."""
    import numpy as np
    import torch

    from yolo_tpu_torch.ops import cuda_head

    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        for B, H, W, C, c2, c3, nc in cuda_head.HEAD_EDGES:
            kw = cuda_head.HeadWeights.random(C, c2, c3, nc, seed=0, device="cuda", dtype=dtype)
            x = torch.from_numpy(np.random.default_rng(1).normal(0, 1, (B, H, W, C))).float().to("cuda", dtype)
            desc = f"B={B} {H}x{W} C={C} c2={c2} c3={c3} nc={nc}"
            for name in ("head_level", "head_level_cm"):
                kern, plain = head_fns(name)
                got, want = kern(x, kw), plain(x, kw)
                torch.cuda.synchronize()
                errs = hold(name, desc, dn, got, want)
                log(f"head edges {dn}", card, f"{name:14s} {desc:40s} max_abs_err="
                    + "/".join(f"{v:.3e}" for v in errs.values()) + f" {head_plan_text(B, H, W, C, kw, dtype)}")


def head_plan_sweep(cases, card, within=3.0, most=40):
    """`[head plans]`: the head plan's cost model against the card, as `[c2f
    plans]` does for C2f: per captured Detect level, dtype and batch (a chunk,
    one frame), every candidate tile the model rates within `within` of its
    choice (the `most` cheapest) is launched and timed; then the model's choice
    with its constant `barrier` at 0."""
    import torch

    from yolo_tpu_torch.ops import cuda_head

    key = lambda p: (p["th"], p["tw"])  # noqa: E731
    show = lambda k: f"{k[0]}x{k[1]}"  # noqa: E731
    for dn, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        for B in (CHUNK, 1):
            total = {"model": 0.0, "fastest": 0.0, "without barrier": 0.0}
            for x, kw in cases[dn]:
                x = x[:B]
                _, H, W, C = x.shape
                shape = (B, H, W, C, kw.c2, kw.c3, kw.nc, dtype)
                timed = {}

                def ms(k):
                    if k not in timed:
                        run = lambda: cuda_head._launch(x, kw, cm=False, force=k)  # noqa: E731
                        timed[k] = cuda_ms(run, iters=3, warmup=1)
                        if timed[k] < 0.5:  # a short kernel: enough launches in a row that the host's gaps do not count
                            timed[k] = cuda_ms(run, iters=30, warmup=3)
                    return timed[k]

                def choice(model):
                    cands = cuda_head.candidates(*shape, model=model)
                    return key(min(cands, key=lambda p: p["cost"])), cands

                pick, cands = choice(None)
                if pick != cuda_head.plan(*shape)["tile"]:
                    raise AssertionError(f"head plans: the candidates' cheapest {pick} is not the plan's tile for {shape}")
                floor = min(p["cost"] for p in cands)
                near = sorted({key(p): p["cost"] for p in cands if p["cost"] <= within * floor}.items(), key=lambda kv: kv[1])[:most]
                for k, _ in near:
                    ms(k)
                fastest = min(timed, key=timed.get)
                alt = choice({"barrier": 0.0})[0]
                total["model"] += ms(pick)
                total["fastest"] += timed[fastest]
                total["without barrier"] += ms(alt)
                log(f"head plans {dn}", card, f"B={B:<3d} {H}x{W} C={C:<4d} model {show(pick)} {ms(pick):.4f} ms | fastest of "
                    f"{len(near)} {show(fastest)} {timed[fastest]:.4f} ms ({ms(pick) / timed[fastest]:.3f}x), then "
                    + " ".join(f"{show(k)} {v:.4f}" for k, v in sorted(timed.items(), key=lambda kv: kv[1])[1:4])
                    + (f" | without barrier: {show(alt)} {ms(alt):.4f}" if alt != pick else ""))
            log(f"head plans {dn}", card, f"B={B}: sum over the levels, ms: " + ", ".join(f"{k} {v:.4f}" for k, v in total.items()))


def head_stage_trace(cases, card):
    """`[head trace]`: the bf16 head kernel built with -DYT_HEAD_TRACE. Per
    captured Detect level at chunk size, the cycles that thread 0 of one
    interior block spent per stage (input staging, the first conv, the reg
    second conv with its 1x1 and DFL as its epilogue, the cls second conv with
    its 1x1 as its epilogue), split into waits for its copies, the block
    barriers, copy issue, the product loop, the epilogues and the rest, per
    tile of that block, with the level's kernel time in that build."""
    import ctypes

    import torch

    from yolo_tpu_torch.ops import _cuda, cuda_head

    t0 = time.perf_counter()
    lib = ctypes.CDLL(str(_cuda.build(extra=("-DYT_HEAD_TRACE",))))
    lib.yt_head_set_trace.argtypes = [ctypes.c_void_p]
    log("head trace", card, f"traced build in {time.perf_counter() - t0:.1f} s")
    stages = ("staging", "first conv", "reg 3x3 | 1x1+DFL", "cls 3x3 | 1x1")
    slots = ("copy wait", "barrier", "copy issue", "loop", "epilogue", "other")
    buf = torch.zeros((4 * 7 + 1,), dtype=torch.int64, device="cuda")
    for x, kw in cases:
        _, H, W, C = x.shape
        desc = f"{H}x{W} C={C}"
        run = lambda: cuda_head._launch(x, kw, cm=False, lib=lib)  # noqa: E731
        kms = cuda_ms(run)  # also warms L2 with the weights and the input, as in a run of chunks
        torch.cuda.synchronize()
        buf.zero_()
        lib.yt_head_set_trace(buf.data_ptr())
        run()
        torch.cuda.synchronize()
        lib.yt_head_set_trace(None)
        v = buf.cpu().tolist()
        tiles = max(v[-1], 1)
        rows = [v[7 * s_ : 7 * s_ + 7] for s_ in range(4)]
        whole = sum(sum(r[:6]) for r in rows)
        for stage, r in zip(stages, rows):
            log("head trace", card, f"{desc:16s} {stage:18s} steps/tile={r[6] / tiles:<5.1f} "
                + " ".join(f"{s_}={v_ / tiles:.0f}" for s_, v_ in zip(slots, r)) + f" sum={sum(r[:6]) / tiles:.0f}")
        log("head trace", card, f"{desc:16s} block: {tiles} tiles, {whole / tiles:.0f} cycles/tile, kernel "
            f"{kms:.4f} ms; shares: " + ", ".join(f"{s_} {sum(r[i] for r in rows) / whole:.3f}" for i, s_ in enumerate(slots))
            + f"; reg loop {rows[2][3] / tiles:.0f} cycles/tile")


def _c2f_case(name, args, B):
    """A captured C2f call cut to B frames → (x or skip, small or None, kw, shortcut, description)."""
    if name == "c2f":
        x, kw, sc = args
        small = None
    else:
        small, x, kw, sc = args
        small = small[:B]
    x = x[:B]
    cs = 0 if small is None else small.shape[-1]
    desc = f"{x.shape[1]}x{x.shape[2]} {f'up({cs})+{x.shape[-1]}' if cs else x.shape[-1]}->{kw.w2.shape[1]} n={kw.n}"
    return x, small, kw, sc, desc


def c2f_plan_sweep(cases, card, within=3.0, most=40):
    """`[c2f plans]`: the plan's cost model against the card. Per captured C2f
    instance, dtype and batch (a chunk, one frame), every candidate the model
    rates within `within` of its choice (the `most` cheapest) is launched and
    timed; the line gives the model's choice and the fastest candidate. Then each
    constant of the model is set to its neutral value in turn, and the choice the
    model would then make is timed too. The sums say what each constant is worth."""
    import torch

    from yolo_tpu_torch.ops import cuda_c2f

    neutral = {"barrier": 0.0, "shared": 1.0}
    key = lambda p: (p["th"], p["tw"], p["step_slices"])  # noqa: E731
    show = lambda k: f"{k[0]}x{k[1]}" + (f" ring 2x{k[2]}" if k[2] else "")  # noqa: E731
    sums = {}
    for dn, dtype in (("bfloat16", torch.bfloat16), ("float32", torch.float32)):
        for B in (CHUNK, 1):
            total = sums.setdefault((dn, B), {"model": 0.0, "fastest": 0.0, **{f"without {k}": 0.0 for k in neutral}})
            for name, args in cases[dn]:
                x, small, kw, sc, desc = _c2f_case(name, args, B)
                shape = (B, x.shape[1], x.shape[2], kw.w1.shape[0], 0 if small is None else small.shape[-1], kw.c, kw.w2.shape[1], kw.n, dtype)
                timed = {}

                def ms(k):
                    if k not in timed:
                        run = lambda: cuda_c2f._launch(x, small, kw, sc, force=k)  # noqa: E731
                        timed[k] = cuda_ms(run, iters=3, warmup=1)
                        if timed[k] < 0.5:  # a short kernel: enough launches in a row that the host's gaps do not count
                            timed[k] = cuda_ms(run, iters=30, warmup=3)
                    return timed[k]

                def choice(model):
                    cands = cuda_c2f.candidates(*shape, model=model)
                    return key(min(cands, key=lambda p: p["cost"])), cands  # the first of least cost, as the plan takes it

                pick, cands = choice(None)
                if pick[:2] != cuda_c2f.plan(*shape)["tile"]:
                    raise AssertionError(f"c2f plans: the candidates' cheapest {pick} is not the plan's tile for {desc}")
                floor = min(p["cost"] for p in cands)
                near = sorted({key(p): p["cost"] for p in cands if p["cost"] <= within * floor}.items(), key=lambda kv: kv[1])[:most]
                for k, _ in near:
                    ms(k)
                fastest = min(timed, key=timed.get)
                without = {k: choice({k: v})[0] for k, v in neutral.items()}
                total["model"] += ms(pick)
                total["fastest"] += timed[fastest]
                for k, alt in without.items():
                    total[f"without {k}"] += ms(alt)
                log(f"c2f plans {dn}", card, f"B={B:<3d} {desc:30s} model {show(pick)} {ms(pick):.4f} ms | fastest of {len(near)} "
                    f"{show(fastest)} {timed[fastest]:.4f} ms ({ms(pick) / timed[fastest]:.3f}x), then "
                    + " ".join(f"{show(k)} {v:.4f}" for k, v in sorted(timed.items(), key=lambda kv: kv[1])[1:4]) + " | "
                    + ", ".join(f"without {k}: {show(alt)} {ms(alt):.4f}" for k, alt in without.items() if alt != pick))
    for (dn, B), total in sums.items():
        log(f"c2f plans {dn}", card, f"B={B}: sum over the instances, ms: " + ", ".join(f"{k} {v:.4f}" for k, v in total.items()))


def c2f_stage_trace(cases, card):
    """`[c2f trace]`: the bf16 kernel built with -DYT_C2F_TRACE. Per captured
    instance at chunk size, the cycles that thread 0 of one interior block spent,
    per GEMM of the block: waiting for its own copies, at the block barriers,
    issuing copies, in the ldmatrix + mma loop, in the epilogues and in the rest
    (zeroing, item set-up), with the ring steps it took."""
    import ctypes

    import torch

    from yolo_tpu_torch.ops import _cuda, cuda_c2f

    t0 = time.perf_counter()
    lib = ctypes.CDLL(str(_cuda.build(extra=("-DYT_C2F_TRACE",))))
    lib.yt_c2f_set_trace.argtypes = [ctypes.c_void_p]
    log("c2f trace", card, f"traced build in {time.perf_counter() - t0:.1f} s")
    slots = ("copy wait", "barrier", "copy issue", "loop", "epilogue", "other")
    buf = torch.zeros((16, 7), dtype=torch.int64, device="cuda")
    for name, args in cases:
        x, small, kw, sc, desc = _c2f_case(name, args, CHUNK)
        stages = ["cv1 y_a", "cv1 y_b"] + [f"m{i}.cv{j}" for i in range(kw.n) for j in (1, 2)]
        stages += [f"cv2[{o}]" for o in range(-(-kw.w2.shape[1] // (-(-kw.c // 16) * 16)))]
        cuda_c2f._launch(x, small, kw, sc, lib=lib)  # warm: the weights and this block's input are in L2, as in a run of chunks
        torch.cuda.synchronize()
        buf.zero_()
        lib.yt_c2f_set_trace(buf.data_ptr())
        cuda_c2f._launch(x, small, kw, sc, lib=lib)
        torch.cuda.synchronize()
        lib.yt_c2f_set_trace(None)
        rows = buf.cpu().tolist()[: len(stages)]
        whole = sum(sum(r[:6]) for r in rows)
        for stage, r in zip(stages, rows):
            log("c2f trace", card, f"{desc:30s} {stage:8s} steps={r[6]:<4d} " + " ".join(f"{s}={v}" for s, v in zip(slots, r)) + f" sum={sum(r[:6])}")
        log("c2f trace", card, f"{desc:30s} block    steps={sum(r[6] for r in rows):<4d} cycles={whole} shares: "
            + ", ".join(f"{s} {sum(r[i] for r in rows) / whole:.3f}" for i, s in enumerate(slots)))


def check_kernels(model, params, frames, card, d_max=16, keep=None):
    """Phase 2: every kernel against its plain twin at the main path's shapes → per-kernel records (bf16).
    `keep`, a dict, receives the captured C2f calls by dtype name and, under "head " + that name, the
    captured Detect levels (for `--profile`)."""
    import torch

    from yolo_tpu_torch import FusedDetectTrack
    from yolo_tpu_torch.ops import cuda_c2f, cuda_nms

    records = {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        atol, rtol = TOL[dn]
        ft = FusedDetectTrack(model, params, frame_hw=HW, chunk=CHUNK, d_max=d_max, dtype=dtype, plain=True)
        x = torch.from_numpy(frames).cuda().to(dtype)
        rec, boxes, scores = capture_instances(ft.model, x)
        nb = sum(1 for name, _ in rec if name == "c2f")
        log(f"kernels {dn}", card, f"captured {len(rec)} kernel calls from a {tuple(x.shape)} chunk ({nb} c2f)")
        if keep is not None:
            keep[dn] = [(name, args) for name, args in rec if name.startswith("c2f")]
            keep["head " + dn] = [args for name, args in rec if name == "head_level"]
        # every captured Detect level is also a case of the channel-major head kernel
        cases = [c for name, args in rec for c in ([(name, args)] + ([("head_level_cm", args)] if name == "head_level" else []))]
        for name, args in cases:
            if name == "c2f":
                xin, kw, sc = args
                B, H, W, c1 = xin.shape
                kern = lambda: cuda_c2f.fused_c2f(xin, kw, sc)  # noqa: E731
                plain = lambda: cuda_c2f.c2f_plain(xin, kw, sc)  # noqa: E731
                lib, lib_in = library_c2f(kw, sc, dtype), _nchw(xin)
                macs = H * W * (c1 * 2 * kw.c + kw.n * 18 * kw.c * kw.c + (2 + kw.n) * kw.c * kw.w2.shape[1])
                ins = (xin,)
                desc = f"{H}x{W} {c1}->{kw.w2.shape[1]} n={kw.n}{' shortcut' if sc else ''}"
                tile = c2f_plan_text(B, H, W, c1, 0, kw, dtype)
            elif name == "c2f_upconcat":
                small, skip, kw, sc = args
                B, H, W, ck = skip.shape
                cs = small.shape[-1]
                kern = lambda: cuda_c2f.fused_c2f_upconcat(small, skip, kw, sc)  # noqa: E731
                plain = lambda: cuda_c2f.c2f_upconcat_plain(small, skip, kw, sc)  # noqa: E731
                walk = library_c2f(kw, sc, dtype)
                lib_small, lib_skip = _nchw(small), _nchw(skip)

                def lib(_, walk=walk, s=lib_small, k=lib_skip):
                    return walk(torch.cat([torch.nn.functional.interpolate(s, scale_factor=2.0), k], 1))

                lib_in = None
                macs = (H // 2) * (W // 2) * cs * 2 * kw.c + H * W * (
                    ck * 2 * kw.c + kw.n * 18 * kw.c * kw.c + (2 + kw.n) * kw.c * kw.w2.shape[1]
                )
                ins = (small, skip)
                desc = f"{H}x{W} up({cs})+{ck}->{kw.w2.shape[1]} n={kw.n}"
                tile = c2f_plan_text(B, H, W, cs + ck, cs, kw, dtype)
            else:
                xin, kw = args
                B, H, W, C = xin.shape
                kfn, pfn = head_fns(name)
                kern = lambda: kfn(xin, kw)  # noqa: E731
                plain = lambda: pfn(xin, kw)  # noqa: E731
                lib, lib_in = (library_head_cm if name == "head_level_cm" else library_head)(kw, dtype), _nchw(xin)
                tile = head_plan_text(B, H, W, C, kw, dtype)
                macs = H * W * (9 * C * (kw.c2 + kw.c3) + 9 * kw.c2 * kw.c2 + 9 * kw.c3 * kw.c3
                                + kw.c2 * 4 * kw.reg_max + kw.c3 * kw.nc)
                ins = (xin,)
                desc = f"{H}x{W} C={C}"
            got, want = kern(), plain()
            torch.cuda.synchronize()
            errs = hold(name, desc, dn, got, want)
            got = (got,) if torch.is_tensor(got) else got
            err = max(v for k, v in errs.items() if k != "cls as logit")
            ms, pms = cuda_ms(kern), cuda_ms(plain)
            lms = cuda_ms(lambda: lib(lib_in))
            wbytes = _nbytes(*(t for k, t in vars(kw).items() if torch.is_tensor(t) and not k.startswith("_")))
            bound, by = _bound(_nbytes(*ins, *got) + wbytes, 2.0 * B * macs, dn)
            log(
                f"kernels {dn}", card,
                f"{name:14s} {desc:32s} {tile} "
                f"max_abs_err={err:.3e} kernel_ms={ms:.4f} plain_ms={pms:.4f} library_ms(cudnn walk)={lms:.4f} "
                f"bound_ms={bound:.4f} ({by})"
            )
            if name.startswith("c2f"):
                # the per-frame predict path gives the kernel the same instance with one frame: another plan
                one = [t[:1] for t in ins]
                fused = cuda_c2f.fused_c2f if name == "c2f" else cuda_c2f.fused_c2f_upconcat
                plain1 = cuda_c2f.c2f_plain if name == "c2f" else cuda_c2f.c2f_upconcat_plain
                g1, w1 = fused(*one, kw, sc).float(), plain1(*one, kw, sc).float()
                torch.cuda.synchronize()
                err1 = float((g1 - w1).abs().max())
                if g1.shape != w1.shape or not torch.isfinite(g1).all() or not torch.allclose(g1, w1, atol=atol, rtol=rtol):
                    raise AssertionError(f"{name} {desc} {dn} at B=1: disagrees with the plain twin (atol {atol}, rtol {rtol}), "
                                         f"max |err| {err1}")
                log(f"kernels {dn}", card, f"{name:14s} {desc:32s} B=1: {c2f_plan_text(1, H, W, kw.w1.shape[0], kw.w1.shape[0] - ins[-1].shape[-1], kw, dtype)} "
                    f"max_abs_err={err1:.3e} kernel_ms={cuda_ms(lambda: fused(*one, kw, sc)):.4f}")
            if name.startswith("head"):
                # the per-frame predict path gives the kernel the same level with one frame: another plan
                e1 = hold(name, desc + " B=1", dn, kfn(xin[:1], kw), pfn(xin[:1], kw))
                log(f"kernels {dn}", card, f"{name:14s} {desc:32s} B=1: {head_plan_text(1, H, W, C, kw, dtype)} max_abs_err="
                    + "/".join(f"{v:.3e}" for v in e1.values()) + f" kernel_ms={cuda_ms(lambda: kfn(xin[:1], kw)):.4f}")
            if name == "head_level_cm":
                cls = want[1].float().abs()
                for k, v in errs.items():
                    log(f"kernels {dn}", card, f"{name:14s} {desc:32s} {k:12s} max_abs_err={v:.3e}"
                        + (f" (scores: max {float(cls.max()):.3e}, median {float(cls.median()):.3e})" if k == "cls" else ""))
            if dtype == torch.bfloat16:
                r = records.setdefault(name, dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, max_abs_err=0.0,
                                                  ops_ms=0.0, bytes_ms=0.0))
                r["ms"] += ms
                r["plain_ms"] += pms
                r["library_ms"] += lms
                r["bound_ms"] += bound
                r["max_abs_err"] = max(r["max_abs_err"], err)
                r["ops_ms" if by == "operations" else "bytes_ms"] += bound
        # NMS: the candidates of this chunk (K = max_nms = 64 at d_max = 16)
        cand, top = nms_candidates(boxes, scores, ft.conf, ft.max_nms)
        B, K, _ = cand.shape
        got = cuda_nms.nms_keep(cand, top, ft.iou)
        want = cuda_nms.nms_keep_plain(cand, top, ft.iou)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"nms_keep {dn}: keep mask differs from the plain twin in {int((got != want).sum())} slots")
        ms = cuda_ms(lambda: cuda_nms.nms_keep(cand, top, ft.iou), iters=50, warmup=5)
        pms = cuda_ms(lambda: cuda_nms.nms_keep_plain(cand, top, ft.iou))
        n_iou = nms_iou_count(cand, ft.iou)
        bound, by = _bound(_nbytes(cand, top) + B * K, 12.0 * n_iou, "float32")
        log(
            f"kernels {dn}", card,
            f"nms_keep      B={B} K={K} kept={int(got.sum())} valid={int((top > 0).sum())} {cuda_nms.plan_text(B, K)} "
            f"max_abs_err=0 kernel_ms={ms:.4f} (device, graph: {graph_ms(lambda: cuda_nms.nms_keep(cand, top, ft.iou)):.4f}) "
            f"plain_ms={pms:.4f} library_ms=null bound_ms={bound:.5f} ({by}; {n_iou} IoUs x 12 f32 ops)"
        )
        # the predict facade's NMS: K = max_nms = 1024 candidates of one frame at its conf 0.15, as each
        # predict launches it, and over 8 frames at a low threshold
        for nb, conf in ((1, ft.conf), (8, 0.01)):
            cand1k, top1k = nms_candidates(boxes[:nb], scores[:nb], conf, 1024)
            got1k = cuda_nms.nms_keep(cand1k, top1k, ft.iou)
            want1k = cuda_nms.nms_keep_plain(cand1k, top1k, ft.iou)
            torch.cuda.synchronize()
            if not torch.equal(got1k, want1k):
                raise AssertionError(f"nms_keep {dn} B={nb} K=1024: keep mask differs in {int((got1k != want1k).sum())} slots")
            log(f"kernels {dn}", card, f"nms_keep      B={nb} K=1024 conf={conf} kept={int(got1k.sum())} "
                f"valid={int((top1k > 0).sum())} {cuda_nms.plan_text(nb, 1024)} max_abs_err=0 kernel_ms="
                f"{cuda_ms(lambda: cuda_nms.nms_keep(cand1k, top1k, ft.iou), iters=50, warmup=5):.4f} (device, graph: "
                f"{graph_ms(lambda: cuda_nms.nms_keep(cand1k, top1k, ft.iou)):.4f}) plain_ms="
                f"{cuda_ms(lambda: cuda_nms.nms_keep_plain(cand1k, top1k, ft.iou), iters=2, warmup=1):.4f}")
        if dtype == torch.bfloat16:
            records["nms_keep"] = dict(ms=ms, plain_ms=pms, library_ms=None, bound_ms=bound, max_abs_err=0.0,
                                       ops_ms=bound if by == "operations" else 0.0,
                                       bytes_ms=bound if by == "bytes" else 0.0)
    return records


# ---------------------------------------------------------------- phase 3 --


def make_pipeline(model, params, dtype, plain, head_cm=False, channels=1):
    from yolo_tpu_torch import FusedDetectTrack

    return FusedDetectTrack(model, params, frame_hw=HW, channels=channels, chunk=CHUNK, conf=0.15, iou=0.6, n_max=64,
                            d_max=16, dtype=dtype, plain=plain, pallas_head2=head_cm)


def launch_counters() -> dict:
    """name → the wrapper whose `launches` attribute counts that kernel's launches."""
    from yolo_tpu_torch.ops import cuda_c2f, cuda_head, cuda_head_cm, cuda_nms

    return {"c2f": cuda_c2f.fused_c2f, "c2f_upconcat": cuda_c2f.fused_c2f_upconcat, "head_level": cuda_head.fused_head_level,
            "head_level_cm": cuda_head_cm.head_level_cm, "nms_keep": cuda_nms.nms_keep}


def counted(path_kernels, run):
    """Set every launch count to 0, drive one path with `run()`, read the counts
    just after: every kernel of the path must have launched, no other head kernel may have."""
    counters = launch_counters()
    for f in counters.values():
        f.launches = 0
    result = run()
    launches = {k: f.launches for k, f in counters.items()}
    for k, v in launches.items():
        if (v <= 0) if k in path_kernels else (v != 0):
            raise AssertionError(f"kernel {k}: {v} launches on a path of {sorted(path_kernels)}")
    return result, launches


def timed_run(ft, clip):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs, stats = ft.run_clip(clip)  # ends in one device synchronisation
    return outs, stats, time.perf_counter() - t0


def pipeline_phase(tag, model, params, clip, card, head_cm):
    """FusedDetectTrack on the clip: f32 kernels against f32 twins, then the timed bf16 run → its launch counts."""
    import torch

    ok_, sk, wk = timed_run(make_pipeline(model, params, torch.float32, plain=False, head_cm=head_cm), clip)
    op_, sp, wp = timed_run(make_pipeline(model, params, torch.float32, plain=True, head_cm=head_cm), clip)
    worst = compare_runs(ok_, op_, sk, sp)
    log(f"{tag} f32", card, f"kernels {sk} in {wk:.2f} s | plain {sp} in {wp:.2f} s | tracks, ids, statuses, detection "
        f"counts, stats equal; max |box/conf/vel diff| {worst:.3e}")

    ft = make_pipeline(model, params, torch.bfloat16, plain=False, head_cm=head_cm)
    ft.run_clip(clip[:CHUNK])  # warm-up: cuDNN plans, allocator, first launches
    ft.reset()
    ft.timings = []
    path = {"c2f", "c2f_upconcat", "nms_keep", "head_level_cm" if head_cm else "head_level"}
    (ob, sb, wb), launches = counted(path, lambda: timed_run(ft, clip))
    split = {}
    for marks in ft.timings:
        for (_, a), (name, b) in zip(marks, marks[1:]):
            split[name] = split.get(name, 0.0) + a.elapsed_time(b)
    same = sum(int((a["det_count"] == b["det_count"]).sum()) for a, b in zip(ob, ok_))
    log(f"{tag} bf16", card, f"{sb}; {FRAMES} frames in {wb:.3f} s = {FRAMES / wb:.1f} frames/s end to end (host clock, "
        f"upload included); device split per {FRAMES} frames: "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in split.items())
        + f"; tracker {split.get('tracker', 0.0) / FRAMES:.3f} ms/frame; det_count equal to f32 on {same}/{FRAMES} frames")
    log(f"{tag} bf16", card, f"kernel launches in that run: {launches}")
    if not all(len(o["bbox"]) == CHUNK and o["bbox"].shape[1:] == (64, 4) for o in ob):
        raise AssertionError("unexpected packed output shape")
    return ft, launches, (ob, sb), (ok_, sk), FRAMES / wb


def bgr_phase(model, params, clip, card):
    """FusedDetectTrack on 3-channel BGR frames (no gray fold; the flip to RGB
    on the card), one chunk: f32 through the kernels against f32 through the
    twins, then bf16 with the launch counts."""
    import numpy as np
    import torch

    bgr = np.repeat(clip[:CHUNK], 3, -1)
    bgr[..., 0] //= 2  # unequal channels, so the stem's three input planes all matter
    ok_, sk, _ = timed_run(make_pipeline(model, params, torch.float32, plain=False, channels=3), bgr)
    op_, sp, _ = timed_run(make_pipeline(model, params, torch.float32, plain=True, channels=3), bgr)
    worst = compare_runs(ok_, op_, sk, sp)
    path = {"c2f", "c2f_upconcat", "head_level", "nms_keep"}
    (_, sb, wb), launches = counted(path, lambda: timed_run(make_pipeline(model, params, torch.bfloat16, plain=False, channels=3), bgr))
    if sk["detection_frames"] <= 0:
        raise AssertionError(f"the 3-channel pipeline detected nothing: {sk}")
    log("pipeline bgr", card, f"f32 kernels {sk} | plain equal in tracks, ids, statuses, detection counts, stats; max |box/conf/vel "
        f"diff| {worst:.3e}; bf16 {sb} in {wb:.3f} s (cold), launches {launches}")


def batched_tracker_phase(card):
    """BatchedMultiTargetTracker (the host wrapper of the batched Kalman step)
    on the card against the same wrapper on the CPU, on a seeded sequence of
    three moving boxes with dropout gaps: `update` frame by frame over the
    first frames, then `scan_frames` over the rest."""
    import numpy as np

    from yolo_tpu_torch.kalman.batched import STATUS_PREDICTED, BatchedMultiTargetTracker

    rng = np.random.default_rng(0)
    T, T_UPDATE, D = 96, 32, 16
    boxes, mask = np.zeros((T, D, 4), np.float32), np.zeros((T, D), bool)
    targets = [(60.0, 100.0, 2.5, 0.8, range(20, 40)), (560.0, 420.0, -2.0, -1.0, range(50, 70)), (320.0, 60.0, 0.3, 1.5, range(0))]
    for t in range(T):
        seen = [(x0 + vx * t, y0 + vy * t) for x0, y0, vx, vy, hidden in targets if t not in hidden]
        for i, (cx, cy) in enumerate(seen):
            cx, cy = cx + rng.normal(0, 0.3), cy + rng.normal(0, 0.3)
            boxes[t, i], mask[t, i] = (cx - 6, cy - 6, cx + 6, cy + 6), True
    trackers = [BatchedMultiTargetTracker(n_max=64, d_max=D, device=dev) for dev in ("cuda", "cpu")]
    worst, n_tracks = 0.0, 0
    for t in range(T_UPDATE):
        dets = [[*b, 0.9] for b, m in zip(boxes[t], mask[t]) if m]
        got, want = (tr.update(dets) for tr in trackers)
        if [(g["track_id"], g["status"], g["time_since_update"]) for g in got] != [(w["track_id"], w["status"], w["time_since_update"]) for w in want]:
            raise AssertionError(f"batched tracker update, frame {t}: the card's tracks differ from the CPU's")
        for g, w in zip(got, want):
            worst = max(worst, float(np.abs(g["bbox"] - w["bbox"]).max()), float(np.abs(g["velocity"] - w["velocity"]).max()))
        n_tracks += len(got)
    got, want = (tr.scan_frames(boxes[T_UPDATE:], mask[T_UPDATE:]) for tr in trackers)
    for k in ("emit", "status", "track_num", "time_since_update"):
        if not np.array_equal(got[k], want[k]):
            raise AssertionError(f"batched tracker scan_frames: '{k}' on the card differs from the CPU's")
    emit = got["emit"]
    for k in ("bbox", "velocity", "confidence"):
        worst = max(worst, float(np.abs(got[k][emit] - want[k][emit]).max()))
    predicted = int((got["status"][emit] == STATUS_PREDICTED).sum())
    if worst > 1e-2 or n_tracks <= 0 or not emit.any() or predicted <= 0:
        raise AssertionError(f"batched tracker: max diff {worst}, {n_tracks} tracks from update, {int(emit.sum())} emitted, {predicted} coasting")
    log("batched tracker", card, f"update x{T_UPDATE} ({n_tracks} tracks) and scan_frames x{T - T_UPDATE} ({int(emit.sum())} emitted, "
        f"{predicted} coasting) on the card equal the CPU's in ids, statuses and ages; max |box/vel/conf diff| {worst:.3e}")


def predict_phase(clip, card):
    """`YOLO(best.npz).predict`, one 3-channel frame at a time, into the clip loop
    with the per-object Kalman trackers: f32 through the kernels against f32
    through the twins, then bf16, timed (each predict ends in a device wait,
    so the host clock sees all of it)."""
    import contextlib
    import io

    import numpy as np

    from yolo_tpu_torch import YOLO
    from yolo_tpu_torch.kalman.multi_tracker import EnhancedMultiTargetTracker
    from yolo_tpu_torch.kalman.pipeline import track_clip, yolo_detector

    frames = np.repeat(clip[:PREDICT_FRAMES], 3, -1)  # BGR copies of the IR frames

    def run(half, plain):
        detect = yolo_detector(YOLO(str(WEIGHTS)).fuse(), 0.15, imgsz=640, iou=0.6, half=half, plain=plain,
                               compute_dtype=compute_dtype(half))
        detect(frames[0])  # warm-up: cuDNN plans, allocator, first launches
        seen, spent = [], {"detect": 0.0, "track": 0.0}

        def detector(frame):
            t0 = time.perf_counter()
            seen.append(detect(frame))
            spent["detect"] += time.perf_counter() - t0
            return seen[-1]

        class Timed(EnhancedMultiTargetTracker):
            def update(self, detections):
                t0 = time.perf_counter()
                tracks = super().update(detections)
                spent["track"] += time.perf_counter() - t0
                return tracks

        with contextlib.redirect_stdout(io.StringIO()):  # the trackers narrate every track they open and lose
            tracker = Timed(max_lost_frames=150, min_hits=1, iou_threshold=0.1)
            t0 = time.perf_counter()
            stats = track_clip(iter(frames), detector, tracker, total_frames=len(frames))
            wall = time.perf_counter() - t0
        return seen, stats, wall, spent

    path = {"c2f", "c2f_upconcat", "head_level", "nms_keep"}
    (dk, sk, wk, _), _ = counted(path, lambda: run(half=False, plain=False))
    dp, sp, wp, _ = run(half=False, plain=True)
    if [len(d) for d in dk] != [len(d) for d in dp]:
        raise AssertionError(f"detections per frame differ: kernels {[len(d) for d in dk]} vs plain {[len(d) for d in dp]}")
    worst = max([float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max()) for a, b in zip(dk, dp) if a] or [0.0])
    if worst > 1e-2:
        raise AssertionError(f"boxes of the kernel and plain runs differ by {worst} px")
    details = lambda s: [{k: v for k, v in d.items() if k != "confidence"} for d in s["tracker"]["tracker_details"]]  # noqa: E731
    head = lambda s: {**{k: v for k, v in s.items() if k != "tracker"}, **{k: v for k, v in s["tracker"].items() if k != "tracker_details"}}  # noqa: E731
    if head(sk) != head(sp) or details(sk) != details(sp):
        raise AssertionError(f"clip stats differ: kernels {sk} vs plain {sp}")
    if sk["frames"] != PREDICT_FRAMES or sk["detection_frames"] <= 0 or sum(len(d) for d in dk) <= 0:
        raise AssertionError(f"the predict path detected nothing: {head(sk)}")
    log("predict f32", card, f"kernels {head(sk)} in {wk:.2f} s | plain in {wp:.2f} s | detections per frame and stats equal "
        f"({sum(len(d) for d in dk)} detections); max |box/conf diff| {worst:.3e}")
    (db, sb, wb, spent), launches = counted(path, lambda: run(half=True, plain=False))
    same = sum(len(a) == len(b) for a, b in zip(db, dk))
    log("predict bf16", card, f"{head(sb)}; {PREDICT_FRAMES} frames in {wb:.3f} s = {PREDICT_FRAMES / wb:.1f} frames/s (host clock, one "
        f"frame per predict); predict {spent['detect'] / PREDICT_FRAMES * 1e3:.3f} ms/frame, per-object tracker "
        f"{spent['track'] / PREDICT_FRAMES * 1e3:.3f} ms/frame; detections equal to f32 on {same}/{PREDICT_FRAMES} frames")
    log("predict bf16", card, f"kernel launches in that run: {launches}")


@contextlib.contextmanager
def environ(**env):
    """Set environment variables for the block, then restore them."""
    import os

    old = {k: os.environ.get(k) for k in env}
    os.environ.update({k: str(v) for k, v in env.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def track_run(frames, tracker, half, plain, device_tracker=False, d_max=320, n_max=512, encoder_s=None):
    """`YOLO(best.npz).track` one BGR frame per call with persist=True at the track
    defaults (conf 0.1, max_det 300, imgsz 640) → (Results rows per frame, wall s,
    tracker s, tracker class). The tracker is made first, as the first call would
    make it (create_tracker), so that its update can be timed; one predict warms up.
    A BoT-SORT ReID encoder embeds through the C2f kernel's twin too with `plain`, is
    warmed up on one crop, and adds its host seconds to `encoder_s["encoder"]`."""
    import numpy as np
    import torch

    from yolo_tpu_torch import YOLO
    from yolo_tpu_torch.trackers.track import create_tracker

    with environ(YOLO_TPU_DEVICE_TRACKER=int(device_tracker), YOLO_TPU_DEVICE_TRACKER_DMAX=d_max,
                 YOLO_TPU_DEVICE_TRACKER_NMAX=n_max):
        model = YOLO(str(WEIGHTS))
        # cuDNN plans, allocator, first launches
        model.predict(frames[0], conf=0.1, half=half, plain=plain, compute_dtype=compute_dtype(half), verbose=False)
        model._tracker = trk = create_tracker(tracker, device=model.device)
    encoder = getattr(trk, "encoder", None)
    if encoder is not None:
        if plain:
            embed = encoder.model.embed
            encoder.model.embed = lambda *a, **k: embed(*a, plain=True, **k)
        encoder(frames[0], np.array([[64.0, 64.0, 32.0, 32.0]], np.float32))  # plans, cuDNN, allocator
        time_calls(trk, "encoder", encoder_s if encoder_s is not None else {})
    spent, update = [0.0], trk.update

    def timed_update(*args, **kw):
        t0 = time.perf_counter()
        out = update(*args, **kw)
        spent[0] += time.perf_counter() - t0
        return out

    trk.update = timed_update
    rows = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for frame in frames:
        rows.append(model.track(frame, persist=True, tracker=tracker, half=half, plain=plain, compute_dtype=compute_dtype(half),
                                verbose=False)[0].boxes.data)
    return rows, time.perf_counter() - t0, spent[0], type(trk).__name__


def compare_tracks(got, want, box_tol, conf_tol, what):
    """Per frame: equal row counts, equal ids, boxes within box_tol px, conf within
    conf_tol (rows in id order) → (largest box difference, tracked rows, distinct ids)."""
    import numpy as np

    worst, n_rows, ids = 0.0, 0, set()
    for f, (g, w) in enumerate(zip(got, want)):
        if g.shape != w.shape:
            raise AssertionError(f"{what}, frame {f}: rows {g.shape} vs {w.shape}")
        if g.shape[-1] == 7:
            g, w = g[np.argsort(g[:, 4], kind="stable")], w[np.argsort(w[:, 4], kind="stable")]
            if not np.array_equal(g[:, 4], w[:, 4]):
                raise AssertionError(f"{what}, frame {f}: ids {g[:, 4]} vs {w[:, 4]}")
            n_rows += len(g)
            ids |= set(g[:, 4].tolist())
        if len(g):
            worst = max(worst, float(np.abs(g[:, :4] - w[:, :4]).max()))
            if worst > box_tol or float(np.abs(g[:, -2] - w[:, -2]).max()) > conf_tol or not np.array_equal(g[:, -1], w[:, -1]):
                raise AssertionError(f"{what}, frame {f}: boxes / conf / cls beyond {box_tol} px / {conf_tol}:\n{g}\n{w}")
    return worst, n_rows, ids


def track_phase(tag, clip, card, tracker):
    """`[track bytetrack]` / `[track botsort]`: YOLO.track over the clip's first
    TRACK_FRAMES frames as BGR, f32 through the kernels against f32 through the
    twins (rows, ids, boxes 1e-2 px, conf 1e-4), then bf16, timed → the f32 kernel rows."""
    import numpy as np

    frames = np.repeat(clip[:TRACK_FRAMES], 3, -1)
    path = {"c2f", "c2f_upconcat", "head_level", "nms_keep"}
    (rk, wk, _, name), _ = counted(path, lambda: track_run(frames, tracker, half=False, plain=False))
    rp, wp, _, _ = track_run(frames, tracker, half=False, plain=True)
    worst, n_rows, ids = compare_tracks(rk, rp, 1e-2, 1e-4, f"{tag}: kernels against plain")
    if n_rows <= 0:
        raise AssertionError(f"{tag}: no tracked rows in {TRACK_FRAMES} frames")
    log(f"{tag} f32", card, f"{name}: kernels in {wk:.2f} s | plain in {wp:.2f} s | rows and ids equal on every frame "
        f"({n_rows} tracked rows, ids {sorted(int(i) for i in ids)}); max |box diff| {worst:.3e} px")
    (rb, wb, tb, _), launches = counted(path, lambda: track_run(frames, tracker, half=True, plain=False))
    same = sum(len(a) == len(b) for a, b in zip(rb, rk))
    log(f"{tag} bf16", card, f"{TRACK_FRAMES} frames in {wb:.3f} s = {TRACK_FRAMES / wb:.1f} frames/s (host clock, one frame "
        f"per track call); predict {(wb - tb) / TRACK_FRAMES * 1e3:.3f} ms/frame, tracker {tb / TRACK_FRAMES * 1e3:.3f} ms/frame; "
        f"rows per frame equal to f32 on {same}/{TRACK_FRAMES} frames; kernel launches {launches}")
    return rk


def track_device_phase(clip, card, host_rows):
    """`[track device]`: the bytetrack run with YOLO_TPU_DEVICE_TRACKER=1, the batched
    twin on the card: rows match the host tracker's under the JAX package's contract
    (ids exact, 2e-2); then its bf16 ms/frame at the default capacities and at 16 / 64."""
    import numpy as np

    frames = np.repeat(clip[:TRACK_FRAMES], 3, -1)
    path = {"c2f", "c2f_upconcat", "head_level", "nms_keep"}
    (rd, _, _, name), _ = counted(path, lambda: track_run(frames, "bytetrack.yaml", half=False, plain=False, device_tracker=True))
    if name != "BatchedBYTETracker":
        raise AssertionError(f"track device: YOLO_TPU_DEVICE_TRACKER=1 made a {name}")
    worst, n_rows, _ = compare_tracks(rd, host_rows, 2e-2, 2e-2, "track device: the batched twin against the host tracker")
    log("track device f32", card, f"BatchedBYTETracker on the card (d_max 320, n_max 512): {n_rows} tracked rows, rows and ids "
        f"equal to [track bytetrack]'s host tracker on every frame; max |box diff| {worst:.3e} px")
    for d_max, n_max in ((320, 512), (16, 64)):
        (rb, wb, tb, _), launches = counted(
            path, lambda: track_run(frames, "bytetrack.yaml", half=True, plain=False, device_tracker=True, d_max=d_max, n_max=n_max))
        log("track device bf16", card, f"d_max {d_max} n_max {n_max}: {TRACK_FRAMES} frames in {wb:.3f} s = {TRACK_FRAMES / wb:.1f} "
            f"frames/s; predict {(wb - tb) / TRACK_FRAMES * 1e3:.3f} ms/frame, batched tracker update {tb / TRACK_FRAMES * 1e3:.3f} "
            f"ms/frame (host clock, ends in its copy to the host); tracked rows {sum(len(r) for r in rb if r.shape[-1] == 7)}; "
            f"kernel launches {launches}")


def reid_tracker_yaml(path: Path) -> Path:
    """The shipped botsort.yaml with the GMC off and the ReID encoder on (`model: yolov8n.yaml`), at `path`."""
    text = (ROOT / "yolo_tpu_torch" / "cfg" / "trackers" / "botsort.yaml").read_text()
    text = text.replace("gmc_method: sparseOptFlow", "gmc_method: none").replace("with_reid: False", "with_reid: True")
    text = "\n".join("model: yolov8n.yaml" if line.startswith("model:") else line for line in text.splitlines()) + "\n"
    if "with_reid: True" not in text or "model: yolov8n.yaml" not in text:
        raise AssertionError(f"botsort.yaml no longer has the with_reid / model keys this phase sets:\n{text}")
    path.write_text(text)
    return path


def track_reid_phase(clip, card):
    """`[track botsort reid]`: YOLO(best.npz).track over the first TRACK_FRAMES BGR frames with BoT-SORT's
    crop-and-embed ReID encoder (`YOLO("yolov8n.yaml").embed` of each detection's crop at imgsz 128, on the
    card, f32, through the C2f kernel; the JAX package's initial tree) and the GMC off: f32 kernels (the
    detector's and the encoder's) against the twins (rows and ids equal, boxes 1e-2 px, conf 1e-4), then the
    bf16 detector, timed: frames/s, predict, tracker and the encoder's host ms/frame, launches."""
    import numpy as np

    frames = np.repeat(clip[:TRACK_FRAMES], 3, -1)
    path = {"c2f", "c2f_upconcat", "head_level", "nms_keep"}
    with tempfile.TemporaryDirectory() as tmp:
        cfg = str(reid_tracker_yaml(Path(tmp) / "botsort_reid.yaml"))
        enc_k, enc_p, enc_b = {}, {}, {}
        (rk, wk, _, name), launches_f32 = counted(path, lambda: track_run(frames, cfg, half=False, plain=False, encoder_s=enc_k))
        rp, wp, _, _ = track_run(frames, cfg, half=False, plain=True, encoder_s=enc_p)
        worst, n_rows, ids = compare_tracks(rk, rp, 1e-2, 1e-4, "track botsort reid: kernels against plain")
        if n_rows <= 0 or not enc_k.get("encoder") or not enc_p.get("encoder"):
            raise AssertionError(f"track botsort reid: {n_rows} tracked rows, encoder seconds {enc_k} / {enc_p}")
        log("track botsort reid f32", card, f"{name} + ReID(yolov8n.yaml, imgsz 128): kernels in {wk:.2f} s | plain in {wp:.2f} s | "
            f"rows and ids equal on every frame ({n_rows} tracked rows, ids {sorted(int(i) for i in ids)}); max |box diff| "
            f"{worst:.3e} px; encoder {enc_k['encoder'] * 1e3 / TRACK_FRAMES:.3f} ms/frame (twins "
            f"{enc_p['encoder'] * 1e3 / TRACK_FRAMES:.3f}); launches {launches_f32}")
        (rb, wb, tb, _), launches = counted(path, lambda: track_run(frames, cfg, half=True, plain=False, encoder_s=enc_b))
    same = sum(len(a) == len(b) for a, b in zip(rb, rk))
    enc = enc_b["encoder"]
    log("track botsort reid bf16", card, f"{TRACK_FRAMES} frames in {wb:.3f} s = {TRACK_FRAMES / wb:.1f} frames/s (host clock, one "
        f"frame per track call); predict {(wb - tb) / TRACK_FRAMES * 1e3:.3f} ms/frame, tracker {(tb - enc) / TRACK_FRAMES * 1e3:.3f} "
        f"ms/frame and its ReID encoder {enc / TRACK_FRAMES * 1e3:.3f} ms/frame (f32); rows per frame equal "
        f"to f32 on {same}/{TRACK_FRAMES} frames; kernel launches {launches}")


def byte_scan_phase(model, params, clip, card):
    """`[byte scan]`: the JAX package's device_fps_byte_track shape. Per 128-frame
    chunk, frames already on the card: the bf16 forward (predict_parts, the default
    head kernel), NMS with d_max 16, xyxy → xywh with cls 0, then
    BatchedBYTETracker(n_max 64, d_max 16, max_time_lost 30).scan_frames. The
    outputs must equal `update` frame by frame on the same detections, and the
    same scan on the CPU (ids exact, 1e-4)."""
    import numpy as np
    import torch

    from yolo_tpu_torch.ops.nms import non_max_suppression_parts
    from yolo_tpu_torch.trackers.batched import BatchedBYTETracker

    ft = make_pipeline(model, params, torch.bfloat16, plain=False)
    chunks = [torch.from_numpy(clip[i : i + CHUNK]).cuda() for i in range(0, FRAMES, CHUNK)]

    def run(trk, marks=None):
        dets, outs = [], []
        with torch.no_grad():
            for frames in chunks:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
                ev[0].record()
                boxes, scores = ft.model.predict_parts(frames.to(ft.dtype), plain=False)
                ev[1].record()
                det = non_max_suppression_parts(boxes, scores, conf_thres=ft.conf, iou_thres=ft.iou, max_det=ft.d_max,
                                                max_nms=ft.max_nms)
                ev[2].record()
                xyxy = det["boxes"].float()
                xywh = torch.cat([(xyxy[..., :2] + xyxy[..., 2:]) / 2, xyxy[..., 2:] - xyxy[..., :2]], -1)
                seq = (xywh, det["scores"].float(), torch.zeros_like(det["scores"], dtype=torch.float32), det["valid"])
                outs.append(trk.scan_frames(*seq))  # ends in the chunk's one wait for the device
                ev[3].record()
                dets.append(seq)
                if marks is not None:
                    marks.append(ev)
        return dets, {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}

    def make(device):  # the ByteTrack defaults: track_buffer 30 at 30 frames/s, so max_time_lost 30
        return BatchedBYTETracker(n_max=64, d_max=ft.d_max, device=device)

    run(make("cuda"))  # warm-up
    marks = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (dets, outs), launches = counted({"c2f", "c2f_upconcat", "head_level", "nms_keep"}, lambda: run(make("cuda"), marks))
    wall = time.perf_counter() - t0
    split = np.array([[a.elapsed_time(b) for a, b in zip(ev, ev[1:])] for ev in marks])
    xywh, sc, cl, valid = (torch.cat([d[i] for d in dets]).cpu().numpy() for i in range(4))
    cpu = make("cpu").scan_frames(xywh, sc, cl, valid)
    step = make("cuda")
    worst = 0.0
    for f in range(FRAMES):
        m = valid[f]
        rows = step.update(xywh[f][m], sc[f][m], cl[f][m])
        for o, what in ((outs, "the scan"), (cpu, "the CPU scan")):
            keep = np.flatnonzero(o["emit"][f])
            keep = keep[np.argsort(o["track_id"][f][keep])]
            scan_rows = np.concatenate([o["xyxy"][f][keep]] + [o[k][f][keep, None] for k in ("track_id", "score", "cls", "det_idx")], 1)
            if scan_rows.shape != rows.shape or not np.array_equal(scan_rows[:, 4], rows[:, 4]):
                raise AssertionError(f"byte scan, frame {f}: stepwise update gives ids {rows[:, 4]}, {what} {scan_rows[:, 4]}")
            if len(rows):
                worst = max(worst, float(np.abs(scan_rows - rows).max()))
    if worst > 1e-4 or not outs["emit"].any():
        raise AssertionError(f"byte scan: max |row diff| {worst} against stepwise update, {int(outs['emit'].sum())} emitted")
    log("byte scan", card, f"{FRAMES} frames (on the card) in {wall:.3f} s = {FRAMES / wall:.1f} frames/s (host clock); "
        f"{int(valid.sum())} detections, {int(outs['emit'].sum())} emitted rows, {len(set(outs['track_id'][outs['emit']].tolist()))} "
        f"ids; the scan equals update frame by frame and the CPU scan (ids exact, max |row diff| {worst:.3e}); kernel launches "
        f"{launches}")
    for i, (fwd, nms, byte) in enumerate(split):
        log("byte scan", card, f"chunk {i}: forward {fwd:.2f} ms, NMS {nms:.2f} ms, byte step {byte:.2f} ms "
            f"({byte / CHUNK:.3f} ms/frame, its copy to the host included)")


# ------------------------------------------------------------ config 5 --


def make_panning_clip(n_frames: int, w: int = 640, h: int = 512, seed: int = 7, visible: int = 10, occluded: int = 50):
    """The config-5 clip (a copy of demos/motion_comp_bench.py::make_panning_clip): the frame is
    a crop window drifting over a 2x textured background, with a smooth pan and two abrupt
    jumps at 1/3 and 2/3 of the clip (camera bumps that should fire global resets), and one
    target that moves in world coordinates, visible 10 frames of every 60. → (n, h, w) uint8."""
    import cv2
    import numpy as np

    rng = np.random.default_rng(seed)
    H2, W2 = h * 2, w * 2
    bg = cv2.resize(rng.normal(30, 10, (H2 // 16, W2 // 16)).astype(np.float32), (W2, H2), interpolation=cv2.INTER_CUBIC)
    # mid-frequency texture: the LK and ORB motion detectors need trackable features
    bg += cv2.resize(rng.normal(0, 12, (H2 // 4, W2 // 4)).astype(np.float32), (W2, H2), interpolation=cv2.INTER_CUBIC)
    gy, gx = np.mgrid[0:H2, 0:W2]
    bg += 25 * np.cos(gy / 37.0) * np.sin(gx / 53.0)
    frames = np.empty((n_frames, h, w), np.uint8)
    cycle = visible + occluded
    yy, xx = np.mgrid[0:h, 0:w]
    for f in range(n_frames):
        ox = int(w / 2 + (w / 3) * np.sin(f / 90)) + (80 if f >= n_frames // 3 else 0)
        oy = int(h / 2 + (h / 4) * np.cos(f / 130)) + (60 if f >= 2 * n_frames // 3 else 0)
        ox = int(np.clip(ox, 0, W2 - w))
        oy = int(np.clip(oy, 0, H2 - h))
        img = bg[oy : oy + h, ox : ox + w] + rng.normal(0, 2, (h, w))
        tx = W2 / 2 + 300 * np.sin(f / 200)
        ty = H2 / 2 + 150 * np.cos(f / 260)
        cx, cy = tx - ox, ty - oy
        if (f % cycle) < visible and 10 < cx < w - 10 and 10 < cy < h - 10:
            img = img + 170 * np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * 4.0**2)))
        frames[f] = np.clip(img, 0, 255).astype(np.uint8)
    return frames


def motion_detector(model, params, dtype, plain):
    """The counterpart of demos/motion_comp_bench.py::build_batch_detector / build_detector:
    (T, H, W) uint8 gray frames on the card, /255 in the compute dtype, broadcast to the
    stem's channels, `DetectionModel.predict_parts`, `non_max_suppression_parts` at conf
    0.15, iou 0.6, max_det 16 (max_nms 1024, its default, as there) → the NMS dict."""
    import copy

    import torch

    from yolo_tpu_torch import params_from_jax
    from yolo_tpu_torch.ops.nms import non_max_suppression_parts

    m = copy.deepcopy(model)
    params_from_jax(m, params, dtype)
    ch = int(params["model"]["0"]["conv"]["weight"].shape[2])  # stem input channels

    @torch.no_grad()
    def detect(frames):
        x = frames[..., None].to(dtype) / 255.0
        boxes, scores = m.predict_parts(x.expand(*x.shape[:3], ch), plain=plain)
        return non_max_suppression_parts(boxes, scores, conf_thres=0.15, iou_thres=0.6, max_det=16, plain=plain)

    return detect


def time_calls(obj, name: str, spent: dict) -> None:
    """Replace `obj.<name>` by a wrapper that adds each call's host seconds to `spent[name]`."""
    call = getattr(obj, name)
    spent[name] = 0.0

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return call(*args, **kwargs)
        finally:
            spent[name] += time.perf_counter() - t0

    setattr(obj, name, timed)


def det_lists(out) -> list:
    """NMS dict (host numpy) → per frame [[x1, y1, x2, y2, conf], ...], the tracker's input."""
    return [[[*b.tolist(), float(s)] for b, s, v in zip(bb, ss, vv) if v] for bb, ss, vv in zip(out["boxes"], out["scores"], out["valid"])]


def detect_chunked(detect, clip_gray):
    """The whole clip through `detect` in CHUNK-frame chunks (the last one padded with black
    frames) → (per-frame detections, host-clock s of the leg: uploads, forward, NMS and the
    copies back, one device wait per chunk; CUDA-event ms of each chunk's forward + NMS)."""
    import numpy as np
    import torch

    n = len(clip_gray)
    pad = (-n) % CHUNK
    clip = np.concatenate([clip_gray, np.zeros((pad, *clip_gray.shape[1:]), np.uint8)]) if pad else clip_gray
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs, marks = [], []
    for i in range(0, len(clip), CHUNK):
        frames = torch.from_numpy(clip[i : i + CHUNK]).cuda()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = detect(frames)
        ev[1].record()
        outs.append({k: out[k].cpu().numpy() for k in ("boxes", "scores", "valid")})
        marks.append(ev)
    wall = time.perf_counter() - t0
    out = {k: np.concatenate([o[k] for o in outs])[:n] for k in outs[0]}
    return det_lists(out), wall, [a.elapsed_time(b) for a, b in marks]


def motion_loop(method, clip_bgr, dets):
    """MotionCompensatedMultiTracker over the clip with precomputed detections (the demo's
    batched-detect leg) → (per-frame track lists, comprehensive stats, host s, of which s in
    the global motion detector). The trackers' per-reset prints go to a buffer, as in
    motion/compare.py."""
    import contextlib
    import io

    from yolo_tpu_torch.motion import MotionCompensatedMultiTracker

    spent = {}
    with contextlib.redirect_stdout(io.StringIO()):
        tracker = MotionCompensatedMultiTracker(max_lost_frames=150, min_hits=1, iou_threshold=0.1,
                                                motion_detection_method=method)
        time_calls(tracker.motion_detector, "detect_motion", spent)
        tracks = []
        t0 = time.perf_counter()
        for frame, d in zip(clip_bgr, dets):
            tracks.append(tracker.update([list(x) for x in d], frame))
        wall = time.perf_counter() - t0
    return tracks, tracker.get_comprehensive_stats(), wall, spent["detect_motion"]


def same_tracks(got, want, what) -> float:
    """Per frame, track lists compared by position (ids are random uuids): equal statuses,
    ages, hits, resets; boxes within 1e-2 px → the largest box difference."""
    import numpy as np

    worst = 0.0
    for f, (g, w) in enumerate(zip(got, want)):
        if len(g) != len(w):
            raise AssertionError(f"{what}, frame {f}: {len(g)} tracks vs {len(w)}")
        for a, b in zip(g, w):
            keys = ("status", "age", "hits", "hit_streak", "time_since_update", "reset_count")
            if [a[k] for k in keys] != [b[k] for k in keys]:
                raise AssertionError(f"{what}, frame {f}: {[a[k] for k in keys]} vs {[b[k] for k in keys]}")
            worst = max(worst, float(np.abs(np.asarray(a["bbox"]) - np.asarray(b["bbox"])).max()))
    if worst > 1e-2:
        raise AssertionError(f"{what}: boxes differ by {worst} px")
    return worst


def motion_kernels_phase(model, params, pan, card):
    """`[motion kernels]`: the chunked config-5 detector over the panning clip in f32 through
    the kernels and through the twins (equal detection counts per frame, boxes 1e-2 px, conf
    1e-4), then the optical-flow motion-compensated tracker on both detection sequences
    (equal events, resets and per-frame track lists)."""
    import numpy as np
    import torch

    path = {"c2f", "c2f_upconcat", "head_level", "nms_keep"}
    (dk, wk, _), launches = counted(path, lambda: detect_chunked(motion_detector(model, params, torch.float32, False), pan))
    dp, wp, _ = detect_chunked(motion_detector(model, params, torch.float32, True), pan)
    if [len(d) for d in dk] != [len(d) for d in dp]:
        bad = [f for f, (a, b) in enumerate(zip(dk, dp)) if len(a) != len(b)]
        raise AssertionError(f"motion kernels: detection counts differ on frames {bad[:20]}")
    rows = [(np.asarray(a), np.asarray(b)) for a, b in zip(dk, dp) if a]
    box = max([float(np.abs(a[:, :4] - b[:, :4]).max()) for a, b in rows] or [0.0])
    conf = max([float(np.abs(a[:, 4] - b[:, 4]).max()) for a, b in rows] or [0.0])
    n_det = sum(len(d) for d in dk)
    if box > 1e-2 or conf > 1e-4 or n_det <= 0:
        raise AssertionError(f"motion kernels: {n_det} detections, boxes differ by {box} px, conf by {conf}")
    log("motion kernels f32", card, f"{len(pan)} frames in {-(-len(pan) // CHUNK)} chunks: kernels {wk:.2f} s (first, cold), "
        f"plain {wp:.2f} s; detection counts equal on every frame ({n_det} detections on "
        f"{sum(1 for d in dk if d)} frames); max |box diff| {box:.3e} px, |conf diff| {conf:.3e}; launches {launches}")
    bgr = np.repeat(pan[..., None], 3, -1)
    tk, sk, _, _ = motion_loop("optical_flow", bgr, dk)
    tp, sp, _, _ = motion_loop("optical_flow", bgr, dp)
    if sk["basic"] != sp["basic"] or sk["motion_detection"] != sp["motion_detection"]:
        raise AssertionError(f"motion kernels: tracker stats differ: {sk['basic']} vs {sp['basic']}")
    worst = same_tracks(tk, tp, "motion kernels: optical_flow tracks, kernels against plain")
    if sk["basic"]["global_resets"] <= 0:
        raise AssertionError(f"motion kernels: no global reset on the panning clip: {sk['basic']}")
    log("motion kernels f32", card, f"optical_flow tracker on both: stats equal {sk['basic']}; "
        f"{sum(len(t) for t in tk)} track rows equal frame by frame (by position), max |box diff| {worst:.3e} px")


def motion_method_phase(method, model, params, pan, card):
    """`[motion <method>]`: the bf16 chunked detector, then the host loop (demos/motion_comp_bench.py's
    batched-detect leg, its deployment shape)."""
    import numpy as np
    import torch

    path = {"c2f", "c2f_upconcat", "head_level", "nms_keep"}
    detect = motion_detector(model, params, torch.bfloat16, False)
    detect_chunked(detect, pan[:CHUNK])  # warm-up: cuDNN plans, allocator, first launches
    (dets, dev_s, chunk_ms), launches = counted(path, lambda: detect_chunked(detect, pan))
    _, stats, host_s, motion_s = motion_loop(method, np.repeat(pan[..., None], 3, -1), dets)
    n = len(pan)
    b = stats["basic"]
    log(f"motion {method}", card, f"{n} frames: fps_batched {n / (dev_s + host_s):.1f} frames/s = {n} / (detect {dev_s:.3f} s "
        f"+ host {host_s:.3f} s); detect {dev_s / n * 1e3:.3f} ms/frame (host clock, uploads and copies back included), "
        f"device {sum(chunk_ms) / n:.3f} ms/frame (CUDA events; per chunk " + ", ".join(f"{v:.2f}" for v in chunk_ms)
        + f" ms); host {host_s / n * 1e3:.3f} ms/frame = motion detection {motion_s / n * 1e3:.3f} + tracker "
        f"{(host_s - motion_s) / n * 1e3:.3f}; {sum(len(d) for d in dets)} detections; events {b['global_motion_events']}, "
        f"global resets {b['global_resets']}, individual resets {b['individual_resets']}; launches {launches}")


def motion_per_frame_phase(method, model, params, pan, card):
    """`[motion <method> per-frame]`: the demo's per-frame-dispatch control: the bf16 detector
    called once a frame (B = 1), its detections straight into the host loop."""
    import contextlib
    import io

    import numpy as np
    import torch

    from yolo_tpu_torch.motion import MotionCompensatedMultiTracker

    detect = motion_detector(model, params, torch.bfloat16, False)
    bgr = np.repeat(pan[..., None], 3, -1)
    n = len(pan)
    spent = {"detect": 0.0, "track": 0.0}

    def run():
        t0 = time.perf_counter()
        for f in range(n):
            t1 = time.perf_counter()
            d = det_lists({k: v.cpu().numpy() for k, v in detect(torch.from_numpy(pan[f : f + 1]).cuda()).items()})[0]
            t2 = time.perf_counter()
            tracker.update(d, bgr[f])
            spent["detect"] += t2 - t1
            spent["track"] += time.perf_counter() - t2
        return time.perf_counter() - t0

    detect(torch.from_numpy(pan[:1]).cuda())  # warm-up at B = 1
    with contextlib.redirect_stdout(io.StringIO()):
        tracker = MotionCompensatedMultiTracker(max_lost_frames=150, min_hits=1, iou_threshold=0.1, motion_detection_method=method)
        wall, launches = counted({"c2f", "c2f_upconcat", "head_level", "nms_keep"}, run)
    b = tracker.get_comprehensive_stats()["basic"]
    log(f"motion {method} per-frame", card, f"{n} frames in {wall:.3f} s = {n / wall:.1f} frames/s (host clock, one detect "
        f"call a frame, B = 1): detect {spent['detect'] / n * 1e3:.3f} ms/frame, host motion + tracker "
        f"{spent['track'] / n * 1e3:.3f} ms/frame; events {b['global_motion_events']}, global resets {b['global_resets']}, "
        f"individual resets {b['individual_resets']}; launches {launches}")


def motion_compare_phase(model, params, pan, card):
    """`[motion compare]`: the first MOTION_COMPARE_FRAMES frames of the panning clip as an mp4v
    file; the package's entry point `motion.compare_motion_methods` over it with the bf16
    detector called once a frame."""
    import contextlib
    import io

    import cv2
    import numpy as np
    import torch

    from yolo_tpu_torch.motion import compare_motion_methods

    detect = motion_detector(model, params, torch.bfloat16, False)

    def detector(frame):  # a decoded BGR frame → its gray plane, as the demo's per-frame detector
        return det_lists({k: v.cpu().numpy() for k, v in detect(torch.from_numpy(frame[None, ..., 0].copy()).cuda()).items()})[0]

    detector(np.repeat(pan[0][..., None], 3, -1))  # warm-up
    with tempfile.TemporaryDirectory() as tmp:
        vid = Path(tmp) / "pan.mp4"
        vw = cv2.VideoWriter(str(vid), cv2.VideoWriter_fourcc(*"mp4v"), 30, (pan.shape[2], pan.shape[1]))
        for frame in pan[:MOTION_COMPARE_FRAMES]:
            vw.write(np.repeat(frame[..., None], 3, -1))
        vw.release()
        path = {"c2f", "c2f_upconcat", "head_level", "nms_keep"}
        with contextlib.redirect_stdout(io.StringIO()):  # the trackers' own prints; the method lines go to the log
            out, launches = counted(path, lambda: compare_motion_methods(vid, detector, report_path=Path(tmp) / "report.txt"))
    for method, r in out["results"].items():
        log("motion compare", card, f"{method}: {r['frames']} frames, {r['fps']:.1f} frames/s ({r['ms_per_frame']:.3f} ms/frame, "
            f"detect, decode and host legs together); events {r['global_motion_events']}, global resets "
            f"{r['global_resets']}, individual resets {r['individual_resets']}")
    if any(r["frames"] != MOTION_COMPARE_FRAMES for r in out["results"].values()):
        raise AssertionError(f"motion compare: frames read {[r['frames'] for r in out['results'].values()]}")
    log("motion compare", card, f"recommended {out['recommended']}; launches over the three methods {launches}")


def grayscale_phase(clip, card):
    """`[grayscale]`: GRAY_FRAMES frames of the IR clip as a BGR mp4v file through
    `GrayscaleTracker.process_video(test_range=(32, 80))`: the tracker's own `yolo_detect`
    (the port's YOLO on the card, set to f32 through its overrides) against a detector that
    calls `YOLO.predict(plain=True, compute_dtype="float32")`: equal stats and tracks; then
    the default tracker (bf16), timed."""
    import contextlib
    import io

    import cv2
    import numpy as np
    import torch

    from yolo_tpu_torch import YOLO
    from yolo_tpu_torch.grayscale import GrayscaleTracker

    path = {"c2f", "c2f_upconcat", "head_level", "nms_keep"}
    with tempfile.TemporaryDirectory() as tmp:
        vid = Path(tmp) / "ir.mp4"
        vw = cv2.VideoWriter(str(vid), cv2.VideoWriter_fourcc(*"mp4v"), 30, (clip.shape[2], clip.shape[1]))
        for frame in clip[:GRAY_FRAMES]:
            vw.write(np.repeat(frame, 3, -1))
        vw.release()
        run = lambda t: t.process_video(vid, test_range=GRAY_TEST_RANGE, write_video=False)  # noqa: E731

        with contextlib.redirect_stdout(io.StringIO()):
            own = GrayscaleTracker(str(WEIGHTS), conf=0.25)
            own._yolo = YOLO(str(WEIGHTS)).fuse()
            own._yolo.overrides["compute_dtype"] = "float32"
            sk, launches32 = counted(path, lambda: run(own))
            twin = YOLO(str(WEIGHTS)).fuse()
            plain = GrayscaleTracker(conf=0.25, detector=lambda frame: [list(r) for r in twin.predict(
                frame, conf=0.25, plain=True, compute_dtype="float32", verbose=False)[0].boxes.data])
            sp = run(plain)
        if own._yolo.predictor.dtype != torch.float32 or sk != sp:
            raise AssertionError(f"grayscale: f32 kernels {sk} vs plain {sp}")
        if sk["detected_frames"] <= 0 or sk["predicted_frames"] <= 0:
            raise AssertionError(f"grayscale: nothing detected or coasted: {sk}")
        log("grayscale f32", card, f"own yolo_detect (kernels) and the plain detector: stats and tracks equal "
            f"{ {k: v for k, v in sk.items() if k != 'tracks'} }, tracks {sk['tracks']}; launches {launches32}")

        with contextlib.redirect_stdout(io.StringIO()):
            t = GrayscaleTracker(str(WEIGHTS), conf=0.25)
            t.yolo_detect(np.repeat(clip[0], 3, -1), -1)  # builds the YOLO on the card; warm-up
            spent = {}
            for name in ("yolo_detect", "predict_lost_targets"):
                time_calls(t, name, spent)
            t0 = time.perf_counter()
            sb, launches16 = counted(path, lambda: run(t))
            wall = time.perf_counter() - t0
    n = sb["frames"]
    if t._yolo.predictor.dtype != torch.bfloat16 or n != GRAY_FRAMES:
        raise AssertionError(f"grayscale: the default run computed in {t._yolo.predictor.dtype} over {n} frames")
    counts = {k: v for k, v in sb.items() if k != "tracks"}
    moved = max(max(abs(a - b) for a, b in zip(sb["tracks"][i]["last_center"], sk["tracks"][i]["last_center"]))
                for i in sb["tracks"] if i in sk["tracks"])
    log("grayscale bf16", card, f"{n} frames in {wall:.3f} s = {n / wall:.1f} frames/s (host clock, video decode included); "
        f"yolo_detect {spent['yolo_detect'] / n * 1e3:.3f} ms/frame, predict_lost_targets "
        f"{spent['predict_lost_targets'] / n * 1e3:.3f} ms/frame; stats {counts}, equal to f32: "
        f"{counts == {k: v for k, v in sk.items() if k != 'tracks'}}, track ids {sorted(sb['tracks'])} (f32 "
        f"{sorted(sk['tracks'])}), last centers within {moved} px of f32's; launches {launches16}")


def grayscale_scorer_phase(card):
    """`[grayscale scorer]`: `predict_center_torch` on the card over 256 seeded 40x40 ROIs at
    once against the numpy scorer's argmax on each (same index, score rel 1e-5); its time per
    256 ROIs and per single ROI (CUDA events). Plain PyTorch: no kernel, no bound row."""
    import numpy as np
    import torch

    from yolo_tpu_torch.grayscale.scoring import gradient_window_scores, predict_center_torch

    rng = np.random.default_rng(0)
    rois = rng.integers(0, 256, (256, 40, 40)).astype(np.uint8)
    yy, xx = np.mgrid[0:40, 0:40]
    for i in range(0, 256, 4):  # a bright target in every fourth ROI
        cx, cy = rng.uniform(3, 37, 2)
        rois[i] = np.clip(rois[i] // 4 + 170 * np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / 18.0), 0, 255).astype(np.uint8)
    dev = torch.from_numpy(rois).cuda()
    best, score = (t.cpu().numpy() for t in predict_center_torch(dev))
    worst = 0.0
    for i, roi in enumerate(rois):
        s = gradient_window_scores(roi)
        iy, ix = np.unravel_index(int(np.argmax(s)), s.shape)
        worst = max(worst, abs(float(score[i]) - float(s[iy, ix])) / abs(float(s[iy, ix])))
        if (iy, ix) != tuple(best[i]) or worst > 1e-5:
            raise AssertionError(f"grayscale scorer, ROI {i}: card {tuple(best[i])} {score[i]} vs numpy {(iy, ix)} {s[iy, ix]}")
    ms256 = cuda_ms(lambda: predict_center_torch(dev), iters=20, warmup=3)
    ms1 = cuda_ms(lambda: predict_center_torch(dev[0]), iters=50, warmup=5)
    log("grayscale scorer", card, f"256 ROIs 40x40 on the card: every index equal to the numpy scorer's, score rel err "
        f"{worst:.2e}; {ms256:.4f} ms per 256 ROIs ({ms256 / 256 * 1e3:.2f} us/ROI), {ms1:.4f} ms for one ROI (CUDA events)")


# ------------------------------------------------------------- validation --


# --------------------------------------------------------------- serving --

SERVE_CLIENTS, SERVE_FRAMES = 8, 64  # `[serve]`: v2 client threads x frames each, plus one v1 client
SERVE_KERNEL_CLIENTS, SERVE_KERNEL_FRAMES = 4, 16  # `[serve kernels]`
SERVE_PATH = {"c2f", "c2f_upconcat", "head_level", "nms_keep"}


@contextlib.contextmanager
def serving(models, **kw):
    """A DetectionServer on 127.0.0.1 (any free port) in a thread, its lanes built, or failing;
    shut down and joined on exit."""
    import threading

    from yolo_tpu_torch.serve import DetectionServer

    srv = DetectionServer(models, host="127.0.0.1", port=0, batch_window_ms=4.0, **kw)
    ready = threading.Event()
    t = threading.Thread(target=srv.serve_forever, args=(ready,), daemon=True)
    t.start()
    try:
        if not ready.wait(60):
            raise RuntimeError("the server did not start listening")
        t0 = time.perf_counter()
        while not all(lane.error or (lane.predictor is not None and lane.predictor.done_warmup) for lane in srv.lanes.values()):
            if time.perf_counter() - t0 > 600:
                raise RuntimeError("the server's lanes did not build in 600 s")
            time.sleep(0.05)
        errors = {mid: lane.error for mid, lane in srv.lanes.items() if lane.error}
        if errors:
            raise AssertionError(f"server lanes out of service: {errors}")
        yield srv
    finally:
        srv.shutdown()
        t.join(30)
        if t.is_alive():
            raise RuntimeError("the server did not stop")


def v1_request(conn, frame):
    """One protocol-v1 round trip → (n, 6) detections (v1 has no status field)."""
    import struct

    import numpy as np

    def recv(n):
        buf = b""
        while len(buf) < n:
            chunk = conn.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("server closed")
            buf += chunk
        return buf

    conn.sendall(b"YTPU" + struct.pack("<III", *frame.shape) + frame.tobytes())
    if recv(4) != b"YTPR":
        raise AssertionError("bad v1 response magic")
    (n,) = struct.unpack("<I", recv(4))
    return np.frombuffer(recv(n * 24), np.float32).reshape(n, 6)


def run_clients(port, jobs):
    """`jobs`: one list a client thread of (lane or "v1", frame). Each thread sends its frames one
    request at a time (v2 through utils/remote.RemoteModel, which raises on a reply with a status
    other than 0) → (per thread the replies and each request's seconds, wall s of the whole run)."""
    import socket
    import threading

    from yolo_tpu_torch.utils.remote import RemoteModel

    out, failures = [None] * len(jobs), []

    def client(i):
        replies, lat = [], []
        models = {}
        conn = None
        try:
            for lane, frame in jobs[i]:
                t0 = time.perf_counter()
                if lane == "v1":
                    conn = conn or socket.create_connection(("127.0.0.1", port), timeout=300)
                    replies.append(v1_request(conn, frame))
                else:
                    rm = models.setdefault(lane, RemoteModel(f"tcp://127.0.0.1:{port}/{lane}"))
                    replies.append(rm(frame))
                lat.append(time.perf_counter() - t0)
            out[i] = (replies, lat)
        except Exception as e:  # reported below: a client that fails fails the phase
            failures.append(f"client {i}: {type(e).__name__}: {e}")
        finally:
            for rm in models.values():
                rm.close()
            if conn is not None:
                conn.close()

    threads = [threading.Thread(target=client, args=(i,), daemon=True) for i in range(len(jobs))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t0
    if failures or any(t.is_alive() for t in threads):
        raise AssertionError(f"serving clients failed: {failures or 'a client did not finish in 600 s'}")
    return out, wall


def same_dets(got, want, what) -> float:
    """Equal row counts and classes, boxes within 1e-2 px, conf 1e-4 (the f32 gates) → the largest difference."""
    import numpy as np

    worst = 0.0
    for k, (g, w) in enumerate(zip(got, want)):
        if g.shape != w.shape or not np.array_equal(g[:, 5], w[:, 5]):
            raise AssertionError(f"{what}, reply {k}: {len(g)} vs {len(w)} detections or other classes")
        if len(g):
            d = np.abs(g - w)
            if d[:, :4].max() > 1e-2 or d[:, 4].max() > 1e-4:
                raise AssertionError(f"{what}, reply {k}: boxes differ by {d[:, :4].max()} px, conf by {d[:, 4].max()}")
            worst = max(worst, float(d[:, :5].max()))
    return worst


def batch_stats(timings) -> dict:
    """The worker's batches: histogram of padded sizes B (and of frames n), and per batch the host's
    letterbox + assembly, enqueue, wait and Results ms and, in CUDA events, upload and device ms."""
    import numpy as np

    hist, frames = {}, {}
    for t in timings:
        hist[t["B"]] = hist.get(t["B"], 0) + 1
        frames[t["n"]] = frames.get(t["n"], 0) + 1
    ms = lambda key: np.array([t[key] for t in timings]) * 1e3  # noqa: E731
    up = np.array([t["events"][0].elapsed_time(t["events"][1]) for t in timings])
    dev = np.array([t["events"][1].elapsed_time(t["events"][2]) for t in timings])
    return {"batches": len(timings), "B": dict(sorted(hist.items())), "n": dict(sorted(frames.items())),
            "pre": ms("pre_s"), "enqueue": ms("enqueue_s"), "wait": ms("wait_s"), "post": ms("post_s"), "upload": up, "device": dev}


def serve_kernels_phase(clip, card):
    """`[serve kernels]`: lane 0 from best.npz and lane 1 from the .pt the port's `YOLO.export(format="pt")`
    writes, f32 through the kernels; a second server's lane 0 f32 through the twins (`plain`). 4 client
    threads x 16 frames of 640x512, 1- and 3-channel by thread, each frame to lane 0 and lane 1 (the
    twins' server: lane 0). Every reply has status 0 and no lane fails; kernels against twins and lane 0
    against lane 1 within the f32 gates; the kernel server launches kernels 1, 2, 3 and 5, the twins' none."""
    import numpy as np
    import torch

    from yolo_tpu_torch import YOLO

    frames = [clip[k] if (k // SERVE_KERNEL_FRAMES) % 2 == 0 else np.repeat(clip[k], 3, -1)
              for k in range(SERVE_KERNEL_CLIENTS * SERVE_KERNEL_FRAMES)]
    per = [frames[i * SERVE_KERNEL_FRAMES:(i + 1) * SERVE_KERNEL_FRAMES] for i in range(SERVE_KERNEL_CLIENTS)]
    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp):
        pt = YOLO(str(WEIGHTS)).export(format="pt")
        f32 = {"compute_dtype": "float32"}
        with serving({0: str(WEIGHTS), 1: str(pt.resolve())}, predict_args=f32) as srv:
            for lane in srv.lanes.values():
                lane.predictor.timings = []
            (out, wall), launches = counted(SERVE_PATH, lambda: run_clients(srv.port, [[(j, f) for f in fr for j in (0, 1)] for fr in per]))
            stats = batch_stats([t for lane in srv.lanes.values() for t in lane.predictor.timings])
            if any(lane.predictor.dtype != torch.float32 for lane in srv.lanes.values()):
                raise AssertionError("the kernel server's lanes did not compute in f32")
        with serving({0: str(WEIGHTS)}, predict_args={**f32, "plain": True}) as srv:
            (twin, _), none = counted(set(), lambda: run_clients(srv.port, [[(0, f) for f in fr] for fr in per]))
    lane0 = [r for replies, _ in out for r in replies[0::2]]
    lane1 = [r for replies, _ in out for r in replies[1::2]]
    plain = [r for replies, _ in twin for r in replies]
    worst = same_dets(lane0, plain, "serve kernels vs twins")
    worst_pt = same_dets(lane1, lane0, "serve lane 1 (.pt) vs lane 0 (.npz)")
    n = sum(len(r) for r in lane0)
    if n <= 0:
        raise AssertionError("the server detected nothing")
    log("serve kernels", card, f"{len(frames)} frames x 2 lanes in {wall:.2f} s from {SERVE_KERNEL_CLIENTS} clients, every status 0, "
        f"no lane error; {n} detections; kernels vs twins max |diff| {worst:.3e}, lane 1 (.pt) vs lane 0 {worst_pt:.3e}; "
        f"batches B {stats['B']}; launches {launches} (twins' server: {none})")


def serve_phase(clip, card, run_no, srv):
    """`[serve]` (timed): the bf16 server (the default) on `srv`, SERVE_CLIENTS v2 client threads x
    SERVE_FRAMES frames of 640x512 (1-channel on even threads, 3 on odd) plus one v1 client of
    SERVE_FRAMES 3-channel frames: frames/s over all clients (host clock over the run), request
    latency p50 / p99, the batch-size histogram, the worker's split per batch and its device-busy
    share, the first batch at each B against that B's median, and the launches (kernels 1, 2, 3, 5)."""
    import numpy as np

    lane = srv.lanes[0]
    n_clip = len(clip)
    jobs = [[(0, clip[(i * SERVE_FRAMES + k) % n_clip] if i % 2 == 0 else np.repeat(clip[(i * SERVE_FRAMES + k) % n_clip], 3, -1))
             for k in range(SERVE_FRAMES)] for i in range(SERVE_CLIENTS)]
    jobs.append([("v1", np.repeat(clip[k % n_clip], 3, -1)) for k in range(SERVE_FRAMES)])
    lane.predictor.timings = []
    with native_letterboxes() as calls:
        (out, wall), launches = counted(SERVE_PATH, lambda: run_clients(srv.port, jobs))
    if launches["head_level_cm"] != 0:
        raise AssertionError(f"[serve] launched the channel-major head: {launches}")
    st = batch_stats(lane.predictor.timings)
    lat = np.array([x for _, ls in out for x in ls]) * 1e3
    frames = len(lat)
    if len(calls) != frames:
        raise AssertionError(f"[serve]: {len(calls)} of {frames} frames went through the native letterbox")
    busy = float(st["upload"].sum() + st["device"].sum()) / 1e3
    q = lambda a: f"median {np.median(a):.3f} (p90 {np.percentile(a, 90):.3f})"  # noqa: E731
    first = {}
    for t in lane.predictor.timings:
        first.setdefault(t["B"], (t["pre_s"] + t["enqueue_s"] + t["wait_s"] + t["post_s"]) * 1e3)
    per_b = {}
    for t in lane.predictor.timings:
        per_b.setdefault(t["B"], []).append((t["pre_s"] + t["enqueue_s"] + t["wait_s"] + t["post_s"]) * 1e3)
    log(f"serve run {run_no}", card, f"{frames} frames from {SERVE_CLIENTS} v2 + 1 v1 clients in {wall:.3f} s = {frames / wall:.1f} "
        f"frames/s (all letterboxed by the native library); request latency p50 {np.percentile(lat, 50):.2f} ms, p99 {np.percentile(lat, 99):.2f} ms; "
        f"{sum(len(r) for rs, _ in out for r in rs)} detections; batches {st['batches']}: B {st['B']}, frames per batch {st['n']}")
    log(f"serve run {run_no}", card, f"worker per batch (ms): letterbox + assembly {q(st['pre'])}, enqueue {q(st['enqueue'])}, "
        f"wait {q(st['wait'])}, Results {q(st['post'])} (host clock); upload {q(st['upload'])}, device {q(st['device'])} "
        f"(CUDA events); device busy {busy:.3f} s of {wall:.3f} s: idle {100 * (1 - busy / wall):.1f}%")
    log(f"serve run {run_no}", card, "first batch at each B against that B's median (ms, host): " + ", ".join(
        f"B={b}: {first[b]:.2f} / {np.median(per_b[b]):.2f} ({len(per_b[b])} batches)" for b in sorted(first)))
    log(f"serve run {run_no}", card, f"kernel launches in that run: {launches}")
    return launches


def letterbox_cost(clip, card):
    """The host's cost of one 640x512 BGR frame's letterbox into 640x640 on the main thread, nothing
    else running: the native library (the server's route; a row copy at ratio 1) against the
    port's LetterBox (a numpy pad at ratio 1); ms per frame over 64 frames."""
    import numpy as np

    from yolo_tpu_torch import native
    from yolo_tpu_torch.ops.letterbox import LetterBox

    frames = [np.ascontiguousarray(np.repeat(f, 3, -1)) for f in clip[:64]]
    lb = LetterBox((640, 640), auto=False)
    cost = {}
    for name, fn in (("native", lambda f: native.letterbox(f, (640, 640))), ("LetterBox", lambda f: lb(f, return_meta=True))):
        fn(frames[0])
        t0 = time.perf_counter()
        outs = [fn(f) for f in frames]
        cost[name] = (time.perf_counter() - t0) / len(frames) * 1e3
    if not all(np.array_equal(a[0], b[0]) for a, b in zip(outs, [native.letterbox(f, (640, 640)) for f in frames])):
        raise AssertionError("at ratio 1 the native letterbox and the padding differ")
    log("serve letterbox", card, "one 640x512x3 frame into 640x640 on the main thread: "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in cost.items()) + " (equal pixels)")


def write_bgr_video(path: Path, frames) -> Path:
    """(n, h, w, 1) IR frames as a 30 fps mp4v file of BGR frames."""
    import cv2
    import numpy as np

    vw = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 30, (frames.shape[2], frames.shape[1]))
    for frame in frames:
        vw.write(np.repeat(frame, 3, -1))
    vw.release()
    return path


def remote_phase(clip, card, srv):
    """`[remote]`: `YOLO("tcp://.../0")` on the `[serve]` server (bf16) over a 16-frame mp4v file and a
    directory of 8 PNGs: each Results equals a raw v2 request for the frame it decoded (one client,
    so every call is B = 1); `track` over the video attaches ids."""
    import cv2
    import numpy as np

    from yolo_tpu_torch import YOLO
    from yolo_tpu_torch.utils.remote import RemoteModel

    with tempfile.TemporaryDirectory() as tmp:
        vid, pngs = write_bgr_video(Path(tmp) / "ir.mp4", clip[:16]), Path(tmp) / "pngs"
        pngs.mkdir()
        for k in range(8):
            cv2.imwrite(str(pngs / f"{k:03d}.png"), clip[100 + k])
        m = YOLO(f"tcp://127.0.0.1:{srv.port}/0")
        counts = {}
        with RemoteModel(f"tcp://127.0.0.1:{srv.port}/0") as rm:
            for name, src in (("video", vid), ("pngs", pngs)):
                res = m.predict(str(src), conf=0.0, verbose=False)
                raw = [rm(r.orig_img) for r in res]
                if [len(r) for r in res] != [len(d) for d in raw] or not all(np.array_equal(r.boxes.data, d) for r, d in zip(res, raw)):
                    raise AssertionError(f"[remote] {name}: YOLO(tcp://).predict differs from raw v2 replies")
                counts[name] = (len(res), sum(len(r) for r in res))
        tracked = m.track(str(vid), conf=0.0, verbose=False)
        ids = sorted({int(i) for r in tracked if len(r) for i in r.boxes.id})
        m.predictor.close()
    if counts["video"][0] != 16 or counts["pngs"][0] != 8 or not ids or not all(r.boxes.is_track for r in tracked if len(r)):
        raise AssertionError(f"[remote]: frames/detections {counts}, track ids {ids}")
    log("remote", card, f"YOLO(tcp://) predict = raw v2 replies: video {counts['video'][0]} frames ({counts['video'][1]} detections), "
        f"PNG dir {counts['pngs'][0]} frames ({counts['pngs'][1]}); track ids {ids}")


def predict_sources_phase(clip, card):
    """`[predict sources]`: `YOLO(best.npz).predict` on the card (bf16) over a directory of 8 PNGs, a glob
    of 4 of them and a 16-frame mp4v video, with save, save_txt and save_crop: the files each writes.
    Then a 300x500 frame, which the letterbox resizes: the native letterbox route (required here),
    f32 kernels against f32 twins at the f32 gates, with the launches."""
    import cv2
    import numpy as np

    from yolo_tpu_torch import YOLO, native

    with tempfile.TemporaryDirectory() as tmp:
        pngs, vid = Path(tmp) / "pngs", write_bgr_video(Path(tmp) / "ir.mp4", clip[:16])
        pngs.mkdir()
        for k in range(8):
            cv2.imwrite(str(pngs / f"{k:03d}.png"), clip[200 + k])
        written = {}
        for name, src, want in (("dir", pngs, 8), ("glob", pngs / "00[0-3].png", 4), ("video", vid, 16)):
            out = Path(tmp) / "runs" / name
            y = YOLO(str(WEIGHTS))  # a predictor keeps the run directory of its first write
            res, launches = counted(SERVE_PATH, lambda: y.predict(str(src), save=True, save_txt=True, save_crop=True, project=str(out.parent),
                                                                  name=name, exist_ok=True, verbose=False))
            files = sorted(str(f.relative_to(out)) for f in out.rglob("*") if f.is_file())
            kinds = {k: sum(1 for f in files if f.startswith(k)) for k in ("labels/", "crops/")}
            kinds["images"] = len(files) - sum(kinds.values())
            if len(res) != want or kinds["images"] < 1 or kinds["labels/"] < 1 or kinds["crops/"] < 1:
                raise AssertionError(f"[predict sources] {name}: {len(res)} results, files {files}")
            written[name] = (len(res), sum(len(r) for r in res), kinds, launches["c2f"])
        log("predict sources", card, "; ".join(f"{k}: {n} frames, {d} detections, written {w} (c2f launches {c})"
                                               for k, (n, d, w, c) in written.items()))

    small = np.ascontiguousarray(np.repeat(clip[290, 100:400, 50:550], 3, -1))  # 300x500 with 3 targets: scaled by 1.28
    with native_letterboxes() as calls:
        got, launches = counted(SERVE_PATH, lambda: YOLO(str(WEIGHTS)).predict(small, compute_dtype="float32", verbose=False)[0])
    want = YOLO(str(WEIGHTS)).predict(small, compute_dtype="float32", plain=True, verbose=False)[0]
    worst = same_dets([got.boxes.data], [want.boxes.data], "predict 300x500 kernels vs twins")
    if calls != [(300, 500, 3)] or len(got) == 0:
        raise AssertionError(f"300x500 predict: native letterbox calls {calls}, {len(got)} detections")
    _, meta = native.letterbox(small, (640, 640))
    log("predict sources", card, f"300x500 frame through the native letterbox (ratio {meta[0][0]!r}, pad {meta[1]}): f32 kernels "
        f"{len(got)} detections = twins', max |diff| {worst:.3e}; launches {launches}")


@contextlib.contextmanager
def native_letterboxes():
    """Record the shape of every image the predictor letterboxes through the native library in
    the block (it must have built: the card's machine has g++)."""
    from yolo_tpu_torch import native

    if not native.available():
        raise AssertionError("the native letterbox library did not build (g++)")
    calls, real = [], native.letterbox
    native.letterbox = lambda img, *a, **k: (calls.append(img.shape), real(img, *a, **k))[1]
    try:
        yield calls
    finally:
        native.letterbox = real


def write_split(root: Path, n: int, seed: int, w: int = 640, h: int = 512, split: str = "val") -> Path:
    """A copy of demos/ir_end_to_end.py::_write_split at its defaults (the training
    distribution): n seeded 640x512 IR frames as PNGs under root/images/<split>, 1-3 small
    bright targets on a cloudy background each, YOLO labels under root/labels/<split> → the
    dataset yaml, which names every split written under root."""
    import cv2
    import numpy as np

    rng = np.random.default_rng(seed)
    (root / f"images/{split}").mkdir(parents=True, exist_ok=True)
    (root / f"labels/{split}").mkdir(parents=True, exist_ok=True)
    yy, xx = np.mgrid[0:h, 0:w]
    for i in range(n):
        bg = rng.normal(30, 10, (h // 16, w // 16)).astype(np.float32)
        img = cv2.resize(bg, (w, h), interpolation=cv2.INTER_CUBIC)
        img += rng.normal(0, 2, (h, w))
        lines = []
        for _ in range(rng.integers(1, 4)):
            cx, cy = rng.uniform(0.08, 0.92), rng.uniform(0.08, 0.92)
            r = rng.uniform(2.5, 6.0)
            a = rng.uniform(120.0, 200.0)
            img += a * np.exp(-(((xx - cx * w) ** 2 + (yy - cy * h) ** 2) / (2 * r**2)))
            lines.append(f"0 {cx:.4f} {cy:.4f} {(4 * r) / w:.4f} {(4 * r) / h:.4f}")
        cv2.imwrite(str(root / f"images/{split}/{i}.png"), np.clip(img, 0, 255).astype(np.uint8))
        (root / f"labels/{split}/{i}.txt").write_text("\n".join(lines) + "\n")
    splits = "".join(f"{s.name}: images/{s.name}\n" for s in sorted((root / "images").iterdir()))
    (root / "data.yaml").write_text(f"path: {root}\n{splits}names:\n  0: aircraft\n")
    return root / "data.yaml"


def recording_validator():
    """The port's DetectionValidator, keeping each batch's packed device outputs (host copies) in `outs`."""
    from yolo_tpu_torch.engine.validator import DetectionValidator

    class Recording(DetectionValidator):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.outs = []

        def _update(self, batch, out, *rest):
            self.outs.append(out)
            return super()._update(batch, out, *rest)

    return Recording


def val_run(data, y=None, **kw):
    """`y.val(data=..., imgsz=640, plots=False, **kw)` on the card, `y` a new YOLO(best.npz) unless
    given → (results, validator)."""
    from yolo_tpu_torch import YOLO

    y = y or YOLO(str(WEIGHTS))
    results = y.val(validator=recording_validator(), data=str(data), imgsz=640, plots=False, **kw)
    return results, y.validator


def same_val_detections(got, want) -> float:
    """Per image: equal detection counts, boxes within 1e-2 px and conf within 1e-4, rows in x1 order
    (two scores of one image may lie within the f32 difference) → the largest |diff|."""
    import numpy as np

    worst = 0.0
    for a, b in zip((o for out in got.outs for o in out), (o for out in want.outs for o in out)):
        a, b = a[a[:, 6] > 0], b[b[:, 6] > 0]
        if len(a) != len(b):
            raise AssertionError(f"val: detections per image differ, kernels {len(a)} vs plain {len(b)}")
        a, b = a[np.argsort(a[:, 0], kind="stable")], b[np.argsort(b[:, 0], kind="stable")]
        if not np.array_equal(a[:, 5], b[:, 5]) or not np.isfinite(a).all():
            raise AssertionError("val: classes differ or non-finite outputs")
        box, conf = float(np.abs(a[:, :4] - b[:, :4]).max(initial=0)), float(np.abs(a[:, 4] - b[:, 4]).max(initial=0))
        if box > 1e-2 or conf > 1e-4:
            raise AssertionError(f"val: boxes differ by {box} px or conf by {conf}")
        worst = max(worst, box, conf)
    return worst


def val_kernel_holds(model, params, data, card):
    """Kernels 1, 2, 3 and 5 against their twins at TOL on activations captured from the first
    val batch (B = 16, 640x640, the letterboxed 640x512 frames, RGB / 255), f32 and bf16; NMS at
    conf 0.001, K = 1024, bit for bit."""
    import copy

    import torch

    from yolo_tpu_torch.cfg import get_cfg
    from yolo_tpu_torch.data import build_dataloader, build_yolo_dataset, check_det_dataset
    from yolo_tpu_torch.nn.tasks import params_from_jax
    from yolo_tpu_torch.ops import cuda_c2f, cuda_nms

    model = copy.deepcopy(model)
    d = check_det_dataset(str(data))
    imgs = next(iter(build_dataloader(build_yolo_dataset(get_cfg(overrides={"imgsz": 640}), d["val"], d), 16, workers=4)))["img"]
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        params_from_jax(model, params, dtype)
        x = torch.from_numpy(imgs).cuda().to(dtype) / 255.0
        rec, boxes, scores = capture_instances(model, x)
        for name, args in rec:
            if name == "c2f":
                kern, plain = (lambda a=args: cuda_c2f.fused_c2f(*a)), (lambda a=args: cuda_c2f.c2f_plain(*a))
            elif name == "c2f_upconcat":
                kern, plain = (lambda a=args: cuda_c2f.fused_c2f_upconcat(*a)), (lambda a=args: cuda_c2f.c2f_upconcat_plain(*a))
            else:
                kfn, pfn = head_fns(name)
                kern, plain = (lambda a=args: kfn(*a)), (lambda a=args: pfn(*a))
            B, H, W, C = args[1 if name == "c2f_upconcat" else 0].shape
            desc = f"B={B} {H}x{W} C={C}"
            errs = hold(name, desc, dn, kern(), plain())
            log(f"val kernels {dn}", card, f"{name:14s} {desc:22s} max_abs_err={max(errs.values()):.3e} "
                f"kernel_ms={cuda_ms(kern):.4f} plain_ms={cuda_ms(plain):.4f}")
        cand, top = nms_candidates(boxes, scores, 0.001, 1024)
        got, want = cuda_nms.nms_keep(cand, top, 0.7), cuda_nms.nms_keep_plain(cand, top, 0.7)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"nms_keep {dn} B=16 K=1024 conf 0.001: keep mask differs in {int((got != want).sum())} slots")
        log(f"val kernels {dn}", card, f"nms_keep       B={cand.shape[0]} K={cand.shape[1]} valid={int((top > 0).sum())} "
            f"kept={int(got.sum())} max_abs_err=0 kernel_ms={cuda_ms(lambda: cuda_nms.nms_keep(cand, top, 0.7), iters=50, warmup=5):.4f} "
            f"plain_ms={cuda_ms(lambda: cuda_nms.nms_keep_plain(cand, top, 0.7), iters=2, warmup=1):.4f}")


def val_kernels_phase(model, params, data, card):
    """`[val kernels]`: YOLO(best.npz).val on the demo's held-out split (32 frames, seed 10,000, as
    demos/ir_end_to_end.py::make_dataset makes it) at imgsz 640, batch 16: f32 through the kernels
    against f32 through the twins (metrics within 1e-4, equal confusion matrices, per-image
    detections), then bf16; the kernels against their twins on one val batch."""
    path = {"c2f", "c2f_upconcat", "head_level", "nms_keep"}
    (rk, vk), launches = counted(path, lambda: val_run(data, batch=16))
    rp, vp = val_run(data, batch=16, plain=True)
    n_det, dm, worst = hold_val_runs("val", card, rk, vk, rp, vp)
    if rk["mAP50"] <= 0 or n_det <= 0:
        raise AssertionError(f"val found nothing: {rk}, {n_det} detections")
    demo = json.loads((ROOT / "demos" / "artifacts" / "demo_report.json").read_text())["train_metrics_heldout_val"]
    log("val kernels f32", card, f"kernels {rk} | plain: every key within {dm:.2e}, confusion matrix equal "
        f"{vk.confusion_matrix.matrix.tolist()}, {n_det} detections over {VAL_HELDOUT[0]} images equal per image (max |box/conf diff| "
        f"{worst:.3e}); launches {launches}")
    log("val kernels f32", card, f"for scale only: the JAX demo's recorded held-out mAP50 {demo['mAP50']:.4f}, "
        f"mAP50-95 {demo['mAP50-95']:.4f} (demos/artifacts/demo_report.json); the port's here {rk['mAP50']:.4f}, {rk['mAP50-95']:.4f}")
    rb, _ = val_run(data, batch=16, half=True)
    log("val kernels bf16", card, f"{rb}; bf16 - f32: " + ", ".join(f"{k} {rb[k] - rk[k]:+.4f}" for k in rb))
    val_kernel_holds(model, params, data, card)


def val_phase(data, warm_data, card):
    """`[val]`: YOLO(best.npz).val on a 512-frame split (seed 20,000), f32 and bf16 at batch 16 (the
    cfg default) and 32, each after a warm-up of the same YOLO on the 32-frame split: images/s by
    the host clock over the `.val(...)` call alone (the model built and its weights on the card
    before the clock starts), the per-batch split (loader wait on the main thread, upload + forward +
    NMS in CUDA events, the wait on the copy back, host matching) and each kernel's launches (6
    c2f, 3 c2f_upconcat, 4 head_level and 1 nms_keep a batch); at batch 16 also a profiled call
    for the device's idle share."""
    import torch

    from yolo_tpu_torch import YOLO
    from yolo_tpu_torch.data.dataset import YOLODataset

    YOLODataset(str(Path(data).parent / "images" / "val"))  # the label cache, written before any timed run
    path = {"c2f", "c2f_upconcat", "head_level", "nms_keep"}
    per_batch = {"c2f": 6, "c2f_upconcat": 3, "head_level": 4, "nms_keep": 1}
    for half in (False, True):
        for batch in (16, 32):
            y = YOLO(str(WEIGHTS))
            val_run(warm_data, y, batch=batch, half=half)  # weights, plans, cuDNN, allocator at this batch

            def timed():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = val_run(data, y, batch=batch, half=half)
                return out, time.perf_counter() - t0

            ((res, v), wall), launches = counted(path, timed)
            n_b = len(v.timings)
            if n_b != -(-VAL_FRAMES[0] // batch) or any(launches[k] != c * n_b for k, c in per_batch.items()):
                raise AssertionError(f"val batch {batch}: {n_b} batches, launches {launches}")
            mean = {k: sum(t[k] for t in v.timings) / n_b for k in v.timings[0]}
            tag = f"val {'bf16' if half else 'f32'} b{batch}"
            log(tag, card, f"{VAL_FRAMES[0]} images in {wall:.3f} s = {VAL_FRAMES[0] / wall:.1f} images/s (host clock, the "
                f".val call on a warm model); per batch: " + ", ".join(f"{k} {m:.2f} ms" for k, m in mean.items())
                + f"; mAP50 {res['mAP50']:.4f} mAP50-95 {res['mAP50-95']:.4f}; launches {launches}")
            if batch == 16:
                val_profile(tag, y, data, batch, half, card)


def val_profile(tag, y, data, batch, half, card):
    """One more val call under torch.profiler: the device's busy time (the sum of its kernels and
    copies) against the call's wall time → the idle share (the profiler's own host cost inflates
    the wall a little, so the share is an upper bound); the top device kernels and host ops."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        val_run(data, y, batch=batch, half=half)
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    on_card = [e for e in events if str(e.device_type).endswith("CUDA")]  # kernels, copies, sets
    dev = lambda e: getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)  # noqa: E731 (µs)
    busy = sum(dev(e) for e in on_card) / 1e6
    if busy <= 0:
        raise AssertionError(f"{tag}: the profiler recorded no device time ({len(on_card)} device events)")
    top_dev = sorted(on_card, key=dev, reverse=True)[:6]
    top_cpu = sorted(events, key=lambda e: e.self_cpu_time_total, reverse=True)[:8]
    log(tag + " profile", card, f"device busy {busy:.3f} s of {wall:.3f} s under the profiler: idle {1 - busy / wall:.1%}; "
        "device: " + ", ".join(f"{e.key[:40]} {dev(e) / 1e3:.1f} ms x{e.count}" for e in top_dev)
        + "; host self: " + ", ".join(f"{e.key[:32]} {e.self_cpu_time_total / 1e3:.1f} ms x{e.count}" for e in top_cpu))


def val_workers_sweep(data, warm_data, card):
    """`--profile`: the bf16 `[val]` call at batch 16 with 1, 2, 4, 8 (the cfg default) and 16 loader
    threads, then the validator's device pass alone (no loader) on one pinned-able batch: the host's
    time to issue it and the time left for the device after."""
    import numpy as np
    import torch

    from yolo_tpu_torch import YOLO

    for workers in (1, 2, 4, 8, 16):
        y = YOLO(str(WEIGHTS))
        val_run(warm_data, y, batch=16, half=True, workers=workers)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, v = val_run(data, y, batch=16, half=True, workers=workers)
        wall = time.perf_counter() - t0
        mean = {k: sum(t[k] for t in v.timings) / len(v.timings) for k in v.timings[0]}
        log("val workers", card, f"bf16 b16, {workers:2d} loader threads: {VAL_FRAMES[0] / wall:.1f} images/s; per batch: "
            + ", ".join(f"{k} {m:.2f} ms" for k, m in mean.items()))
    y = YOLO(str(WEIGHTS))
    y.val(data=str(warm_data), imgsz=640, plots=False, half=True)
    imgs = np.random.default_rng(0).integers(0, 255, (16, 640, 640, 3), np.uint8)
    for _ in range(3):
        y.validator._device_pass(y.model, imgs, torch.device("cuda"), torch.bfloat16)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        y.validator._device_pass(y.model, imgs, torch.device("cuda"), torch.bfloat16)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    log("val workers", card, f"the device pass alone (B = 16, bf16, no loader threads): the host issues it in "
        f"{(t1 - t0) / 10 * 1e3:.2f} ms, the device finishes {(time.perf_counter() - t1) * 1e3:.2f} ms after the tenth")


# ---------------------------------------------------------------- training --

TRAIN_SET = (64, 0)  # demos/ir_end_to_end.py::make_dataset: 64 train frames (seed 0), the held-out split as val
# train_small_targets.py:16-45 (the IR recipe) on yolov8-small.yaml at scale n, nc = 1, full width and depth;
# cut: epochs 3 (150) and close_mosaic 1 (20, which at 3 epochs would switch mosaic and copy-paste off at once)
TRAIN_RECIPE = dict(
    epochs=3, patience=30, batch=16, imgsz=640, optimizer="AdamW", lr0=0.0008, lrf=0.005, momentum=0.95,
    weight_decay=0.0008, warmup_epochs=5, hsv_h=0.0, hsv_s=0.0, hsv_v=0.3, degrees=0.0, translate=0.05, scale=0.2,
    shear=0.0, perspective=0.0, flipud=0.1, fliplr=0.5, mosaic=0.3, mixup=0.0, copy_paste=0.15, close_mosaic=1,
    amp=True, workers=8, seed=0,
)
# [train step f32], card against CPU: the loss and its components (relative), every gradient (absolute, as a
# share of its tensor's largest), the BN running moments after the step (absolute), and the parameters after
# the optimizer. AdamW's first step moves a parameter by lr · u(g), u(g) = g / (|g| + 1e-8) of the clipped
# gradient, which is ±1 wherever |g| >> 1e-8: a gradient near zero that differs between the devices within
# the gradient tolerance may move its parameter up to 2 lr the other way. So the parameters must agree
# within lr · |u(g_card) - u(g_cpu)| (from the two runs' own gradients, in float64) + TRAIN_STEP_TOL["param"]
TRAIN_STEP_TOL = {"loss": 1e-4, "grad": 1e-3, "bn": 1e-4, "param": 1e-6}


def train_epoch_recorder(epochs: list, profile_epoch=None):
    """A DetectionTrainer whose hooks keep each epoch's numbers in `epochs`, and profile
    one epoch's training steps (`profile_epoch`, a dict that gets the result) with torch.profiler."""
    from yolo_tpu_torch.engine.trainer import DetectionTrainer

    class Recording(DetectionTrainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.callbacks["on_train_epoch_start"].append(self._start)
            self.callbacks["on_train_epoch_end"].append(self._train_end)
            self.callbacks["on_fit_epoch_end"].append(self._record)
            self._n, self._prof = 0, None

        def _start(self, t):
            self._t0 = time.perf_counter()
            if profile_epoch is not None and self._n == profile_epoch["epoch"]:
                from torch.profiler import ProfilerActivity, profile

                self._prof = profile(activities=[ProfilerActivity.CUDA])  # the device only: host tracing slows the steps 10x
                self._prof.__enter__()
            self._n += 1

        def _train_end(self, t):
            self._t_end = time.perf_counter()  # the epoch's losses were read: the device is done with its steps
            if self._prof is not None:
                self._prof.__exit__(None, None, None)
                profile_epoch.update(device_profile(self._prof, self._t_end - self._t0))
                self._prof = None

        def _record(self, t):
            profiled = profile_epoch is not None and self._n - 1 == profile_epoch["epoch"]
            epochs.append({"row": dict(t._last_row), "epoch_s": t.epoch_time, "val_s": t.val_time,
                           "timings": list(t.timings), "t_end": self._t_end, "profiled": profiled})

    return Recording


def device_profile(prof, wall: float) -> dict:
    """The device's busy time (its kernels, copies and sets) in a profiled window of `wall` s → busy,
    the window's idle share, the top device kernels."""
    events = prof.key_averages()
    on_card = [e for e in events if str(e.device_type).endswith("CUDA")]
    dev = lambda e: getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)  # noqa: E731 (µs)
    busy = sum(dev(e) for e in on_card) / 1e6
    if busy <= 0:
        raise AssertionError(f"the profiler recorded no device time ({len(on_card)} device events)")
    top = sorted(on_card, key=dev, reverse=True)[:6]
    return {"busy": busy, "wall": wall, "idle": 1 - busy / wall, "kernels": len(on_card),
            "top": ", ".join(f"{e.key[:40]} {dev(e) / 1e3:.1f} ms x{e.count}" for e in top)}


def train_step_flops(batch: int, imgsz: int = 640) -> tuple:
    """The operations of one train step's convolutions and matrix products (FlopCounterMode, from
    their shapes): (forward, forward + backward) of the yolov8-small train form on `batch` images."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from yolo_tpu_torch.nn.tasks import DetectionModel, load_train_params

    m = DetectionModel("yolov8-small.yaml")
    load_train_params(m, m.init(0))
    m.train()
    x = torch.rand(batch, imgsz, imgsz, 3, device="cuda", dtype=torch.bfloat16)
    with FlopCounterMode(display=False) as fwd:
        outs = m.forward_features(x)
    with FlopCounterMode(display=False) as both:
        sum(o.float().sum() for o in m.forward_features(x)).backward()
    del outs
    return fwd.get_total_flops(), both.get_total_flops()


def train_phase(data, run_dir, card, profiling):
    """`[train]`: YOLO("yolov8-small.yaml").train with TRAIN_RECIPE on the 64-frame split, validating
    the EMA weights on the 32-frame held-out split each epoch: per epoch the loss components, P, R,
    mAP50, mAP50-95, epoch and validation seconds; train images/s over every step after the first of
    each epoch (host clock, from the step's loader wait to the epoch's read of its losses); the mean
    per-step split (loader wait on the host; forward + loss, backward, optimizer + BN + EMA in CUDA
    events); peak device memory; each kernel's launches (check_amp and the validations); with
    --profile, the device's idle share over the second epoch's steps."""
    import numpy as np
    import torch

    from yolo_tpu_torch import YOLO

    epochs, prof = [], ({"epoch": 1} if profiling else None)
    y = YOLO("yolov8-small.yaml")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()  # what the earlier phases still hold
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    metrics, launches = counted({"c2f", "c2f_upconcat", "head_level", "nms_keep"}, lambda: y.train(
        trainer=train_epoch_recorder(epochs, prof), data=str(data), project=str(run_dir), name="train", exist_ok=True,
        **TRAIN_RECIPE))
    wall = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    batch = TRAIN_RECIPE["batch"]
    for e in epochs:
        r = e["row"]
        if not all(np.isfinite(r[f"train/{k}_loss"]) for k in ("box", "cls", "dfl")) or r["train/box_loss"] <= 0:
            raise AssertionError(f"train: epoch {r['epoch']} losses {r}")
        log("train", card, f"epoch {r['epoch'] + 1}/{TRAIN_RECIPE['epochs']}: box {r['train/box_loss']:.4f} cls "
            f"{r['train/cls_loss']:.4f} dfl {r['train/dfl_loss']:.4f}; P {r['metrics/precision']:.4f} R {r['metrics/recall']:.4f} "
            f"mAP50 {r['metrics/mAP50']:.4f} mAP50-95 {r['metrics/mAP50-95']:.4f}; epoch {e['epoch_s']:.2f} s, val {e['val_s']:.2f} s")
    timed = [e for e in epochs if not e["profiled"]]
    images = sum((len(e["timings"]) - 1) * batch for e in timed)
    span = sum(e["t_end"] - e["timings"][1]["start"] for e in timed)
    steps = [t for e in timed for t in e["timings"][1:]]
    mean = {k: sum(t[k] for t in steps) / len(steps) for k in ("loader", "forward", "backward", "optimizer")}
    log("train", card, f"{images} images over the {len(steps)} steps after the first of each epoch not profiled: "
        f"{images / span:.1f} images/s "
        f"(host clock); per step: loader wait {mean['loader']:.2f} ms (host), forward+loss {mean['forward']:.2f} ms, backward "
        f"{mean['backward']:.2f} ms, optimizer+BN+EMA {mean['optimizer']:.2f} ms (events); peak memory {peak:.2f} GiB "
        f"(max_memory_allocated, over the {base / 2**30:.2f} GiB held before the phase); the whole .train call {wall:.1f} s; launches {launches}")
    fwd, both = train_step_flops(batch)
    log("train", card, f"a step's convolutions: {both / 1e12:.3f} TFLOP (forward {fwd / batch / 1e9:.2f} GFLOP an image, "
        f"FlopCounterMode); at {PEAK_OPS_PER_S['bfloat16'] / 1e12:.0f} TFLOP/s (bf16) the bound is {both / PEAK_OPS_PER_S['bfloat16'] * 1e3:.3f} "
        f"ms a step against {span / len(steps) * 1e3:.1f} ms measured")
    if prof:
        n_prof = len(next(e for e in epochs if e["profiled"])["timings"])
        busy_step, wall_step = prof["busy"] / n_prof, span / len(steps)
        log("train profile", card, f"epoch {prof['epoch'] + 1}'s {n_prof} steps: device busy {prof['busy']:.3f} s in {prof['wall']:.3f} s "
            f"under the profiler (idle {prof['idle']:.1%} there); {busy_step * 1e3:.1f} ms of device work a step against "
            f"{wall_step * 1e3:.1f} ms a step unprofiled: idle {1 - busy_step / wall_step:.1%}; device: {prof['top']}")
    if metrics is None or y.params is None:
        raise AssertionError("train: no metrics or weights")
    return y, launches


def train_step_f32_phase(data, card, cfg_name="yolov8-small.yaml", tag="train step f32", recipe=None):
    """`[train step f32]`: one f32 step of the trainer's path (forward, loss, backward, AdamW at the
    recipe's lr0 with its weight decay at batch 16, BN moments) on the card and on the CPU, from
    DetectionModel("yolov8-small.yaml").init(0) (or `cfg_name`'s model at the dataset's nc: a segment
    or pose model with its loss and the batch's masks or keypoints) and the first batch of the training
    loader (B = 16, 640x640): within TRAIN_STEP_TOL, or the run fails."""
    import numpy as np
    import torch

    from yolo_tpu_torch.cfg import get_cfg
    from yolo_tpu_torch.data import build_dataloader, build_yolo_dataset, check_det_dataset
    from yolo_tpu_torch.nn.tasks import guess_model_task, load_train_params, model_class_for, train_leaves, yaml_model_load
    from yolo_tpu_torch.engine.trainer import LOSSES
    from yolo_tpu_torch.utils.optim import AdamW, apply_bn_stats

    cfg = get_cfg(overrides=recipe or TRAIN_RECIPE)
    d = check_det_dataset(str(data))
    batch = next(iter(build_dataloader(build_yolo_dataset(cfg, d["train"], d, mode="train"), cfg.batch, workers=8, shuffle=True)))
    lr, decay = cfg.lr0, cfg.weight_decay * cfg.batch * max(round(cfg.nbs / cfg.batch), 1) / cfg.nbs
    yaml_cfg = yaml_model_load(cfg_name)
    model_cls = model_class_for(yaml_cfg)
    loss_cls = LOSSES[guess_model_task(yaml_cfg)]
    runs = {}
    for dev in ("cuda", "cpu"):
        m = model_cls(cfg_name, nc=d["nc"], device=dev)
        load_train_params(m, m.init(0))
        m.train()
        x = torch.from_numpy(batch["img"]).to(dev).float() / 255.0
        tb = {k: torch.from_numpy(batch[k]).to(dev) for k in ("cls", "bboxes", "mask_gt", "masks", "keypoints") if k in batch}
        t0 = time.perf_counter()
        total, comps = loss_cls(m, cfg)(m.forward_features(x), tb)
        total.backward()
        leaves = train_leaves(m)
        params = {k: t for k, t in leaves.items() if isinstance(t, torch.nn.Parameter)}
        grads = {k: t.grad.detach().cpu().clone() for k, t in params.items()}  # before the clip scales them in place
        AdamW(list(params.items()), weight_decay=decay).step(lr, None, lr_bias=lr)
        apply_bn_stats(m)
        after = {k: t.detach().cpu().clone() for k, t in leaves.items()}
        runs[dev] = (float(total.detach()), comps.cpu().numpy(), grads, after, time.perf_counter() - t0)
    (tc, cc, gc, pc, sc), (tp, cp, gp, pp, sp) = runs["cuda"], runs["cpu"]
    err = {"loss": max(abs(tc - tp) / abs(tp), float(np.abs(cc - cp).max() / np.abs(cp).max()))}
    err["grad"] = max(float((gc[k] - gp[k]).abs().max() / gp[k].abs().max().clamp(min=1e-30)) for k in gp)
    err["bn"] = max(float((pc[k] - pp[k]).abs().max()) for k in pp if "running" in k)
    def u(g):  # AdamW's first-step direction of each gradient after the global-norm clip at 10
        g = {k: v.double() for k, v in g.items()}
        scale = min(1.0, 10.0 / (float(torch.sqrt(sum((v * v).sum() for v in g.values()))) + 1e-6))
        return {k: scale * v / ((scale * v).abs() + 1e-8) for k, v in g.items()}

    uc, up = u(gc), u(gp)
    err["param"], apart = 0.0, 0
    for k in gp:
        excess = (pc[k] - pp[k]).double().abs() - lr * (uc[k] - up[k]).abs()
        err["param"] = max(err["param"], float(excess.max()))
        apart += int((torch.sign(gc[k]) != torch.sign(gp[k])).sum())
    if any(v > TRAIN_STEP_TOL[k] for k, v in err.items()):
        raise AssertionError(f"{tag}: card vs CPU {err} beyond {TRAIN_STEP_TOL}")
    log(tag, card, f"{cfg_name}: loss {tc:.6f} (CPU {tp:.6f}), components {np.round(cc, 6).tolist()} (CPU "
        f"{np.round(cp, 6).tolist()}); largest differences, as TRAIN_STEP_TOL measures them: {err}; {apart} gradient "
        f"elements of opposite sign (near zero); the step took "
        f"{sc:.2f} s on the card (its first) and {sp:.2f} s on the CPU; all {len(gp)} gradients and {len(pp)} tensors held")


def hold_val_runs(tag, card, rk, vk, rp, vp):
    """f32 kernels against f32 twins on one split: metrics within 1e-4, equal confusion matrices, the
    same detections per image → the number of detections and the largest |box / conf| difference."""
    import numpy as np

    diff = {k: abs(rk[k] - rp[k]) for k in rk}
    if max(diff.values()) > 1e-4 or not np.array_equal(vk.confusion_matrix.matrix, vp.confusion_matrix.matrix):
        raise AssertionError(f"{tag}: kernels {rk} vs plain {rp}; confusion matrices {vk.confusion_matrix.matrix.tolist()} "
                             f"vs {vp.confusion_matrix.matrix.tolist()}")
    worst = same_val_detections(vk, vp)
    return sum(int((o[:, 6] > 0).sum()) for out in vk.outs for o in out), max(diff.values()), worst


def train_val_kernels_phase(trees, data, card):
    """`[train val kernels]`: the validator in f32 on the held-out split, through the kernels and with
    plain=True, on each trained YOLO of `trees` ({name: YOLO}: `[train]`'s, holding its final best EMA
    tree, and `[train finetune]`'s): the same metrics within 1e-4, the same confusion matrix and the
    same detections per image, or the run fails."""
    path = {"c2f", "c2f_upconcat", "head_level", "nms_keep"}
    for name, y in trees.items():
        (rk, vk), launches = counted(path, lambda: val_run(data, y, batch=16))
        rp, vp = val_run(data, y, batch=16, plain=True)
        n_det, dm, worst = hold_val_runs(f"train val {name}", card, rk, vk, rp, vp)
        log("train val kernels", card, f"{name}: kernels {rk} | plain: every key within {dm:.2e}, confusion matrix equal "
            f"{vk.confusion_matrix.matrix.tolist()}, {n_det} detections equal per image (max |box/conf diff| {worst:.3e}); "
            f"launches {launches}")


def train_finetune_phase(data, run_dir, card):
    """`[train finetune]` (report only): YOLO(best.npz), the demo's trained weights, validated on the
    held-out split (f32), then one epoch of TRAIN_RECIPE from them (the pretrained path; close_mosaic 1
    makes it a clean epoch) and its own validation → the fine-tuned YOLO."""
    from yolo_tpu_torch import YOLO

    y = YOLO(str(WEIGHTS))
    before, _ = val_run(data, y, batch=16)
    t0 = time.perf_counter()
    after = y.train(data=str(data), project=str(run_dir), name="finetune", exist_ok=True, plots=False,
                    **{**TRAIN_RECIPE, "epochs": 1})
    log("train finetune", card, f"{WEIGHTS.relative_to(ROOT)} on the held-out split: mAP50 {before['mAP50']:.4f} "
        f"mAP50-95 {before['mAP50-95']:.4f}; after one epoch of the recipe ({time.perf_counter() - t0:.1f} s, "
        f"{'bf16' if y.trainer.args.amp else 'f32: check_amp refused bf16'}): mAP50 {after['mAP50']:.4f} "
        f"mAP50-95 {after['mAP50-95']:.4f}")
    return y


# ------------------------------------------- otherplan, tiles, TTA, ensembles, embed --

TILE, TILE_OVERLAP = 256, 0.25  # 9 tiles of a 640x512 frame, one batch padded to B = 16
SLICE_FRAMES = 64  # frames of the `[tiled]`, `[tta]`, `[ensemble]` and `[embed]` phases
ENHANCE_FRAMES, ENHANCE_CPU_FRAMES = 128, 16
VIDEO_FRAMES = 128  # `[detect_only]` / `[single target]`: the clip's first frames as an mp4v file


def hold_path_kernels(models, x, tag, card, conf=0.15, iou=0.6, max_nms=1024, nms=True):
    """Kernels 1, 2, 3 and 5 against their twins on the activations of one f32 forward of the NHWC
    images `x` through each model (loaded in f32 on the card): every C2f and upconcat instance and
    every Detect level at TOL, the NMS keep mask over the models' candidates joined on the anchor
    axis (K = max_nms at `conf`, as the predictor forms them) bit for bit, unless `nms` is False (a
    path without kernel 5) → {kernel: max |err|}."""
    import torch

    from yolo_tpu_torch.ops import cuda_c2f, cuda_head, cuda_nms

    kernels = {"c2f": (cuda_c2f.fused_c2f, cuda_c2f.c2f_plain), "c2f_upconcat": (cuda_c2f.fused_c2f_upconcat, cuda_c2f.c2f_upconcat_plain),
               "head_level": (cuda_head.fused_head_level, cuda_head.head_level_plain)}
    worst, parts, n = {}, [], 0
    for model in models:
        rec, boxes, scores = capture_instances(model, x)
        parts.append((boxes, scores))
        for name, args in rec:
            kern, plain = kernels[name]
            got, want = kern(*args), plain(*args)
            torch.cuda.synchronize()
            errs = hold(name, f"{tag} {tuple(args[-3 if name == 'c2f_upconcat' else 0].shape)}", "float32", got, want)
            worst[name] = max(worst.get(name, 0.0), *errs.values())
            n += 1
    if not nms:
        log(tag, card, f"f32 kernels against twins on {tuple(x.shape)} through {len(models)} model(s): {n} C2f / Detect instances "
            f"within atol = rtol = 1e-3 (max |err| " + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()) + ")")
        return worst
    cand, top = nms_candidates(torch.cat([b for b, _ in parts], 1), torch.cat([s for _, s in parts], 1), conf, max_nms)
    got, want = cuda_nms.nms_keep(cand, top, iou), cuda_nms.nms_keep_plain(cand, top, iou)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"nms_keep {tag}: keep mask differs from the plain twin in {int((got != want).sum())} slots")
    worst["nms_keep"] = 0.0
    log(tag, card, f"f32 kernels against twins on {tuple(x.shape)} through {len(models)} model(s): {n} C2f / Detect instances "
        f"within atol = rtol = 1e-3 (max |err| " + ", ".join(f"{k} {v:.3e}" for k, v in worst.items() if k != "nms_keep")
        + f"), NMS B={cand.shape[0]} K={cand.shape[1]} kept {int(got.sum())} of {int((top > 0).sum())} valid, bit for bit")
    return worst


def letterboxed(frame, imgsz=640):
    """One BGR frame as the predictor feeds the device: the native letterbox, RGB in [0, 1], f32 (1, H, W, 3)."""
    import torch

    from yolo_tpu_torch import native

    img, _ = native.letterbox(frame, (imgsz, imgsz))
    return torch.from_numpy(img[None]).cuda().flip(-1).float() / 255.0


def merged_rows(out):
    """tiled_predict's (boxes, scores, cls) → (M, 6) rows, as same_dets takes them."""
    import numpy as np

    boxes, scores, cls = out
    return np.concatenate([boxes, scores[:, None], cls[:, None]], 1)


def timed_frames(fn, frames):
    """`fn(frame)` over the frames (each call ends in its device wait) → (outputs, seconds on the host clock)."""
    t0 = time.perf_counter()
    out = [fn(f) for f in frames]
    return out, time.perf_counter() - t0


def tiled_phase(clip, card):
    """`[tiled]`: the clip's first 64 frames as BGR through `ops.tiling.tiled_predict` (tile 256, overlap
    0.25: 9 tiles, one batch padded to B = 16 a frame), f32 through the kernels against the same
    calls through the twins (merged boxes at the f32 gates), kernels 1, 2, 3 and 5 held against their
    twins on one frame's tile batch, then bf16, timed: frames/s, the padded B, the launches."""
    import numpy as np

    from yolo_tpu_torch import YOLO
    from yolo_tpu_torch.engine.predictor import _snap_batch
    from yolo_tpu_torch.ops.tiling import slice_tiles, tile_grid, tiled_predict

    frames = np.repeat(clip[:SLICE_FRAMES], 3, -1)
    grid = tile_grid(*HW, TILE, TILE_OVERLAP)
    kw = dict(tile=TILE, overlap=TILE_OVERLAP, conf=0.15, iou=0.6)
    yk, yp = YOLO(str(WEIGHTS)), YOLO(str(WEIGHTS))
    (got, wk), launches = counted(SERVE_PATH, lambda: timed_frames(lambda f: tiled_predict(yk, f, compute_dtype="float32", **kw), frames))
    want, wp = timed_frames(lambda f: tiled_predict(yp, f, compute_dtype="float32", plain=True, **kw), frames)
    worst = same_dets([merged_rows(g) for g in got], [merged_rows(w) for w in want], "tiled kernels vs twins")
    n_det = sum(len(g[0]) for g in got)
    if n_det <= 0 or launches["c2f"] != 6 * SLICE_FRAMES:
        raise AssertionError(f"[tiled] {n_det} detections, launches {launches} (one batch a frame expected)")
    log("tiled f32", card, f"{len(grid)} tiles a frame; kernels {n_det} merged detections in {wk:.2f} s | twins in {wp:.2f} s | equal "
        f"counts and classes, max |box/conf diff| {worst:.3e}; launches {launches}")
    tiles = np.zeros((_snap_batch(len(grid)), TILE, TILE, 3), np.uint8)
    tiles[: len(grid)] = slice_tiles(frames[-1], grid, TILE)
    import torch

    hold_path_kernels([yk.model], torch.from_numpy(tiles).cuda().flip(-1).float() / 255.0, "tiled f32", card)

    yb = YOLO(str(WEIGHTS))
    tiled_predict(yb, frames[0], **kw)  # warm-up: the plans of B = 16 at 256x256, the allocator
    yb.predictor.timings = []
    (bf, wb), launches = counted(SERVE_PATH, lambda: timed_frames(lambda f: tiled_predict(yb, f, **kw), frames))
    padded = sorted({t["B"] for t in yb.predictor.timings})
    same = sum(len(a[0]) == len(b[0]) for a, b in zip(bf, got))
    log("tiled bf16", card, f"{SLICE_FRAMES} frames in {wb:.3f} s = {SLICE_FRAMES / wb:.1f} frames/s (host clock; one predict of "
        f"{len(grid)} tiles a frame, padded B {padded}); {sum(len(b[0]) for b in bf)} detections, counts equal to f32 on "
        f"{same}/{SLICE_FRAMES} frames; launches {launches}")
    if padded != [16]:
        raise AssertionError(f"[tiled] the tiles went in batches of {padded}, not one of 16")


def launches_by_shape(model):
    """Count each kernel's launches per input size of `model.predict` (an instance attribute
    wraps the method until `del model.predict`) → {(H, W): {kernel: launches}}."""
    counters, per, real = launch_counters(), {}, model.predict

    def predict(x, *a, **k):
        before = {n: f.launches for n, f in counters.items()}
        out = real(x, *a, **k)
        d = per.setdefault(tuple(x.shape[1:3]), dict.fromkeys(counters, 0))
        for n, f in counters.items():
            d[n] += f.launches - before[n]
        return out

    model.predict = predict
    return per


def tta_phase(clip, card):
    """`[tta]`: 64 BGR frames through `YOLO(best.npz).predict(augment=True, imgsz=640)` (the scales 1,
    0.83 flipped and 0.67: 640x640, 544x544 and 448x448 on the device), f32 through the kernels against
    the twins (the f32 gates), the launches per shape, kernels 1, 2, 3 and 5 held against their twins
    at each scaled image of one frame; then bf16, timed."""
    import numpy as np

    from yolo_tpu_torch import YOLO
    from yolo_tpu_torch.nn.tasks import AUGMENT_FLIPS, AUGMENT_SCALES, _scale_img

    frames = np.repeat(clip[:SLICE_FRAMES], 3, -1)
    kw = dict(augment=True, imgsz=640, conf=0.15, iou=0.6, verbose=False)
    yk, yp = YOLO(str(WEIGHTS)), YOLO(str(WEIGHTS))
    per = launches_by_shape(yk.model)
    (got, wk), launches = counted(SERVE_PATH, lambda: timed_frames(
        lambda f: yk.predict(f, compute_dtype="float32", **kw)[0].boxes.data, frames))
    del yk.model.predict
    want, wp = timed_frames(lambda f: yp.predict(f, compute_dtype="float32", plain=True, **kw)[0].boxes.data, frames)
    worst = same_dets(got, want, "tta kernels vs twins")
    if sum(len(g) for g in got) <= 0 or sorted(per) != [(448, 448), (544, 544), (640, 640)]:
        raise AssertionError(f"[tta] {sum(len(g) for g in got)} detections, shapes {sorted(per)}")
    log("tta f32", card, f"kernels {sum(len(g) for g in got)} detections in {wk:.2f} s ({SLICE_FRAMES / wk:.1f} frames/s) | twins in "
        f"{wp:.2f} s | equal counts and classes, max |box/conf diff| {worst:.3e}; launches {launches}; per shape "
        + "; ".join(f"{h}x{w}: " + ", ".join(f"{k} {v}" for k, v in d.items() if v) for (h, w), d in sorted(per.items(), reverse=True)))
    x = letterboxed(frames[-1])
    gs = int(max(yk.model.stride))
    for ratio, flip in zip(AUGMENT_SCALES, AUGMENT_FLIPS):
        hold_path_kernels([yk.model], _scale_img(x.flip(2) if flip else x, ratio, gs), f"tta f32 scale {ratio}", card)

    yb = YOLO(str(WEIGHTS))
    yb.predict(frames[0], **kw)  # warm-up: the three shapes' plans
    (bf, wb), launches = counted(SERVE_PATH, lambda: timed_frames(lambda f: yb.predict(f, **kw)[0].boxes.data, frames))
    log("tta bf16", card, f"{SLICE_FRAMES} frames in {wb:.3f} s = {SLICE_FRAMES / wb:.1f} frames/s (host clock, one predict a frame, "
        f"three forwards); {sum(len(b) for b in bf)} detections; launches {launches}")


def ensemble_phase(clip, card):
    """`[ensemble]`: `YOLO([best.npz, last.npz])`, the two members' predictions in one NMS, over 64 BGR
    frames: f32 through the kernels against the twins (the f32 gates), kernels 1, 2, 3 and 5 held against
    their twins through both members on one frame (NMS over the joined candidates); then bf16, timed."""
    import numpy as np

    from yolo_tpu_torch import YOLO

    members = [str(WEIGHTS), str(WEIGHTS.with_name("last.npz"))]
    frames = np.repeat(clip[:SLICE_FRAMES], 3, -1)
    kw = dict(imgsz=640, conf=0.15, iou=0.6, verbose=False)
    yk, yp = YOLO(members), YOLO(members)
    (got, wk), launches = counted(SERVE_PATH, lambda: timed_frames(lambda f: yk.predict(f, compute_dtype="float32", **kw)[0].boxes.data, frames))
    want, wp = timed_frames(lambda f: yp.predict(f, compute_dtype="float32", plain=True, **kw)[0].boxes.data, frames)
    worst = same_dets(got, want, "ensemble kernels vs twins")
    if sum(len(g) for g in got) <= 0 or launches["c2f"] != 2 * 6 * SLICE_FRAMES:
        raise AssertionError(f"[ensemble] {sum(len(g) for g in got)} detections, launches {launches}")
    log("ensemble f32", card, f"2 members; kernels {sum(len(g) for g in got)} detections in {wk:.2f} s ({SLICE_FRAMES / wk:.1f} "
        f"frames/s) | twins in {wp:.2f} s | equal counts and classes, max |box/conf diff| {worst:.3e}; launches {launches}")
    hold_path_kernels(yk.model.models, letterboxed(frames[-1]), "ensemble f32", card)
    yb = YOLO(members)
    yb.predict(frames[0], **kw)
    (bf, wb), launches = counted(SERVE_PATH, lambda: timed_frames(lambda f: yb.predict(f, **kw)[0].boxes.data, frames))
    log("ensemble bf16", card, f"{SLICE_FRAMES} frames in {wb:.3f} s = {SLICE_FRAMES / wb:.1f} frames/s (host clock, one predict a "
        f"frame); {sum(len(b) for b in bf)} detections; launches {launches}")


def embed_phase(clip, card):
    """`[embed]`: `YOLO(best.npz).embed` of 64 BGR frames (square letterbox to 640, f32, the layer before
    the head, the neck folded): through the kernels against through the twins within 1e-4, kernels 1 and
    2 launched (no head, no NMS); ms/frame; kernels 1, 2, 3 and 5 held on the embed input of one frame."""
    import numpy as np

    from yolo_tpu_torch import YOLO
    from yolo_tpu_torch.ops.letterbox import LetterBox

    frames = np.repeat(clip[:SLICE_FRAMES], 3, -1)
    y = YOLO(str(WEIGHTS))
    y.embed(frames[0])  # warm-up
    (got, wk), launches = counted({"c2f", "c2f_upconcat"}, lambda: timed_frames(lambda f: y.embed(f)[0], frames))
    want, wp = timed_frames(lambda f: y.embed(f, plain=True)[0], frames)
    diff = max(float(np.abs(g - w).max()) for g, w in zip(got, want))
    if diff > 1e-4 or got[0].ndim != 1 or not all(np.isfinite(g).all() for g in got):
        raise AssertionError(f"[embed] kernels vs twins differ by {diff}, or shape {got[0].shape}")
    log("embed f32", card, f"{SLICE_FRAMES} vectors of {got[0].shape[0]} in {wk * 1e3 / SLICE_FRAMES:.3f} ms/frame (twins "
        f"{wp * 1e3 / SLICE_FRAMES:.3f}); max |diff| {diff:.3e} (gate 1e-4); launches {launches}")
    import torch

    x = torch.from_numpy(np.ascontiguousarray(LetterBox((640, 640), auto=False)(frames[-1])[None, ..., ::-1], np.float32) / 255.0).cuda()
    hold_path_kernels([y.model], x, "embed f32", card)


def enhance_phase(clip, card):
    """`[enhance]`: `otherplan.enhance_small_targets_torch` on a 128-frame 640x512 batch on the card against
    the host's cv2 `enhance_small_targets` frame by frame (ms/frame each), the largest difference from the
    same torch function on the CPU (16 frames), and `classical_detect` on the card's and the CPU's
    enhancement of those frames (equal box lists required), and on the host's cv2 enhancement (reported)."""
    import numpy as np
    import torch

    from yolo_tpu_torch.otherplan import classical_detect, enhance_small_targets, enhance_small_targets_torch

    gray = np.ascontiguousarray(clip[:ENHANCE_FRAMES, ..., 0])
    dev = torch.from_numpy(gray).cuda()
    card_out = enhance_small_targets_torch(dev)
    ms = cuda_ms(lambda: enhance_small_targets_torch(dev), iters=3, warmup=1) / ENHANCE_FRAMES
    t0 = time.perf_counter()
    host = [enhance_small_targets(g) for g in gray]
    host_ms = (time.perf_counter() - t0) * 1e3 / ENHANCE_FRAMES
    cpu = enhance_small_targets_torch(torch.from_numpy(gray[:ENHANCE_CPU_FRAMES]))
    ours = card_out[:ENHANCE_CPU_FRAMES].cpu()
    diff = float((ours - cpu).abs().max())
    boxes_card = [classical_detect(g, enhanced=e.numpy().astype(np.uint8)) for g, e in zip(gray, ours)]
    boxes_cpu = [classical_detect(g, enhanced=e.numpy().astype(np.uint8)) for g, e in zip(gray, cpu)]
    boxes_host = [classical_detect(g, enhanced=e) for g, e in zip(gray, host)]
    if card_out.shape != dev.shape or not torch.isfinite(card_out).all() or diff > 1e-3 or boxes_card != boxes_cpu:
        raise AssertionError(f"[enhance] card vs CPU differ by {diff} (gate 1e-3 on 0-255) or in classical_detect's boxes")
    host_diff = float(np.abs(card_out.cpu().numpy() - np.stack(host).astype(np.float32)).max())
    log("enhance", card, f"{ENHANCE_FRAMES} frames of 640x512: card {ms:.4f} ms/frame (events) | host cv2 {host_ms:.3f} ms/frame; "
        f"card vs CPU torch max |diff| {diff:.3e} on {ENHANCE_CPU_FRAMES} frames (gate 1e-3), classical_detect box lists equal "
        f"({sum(len(b) for b in boxes_card)} boxes); vs the cv2 enhancement (another border and kernel): max |diff| {host_diff:.1f}, "
        f"box lists equal on {sum(a == b for a, b in zip(boxes_card, boxes_host))}/{ENHANCE_CPU_FRAMES} frames")


def video_phases(clip, card):
    """`[detect_only]`: the clip's first 128 frames as an mp4v file through `otherplan.detect_only` with
    its default detector (`YOLO(best.npz)`, fused, bf16, on the card), timed, and with f32 detectors
    through the kernels and the twins (equal stats). `[single target]`: `run_single_target_tracking` over
    the file with the port's YOLO (bf16) as the detector: frames/s, stats and the CSV's rows."""
    import csv

    from yolo_tpu_torch import YOLO
    from yolo_tpu_torch.kalman.pipeline import yolo_detector
    from yolo_tpu_torch.otherplan import detect_only, run_single_target_tracking

    with tempfile.TemporaryDirectory() as tmp:
        vid = write_bgr_video(Path(tmp) / "clip.mp4", clip[:VIDEO_FRAMES])
        detect_only(vid, model=str(WEIGHTS), max_frames=2)  # warm-up
        t0 = time.perf_counter()
        stats, launches = counted(SERVE_PATH, lambda: detect_only(vid, model=str(WEIGHTS), output_video=Path(tmp) / "det.mp4"))
        wall = time.perf_counter() - t0
        f32 = []
        for plain in (False, True):
            y = YOLO(str(WEIGHTS)).fuse()
            f32.append(detect_only(vid, detector=lambda f, y=y, plain=plain: y.predict(
                f, conf=0.15, compute_dtype="float32", plain=plain, verbose=False)[0].boxes.data))
        if f32[0] != f32[1] or stats["frames"] != VIDEO_FRAMES or stats["total_detections"] <= 0:
            raise AssertionError(f"[detect_only] bf16 {stats}; f32 kernels {f32[0]} vs twins {f32[1]}")
        log("detect_only", card, f"{stats} in {wall:.2f} s = {stats['frames'] / wall:.1f} frames/s (decode, bf16 predict, drawing "
            f"and writing); f32 kernels {f32[0]} = twins'; launches {launches}")

        det = yolo_detector(YOLO(str(WEIGHTS)).fuse(), 0.15, imgsz=640)
        det(clip[0])
        t0 = time.perf_counter()
        stats, launches = counted(SERVE_PATH, lambda: run_single_target_tracking(vid, detector=det, csv_path=Path(tmp) / "traj.csv"))
        wall = time.perf_counter() - t0
        with open(Path(tmp) / "traj.csv") as f:
            rows = list(csv.DictReader(f))
        by = {s: sum(r["source"] == s for r in rows) for s in ("yolo", "classical", "none")}
        if len(rows) != stats["frames"] or stats["frames"] <= 0:
            raise AssertionError(f"[single target] {stats}, {len(rows)} CSV rows")
        log("single target", card, f"{stats} in {wall:.2f} s = {stats['frames'] / wall:.1f} frames/s; {len(rows)} CSV rows by source "
            f"{by}; launches {launches}")


def benchmark_phase(model, params, clip, card):
    """`[benchmark]`: best.npz's decoded forward (`DetectionModel.predict`, no NMS) on the clip's first
    frames letterboxed to 640x640 at B = 8 and 32, f32 through the kernels against the twins (boxes
    1e-2 px, scores 1e-4), with kernels 1, 2, 3 and 5 held against their twins on those activations;
    then `YOLO(best.npz).benchmark(imgsz=640)` (bf16) and `half=False` (f32): latency and frames/s at
    B = 1, 8, 32 with the launches of each call (no NMS); then `benchmark_formats` at 640, B = 1."""
    import numpy as np
    import torch

    from yolo_tpu_torch import YOLO
    from yolo_tpu_torch.nn.tasks import install_params
    from yolo_tpu_torch.utils.benchmarks import benchmark_formats

    frames = np.repeat(clip[:32], 3, -1)
    x32 = torch.cat([letterboxed(f) for f in frames])
    install_params(model, params, model.device, torch.float32)
    for B in (8, 32):
        x = x32[:B]
        got, want = model.predict(x), model.predict(x, plain=True)
        torch.cuda.synchronize()
        box, score = float((got[:, :4] - want[:, :4]).abs().max()), float((got[:, 4:] - want[:, 4:]).abs().max())
        if got.shape != want.shape or not torch.isfinite(got).all() or box > 1e-2 or score > 1e-4:
            raise AssertionError(f"benchmark B={B}: decoded forward kernels vs twins: boxes {box} px, scores {score}, {tuple(got.shape)}")
        log("benchmark f32", card, f"B={B} 640x640 decoded forward {tuple(got.shape)}: kernels against twins max |box| {box:.3e} px, "
            f"|score| {score:.3e}")
        hold_path_kernels([model], x, f"benchmark B={B}", card)
    y = YOLO(str(WEIGHTS))
    path = {"c2f", "c2f_upconcat", "head_level"}
    for half in (True, False):
        rows, launches = counted(path, lambda: y.benchmark(imgsz=640, half=half))
        if [r["batch"] for r in rows] != [1, 8, 32] or not all(r["fps"] > 0 for r in rows):
            raise AssertionError(f"benchmark: rows {rows}")
        log(f"benchmark {'bf16' if half else 'f32'}", card, "; ".join(f"B={r['batch']} {r['latency_ms']} ± {r['std_ms']} ms = "
                                                                      f"{r['fps']} frames/s" for r in rows)
            + f" (2 warm-ups + 10 timed calls a batch, each ended by torch.cuda.synchronize); launches {launches}")
    with tempfile.TemporaryDirectory() as tmp:
        rows, launches = counted(path, lambda: benchmark_formats(y.model, y.params, imgsz=640, batch=1, workdir=tmp))
    status = [(r["format"], r["status"]) for r in rows]
    if status != [("native-jit", "✅"), ("npz", "✅"), ("orbax", "❌ NotImplementedError"), ("stablehlo", "❌ NotImplementedError")]:
        raise AssertionError(f"benchmark_formats: {rows}")
    log("benchmark formats", card, "; ".join(f"{r['format']} {r['status']} {r['size_MB']} MB {r['latency_ms']} ms {r['fps']} frames/s"
                                            for r in rows) + f" (f32, B=1, 640); launches {launches}")


def pipeline_options_phase(model, params, clip, card, want_outs, want_stats):
    """`[pipeline options]`: `run_clip` of the 512-frame clip in bf16 with collect_outputs=False (no
    outputs kept), and with prefetch 1 and 4 (the pinned ring's depth): the stats must equal `[pipeline]`'s
    bf16 run's, and the outputs too where they are kept; frames/s each."""
    import numpy as np
    import torch

    path = {"c2f", "c2f_upconcat", "head_level", "nms_keep"}
    for opts in (dict(collect_outputs=False), dict(prefetch=1), dict(prefetch=4)):
        ft = make_pipeline(model, params, torch.bfloat16, plain=False)
        ft.run_clip(clip[:CHUNK], collect_outputs=False)
        ft.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (outs, stats), launches = counted(path, lambda: ft.run_clip(clip, **opts))
        wall = time.perf_counter() - t0
        if stats != want_stats or len(outs) != (0 if opts.get("collect_outputs") is False else len(want_outs)):
            raise AssertionError(f"[pipeline options] {opts}: stats {stats} vs {want_stats}, {len(outs)} outputs")
        same = sum(all(np.array_equal(o[k], w[k]) for k in o) for o, w in zip(outs, want_outs))
        log("pipeline options", card, f"{opts}: {stats} = [pipeline]'s; {len(outs)} chunk outputs"
            + (f", {same} of them equal to [pipeline]'s in every column" if outs else "")
            + f"; {FRAMES} frames in {wall:.3f} s = {FRAMES / wall:.1f} frames/s; launches {launches}")


def int8_pipeline_phase(model, params, clip, card, default_f32, default_fps):
    """`[pipeline int8]`: FusedDetectTrack(int8=True) calibrated on the clip's first chunk, on the 512-frame
    clip: f32 through the kernels against f32 through the twins (tracks, ids, statuses, detection counts and
    stats equal, boxes 1e-2 px), the frames whose detection count differs from `[pipeline]`'s f32 run
    (reported, not gated), then the timed bf16 run with its launches (the NMS kernel only), beside
    `[pipeline]`'s frames/s from this call."""
    import numpy as np
    import torch

    from yolo_tpu_torch import FusedDetectTrack

    tag = "pipeline int8"

    def make(dtype, plain):
        return FusedDetectTrack(model, params, frame_hw=HW, chunk=CHUNK, conf=0.15, iou=0.6, n_max=64, d_max=16, dtype=dtype,
                                plain=plain, int8=True, int8_calib=clip[:CHUNK])

    t0 = time.perf_counter()
    fk = make(torch.float32, plain=False)
    t_make = time.perf_counter() - t0
    if not fk.model.int8:
        raise AssertionError(f"[{tag}] the model holds no int8 conv")
    ok_, sk, wk = timed_run(fk, clip)
    op_, sp, wp = timed_run(make(torch.float32, plain=True), clip)
    worst = compare_runs(ok_, op_, sk, sp)
    d_outs, d_stats = default_f32
    differ = sum(int((a["det_count"] != b["det_count"]).sum()) for a, b in zip(ok_, d_outs))
    log(f"{tag} f32", card, f"kernels {sk} in {wk:.2f} s | plain equal in tracks, ids, statuses, detection counts, stats "
        f"(max |box/conf/vel diff| {worst:.3e}; plain {wp:.2f} s); against [pipeline] f32: stats {sk} vs {d_stats}, detection "
        f"count differs on {differ}/{FRAMES} frames (not gated); calibrated and built in {t_make:.2f} s")
    ft = make(torch.bfloat16, plain=False)
    ft.run_clip(clip[:CHUNK])  # warm-up
    ft.reset()
    ft.timings = []
    (ob, sb, wb), launches = counted({"nms_keep"}, lambda: timed_run(ft, clip))
    split = {}
    for marks in ft.timings:
        for (_, a), (name, b) in zip(marks, marks[1:]):
            split[name] = split.get(name, 0.0) + a.elapsed_time(b)
    same = sum(int((a["det_count"] == b["det_count"]).sum()) for a, b in zip(ob, ok_))
    if not all(np.isfinite(o["bbox"]).all() for o in ob):
        raise AssertionError(f"[{tag}] non-finite boxes in the bf16 run")
    log(f"{tag} bf16", card, f"{sb}; {FRAMES} frames in {wb:.3f} s = {FRAMES / wb:.1f} frames/s end to end against [pipeline]'s "
        f"{default_fps:.1f} in this call; device split per {FRAMES} frames: " + ", ".join(f"{k} {v:.1f} ms" for k, v in split.items())
        + f"; det_count equal to its f32 run on {same}/{FRAMES} frames; launches {launches}")


def predict_settings_phase(clip, card):
    """`[predict int8]`: YOLO(best.npz).predict(int8=True) on 16 BGR frames of the clip (dynamic
    activation scales, the int8 convs; the NMS kernel the only kernel), f32 kernel against its twin
    (equal detections, boxes 1e-2 px), then bf16 timed. `[predict visualize]`: one frame with
    visualize=True, the files written (a .npy per layer before the head, and a .png where matplotlib
    imports). `[predict show]`: show=True with no display named: one warning, `show` off, the Results
    of show=False."""
    import io
    import logging
    import os
    import tempfile

    import numpy as np

    from yolo_tpu_torch import YOLO
    from yolo_tpu_torch.utils import LOGGER

    frames = list(np.repeat(clip[:16], 3, -1))
    kw = dict(conf=0.15, iou=0.6, imgsz=640, verbose=False, batch=16)

    def dets(results):
        return [r.boxes.data for r in results]

    y = YOLO(str(WEIGHTS))
    (rk, launches) = counted({"nms_keep"}, lambda: y.predict(frames, int8=True, compute_dtype="float32", **kw))
    rp = YOLO(str(WEIGHTS)).predict(frames, int8=True, compute_dtype="float32", plain=True, **kw)
    worst = 0.0
    for a, b in zip(dets(rk), dets(rp)):
        if a.shape != b.shape:
            raise AssertionError(f"[predict int8] detections differ: kernel {a.shape} vs plain {b.shape}")
        if len(a):
            worst = max(worst, float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max()))
    if worst > 1e-2 or not y.model.int8 or sum(len(d) for d in dets(rk)) == 0:
        raise AssertionError(f"[predict int8] max |diff| {worst}, int8 {y.model.int8}, {sum(len(d) for d in dets(rk))} detections")
    f32 = YOLO(str(WEIGHTS)).predict(frames, compute_dtype="float32", **kw)
    y.predict(frames, int8=True, **kw)  # warm-up in bf16
    t0 = time.perf_counter()
    rb = y.predict(frames, int8=True, **kw)
    wb = time.perf_counter() - t0
    log("predict int8", card, f"f32 kernel = plain ({sum(len(d) for d in dets(rk))} detections, max |diff| {worst:.3e}); against the float "
        f"model: counts {[len(r) for r in rk]} vs {[len(r) for r in f32]}; bf16 {len(frames) / wb:.1f} frames/s ({len(frames)} frames, one "
        f"predict), {sum(len(r) for r in rb)} detections; launches in the f32 kernel run {launches}")

    with tempfile.TemporaryDirectory() as tmp:
        YOLO(str(WEIGHTS)).predict(frames[0], visualize=True, project=tmp, name="vis", **{**kw, "batch": 1})
        files = sorted(p.name for p in (Path(tmp) / "vis").iterdir())
    n_npy = sum(f.endswith(".npy") for f in files)
    if n_npy != 25:  # every layer of best.npz's 26 but the head
        raise AssertionError(f"[predict visualize] {n_npy} feature arrays: {files}")
    log("predict visualize", card, f"{len(files)} files: {n_npy} .npy and {len(files) - n_npy} .png (matplotlib {'present' if len(files) > n_npy else 'absent'})")

    seen = []

    class Catch(logging.Handler):
        def emit(self, record):
            seen.append(record.getMessage())

    h = Catch(level=logging.WARNING)
    LOGGER.addHandler(h)
    try:
        with environ(DISPLAY="", WAYLAND_DISPLAY=""):
            ys = YOLO(str(WEIGHTS))
            with contextlib.redirect_stdout(io.StringIO()):
                shown = ys.predict(frames[:4], show=True, **{**kw, "batch": 4})
                ys.predict(frames[:4], show=True, **{**kw, "batch": 4})
    finally:
        LOGGER.removeHandler(h)
    plain_run = YOLO(str(WEIGHTS)).predict(frames[:4], **{**kw, "batch": 4})
    if len(seen) != 1 or ys.predictor.args.show or [r.boxes.data.tolist() for r in shown] != [r.boxes.data.tolist() for r in plain_run]:
        raise AssertionError(f"[predict show] warnings {seen}, show {ys.predictor.args.show}")
    log("predict show", card, f"headless (DISPLAY and WAYLAND_DISPLAY empty, was {os.environ.get('DISPLAY')!r}): one warning "
        f"({seen[0]!r}), show turned off, the Results of show=False")


# `train(batch=-1)` at 640: one epoch, no validation; the split holds 256 images, so a pick up to 256
# trains in full batches (the loader resizes the small frames to 640)
AUTOBATCH_RUN = dict(batch=-1, epochs=1, imgsz=640, amp=True, val=False, plots=False, workers=8, close_mosaic=0, exist_ok=True)
AUTOBATCH_IMAGES = 256


def autobatch_split(root: Path) -> Path:
    """256 seeded 160x128 IR frames with their labels under root/images/train and 4 under images/val → the yaml."""
    write_split(root, AUTOBATCH_IMAGES, 5, w=160, h=128, split="train")
    return write_split(root, 4, 6, w=160, h=128)


def _peak_after_search():
    """A DetectionTrainer that empties the cache and restarts the peak count once autobatch has picked (its
    failed probe peaks near the card's memory), so the run's peak is the training's own."""
    import torch

    from yolo_tpu_torch.engine.trainer import DetectionTrainer

    class PeakAfterSearch(DetectionTrainer):
        def _autobatch(self, trainset):
            b = super()._autobatch(trainset)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            return b

    return PeakAfterSearch


def train_settings_phase(data, run_dir, card):
    """`[train settings]`: one epoch (4 steps of 16, no validation) of the recipe from yolov8-small.yaml with
    each of the trainer's last settings: the default, remat (peak memory beside the default's), and
    multi_scale with cache='ram', mosaic 1.0 with mosaic_n = 9 and cutmix 0.5: finite losses, device ms a
    step, peak memory. Then `train(batch=-1)` at 640 on a 256-image split: autobatch's pick (the trainer's
    own step as its probe, at least 16 and at most the split) and one epoch of full batches at it."""
    import numpy as np
    import torch

    from yolo_tpu_torch import YOLO
    from yolo_tpu_torch.data import augment as PA

    base_kw = {**TRAIN_RECIPE, "epochs": 1, "close_mosaic": 0, "val": False, "plots": False}
    runs = {"default": {}, "remat": dict(remat=True),
            "multi_scale + RAM cache + mosaic9 + cutmix": dict(multi_scale=True, cache="ram", mosaic=1.0, cutmix=0.5),
            "batch=-1": None}
    peaks = {}
    for name, kw in runs.items():
        y = YOLO("yolov8-small.yaml")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        PA.TrainTransforms.mosaic_n = 9 if "mosaic9" in name else 4
        try:
            t0 = time.perf_counter()
            if kw is None:
                y.train(data=str(autobatch_split(run_dir / "autobatch_split")), trainer=_peak_after_search(), project=str(run_dir),
                        name="settings_auto", **AUTOBATCH_RUN)
            else:
                y.train(data=str(data), project=str(run_dir), name=f"settings_{len(peaks)}", exist_ok=True, **{**base_kw, **kw})
            wall = time.perf_counter() - t0
        finally:
            PA.TrainTransforms.mosaic_n = 4
        t = y.trainer
        peaks[name] = (torch.cuda.max_memory_allocated() - base) / 2**30
        row = t._last_row
        losses = [row[f"train/{k}_loss"] for k in ("box", "cls", "dfl")]
        if not all(np.isfinite(losses)):
            raise AssertionError(f"[train settings] {name}: losses {losses}")
        if kw is None and not (16 <= t.args.batch <= AUTOBATCH_IMAGES and len(t.timings) == len(t.train_loader) >= 1):
            raise AssertionError(f"[train settings] batch=-1 picked {t.args.batch}, {len(t.timings)} steps")
        steps = t.timings[1:]
        step_ms = sum(s["forward"] + s["backward"] + s["optimizer"] for s in steps) / max(len(steps), 1)
        log("train settings", card, f"{name}: {len(t.timings)} steps of {t.args.batch}, losses box/cls/dfl "
            + "/".join(f"{v:.4f}" for v in losses) + f"; epoch {t.epoch_time:.2f} s, the .train call {wall:.1f} s; device per step after "
            f"the first {step_ms:.1f} ms (events); peak memory {peaks[name]:.2f} GiB")
    log("train settings", card, f"remat peak memory {peaks['remat']:.2f} GiB against the default's {peaks['default']:.2f} GiB "
        f"({peaks['remat'] / peaks['default']:.2f}x); batch=-1 at 640 trained at its pick, peak {peaks['batch=-1']:.2f} GiB after the "
        f"search (the probes' peaks in the autobatch lines above) of "
        f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.1f}")


TUNE_SET = (32, 30_000)  # `[tune]`: frames and seed of its split (the same frames as train and val)
TUNE_RUN = dict(iterations=2, epochs=1, imgsz=640, batch=16, workers=8, plots=False)


def tune_phase(root: Path, card):
    """`[tune]`: YOLO("yolov8-small.yaml").tune(TUNE_RUN) on a seeded 32-frame 640x512 split (write_split,
    its frames both the train and the val split): each iteration a fresh model trained one epoch in bf16
    and validated (kernels 1, 2, 3 and 5 on the card); the fitness of both iterations, the CSV's columns,
    the seconds of the whole call and of each training's loop, best_hyperparameters.yaml and best.npz written."""
    import csv

    import numpy as np

    from yolo_tpu_torch import YOLO

    write_split(root, *TUNE_SET, split="train")
    data = write_split(root, *TUNE_SET, split="val")
    t0 = time.perf_counter()
    best, launches = counted({"c2f", "c2f_upconcat", "head_level", "nms_keep"}, lambda: YOLO("yolov8-small.yaml").tune(
        data=str(data), project=str(root / "runs"), **TUNE_RUN))
    wall = time.perf_counter() - t0
    tune_dir = root / "runs" / "tune"

    def csv_rows(path):
        with open(path) as f:
            return list(csv.DictReader(f))

    rows = csv_rows(tune_dir / "tune_results.csv")
    spent = [float(csv_rows(tune_dir / f"iter{r['iteration']}" / "results.csv")[-1]["time"]) for r in rows]
    if len(rows) != TUNE_RUN["iterations"] or not all(np.isfinite(float(r["fitness"])) for r in rows) \
            or not (tune_dir / "best_hyperparameters.yaml").exists() or not (tune_dir / "best.npz").exists():
        raise AssertionError(f"tune: rows {rows}, files {sorted(p.name for p in tune_dir.iterdir())}")
    log("tune", card, f"{len(rows)} iterations in {wall:.1f} s (each training's loop {', '.join(f'{t:.1f}' for t in spent)} s, "
        f"results.csv): fitness "
        + ", ".join(f"iter {r['iteration']} {float(r['fitness']):.4f}" for r in rows) + f"; best iteration {best['best_iteration']}; "
        f"CSV columns {list(rows[0])}; launches {launches}")


def coco_annotations(data) -> Path:
    """annotations/instances_val2017.json beside a write_split dataset, from its val labels: image ids
    the numeric file stems, boxes (ltwh) in the 640x512 frames' pixels, category 0 → the file."""
    root = Path(data).parent
    images, anns = [], []
    for f in sorted((root / "labels" / "val").glob("*.txt"), key=lambda f: int(f.stem)):
        images.append({"id": int(f.stem), "width": HW[1], "height": HW[0]})
        for line in f.read_text().splitlines():
            c, x, y, w, h = (float(v) for v in line.split())
            box = [(x - w / 2) * HW[1], (y - h / 2) * HW[0], w * HW[1], h * HW[0]]
            anns.append({"id": len(anns), "image_id": int(f.stem), "category_id": int(c), "iscrowd": 0, "bbox": box,
                         "area": box[2] * box[3]})
    out = root / "annotations" / "instances_val2017.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps({"images": images, "annotations": anns, "categories": [{"id": 0, "name": "aircraft"}]}))
    return out


def val_coco_phase(data, run_dir: Path, card):
    """`[val coco]`: `[val]`'s 512-frame split with annotations/instances_val2017.json written from its labels,
    YOLO(best.npz).val(save_json=True) at imgsz 640, batch 32, f32 (the kernels): predictions.json holds as
    many rows as the validator kept detections; the coco/* keys beside the validator's mAP50 / mAP50-95, each
    equal to the port's coco_evaluate rerun on the written files; the seconds of each. The annotations file
    is removed afterwards."""
    from yolo_tpu_torch.utils.coco_eval import coco_evaluate

    anno = coco_annotations(data)
    try:
        t0 = time.perf_counter()
        (res, v), launches = counted({"c2f", "c2f_upconcat", "head_level", "nms_keep"}, lambda: val_run(
            data, batch=32, save_json=True, project=str(run_dir), exist_ok=True))
        wall = time.perf_counter() - t0
        written = run_dir / "val" / "predictions.json"
        rows = json.loads(written.read_text())
        kept = sum(int((o[..., 6] > 0).sum()) for o in v.outs)
        t1 = time.perf_counter()
        again = coco_evaluate(str(anno), str(written))
        t_coco = time.perf_counter() - t1
    finally:
        anno.unlink()
    coco = {k: res[k] for k in res if k.startswith("coco/")}
    if len(rows) != kept or not coco or coco != {f"coco/{k}": x for k, x in again.items()}:
        raise AssertionError(f"val coco: {len(rows)} json rows for {kept} kept detections; coco keys {coco} vs rerun {again}")
    log("val coco", card, f"{len(rows)} json rows = the validator's kept detections; validator mAP50 {res['mAP50']:.4f} mAP50-95 "
        f"{res['mAP50-95']:.4f}; COCOeval " + " ".join(f"{k[5:]} {x:.4f}" for k, x in coco.items()) + f" (equal to the rerun on the "
        f"written files, {t_coco:.1f} s); the .val call {wall:.1f} s; launches {launches}")


CLS_SHAPES = ("bright_circle", "bright_triangle", "dark_bar", "dark_square")
CLS_TRAIN, CLS_VAL = (512, 0), (128, 1)  # `[classify]`'s folder dataset: images and seed of each split
# 3 epochs of the 512 images at batch 8, lr0 1e-3 (the cfg's 0.01 otherwise), bf16, RandAugment and erasing off as
# tests/test_classify.py trains its toy set. At batch 32 the 48 steps leave the BN running moments (momentum 0.03)
# 23% at their initial values, and validation (eval mode) read top1 0.25-0.75 in CPU rehearsals at lr0 1e-3 and 0.01
CLS_RUN = dict(epochs=3, imgsz=224, batch=8, lr0=1e-3, amp=True, auto_augment="", erasing=0.0, plots=False, exist_ok=True)


def write_cls_split(root: Path, n: int, seed: int, imgsz: int = 224, split: str = "train") -> Path:
    """n seeded imgsz x imgsz images under root/<split>/<class>/, the classes in turn, drawn like
    tests/test_classify.py's toy set (a noisy grey field, one filled shape) with four separable
    shapes at a random place and size: a bright circle or triangle, a dark bar or square → root."""
    import cv2
    import numpy as np

    rng = np.random.default_rng(seed)
    s = imgsz / 64
    for k in range(n):
        cname = CLS_SHAPES[k % len(CLS_SHAPES)]
        d = root / split / cname
        d.mkdir(parents=True, exist_ok=True)
        img = rng.normal(120, 10, (imgsz, imgsz, 3)).clip(0, 255).astype(np.uint8)
        (x, y), r = (int(v) for v in rng.uniform(24, 40, 2) * s), int(rng.uniform(12, 18) * s)
        if cname == "dark_square":
            cv2.rectangle(img, (x - r, y - r), (x + r, y + r), (10, 10, 10), -1)
        elif cname == "dark_bar":
            cv2.rectangle(img, (x - r, y - r // 4), (x + r, y + r // 4), (10, 10, 10), -1)
        elif cname == "bright_circle":
            cv2.circle(img, (x, y), r, (250, 250, 250), -1)
        else:
            cv2.fillPoly(img, [np.array([[x, y - r], [x - r, y + r], [x + r, y + r]], np.int32)], (250, 250, 250))
        cv2.imwrite(str(d / f"{k}.png"), img)
    return root


def classify_c2f_holds(y, frames, card):
    """The C2f kernel against its twin at yolov8n-cls's four instances (c = 16, 32, 64, 128 on 56², 28², 14²
    and 7² maps at 224), captured from the model's own forward of the frames resized to 224, in f32 and bf16,
    at B = 1 and 32, with each instance's plan."""
    import cv2
    import numpy as np
    import torch

    from yolo_tpu_torch.nn.tasks import install_params
    from yolo_tpu_torch.ops import cuda_c2f

    x224 = np.stack([cv2.resize(f, (224, 224), interpolation=cv2.INTER_LINEAR) for f in frames[:32]])
    plain = cuda_c2f.c2f_plain
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        install_params(y.model, y.params, y.device, dtype)
        for B in (1, 32):
            rec = []
            cuda_c2f.c2f_plain = lambda x, kw, shortcut: (rec.append((x, kw, shortcut)), plain(x, kw, shortcut))[1]
            try:
                y.model.predict(torch.from_numpy(x224[:B]).to(y.device).flip(-1).to(dtype) / 255.0, plain=True)
            finally:
                cuda_c2f.c2f_plain = plain
            if len(rec) != 4:
                raise AssertionError(f"classify: {len(rec)} C2f instances captured, expected 4")
            for x, kw, shortcut in rec:
                got, want = cuda_c2f.fused_c2f(x, kw, shortcut), plain(x, kw, shortcut)
                torch.cuda.synchronize()
                _, H, W, c1 = x.shape
                desc = f"B={B} {H}x{W} {c1}->{kw.w2.shape[1]} c={kw.c} n={kw.n}{' shortcut' if shortcut else ''}"
                errs = hold("c2f", f"classify {desc}", dn, got, want)
                log(f"classify c2f {dn}", card, f"{desc:36s} max_abs_err={max(errs.values()):.3e} "
                    f"{c2f_plan_text(B, H, W, c1, 0, kw, dtype)}")


def classify_phase(clip, root: Path, card):
    """`[classify]`: yolov8n-cls at full width (scale n, nc 1000, the JAX package's initial tree), imgsz 224.
    64 frames of the clip as BGR through `predict`, one per call (a square resize, softmax probabilities,
    no NMS): f32 through the C2f kernel against the twin (probabilities 1e-4, top-1 equal), then bf16,
    frames/s; the C2f kernel held against its twin at the model's four instances (`classify_c2f_holds`).
    Then a seeded 4-class folder dataset (write_cls_split: 512 train and 128 val images at 224) trained
    with CLS_RUN (bf16, batch 8, lr0 1e-3; RandAugment and erasing off, as tests/test_classify.py trains
    its toy set): per-epoch loss, top1 / top5 of each epoch's f32 validation, images/s over the whole train call,
    peak memory; top1 >= 0.9 required. `val` of the trained model on the val split, f32 through the
    kernel against the twin (equal metrics). Kernel 1's launches in each run (the only kernel there)."""
    import numpy as np
    import torch

    from yolo_tpu_torch import YOLO

    frames = np.repeat(clip[:PREDICT_FRAMES], 3, -1)
    y = YOLO("yolov8n-cls.yaml")
    if (y.task, y.model.nc, y.model.stride) != ("classify", 1000, [1]):
        raise AssertionError(f"classify: task {y.task}, nc {y.model.nc}, stride {y.model.stride}")

    def probs(half, plain):
        return lambda f: y.predict(f, imgsz=224, half=half, plain=plain, compute_dtype=compute_dtype(half), verbose=False)[0].probs.data

    probs(False, False)(frames[0])  # warm-up
    (pk, wk), launches_f32 = counted({"c2f"}, lambda: timed_frames(probs(False, False), frames))
    pp, wp = timed_frames(probs(False, True), frames)
    diff = max(float(np.abs(a - b).max()) for a, b in zip(pk, pp))
    top1 = sum(int(a.argmax() == b.argmax()) for a, b in zip(pk, pp))
    if diff > 1e-4 or top1 != PREDICT_FRAMES or pk[0].shape != (1000,) or not all(np.isfinite(a).all() for a in pk):
        raise AssertionError(f"classify predict f32: kernels vs twins differ by {diff}, top-1 equal on {top1}/{PREDICT_FRAMES}")
    log("classify predict f32", card, f"{PREDICT_FRAMES} frames, one per call: kernels {PREDICT_FRAMES / wk:.1f} frames/s, twins "
        f"{PREDICT_FRAMES / wp:.1f}; probabilities max |diff| {diff:.3e} (gate 1e-4), top-1 equal on every frame; launches {launches_f32}")
    probs(True, False)(frames[0])
    (pb, wb), launches = counted({"c2f"}, lambda: timed_frames(probs(True, False), frames))
    same = sum(int(a.argmax() == b.argmax()) for a, b in zip(pb, pk))
    log("classify predict bf16", card, f"{PREDICT_FRAMES} frames in {wb:.3f} s = {PREDICT_FRAMES / wb:.1f} frames/s (host clock, one "
        f"frame per predict call); top-1 equal to f32 on {same}/{PREDICT_FRAMES}; launches {launches}")
    classify_c2f_holds(y, frames, card)

    t0 = time.perf_counter()
    write_cls_split(root, *CLS_TRAIN)
    write_cls_split(root, *CLS_VAL, split="val")
    print(f"[classify split] {CLS_TRAIN[0]} train + {CLS_VAL[0]} val images of 224x224, {len(CLS_SHAPES)} classes, written in "
          f"{time.perf_counter() - t0:.1f} s")
    yt = YOLO("yolov8n-cls.yaml")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    metrics, launches = counted({"c2f"}, lambda: yt.train(data=str(root), project=str(root / "runs"), name="train", **CLS_RUN))
    wall = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    losses = yt.trainer.losses
    if not all(np.isfinite(losses)) or metrics["top1"] < 0.9 or yt.model.nc != len(CLS_SHAPES):
        raise AssertionError(f"classify train: losses {losses}, metrics {metrics}, nc {yt.model.nc}")
    n = CLS_RUN["epochs"] * CLS_TRAIN[0]
    log("classify train", card, f"{CLS_RUN['epochs']} epochs of {CLS_TRAIN[0]} images at batch {CLS_RUN['batch']}, bf16: losses "
        f"{', '.join(f'{x:.4f}' for x in losses)}; best top1 {metrics['top1']:.4f} top5 {metrics['top5']:.4f}; {n / wall:.1f} "
        f"images/s over the whole .train call ({wall:.1f} s: loading and augmenting on the host, the steps, each epoch's f32 "
        f"validation of {CLS_VAL[0]} images); peak memory {peak:.2f} GiB (max_memory_allocated, over the {base / 2**30:.2f} GiB "
        f"held before); launches {launches}")
    vk, launches = counted({"c2f"}, lambda: yt.val(data=str(root), imgsz=224, batch=32))
    vp = yt.val(data=str(root), imgsz=224, batch=32, plain=True)
    if {k: float(x) for k, x in vk.items()} != {k: float(x) for k, x in vp.items()} or vk["top1"] < 0.9:
        raise AssertionError(f"classify val: kernels {vk} vs twins {vp}")
    log("classify val", card, f"{CLS_VAL[0]} images, f32: top1 {vk['top1']:.4f} top5 {vk['top5']:.4f} fitness {vk['fitness']:.4f}, "
        f"equal through the twin; launches {launches}")


# ------------------------------------------------------------------------ the segment task --

SEG_TRAIN, SEG_VAL = (256, 40_000), (64, 40_001)  # `[segment ...]`'s polygon splits: frames and seed
SEG_PATH = {"c2f", "c2f_upconcat", "head_level", "nms_keep"}
# yolov8n-seg from the JAX package's init(0), rebuilt at nc 1: the IR recipe's optimizer, lr0 and batch at 640 in bf16,
# 3 epochs (close_mosaic 1), the cfg's augmentations otherwise
SEG_RUN = dict(epochs=3, batch=16, imgsz=640, optimizer="AdamW", lr0=8e-4, amp=True, workers=8, seed=0, close_mosaic=1,
               plots=False, exist_ok=True)
# `[segment predict]`: each frame's ten best detections (a 3-epoch model's scores sit near 0.01, its box mAP50 near 0.07)
SEG_PREDICT = dict(conf=0.001, max_det=10)


def write_seg_split(root: Path, n: int, seed: int, split: str, w: int = 640, h: int = 512) -> Path:
    """n seeded 640x512 IR-like frames (a cloudy background) written as BGR PNGs under root/images/<split>,
    each with 1-4 bright filled ellipses (radii 12-60 px; about a third placed over the one before, so
    instances overlap), their 30-point polygons as YOLO segment labels under root/labels/<split>, nc 1 →
    the dataset yaml, which names every split written under root."""
    import cv2
    import numpy as np

    rng = np.random.default_rng(seed)
    (root / f"images/{split}").mkdir(parents=True, exist_ok=True)
    (root / f"labels/{split}").mkdir(parents=True, exist_ok=True)
    for i in range(n):
        img = cv2.resize(rng.normal(30, 10, (h // 16, w // 16)).astype(np.float32), (w, h), interpolation=cv2.INTER_CUBIC)
        img += rng.normal(0, 2, (h, w))
        lines, prev = [], None
        for _ in range(rng.integers(1, 5)):
            ax, ay = (int(v) for v in rng.uniform(12, 60, 2))
            if prev is not None and rng.uniform() < 0.35:
                cx, cy = (int(v) for v in np.clip(prev + rng.uniform(-40, 40, 2), [ax, ay], [w - ax, h - ay]))
            else:
                cx, cy = int(rng.uniform(ax, w - ax)), int(rng.uniform(ay, h - ay))
            pts = cv2.ellipse2Poly((cx, cy), (ax, ay), int(rng.uniform(0, 180)), 0, 360, 12)[:-1]
            cv2.fillPoly(img, [pts], float(rng.uniform(140, 220)))
            lines.append("0 " + " ".join(f"{x / w:.6f} {y / h:.6f}" for x, y in pts))
            prev = np.array([cx, cy], np.float64)
        gray = np.clip(img, 0, 255).astype(np.uint8)
        cv2.imwrite(str(root / f"images/{split}/{i}.png"), cv2.cvtColor(gray, cv2.COLOR_GRAY2BGR))
        (root / f"labels/{split}/{i}.txt").write_text("\n".join(lines) + "\n")
    splits = "".join(f"{s.name}: images/{s.name}\n" for s in sorted((root / "images").iterdir()))
    (root / "data.yaml").write_text(f"path: {root}\n{splits}names:\n  0: target\n")
    return root / "data.yaml"


def segment_train_phase(data, run_dir, card):
    """`[segment train]`: YOLO("yolov8n-seg.yaml").train with SEG_RUN on the 256-frame polygon split, validating
    on the 64 held-out frames each epoch: per epoch the four loss components and the box and mask metrics; images/s
    over the whole .train call; peak memory; the launches of check_amp and the validations → the trained YOLO."""
    import numpy as np
    import torch

    from yolo_tpu_torch import YOLO

    epochs = []
    y = YOLO("yolov8n-seg.yaml")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    metrics, launches = counted(SEG_PATH, lambda: y.train(trainer=train_epoch_recorder(epochs), data=str(data),
                                                          project=str(run_dir), name="segment", **SEG_RUN))
    wall = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    if y.task != "segment" or y.model.nc != 1 or not y.trainer.args.amp or metrics is None:
        raise AssertionError(f"segment train: task {y.task}, nc {y.model.nc}, amp {y.trainer.args.amp}, metrics {metrics}")
    for e in epochs:
        r = e["row"]
        losses = [r[f"train/{k}_loss"] for k in ("box", "seg", "cls", "dfl")]
        if not all(np.isfinite(losses)) or min(losses) <= 0:
            raise AssertionError(f"segment train: epoch {r['epoch']} losses {losses}")
        log("segment train", card, f"epoch {r['epoch'] + 1}/{SEG_RUN['epochs']}: box {losses[0]:.4f} seg {losses[1]:.4f} cls "
            f"{losses[2]:.4f} dfl {losses[3]:.4f}; box mAP50 {r['metrics/mAP50']:.4f} mAP50-95 {r['metrics/mAP50-95']:.4f}, mask mAP50 "
            f"{r['metrics/mask_mAP50']:.4f} mAP50-95 {r['metrics/mask_mAP50-95']:.4f}; epoch {e['epoch_s']:.2f} s, val {e['val_s']:.2f} s")
    n = SEG_RUN["epochs"] * SEG_TRAIN[0]
    steps = [t for e in epochs for t in e["timings"][1:]]
    mean = {k: sum(t[k] for t in steps) / len(steps) for k in ("loader", "forward", "backward", "optimizer")}
    log("segment train", card, f"{SEG_RUN['epochs']} epochs of {SEG_TRAIN[0]} frames at batch {SEG_RUN['batch']}, 640, bf16: "
        f"{n / wall:.1f} images/s over the whole .train call ({wall:.1f} s: check_amp, the loader, the steps, each epoch's f32 "
        f"validation of {SEG_VAL[0]} frames); per step after each epoch's first: loader wait {mean['loader']:.2f} ms (host), "
        f"forward+loss {mean['forward']:.2f} ms, backward {mean['backward']:.2f} ms, optimizer+BN+EMA {mean['optimizer']:.2f} ms "
        f"(events); peak memory {peak:.2f} GiB (max_memory_allocated, over the {base / 2**30:.2f} GiB held before); launches {launches}")
    return y


def segment_val_kernels_phase(y, data, card):
    """`[segment val kernels]`: the trained model on the held-out split, f32 through the kernels against f32
    through the twins (every box and mask key within 1e-4), then bf16 images/s over a warmed .val call."""
    path = SEG_PATH
    rk, launches = counted(path, lambda: y.val(data=str(data), imgsz=640, batch=16, plots=False))
    rp = y.val(data=str(data), imgsz=640, batch=16, plots=False, plain=True)
    diff = {k: abs(rk[k] - rp[k]) for k in rk}
    if set(rk) != set(rp) or max(diff.values()) > 1e-4 or "mask_mAP50-95" not in rk:
        raise AssertionError(f"segment val: kernels {rk} vs twins {rp}")
    log("segment val kernels", card, "f32 kernels: " + ", ".join(f"{k} {v:.4f}" for k, v in rk.items())
        + f"; every key within {max(diff.values()):.2e} of the twins'; launches {launches}")
    y.val(data=str(data), imgsz=640, batch=16, plots=False, half=True)  # warm: bf16 weights and plans
    t0 = time.perf_counter()
    rb, launches = counted(path, lambda: y.val(data=str(data), imgsz=640, batch=16, plots=False, half=True))
    wall = time.perf_counter() - t0
    log("segment val bf16", card, f"{SEG_VAL[0]} frames in {wall:.2f} s = {SEG_VAL[0] / wall:.1f} images/s (host clock, the .val "
        f"call); box mAP50-95 {rb['mAP50-95']:.4f} (f32 {rk['mAP50-95']:.4f}), mask mAP50-95 {rb['mask_mAP50-95']:.4f} "
        f"(f32 {rk['mask_mAP50-95']:.4f}); launches {launches}")


def _mask_iou(a, b) -> float:
    inter, union = (a & b).sum(), (a | b).sum()
    return 1.0 if union == 0 else float(inter / union)


def segment_predict_phase(y, frames, card):
    """`[segment predict]`: the trained model over held-out BGR frames, one per predict call, at SEG_PREDICT's
    conf and max_det, f32 through the kernels against f32 through the twins: equal detection counts, boxes within
    1e-2 px, conf within 1e-4, every mask's IoU with the twin's at least 0.99; with retina_masks off and on. Then
    bf16 frames/s (host clock) with the host split: the predict call and, inside it, the masks' upsampling."""
    import numpy as np

    def run(half, plain, retina):
        out = []
        for f in frames:
            r = y.predict(f, half=half, plain=plain, compute_dtype=compute_dtype(half), retina_masks=retina, verbose=False,
                          **SEG_PREDICT)[0]
            out.append((r.boxes.data.copy(), r.masks.data.copy()))
        return out

    for retina in (False, True):
        run(False, False, retina)  # warm-up
        pk, launches = counted(SEG_PATH, lambda: run(False, False, retina))
        pp = run(False, True, retina)
        n_det, worst_box, worst_conf, worst_iou = 0, 0.0, 0.0, 1.0
        for (bk, mk), (bp, mp) in zip(pk, pp):
            if bk.shape != bp.shape or mk.shape != mp.shape:
                raise AssertionError(f"segment predict retina={retina}: {bk.shape} / {mk.shape} vs twins {bp.shape} / {mp.shape}")
            if len(bk):
                worst_box = max(worst_box, float(np.abs(bk[:, :4] - bp[:, :4]).max()))
                worst_conf = max(worst_conf, float(np.abs(bk[:, 4] - bp[:, 4]).max()))
                worst_iou = min(worst_iou, *(_mask_iou(a, b) for a, b in zip(mk, mp)))
            n_det += len(bk)
        if n_det == 0 or worst_box > 1e-2 or worst_conf > 1e-4 or worst_iou < 0.99:
            raise AssertionError(f"segment predict retina={retina}: {n_det} detections, |box| {worst_box}, |conf| {worst_conf}, "
                                 f"mask IoU {worst_iou}")
        confs = np.concatenate([b[:, 4] for b, _ in pk])
        areas = np.concatenate([m.sum((1, 2)) for _, m in pk])
        log("segment predict f32", card, f"retina_masks={retina}: {len(frames)} frames, {n_det} detections equal to the twins' "
            f"(max |box| {worst_box:.3e} px, |conf| {worst_conf:.3e}, least mask IoU {worst_iou:.6f}), masks {pk[0][1].shape[1:]} "
            f"a frame; conf {confs.min():.4f}-{confs.max():.4f}, mask areas {int(areas.min())}-{int(areas.max())} px; "
            f"launches {launches}")
    y.predictor.timings = []
    y.predict(frames[0], half=True, compute_dtype="bfloat16", verbose=False, **SEG_PREDICT)  # warm: bf16 weights
    y.predictor.timings = []
    t0 = time.perf_counter()
    _, launches = counted(SEG_PATH, lambda: run(True, False, False))
    wall = time.perf_counter() - t0
    ts = y.predictor.timings
    y.predictor.timings = None
    call = sum(t["pre_s"] + t["enqueue_s"] + t["wait_s"] + t["post_s"] for t in ts) / len(ts) * 1e3
    up = sum(t.get("masks_s", 0.0) for t in ts) / len(ts) * 1e3
    log("segment predict bf16", card, f"{len(frames)} frames in {wall:.3f} s = {len(frames) / wall:.1f} frames/s (host clock, one "
        f"frame per predict call); host ms/frame: letterbox + upload + forward + NMS + masks + copy-back + Results {call:.3f}, of "
        f"which the masks' upsampling (cv2, valid masks only) {up:.3f}; launches {launches}")


def segment_forward_phase(frames, card):
    """`[segment forward]`: yolov8n-seg at full width (nc 80, the JAX package's init(0)) at 640x640, B = 8 and 32, f32
    through the kernels against the twins: boxes within 1e-2 px, scores 1e-4, mask coefficients and prototypes 1e-3;
    kernels 1, 2, 3 and 5 held against their twins on those activations (`hold_path_kernels`); NMS with the
    coefficients as extra columns, kernel against twin: equal kept slots, extras equal for the same slots. NMS runs
    at conf 0, since the initial tree's scores sit near 1e-3: every anchor is a candidate, K = 1024."""
    import torch

    from yolo_tpu_torch.nn.tasks import SegmentationModel, params_from_jax
    from yolo_tpu_torch.ops.nms import non_max_suppression

    m = SegmentationModel("yolov8n-seg.yaml")
    params_from_jax(m, m.init(0), torch.float32)
    x32 = torch.cat([letterboxed(frames[i % len(frames)]) for i in range(32)])

    def forward_nms(x, plain):
        preds, protos = m.predict(x, plain=plain)
        return preds, protos, non_max_suppression(preds, conf_thres=0.0, iou_thres=0.7, max_det=300, nc=m.nc, plain=plain)

    for B in (8, 32):
        x = x32[:B]
        (pk, prk, ok), launches = counted(SEG_PATH, lambda: forward_nms(x, False))
        pp, prp, op = forward_nms(x, True)
        torch.cuda.synchronize()
        err = {"box": float((pk[:, :4] - pp[:, :4]).abs().max()), "score": float((pk[:, 4:84] - pp[:, 4:84]).abs().max()),
               "coef": float((pk[:, 84:] - pp[:, 84:]).abs().max()), "proto": float((prk - prp).abs().max())}
        same = bool(torch.equal(ok["valid"], op["valid"]))
        ex = float((ok["extra"] - op["extra"]).abs().max())
        if (pk.shape != (B, 116, 8400) or prk.shape != (B, 160, 160, 32) or not torch.isfinite(pk).all() or err["box"] > 1e-2
                or err["score"] > 1e-4 or err["coef"] > 1e-3 or err["proto"] > 1e-3 or not same or ex > 1e-3):
            raise AssertionError(f"segment forward B={B}: {err}, NMS valid equal {same}, extras {ex}, {tuple(pk.shape)}, {tuple(prk.shape)}")
        log("segment forward", card, f"B={B} 640x640: preds {tuple(pk.shape)}, protos {tuple(prk.shape)}; kernels against twins max "
            + ", ".join(f"|{k}| {v:.3e}" for k, v in err.items()) + f"; NMS {int(ok['valid'].sum())} kept slots equal, extras "
            f"within {ex:.3e}; launches {launches}")
        hold_path_kernels([m], x, f"segment forward B={B}", card, conf=0.0, iou=0.7)


def segment_phases(root: Path, card):
    """The segment task's four phases on the polygon splits written under `root` → (the trained YOLO, the val
    frames), which `[pose track]` tracks with."""
    import cv2
    import numpy as np

    t0 = time.perf_counter()
    write_seg_split(root, *SEG_TRAIN, split="train")
    data = write_seg_split(root, *SEG_VAL, split="val")
    print(f"[segment split] {SEG_TRAIN[0]} train + {SEG_VAL[0]} val frames of 640x512 with polygon labels written in "
          f"{time.perf_counter() - t0:.1f} s")
    y = segment_train_phase(data, root / "runs", card)
    train_step_f32_phase(data, card, cfg_name="yolov8n-seg.yaml", tag="segment train step f32", recipe=SEG_RUN)
    segment_val_kernels_phase(y, data, card)
    frames = [cv2.imread(str(root / f"images/val/{i}.png")) for i in range(SEG_VAL[0])]
    segment_predict_phase(y, frames, card)
    segment_forward_phase(np.stack(frames), card)
    return y, frames


POSE_PATH = {"c2f", "c2f_upconcat", "head_level", "nms_keep"}
POSE_TRAIN, POSE_VAL = (256, 50_000), (64, 50_001)  # `[pose ...]`'s keypoint splits: frames and seed
# yolov8n-pose from the JAX package's init(0) (nc 1, COCO's 17 keypoints): the IR recipe's optimizer, lr0 and batch
# at 640 in bf16, 3 epochs (close_mosaic 1), the cfg's augmentations otherwise
POSE_RUN = dict(epochs=3, batch=16, imgsz=640, optimizer="AdamW", lr0=8e-4, amp=True, workers=8, seed=0, close_mosaic=1,
                plots=False, exist_ok=True)
# `[pose predict]`, `[pose track]`: each frame's ten best detections (a 3-epoch model's scores are low, as
# `[segment predict]`'s; conf 0 keeps ten a frame however low)
POSE_PREDICT = dict(conf=0.0, max_det=10)
# COCO's 17 keypoints in coco8-pose.yaml's order (nose, eyes, ears, shoulders, elbows, wrists, hips, knees, ankles;
# left before right) on a figure one unit tall, x to the figure's left, y down from its hips; and coco8-pose's flip_idx
POSE_TEMPLATE = ((0.0, -0.44), (0.025, -0.46), (-0.025, -0.46), (0.05, -0.45), (-0.05, -0.45), (0.11, -0.32), (-0.11, -0.32),
                 (0.16, -0.15), (-0.16, -0.15), (0.18, 0.0), (-0.18, 0.0), (0.07, 0.0), (-0.07, 0.0), (0.08, 0.25),
                 (-0.08, 0.25), (0.09, 0.5), (-0.09, 0.5))
POSE_FLIP_IDX = [0, 2, 1, 4, 3, 6, 5, 8, 7, 10, 9, 12, 11, 14, 13, 16, 15]
POSE_LIMBS = ((16, 14), (14, 12), (17, 15), (15, 13), (12, 13), (6, 12), (7, 13), (6, 7), (6, 8), (7, 9), (8, 10), (9, 11),
              (1, 6), (1, 7))  # 1-based pairs: COCO's skeleton below the face, the nose to each shoulder


def write_pose_split(root: Path, n: int, seed: int, split: str, w: int = 640, h: int = 512) -> Path:
    """n seeded 640x512 IR-like frames (a cloudy background) written as BGR PNGs under root/images/<split>, each with
    1-3 bright stick figures 90-240 px tall (limbs drawn between COCO's 17 keypoints, jittered, a head disc at the
    nose), their pose rows (`0 cx cy w h` then 17 × `x y v`, normalized; the box the keypoints' extent padded by 5% of
    the height) under root/labels/<split>: about 75% of the keypoints at visibility 2, 15% at 1 and 10% at 0 (x = y =
    0, COCO's unlabelled form), nc 1 → the dataset yaml, with kpt_shape [17, 3] and coco8-pose's flip_idx."""
    import cv2
    import numpy as np

    rng = np.random.default_rng(seed)
    (root / f"images/{split}").mkdir(parents=True, exist_ok=True)
    (root / f"labels/{split}").mkdir(parents=True, exist_ok=True)
    tpl = np.array(POSE_TEMPLATE, np.float64)
    for i in range(n):
        img = cv2.resize(rng.normal(30, 10, (h // 16, w // 16)).astype(np.float32), (w, h), interpolation=cv2.INTER_CUBIC)
        img += rng.normal(0, 2, (h, w))
        lines = []
        for _ in range(rng.integers(1, 4)):
            H = rng.uniform(90, 240)
            cx, cy = rng.uniform(0.25 * H, w - 0.25 * H), rng.uniform(0.55 * H, h - 0.55 * H)
            pts = (tpl + rng.normal(0, 0.02, tpl.shape)) * H * [rng.choice([-1, 1]) * rng.uniform(0.8, 1.1), 1.0] + [cx, cy]
            val = float(rng.uniform(140, 220))
            th = max(2, int(H / 30))
            for a, b in POSE_LIMBS:
                cv2.line(img, tuple(int(v) for v in pts[a - 1]), tuple(int(v) for v in pts[b - 1]), val, th, cv2.LINE_AA)
            cv2.circle(img, tuple(int(v) for v in pts[0]), int(H * 0.06), val, -1, cv2.LINE_AA)
            x1, y1 = np.clip(pts.min(0) - 0.05 * H, 0, [w, h])
            x2, y2 = np.clip(pts.max(0) + 0.05 * H, 0, [w, h])
            vis = rng.choice([2, 1, 0], 17, p=[0.75, 0.15, 0.10])
            kp = np.where(vis[:, None] > 0, pts / [w, h], 0.0)
            lines.append(f"0 {(x1 + x2) / 2 / w:.6f} {(y1 + y2) / 2 / h:.6f} {(x2 - x1) / w:.6f} {(y2 - y1) / h:.6f} "
                         + " ".join(f"{x:.6f} {y:.6f} {v}" for (x, y), v in zip(kp, vis)))
        gray = np.clip(img, 0, 255).astype(np.uint8)
        cv2.imwrite(str(root / f"images/{split}/{i}.png"), cv2.cvtColor(gray, cv2.COLOR_GRAY2BGR))
        (root / f"labels/{split}/{i}.txt").write_text("\n".join(lines) + "\n")
    splits = "".join(f"{s.name}: images/{s.name}\n" for s in sorted((root / "images").iterdir()))
    (root / "data.yaml").write_text(f"path: {root}\n{splits}kpt_shape: [17, 3]\nflip_idx: {POSE_FLIP_IDX}\n"
                                    "names:\n  0: person\n")
    return root / "data.yaml"


def pose_train_phase(data, run_dir, card):
    """`[pose train]`: YOLO("yolov8n-pose.yaml").train with POSE_RUN on the 256-frame keypoint split, validating on
    the 64 held-out frames each epoch: per epoch the five loss components and the box and pose metrics; images/s over
    the whole .train call; the step's split in events; peak memory; the launches of check_amp and the validations
    → the trained YOLO."""
    import numpy as np
    import torch

    from yolo_tpu_torch import YOLO

    epochs = []
    y = YOLO("yolov8n-pose.yaml")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    metrics, launches = counted(POSE_PATH, lambda: y.train(trainer=train_epoch_recorder(epochs), data=str(data),
                                                           project=str(run_dir), name="pose", **POSE_RUN))
    wall = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    if y.task != "pose" or y.model.head.kpt_shape != (17, 3) or not y.trainer.args.amp or metrics is None:
        raise AssertionError(f"pose train: task {y.task}, kpt_shape {y.model.head.kpt_shape}, amp {y.trainer.args.amp}, metrics {metrics}")
    names = ("box", "pose", "kobj", "cls", "dfl")
    for e in epochs:
        r = e["row"]
        losses = [r[f"train/{k}_loss"] for k in names]
        if not all(np.isfinite(losses)) or min(losses) <= 0:
            raise AssertionError(f"pose train: epoch {r['epoch']} losses {losses}")
        log("pose train", card, f"epoch {r['epoch'] + 1}/{POSE_RUN['epochs']}: " + " ".join(f"{k} {v:.4f}" for k, v in zip(names, losses))
            + f"; box mAP50 {r['metrics/mAP50']:.4f} mAP50-95 {r['metrics/mAP50-95']:.4f}, pose mAP50 {r['metrics/pose_mAP50']:.4f} "
            f"mAP50-95 {r['metrics/pose_mAP50-95']:.4f}; epoch {e['epoch_s']:.2f} s, val {e['val_s']:.2f} s")
    n = POSE_RUN["epochs"] * POSE_TRAIN[0]
    steps = [t for e in epochs for t in e["timings"][1:]]
    mean = {k: sum(t[k] for t in steps) / len(steps) for k in ("loader", "forward", "backward", "optimizer")}
    log("pose train", card, f"{POSE_RUN['epochs']} epochs of {POSE_TRAIN[0]} frames at batch {POSE_RUN['batch']}, 640, bf16: "
        f"{n / wall:.1f} images/s over the whole .train call ({wall:.1f} s: check_amp, the loader, the steps, each epoch's f32 "
        f"validation of {POSE_VAL[0]} frames); per step after each epoch's first: loader wait {mean['loader']:.2f} ms (host), "
        f"forward+loss {mean['forward']:.2f} ms, backward {mean['backward']:.2f} ms, optimizer+BN+EMA {mean['optimizer']:.2f} ms "
        f"(events; {sum(mean[k] for k in ('forward', 'backward', 'optimizer')):.2f} ms a step); peak memory {peak:.2f} GiB "
        f"(max_memory_allocated, over the {base / 2**30:.2f} GiB held before); launches {launches}")
    return y


def pose_val_kernels_phase(y, data, card):
    """`[pose val kernels]`: the trained model on the held-out split, f32 through the kernels against f32 through the
    twins (every box and `pose_` key within 1e-4), then bf16 images/s over a warmed .val call."""
    rk, launches = counted(POSE_PATH, lambda: y.val(data=str(data), imgsz=640, batch=16, plots=False))
    rp = y.val(data=str(data), imgsz=640, batch=16, plots=False, plain=True)
    diff = {k: abs(rk[k] - rp[k]) for k in rk}
    if set(rk) != set(rp) or max(diff.values()) > 1e-4 or "pose_mAP50-95" not in rk:
        raise AssertionError(f"pose val: kernels {rk} vs twins {rp}")
    log("pose val kernels", card, "f32 kernels: " + ", ".join(f"{k} {v:.4f}" for k, v in rk.items())
        + f"; every key within {max(diff.values()):.2e} of the twins'; launches {launches}")
    y.val(data=str(data), imgsz=640, batch=16, plots=False, half=True)  # warm: bf16 weights and plans
    t0 = time.perf_counter()
    rb, launches = counted(POSE_PATH, lambda: y.val(data=str(data), imgsz=640, batch=16, plots=False, half=True))
    wall = time.perf_counter() - t0
    log("pose val bf16", card, f"{POSE_VAL[0]} frames in {wall:.2f} s = {POSE_VAL[0] / wall:.1f} images/s (host clock, the .val "
        f"call); box mAP50-95 {rb['mAP50-95']:.4f} (f32 {rk['mAP50-95']:.4f}), pose mAP50-95 {rb['pose_mAP50-95']:.4f} "
        f"(f32 {rk['pose_mAP50-95']:.4f}); launches {launches}")


def _kpt_diffs(a, b):
    """Largest |x, y| and |visibility| differences of two (n, 17, 3) keypoint sets."""
    import numpy as np

    if not len(a):
        return 0.0, 0.0
    return float(np.abs(a[..., :2] - b[..., :2]).max()), float(np.abs(a[..., 2] - b[..., 2]).max())


def _paired(bk, bp, box_tol=1e-2, tie=1e-6):
    """Pair each kernel row with the twin's row of the nearest box, each used once: two detections whose scores
    differ by less than f32's rounding may leave NMS in either order. The rows without a twin within `box_tol` px
    must match the twin's unpaired rows score for score within `tie`: of two overlapping candidates of one score
    (an undertrained model predicts the same box at neighbouring anchors), NMS keeps whichever its sort put first,
    and the kernel and the twin may put them the other way round → (kernel rows, twin rows, unpaired rows)."""
    import numpy as np

    d = np.abs(bk[:, None, :4] - bp[None, :, :4]).max(-1) if len(bk) else np.zeros((0, len(bp)))
    pairs, free = [], set(range(len(bp)))
    for i in np.argsort(d.min(1) if len(bp) else np.zeros(len(bk)), kind="stable"):
        j = min(free, key=lambda j: d[i, j])
        if d[i, j] <= box_tol:
            pairs.append((i, j))
            free.discard(j)
    ki = sorted(set(range(len(bk))) - {i for i, _ in pairs})
    sk, sp = np.sort(bk[ki, 4]), np.sort(bp[sorted(free), 4])
    if len(sk) != len(sp) or (len(sk) and float(np.abs(sk - sp).max()) > tie):
        raise AssertionError(f"rows without a twin: kernel {bk[ki]}, twin {bp[sorted(free)]}")
    pairs.sort()
    return np.array([i for i, _ in pairs], int), np.array([j for _, j in pairs], int), len(ki)


def pose_predict_phase(y, frames, card):
    """`[pose predict]`: the trained model over held-out BGR frames, one per predict call, at POSE_PREDICT's conf and
    max_det, f32 through the kernels against f32 through the twins: equal detection counts, and for each kernel row
    the twin's with the nearest box (`_paired`; of two overlapping candidates of one score either may be kept): equal
    classes, boxes within 1e-2 px, conf 1e-4, keypoint x, y 1e-2 px,
    visibilities 1e-4. Then bf16 frames/s (host clock) with the host's
    split per frame (letterbox + assembly, enqueue, the wait for the device, the Results with the keypoints'
    inverse letterbox) → each frame's f32 kernel rows."""
    import numpy as np

    def run(half, plain):
        out = []
        for f in frames:
            r = y.predict(f, half=half, plain=plain, compute_dtype=compute_dtype(half), verbose=False, **POSE_PREDICT)[0]
            out.append((r.boxes.data.copy(), r.keypoints.data.copy()))
        return out

    run(False, False)  # warm-up
    pk, launches = counted(POSE_PATH, lambda: run(False, False))
    pp = run(False, True)
    n_det, n_tied, worst = 0, 0, {"box": 0.0, "conf": 0.0, "kpt": 0.0, "vis": 0.0}
    for (bk, kk), (bp, kp) in zip(pk, pp):
        if bk.shape != bp.shape or kk.shape != kp.shape or kk.shape[1:] != (17, 3):
            raise AssertionError(f"pose predict: {bk.shape} / {kk.shape} vs twins {bp.shape} / {kp.shape}")
        if len(bk):
            i, j, tied = _paired(bk, bp)
            bk, kk, bp, kp = bk[i], kk[i], bp[j], kp[j]
            n_tied += tied
            if not np.array_equal(bk[:, 5], bp[:, 5]):
                raise AssertionError(f"pose predict: classes {bk[:, 5]} vs twins {bp[:, 5]}")
            worst["box"] = max(worst["box"], float(np.abs(bk[:, :4] - bp[:, :4]).max()))
            worst["conf"] = max(worst["conf"], float(np.abs(bk[:, 4] - bp[:, 4]).max()))
            dk, dv = _kpt_diffs(kk, kp)
            worst["kpt"], worst["vis"] = max(worst["kpt"], dk), max(worst["vis"], dv)
        n_det += len(bk)
    if n_det == 0 or worst["box"] > 1e-2 or worst["conf"] > 1e-4 or worst["kpt"] > 1e-2 or worst["vis"] > 1e-4:
        raise AssertionError(f"pose predict: {n_det} detections, {worst}")
    confs = np.concatenate([b[:, 4] for b, _ in pk])
    vis = np.concatenate([k[..., 2].ravel() for _, k in pk])
    log("pose predict f32", card, f"{len(frames)} frames, {n_det} detections equal to the twins' ({n_tied} of them replaced "
        f"by an overlapping one of the same score; max |box| {worst['box']:.3e} px, "
        f"|conf| {worst['conf']:.3e}, |keypoint x, y| {worst['kpt']:.3e} px, |visibility| {worst['vis']:.3e}); conf "
        f"{confs.min():.4f}-{confs.max():.4f}, visibility {vis.min():.3f}-{vis.max():.3f}; launches {launches}")
    y.predict(frames[0], half=True, compute_dtype="bfloat16", verbose=False, **POSE_PREDICT)  # warm: bf16 weights
    y.predictor.timings = []
    t0 = time.perf_counter()
    _, launches = counted(POSE_PATH, lambda: run(True, False))
    wall = time.perf_counter() - t0
    ts = y.predictor.timings
    y.predictor.timings = None
    split = {k: sum(t[f"{k}_s"] for t in ts) / len(ts) * 1e3 for k in ("pre", "enqueue", "wait", "post")}
    log("pose predict bf16", card, f"{len(frames)} frames in {wall:.3f} s = {len(frames) / wall:.1f} frames/s (host clock, one "
        f"frame per predict call); host ms/frame: letterbox + assembly {split['pre']:.3f}, enqueue {split['enqueue']:.3f}, wait "
        f"{split['wait']:.3f}, Results with the keypoints {split['post']:.3f}; launches {launches}")
    return pk


def pose_forward_phase(frames, card):
    """`[pose forward]`: yolov8n-pose at full width (nc 1, the JAX package's init(0)) at 640x640, B = 8 and 32, f32
    through the kernels against the twins: boxes within 1e-2 px, scores 1e-4, keypoint x, y 1e-2 px, visibilities
    1e-4; NMS with the 51 keypoint rows as extra columns, the kernel against its twin on the same predictions: every
    output equal, bit for bit; kernels 1, 2, 3 and 5 held against their twins on those activations
    (`hold_path_kernels`). NMS runs at conf 0, since the initial tree's scores sit near 1e-3: every anchor is a
    candidate, K = 1024."""
    import torch

    from yolo_tpu_torch.nn.tasks import PoseModel, params_from_jax
    from yolo_tpu_torch.ops.nms import non_max_suppression

    m = PoseModel("yolov8n-pose.yaml")
    params_from_jax(m, m.init(0), torch.float32)
    x32 = torch.cat([letterboxed(frames[i % len(frames)]) for i in range(32)])
    xy = torch.zeros(56, dtype=torch.bool)
    xy[5:] = torch.arange(51) % 3 != 2

    def nms(preds, plain):
        return non_max_suppression(preds, conf_thres=0.0, iou_thres=0.7, max_det=300, nc=m.nc, plain=plain)

    for B in (8, 32):
        x = x32[:B]
        (pk, ok), launches = counted(POSE_PATH, lambda: (lambda p: (p, nms(p, False)))(m.predict(x)))
        pp = m.predict(x, plain=True)
        op = nms(pk, True)
        torch.cuda.synchronize()
        d = (pk - pp).abs()
        err = {"box": float(d[:, :4].max()), "score": float(d[:, 4].max()), "kpt": float(d[:, xy].max()),
               "vis": float(d[:, 5:][:, ~xy[5:]].max())}
        same = all(torch.equal(ok[k], op[k]) for k in ok) and set(ok) == set(op)
        if (pk.shape != (B, 56, 8400) or not torch.isfinite(pk).all() or err["box"] > 1e-2 or err["score"] > 1e-4
                or err["kpt"] > 1e-2 or err["vis"] > 1e-4 or not same or ok["extra"].shape != (B, 300, 51)):
            raise AssertionError(f"pose forward B={B}: {err}, NMS kernel == twin {same}, {tuple(pk.shape)}")
        log("pose forward", card, f"B={B} 640x640: preds {tuple(pk.shape)}; kernels against twins max "
            + ", ".join(f"|{k}| {v:.3e}" for k, v in err.items()) + f"; NMS with 51 extras: kernel and twin equal in every "
            f"output ({int(ok['valid'].sum())} kept slots); launches {launches}")
        hold_path_kernels([m], x, f"pose forward B={B}", card, conf=0.0, iou=0.7)


def track_yaml_for(y, frames, path: Path, decimals: int = 6, **kw) -> tuple:
    """A ByteTrack yaml for a briefly trained model (its scores sit far below bytetrack.yaml's 0.25): the high and
    new-track thresholds at the median over `frames` of each frame's best f32 score, the low one at a quarter of it,
    written with `decimals` digits, and no score fused into the IoU cost (at scores near 0.01 it leaves every cost
    above match_thresh) → (the yaml, the predict conf: that quarter). An obb model a few steps old scores ~3e-4 on
    every frame alike, where six digits can round the high threshold above every score: `[obb track]` writes ten."""
    import numpy as np

    best = [float((r.obb if r.obb is not None else r.boxes).conf.max()) if len(r) else 0.0
            for f in frames for r in y.predict(f, half=False, plain=False, compute_dtype="float32", verbose=False, **kw, **POSE_PREDICT)]
    hi = float(np.median(best))
    text = (ROOT / "yolo_tpu_torch" / "cfg" / "trackers" / "bytetrack.yaml").read_text()
    for key, v in (("track_high_thresh", f"{hi:.{decimals}f}"), ("track_low_thresh", f"{hi / 4:.{decimals}f}"),
                   ("new_track_thresh", f"{hi:.{decimals}f}"), ("fuse_score", "False")):
        text = "\n".join(f"{key}: {v}" if line.startswith(f"{key}:") else line for line in text.splitlines())
    path.write_text(text + "\n")
    return path, hi / 4


def moving_clip(frames, n: int, steps: int = 16, dx: int = 3):
    """n frames that move: each of `frames` in turn rolled right by dx px a frame for `steps` frames (the held-out
    frames are independent images, on which no track would live past its first frame)."""
    import numpy as np

    return [np.ascontiguousarray(np.roll(frames[(i // steps) % len(frames)], dx * (i % steps), axis=1)) for i in range(n)]


def pose_track_phase(y, frames, seg, tmp: Path, card):
    """`[pose track]`: YOLO.track of the trained pose model over a 64-frame clip made of the held-out frames
    (`moving_clip`), one frame per call with persist=True, ByteTrack at thresholds fitted to the model's scores
    (`track_yaml_for`), f32 through the kernels against f32 through the twins: equal rows and ids per frame (boxes
    1e-2 px, conf 1e-4) and each track's keypoints (x, y 1e-2 px, visibility 1e-4); then bf16 frames/s. `[segment
    track]`: the same with the trained yolov8n-seg of the segment phases over a clip of its frames, the tracks' masks
    against the twins' (their summed intersection over their summed union >= 0.99; the least IoU of one track's mask
    printed: a box edge within 1e-4 px of a prototype pixel's centre crops a whole column of a small mask one way or
    the other)."""
    import numpy as np

    def run(model, frames, yaml, conf, half, plain, extra):
        model._tracker = None
        out = []
        for f in frames:
            r = model.track(f, persist=True, tracker=str(yaml), conf=conf, max_det=POSE_PREDICT["max_det"], half=half, plain=plain,
                            compute_dtype=compute_dtype(half), verbose=False, **extra)[0]
            out.append((r.boxes.data.copy(), (r.keypoints if r.keypoints is not None else r.masks).data.copy()))
        return out

    fitted = {}
    frames = moving_clip(frames, TRACK_FRAMES)
    for tag, model, fr, extra in (("pose track", y, frames, {}),
                                  ("segment track", seg[0], moving_clip(seg[1], TRACK_FRAMES), {"retina_masks": False})):
        yaml, conf = fitted[tag] = track_yaml_for(model, fr, tmp / f"{tag.split()[0]}_bytetrack.yaml", **extra)
        rk, launches = counted(POSE_PATH, lambda: run(model, fr, yaml, conf, False, False, extra))
        rp = run(model, fr, yaml, conf, False, True, extra)
        worst, n_rows, ids = compare_tracks([b for b, _ in rk], [b for b, _ in rp], 1e-2, 1e-4, f"{tag}: kernels against plain")
        least = {"kpt": 0.0, "vis": 0.0, "iou": 1.0}
        inter = union = 0
        for (bk, ek), (bp, ep) in zip(rk, rp):
            ok, op = np.argsort(bk[:, 4], kind="stable"), np.argsort(bp[:, 4], kind="stable")
            if tag == "pose track":
                dk, dv = _kpt_diffs(ek[ok], ep[op])
                least["kpt"], least["vis"] = max(least["kpt"], dk), max(least["vis"], dv)
            else:
                least["iou"] = min(least["iou"], *(_mask_iou(a, b) for a, b in zip(ek[ok], ep[op])), 1.0)
                inter, union = inter + int((ek[ok] & ep[op]).sum()), union + int((ek[ok] | ep[op]).sum())
        overall = inter / union if union else 1.0
        if n_rows <= 0 or least["kpt"] > 1e-2 or least["vis"] > 1e-4 or overall < 0.99:
            raise AssertionError(f"{tag}: {n_rows} tracked rows, per-track {least}, masks' summed IoU {overall}")
        per = (f"keypoints per track within {least['kpt']:.3e} px / visibility {least['vis']:.3e}" if tag == "pose track"
               else f"the tracks' masks: summed IoU with the twins' {overall:.6f}, the least one track's {least['iou']:.6f}")
        log(f"{tag} f32", card, f"ByteTrack at high/new {conf * 4:.4f}, low {conf:.4f}: rows and ids equal on every frame "
            f"({n_rows} tracked rows, {len(ids)} ids), max |box diff| {worst:.3e} px; {per}; launches {launches}")
    yaml, conf = fitted["pose track"]
    run(y, frames[:2], yaml, conf, True, False, {})  # warm: bf16 weights
    t0 = time.perf_counter()
    rb, launches = counted(POSE_PATH, lambda: run(y, frames, yaml, conf, True, False, {}))
    wall = time.perf_counter() - t0
    log("pose track bf16", card, f"{len(frames)} frames in {wall:.3f} s = {len(frames) / wall:.1f} frames/s (host clock, one "
        f"frame per track call); {sum(len(b) for b, _ in rb)} tracked rows; launches {launches}")


def pose_phases(root: Path, card, seg):
    """The pose task's six phases on the keypoint splits written under `root`; `seg` is the segment phases' trained
    YOLO and its frames, which `[segment track]` tracks."""
    import cv2
    import numpy as np

    t0 = time.perf_counter()
    write_pose_split(root, *POSE_TRAIN, split="train")
    data = write_pose_split(root, *POSE_VAL, split="val")
    print(f"[pose split] {POSE_TRAIN[0]} train + {POSE_VAL[0]} val frames of 640x512 with 17-keypoint labels written in "
          f"{time.perf_counter() - t0:.1f} s")
    y = pose_train_phase(data, root / "runs", card)
    train_step_f32_phase(data, card, cfg_name="yolov8n-pose.yaml", tag="pose train step f32", recipe=POSE_RUN)
    pose_val_kernels_phase(y, data, card)
    frames = [cv2.imread(str(root / f"images/val/{i}.png")) for i in range(POSE_VAL[0])]
    pose_predict_phase(y, frames, card)
    pose_forward_phase(np.stack(frames), card)
    pose_track_phase(y, frames, seg, root, card)


OBB_PATH = {"c2f", "c2f_upconcat", "head_level"}  # the rotated NMS is plain torch: kernel 5 must not launch
OBB_TRAIN, OBB_VAL = (256, 60_000), (64, 60_001)  # `[obb ...]`'s rotated splits: frames and seed
# yolov8n-obb from the JAX package's init(0), rebuilt at nc 2: the pose recipe (AdamW lr0 8e-4, batch 16, 640, bf16,
# 3 epochs with close_mosaic 1), the cfg's augmentations otherwise
OBB_RUN = dict(epochs=3, batch=16, imgsz=640, optimizer="AdamW", lr0=8e-4, amp=True, workers=8, seed=0, close_mosaic=1,
               plots=False, exist_ok=True)
OBB_PREDICT = dict(conf=0.0, max_det=10)  # `[obb predict]`, `[obb track]`: each frame's ten best, however low


def _obb_target(rng, w, h, near=None):
    """A rotated rectangle elongated like an aircraft seen from above (20-160 px long, aspect 2-6, a uniform angle)
    inside a w x h frame, or, given `near`, one overlapping it (its centre a quarter to half a length along its axis,
    its angle within 0.2 rad, its size within 20%) → (cx, cy, long side, short side, angle in radians)."""
    import math

    import numpy as np

    if near is None:
        L = rng.uniform(20, 160)
        S, a = L / rng.uniform(2, 6), rng.uniform(0, math.pi)
        r = 0.5 * math.hypot(L, S)
        return rng.uniform(r, w - r), rng.uniform(r, h - r), L, S, a
    cx, cy, L, S, a = near
    d = rng.uniform(0.25, 0.5) * L * rng.choice([-1, 1])
    L2, S2, a2 = L * rng.uniform(0.8, 1.2), S * rng.uniform(0.8, 1.2), a + rng.uniform(-0.2, 0.2)
    r = 0.5 * math.hypot(L2, S2)
    return (float(np.clip(cx + d * math.cos(a), r, w - r)), float(np.clip(cy + d * math.sin(a), r, h - r)), L2, S2, a2)


def write_obb_split(root: Path, n: int, seed: int, split: str, w: int = 640, h: int = 512) -> Path:
    """n seeded 640x512 IR-like frames (a cloudy background) written as BGR PNGs under root/images/<split>, each with
    1-4 bright rotated rectangles (`_obb_target`), a third of the frames with one overlapping pair; class 0 solid,
    class 1 hollow (its outline a quarter of its short side, at least 2 px); their DOTA rows (`cls x1 y1 ... x4 y4`,
    the corners of cv2.boxPoints normalized) under root/labels/<split>; nc 2 → the dataset yaml."""
    import math

    import cv2
    import numpy as np

    rng = np.random.default_rng(seed)
    (root / f"images/{split}").mkdir(parents=True, exist_ok=True)
    (root / f"labels/{split}").mkdir(parents=True, exist_ok=True)
    for i in range(n):
        img = cv2.resize(rng.normal(30, 10, (h // 16, w // 16)).astype(np.float32), (w, h), interpolation=cv2.INTER_CUBIC)
        img += rng.normal(0, 2, (h, w))
        targets = [_obb_target(rng, w, h) for _ in range(rng.integers(1, 4))]
        if i % 3 == 0:
            targets.append(_obb_target(rng, w, h, near=targets[0]))
        lines = []
        for t in targets:
            c = int(rng.integers(0, 2))
            pts = cv2.boxPoints(((t[0], t[1]), (t[2], t[3]), math.degrees(t[4])))
            poly = [np.round(pts).astype(np.int32)]
            val = float(rng.uniform(150, 230))
            if c == 0:
                cv2.fillPoly(img, poly, val)
            else:
                cv2.polylines(img, poly, True, val, max(2, int(t[3] / 4)), cv2.LINE_AA)
            lines.append(f"{c} " + " ".join(f"{v:.6f}" for v in (pts / [w, h]).ravel()))
        gray = np.clip(img, 0, 255).astype(np.uint8)
        cv2.imwrite(str(root / f"images/{split}/{i}.png"), cv2.cvtColor(gray, cv2.COLOR_GRAY2BGR))
        (root / f"labels/{split}/{i}.txt").write_text("\n".join(lines) + "\n")
    splits = "".join(f"{s.name}: images/{s.name}\n" for s in sorted((root / "images").iterdir()))
    (root / "data.yaml").write_text(f"path: {root}\n{splits}names:\n  0: solid\n  1: hollow\n")
    return root / "data.yaml"


def obb_train_phase(data, run_dir, card):
    """`[obb train]`: YOLO("yolov8n-obb.yaml").train with OBB_RUN on the 256-frame rotated split, validating on the 64
    held-out frames each epoch: per epoch the three loss components and the metrics; images/s over the whole .train
    call; the step's split in events; peak memory; the launches of check_amp and the validations → the trained YOLO."""
    import numpy as np
    import torch

    from yolo_tpu_torch import YOLO

    epochs = []
    y = YOLO("yolov8n-obb.yaml")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    metrics, launches = counted(OBB_PATH, lambda: y.train(trainer=train_epoch_recorder(epochs), data=str(data),
                                                          project=str(run_dir), name="obb", **OBB_RUN))
    wall = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    if y.task != "obb" or y.model.nc != 2 or not y.trainer.args.amp or metrics is None:
        raise AssertionError(f"obb train: task {y.task}, nc {y.model.nc}, amp {y.trainer.args.amp}, metrics {metrics}")
    names = ("box", "cls", "dfl")
    for e in epochs:
        r = e["row"]
        losses = [r[f"train/{k}_loss"] for k in names]
        if not all(np.isfinite(losses)) or min(losses) <= 0:
            raise AssertionError(f"obb train: epoch {r['epoch']} losses {losses}")
        log("obb train", card, f"epoch {r['epoch'] + 1}/{OBB_RUN['epochs']}: " + " ".join(f"{k} {v:.4f}" for k, v in zip(names, losses))
            + f"; P {r['metrics/precision']:.4f} R {r['metrics/recall']:.4f} mAP50 {r['metrics/mAP50']:.4f} "
            f"mAP50-95 {r['metrics/mAP50-95']:.4f}; epoch {e['epoch_s']:.2f} s, val {e['val_s']:.2f} s")
    n = OBB_RUN["epochs"] * OBB_TRAIN[0]
    steps = [t for e in epochs for t in e["timings"][1:]]
    mean = {k: sum(t[k] for t in steps) / len(steps) for k in ("loader", "forward", "backward", "optimizer")}
    log("obb train", card, f"{OBB_RUN['epochs']} epochs of {OBB_TRAIN[0]} frames at batch {OBB_RUN['batch']}, 640, bf16: "
        f"{n / wall:.1f} images/s over the whole .train call ({wall:.1f} s: check_amp, the loader, the steps, each epoch's f32 "
        f"validation of {OBB_VAL[0]} frames); per step after each epoch's first: loader wait {mean['loader']:.2f} ms (host), "
        f"forward+loss {mean['forward']:.2f} ms, backward {mean['backward']:.2f} ms, optimizer+BN+EMA {mean['optimizer']:.2f} ms "
        f"(events; {sum(mean[k] for k in ('forward', 'backward', 'optimizer')):.2f} ms a step); peak memory {peak:.2f} GiB "
        f"(max_memory_allocated, over the {base / 2**30:.2f} GiB held before); launches {launches}")
    return y


def obb_val_kernels_phase(y, data, card):
    """`[obb val kernels]`: the trained model on the held-out split, f32 through the kernels against f32 through the
    twins (every key within 1e-4), then bf16 images/s over a warmed .val call."""
    rk, launches = counted(OBB_PATH, lambda: y.val(data=str(data), imgsz=640, batch=16, plots=False))
    rp = y.val(data=str(data), imgsz=640, batch=16, plots=False, plain=True)
    diff = {k: abs(rk[k] - rp[k]) for k in rk}
    if set(rk) != set(rp) or max(diff.values()) > 1e-4:
        raise AssertionError(f"obb val: kernels {rk} vs twins {rp}")
    log("obb val kernels", card, "f32 kernels: " + ", ".join(f"{k} {v:.4f}" for k, v in rk.items())
        + f"; every key within {max(diff.values()):.2e} of the twins'; launches {launches}")
    y.val(data=str(data), imgsz=640, batch=16, plots=False, half=True)  # warm: bf16 weights and plans
    t0 = time.perf_counter()
    rb, launches = counted(OBB_PATH, lambda: y.val(data=str(data), imgsz=640, batch=16, plots=False, half=True))
    wall = time.perf_counter() - t0
    log("obb val bf16", card, f"{OBB_VAL[0]} frames in {wall:.2f} s = {OBB_VAL[0] / wall:.1f} images/s (host clock, the .val "
        f"call); mAP50 {rb['mAP50']:.4f} mAP50-95 {rb['mAP50-95']:.4f} (f32 {rk['mAP50']:.4f} / {rk['mAP50-95']:.4f}); "
        f"launches {launches}")


def _obb_rows(data):
    """OBBoxes rows [cx, cy, w, h, angle, conf, cls] → [cx, cy, w, h, conf, cls, angle], the column order `_paired`
    reads (the box first, then the score)."""
    return data[:, [0, 1, 2, 3, 5, 6, 4]]


def obb_predict_phase(y, frames, card):
    """`[obb predict]`: the trained model over held-out BGR frames, one per predict call, at OBB_PREDICT's conf and
    max_det, f32 through the kernels against f32 through the twins: equal detection counts, and for each kernel row
    the twin's with the nearest box (`_paired`): equal classes, centres and sizes within 1e-2 px, angles 1e-4 rad,
    conf 1e-4. Then bf16 frames/s (host clock) with the host's split per frame (letterbox + assembly, enqueue, the
    wait for the device, the Results with the inverse letterbox) → each frame's f32 kernel rows."""
    import numpy as np

    def run(half, plain):
        return [_obb_rows(y.predict(f, half=half, plain=plain, compute_dtype=compute_dtype(half), verbose=False,
                                    **OBB_PREDICT)[0].obb.data.copy()) for f in frames]

    run(False, False)  # warm-up
    pk, launches = counted(OBB_PATH, lambda: run(False, False))
    pp = run(False, True)
    n_det, n_tied, worst = 0, 0, {"box": 0.0, "angle": 0.0, "conf": 0.0}
    for bk, bp in zip(pk, pp):
        if bk.shape != bp.shape:
            raise AssertionError(f"obb predict: {bk.shape} vs twins {bp.shape}")
        if len(bk):
            i, j, tied = _paired(bk, bp)
            bk, bp = bk[i], bp[j]
            n_tied += tied
            if not np.array_equal(bk[:, 5], bp[:, 5]):
                raise AssertionError(f"obb predict: classes {bk[:, 5]} vs twins {bp[:, 5]}")
            worst["box"] = max(worst["box"], float(np.abs(bk[:, :4] - bp[:, :4]).max()))
            worst["conf"] = max(worst["conf"], float(np.abs(bk[:, 4] - bp[:, 4]).max()))
            worst["angle"] = max(worst["angle"], float(np.abs(bk[:, 6] - bp[:, 6]).max()))
        n_det += len(bk)
    if n_det == 0 or worst["box"] > 1e-2 or worst["conf"] > 1e-4 or worst["angle"] > 1e-4:
        raise AssertionError(f"obb predict: {n_det} detections, {worst}")
    rows = np.concatenate(pk)
    log("obb predict f32", card, f"{len(frames)} frames, {n_det} detections equal to the twins' ({n_tied} of them replaced "
        f"by an overlapping one of the same score; max |centre, size| {worst['box']:.3e} px, |angle| {worst['angle']:.3e} "
        f"rad, |conf| {worst['conf']:.3e}); conf {rows[:, 4].min():.4f}-{rows[:, 4].max():.4f}, angle {rows[:, 6].min():.3f}-"
        f"{rows[:, 6].max():.3f} rad, classes {sorted(set(rows[:, 5].astype(int).tolist()))}; launches {launches}")
    y.predict(frames[0], half=True, compute_dtype="bfloat16", verbose=False, **OBB_PREDICT)  # warm: bf16 weights
    y.predictor.timings = []
    t0 = time.perf_counter()
    _, launches = counted(OBB_PATH, lambda: run(True, False))
    wall = time.perf_counter() - t0
    ts = y.predictor.timings
    y.predictor.timings = None
    split = {k: sum(t[f"{k}_s"] for t in ts) / len(ts) * 1e3 for k in ("pre", "enqueue", "wait", "post")}
    log("obb predict bf16", card, f"{len(frames)} frames in {wall:.3f} s = {len(frames) / wall:.1f} frames/s (host clock, one "
        f"frame per predict call); host ms/frame: letterbox + assembly {split['pre']:.3f}, enqueue {split['enqueue']:.3f}, wait "
        f"{split['wait']:.3f}, Results with the oriented boxes {split['post']:.3f}; launches {launches}")
    return pk


def rotated_nms_near_ties(preds, conf, iou, max_nms=1024):
    """The pairs of candidates of one image, in the rotated NMS's own order (the top K by score, the class offset on the
    centres), whose probiou lies within 1e-6 of `iou`: where a card and the CPU may round either way → per image."""
    import torch

    from yolo_tpu_torch.ops.boxes import probiou
    from yolo_tpu_torch.ops.nms import MAX_WH

    nc = preds.shape[1] - 5
    out = []
    for p in preds:
        scores, cls = p[4 : 4 + nc].T.max(-1)
        scores = torch.where(scores > conf, scores, -1.0)
        top, idx = torch.sort(scores, descending=True, stable=True)
        top, idx = top[:max_nms], idx[:max_nms]
        rb = torch.cat([p[:4].T, p[4 + nc :].T], -1)[idx]
        rb = torch.cat([rb[:, :2] + (cls[idx].to(rb.dtype) * MAX_WH)[:, None], rb[:, 2:]], -1)
        pi = probiou(rb[:, None], rb[None])[..., 0]
        live = (top > 0)[:, None] & (top > 0)[None] & torch.ones_like(pi, dtype=torch.bool).triu(1)
        out.append(int(((pi - iou).abs() <= 1e-6)[live].sum()))
    return out


def obb_forward_phase(frames, card):
    """`[obb forward]`: yolov8n-obb at full width with nc 15 (DOTAv1's class count; the JAX package's init(0)) at
    640x640, B = 8 and 32, f32 through the kernels against the twins: boxes within 1e-2 px, scores and angles 1e-4;
    kernels 1, 2 and 3 held against their twins on those activations (`hold_path_kernels`, no kernel 5); the card's
    rotated NMS (conf 0: K = 1024 candidates, iou 0.7) against the same function on the CPU on the same predictions:
    equal outputs on every image with no candidate pair's probiou within 1e-6 of the threshold (counted and printed);
    the rotated NMS's device time against the forward's (CUDA events)."""
    import torch

    from yolo_tpu_torch.nn.tasks import OBBModel, params_from_jax
    from yolo_tpu_torch.ops.nms import non_max_suppression_rotated

    m = OBBModel("yolov8n-obb.yaml", nc=15)
    params_from_jax(m, m.init(0), torch.float32)
    x32 = torch.cat([letterboxed(frames[i % len(frames)]) for i in range(32)])

    def nms(preds):
        return non_max_suppression_rotated(preds, conf_thres=0.0, iou_thres=0.7, max_det=300)

    for B in (8, 32):
        x = x32[:B]
        pk, launches = counted(OBB_PATH, lambda: m.predict(x))
        pp = m.predict(x, plain=True)
        ok = nms(pk)
        oc = nms(pk.cpu())
        torch.cuda.synchronize()
        d = (pk - pp).abs()
        err = {"box": float(d[:, :4].max()), "score": float(d[:, 4:-1].max()), "angle": float(d[:, -1].max())}
        if pk.shape != (B, 4 + 15 + 1, 8400) or not torch.isfinite(pk).all() or err["box"] > 1e-2 or err["score"] > 1e-4 \
                or err["angle"] > 1e-4:
            raise AssertionError(f"obb forward B={B}: {err}, {tuple(pk.shape)}")
        ties = rotated_nms_near_ties(pk.cpu(), 0.0, 0.7)
        same = [all(torch.equal(ok[k][b].cpu(), oc[k][b]) for k in ok) for b in range(B)]
        if not all(s for s, t in zip(same, ties) if t == 0):
            raise AssertionError(f"obb forward B={B}: the card's rotated NMS differs from the CPU's on images without near "
                                 f"ties: {[b for b in range(B) if not same[b] and ties[b] == 0]}")
        fwd_ms = cuda_ms(lambda: m.predict(x))
        nms_ms = cuda_ms(lambda: nms(pk))
        log("obb forward", card, f"B={B} 640x640: preds {tuple(pk.shape)}; kernels against twins max "
            + ", ".join(f"|{k}| {v:.3e}" for k, v in err.items()) + f"; rotated NMS (K 1024, iou 0.7) on the card equal to the "
            f"CPU's on {sum(same)}/{B} images ({int(ok['valid'].sum())} kept slots; {sum(ties)} candidate pairs within 1e-6 "
            f"of the threshold, on {sum(t > 0 for t in ties)} images); device ms: forward {fwd_ms:.3f}, rotated NMS "
            f"{nms_ms:.3f} (({B}, 1024, 1024) probiou); launches {launches}")
        hold_path_kernels([m], x, f"obb forward B={B}", card, conf=0.0, iou=0.7, nms=False)


def obb_track_phase(y, frames, tmp: Path, card):
    """`[obb track]`: YOLO.track of the trained obb model over a 64-frame clip made of the held-out frames
    (`moving_clip`), one frame per call with persist=True, ByteTrack at thresholds fitted to the model's scores
    (`track_yaml_for`), f32 through the kernels against f32 through the twins: equal rows (centres and sizes 1e-2 px,
    angles and conf 1e-4), ids and classes per frame; then bf16 frames/s."""
    import numpy as np

    def run(yaml, conf, half, plain):
        y._tracker = None
        out = []
        for f in clip:
            r = y.track(f, persist=True, tracker=str(yaml), conf=conf, max_det=OBB_PREDICT["max_det"], half=half, plain=plain,
                        compute_dtype=compute_dtype(half), verbose=False)[0]
            out.append(r.obb.data.copy() if r.obb is not None else np.zeros((0, 8), np.float32))
        return out

    clip = moving_clip(frames, TRACK_FRAMES)
    yaml, conf = track_yaml_for(y, clip, tmp / "obb_bytetrack.yaml", decimals=10)
    rk, launches = counted(OBB_PATH, lambda: run(yaml, conf, False, False))
    rp = run(yaml, conf, False, True)
    def rows7(rows):  # [cx, cy, w, h, id, conf, cls]: compare_tracks' tracked-box form
        return [r[:, [0, 1, 2, 3, 5, 6, 7]] if r.shape[-1] == 8 else r for r in rows]

    worst, n_rows, ids = compare_tracks(rows7(rk), rows7(rp), 1e-2, 1e-4, "obb track: kernels against plain")
    angle = 0.0
    for a, b in zip(rk, rp):
        if len(a) and a.shape[-1] == 8:
            a, b = a[np.argsort(a[:, 5], kind="stable")], b[np.argsort(b[:, 5], kind="stable")]
            angle = max(angle, float(np.abs(a[:, 4] - b[:, 4]).max()))
    if n_rows <= 0 or angle > 1e-4:
        raise AssertionError(f"obb track: {n_rows} tracked rows, max |angle| {angle}")
    log("obb track f32", card, f"ByteTrack at high/new {conf * 4:.4f}, low {conf:.4f}: rows and ids equal on every frame "
        f"({n_rows} tracked rows, {len(ids)} ids), max |centre, size| {worst:.3e} px, |angle| {angle:.3e} rad; launches {launches}")
    run(yaml, conf, True, False)  # warm: bf16 weights
    t0 = time.perf_counter()
    rb, launches = counted(OBB_PATH, lambda: run(yaml, conf, True, False))
    wall = time.perf_counter() - t0
    log("obb track bf16", card, f"{len(clip)} frames in {wall:.3f} s = {len(clip) / wall:.1f} frames/s (host clock, one frame "
        f"per track call); {sum(len(b) for b in rb)} tracked rows; launches {launches}")


def obb_phases(root: Path, card):
    """The obb task's six phases on the rotated splits written under `root`."""
    import cv2
    import numpy as np

    t0 = time.perf_counter()
    write_obb_split(root, *OBB_TRAIN, split="train")
    data = write_obb_split(root, *OBB_VAL, split="val")
    print(f"[obb split] {OBB_TRAIN[0]} train + {OBB_VAL[0]} val frames of 640x512 with DOTA rows written in "
          f"{time.perf_counter() - t0:.1f} s")
    y = obb_train_phase(data, root / "runs", card)
    train_step_f32_phase(data, card, cfg_name="yolov8n-obb.yaml", tag="obb train step f32", recipe={**OBB_RUN, "task": "obb"})
    obb_val_kernels_phase(y, data, card)
    frames = [cv2.imread(str(root / f"images/val/{i}.png")) for i in range(OBB_VAL[0])]
    obb_predict_phase(y, frames, card)
    obb_forward_phase(np.stack(frames), card)
    obb_track_phase(y, frames, root, card)


def compare_runs(a, b, stats_a, stats_b):
    import numpy as np

    if stats_a != stats_b:
        raise AssertionError(f"stats differ: kernels {stats_a} vs plain {stats_b}")
    worst = 0.0
    for ca, cb in zip(a, b):
        for k in ("emit", "status", "track_num", "time_since_update", "det_count"):
            if not np.array_equal(ca[k], cb[k]):
                raise AssertionError(f"'{k}' differs between the kernel and plain runs")
        for k in ("bbox", "confidence", "velocity"):
            if not np.all(np.isfinite(ca[k])):
                raise AssertionError(f"non-finite '{k}' in the kernel run")
            worst = max(worst, float(np.abs(ca[k] - cb[k]).max()))
            np.testing.assert_allclose(ca[k], cb[k], atol=1e-2, rtol=1e-4, err_msg=k)
    return worst


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from yolo_tpu_torch import load_npz
    from yolo_tpu_torch.ops import _cuda

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    lib = _cuda.build()
    log("build", card, f"{lib.name} in {time.perf_counter() - t0:.1f} s")
    for line in (_cuda.BUILD / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print("[build]", line.strip())

    model, params, _ = load_npz(WEIGHTS)
    print(f"[model] {WEIGHTS.relative_to(ROOT)}: {len(model.layers)} layers, strides {model.stride}, nc={model.nc}")
    t0 = time.perf_counter()
    clip = make_clip(FRAMES, *HW)
    print(f"[clip] {clip.shape} uint8 made in {time.perf_counter() - t0:.1f} s")

    profiling = "--profile" in argv
    c2f_cases = {} if profiling else None
    records = check_kernels(model, params, clip[:CHUNK], card, keep=c2f_cases)
    c2f_edges_phase(card)
    head_edges_phase(card)
    nms_edges_phase(card)

    ft, launches, bf16_run, f32_run, fps = pipeline_phase("pipeline", model, params, clip, card, head_cm=False)
    pipeline_options_phase(model, params, clip, card, *bf16_run)
    int8_pipeline_phase(model, params, clip, card, f32_run, fps)
    _, launches_cm, _, _, _ = pipeline_phase("pipeline head_cm", model, params, clip, card, head_cm=True)
    if launches_cm["head_level_cm"] != 4 * (FRAMES // CHUNK):
        raise AssertionError(f"head_level_cm: {launches_cm['head_level_cm']} launches, expected one per level and chunk")
    launches["head_level_cm"] = launches_cm["head_level_cm"]
    bgr_phase(model, params, clip, card)
    batched_tracker_phase(card)
    predict_phase(clip, card)
    predict_settings_phase(clip, card)
    host_rows = track_phase("track bytetrack", clip, card, "bytetrack.yaml")
    with tempfile.TemporaryDirectory() as tmp:
        botsort = Path(tmp) / "botsort_none.yaml"
        botsort.write_text((ROOT / "yolo_tpu_torch" / "cfg" / "trackers" / "botsort.yaml").read_text()
                           .replace("gmc_method: sparseOptFlow", "gmc_method: none"))
        print(f"[track botsort] gmc_method none, the GMC off (a machine without cv2 runs only this form); "
              f"cv2 here: {cv2_version()}")
        track_phase("track botsort", clip, card, str(botsort))
    track_reid_phase(clip, card)
    if cv2_version():  # the default yaml's sparse optical flow, where cv2 imports
        track_phase("track botsort sparseOptFlow", clip, card, "botsort.yaml")
    track_device_phase(clip, card, host_rows)
    byte_scan_phase(model, params, clip, card)

    if cv2_version() is None:
        raise RuntimeError("config 5 needs cv2 (the motion detector, the panning clip, the video files); it does not import")
    t0 = time.perf_counter()
    pan = make_panning_clip(MOTION_FRAMES)
    print(f"[motion clip] {pan.shape} uint8 made in {time.perf_counter() - t0:.1f} s (cv2 {cv2_version()})")
    motion_kernels_phase(model, params, pan, card)
    for method in ("optical_flow", "feature_matching", "hybrid"):
        motion_method_phase(method, model, params, pan, card)
    motion_per_frame_phase("optical_flow", model, params, pan, card)
    motion_compare_phase(model, params, pan, card)
    grayscale_phase(clip, card)
    grayscale_scorer_phase(card)

    serve_kernels_phase(clip, card)
    letterbox_cost(clip, card)
    with serving({0: str(WEIGHTS)}) as srv:  # bf16, the default
        for run in (1, 2):
            serve_phase(clip, card, run, srv)
        remote_phase(clip, card, srv)
    predict_sources_phase(clip, card)

    tiled_phase(clip, card)
    tta_phase(clip, card)
    ensemble_phase(clip, card)
    embed_phase(clip, card)
    enhance_phase(clip, card)
    video_phases(clip, card)
    benchmark_phase(model, params, clip, card)

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        heldout, big = write_split(Path(tmp) / "heldout", *VAL_HELDOUT), write_split(Path(tmp) / "val", *VAL_FRAMES)
        print(f"[val splits] {VAL_HELDOUT[0]} + {VAL_FRAMES[0]} frames of 640x512 written in {time.perf_counter() - t0:.1f} s")
        val_kernels_phase(model, params, heldout, card)
        val_phase(big, heldout, card)
        if profiling:
            val_workers_sweep(big, heldout, card)
        val_coco_phase(big, Path(tmp) / "val_coco", card)

        t0 = time.perf_counter()
        train_root = Path(tmp) / "train"
        write_split(train_root, *TRAIN_SET, split="train")
        train_data = write_split(train_root, *VAL_HELDOUT)
        print(f"[train split] {TRAIN_SET[0]} train + {VAL_HELDOUT[0]} held-out frames of 640x512 written in "
              f"{time.perf_counter() - t0:.1f} s")
        trained, _ = train_phase(train_data, Path(tmp) / "runs", card, profiling)
        train_step_f32_phase(train_data, card)
        tuned = train_finetune_phase(train_data, Path(tmp) / "runs", card)
        train_val_kernels_phase({"train": trained, "finetune": tuned}, train_data, card)
        train_settings_phase(train_data, Path(tmp) / "runs", card)
        tune_phase(Path(tmp) / "tune", card)
        classify_phase(clip, Path(tmp) / "cls", card)
        seg = segment_phases(Path(tmp) / "seg", card)
        pose_phases(Path(tmp) / "pose", card, seg)
        obb_phases(Path(tmp) / "obb", card)

    if profiling:
        from torch.profiler import ProfilerActivity, profile

        dev = torch.from_numpy(clip[:CHUNK]).cuda()
        ft.timings = None
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            ft.process_chunk_device(dev)
            torch.cuda.synchronize()
        print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25))
        c2f_plan_sweep(c2f_cases, card)
        c2f_stage_trace(c2f_cases["bfloat16"], card)
        head_plan_sweep({dn: c2f_cases["head " + dn] for dn in ("bfloat16", "float32")}, card)
        head_stage_trace(c2f_cases["head bfloat16"], card)

    rows = []
    for name, (route, source, replaces) in KERNEL_ROWS.items():
        r = records[name]
        rows.append({
            "name": name, "route": route, "source": source, "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": "operations" if r["ops_ms"] >= r["bytes_ms"] else "bytes", "library_ms": r["library_ms"],
        })
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
