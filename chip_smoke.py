#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`yolo_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py            # from the repository root; needs one CUDA card
    python3 chip_smoke.py --profile  # adds a torch.profiler breakdown of one bf16 chunk

Phases (any failure stops the run with a non-zero exit code):
1. build the hand-written CUDA kernels from yolo_tpu_torch/csrc (nvcc, sm_90a);
2. hold every kernel against its plain PyTorch twin on the card, in f32 and
   bf16, at the main path's shapes (nine C2f instances, four Detect levels,
   NMS at K=64 over a 128-frame chunk), with activations captured from the
   trained model on real-size frames; print each kernel's time, its plain
   twin's, a cuDNN conv walk of the same block (`library_ms`, a yardstick the
   port never calls) and the least time the card could take (`bound_ms`);
3. run FusedDetectTrack (the demo's trained yolov8-small P2, scale n,
   demos/artifacts/train/weights/best.npz) on a seeded synthetic 512-frame
   640x512 IR clip with moving targets and dropout gaps: in f32 through the
   kernels and in f32 through the plain twins (tracks, ids and stats must be
   equal, boxes close), then in bf16, timed, with the per-stage split and the
   launch count of every kernel in that run (each must be > 0).
The last three lines are the `kernels` JSON line, the card's name and power
limit, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WEIGHTS = ROOT / "demos" / "artifacts" / "train" / "weights" / "best.npz"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}  # dense bf16 tensor cores; f32 outside them
# kernel vs plain twin, (atol, rtol): f32 differs only in summation order;
# bf16 rounds every intermediate map, and a one-ulp flip travels down a C2f chain
TOL = {"float32": (1e-3, 1e-3), "bfloat16": (6e-2, 6e-2)}
FRAMES, CHUNK, HW = 512, 128, (512, 640)
KERNEL_ROWS = {  # name → (route, source, the TPU kernel's entry it replaces)
    "c2f": ("cuda", "yolo_tpu_torch/csrc/c2f.cu", "yolo_tpu/ops/pallas_c2f.py:264"),
    "c2f_upconcat": ("cuda", "yolo_tpu_torch/csrc/c2f.cu", "yolo_tpu/ops/pallas_c2f.py:290"),
    "head_level": ("cuda", "yolo_tpu_torch/csrc/head.cu", "yolo_tpu/ops/pallas_head.py:203"),
    "nms_keep": ("cuda", "yolo_tpu_torch/csrc/nms.cu", "yolo_tpu/ops/pallas_nms.py:56"),
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"], capture_output=True, text=True, check=True
    )
    return out.stdout.strip().splitlines()[0]


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


def _nchw(x):
    import torch

    return x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


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


def check_kernels(model, params, frames, card, d_max=16):
    """Phase 2: every kernel against its plain twin at the main path's shapes → per-kernel records (bf16)."""
    import torch

    from yolo_tpu_torch import FusedDetectTrack
    from yolo_tpu_torch.ops import cuda_c2f, cuda_head, cuda_nms

    records = {}
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        atol, rtol = TOL[dn]
        ft = FusedDetectTrack(model, params, frame_hw=HW, chunk=CHUNK, d_max=d_max, dtype=dtype, plain=True)
        x = torch.from_numpy(frames).cuda().to(dtype)
        rec, boxes, scores = capture_instances(ft.model, x)
        nb = sum(1 for name, _ in rec if name == "c2f")
        log(f"kernels {dn}", card, f"captured {len(rec)} kernel calls from a {tuple(x.shape)} chunk ({nb} c2f)")
        for name, args in rec:
            if name == "c2f":
                xin, kw, sc = args
                B, H, W, c1 = xin.shape
                kern = lambda: cuda_c2f.fused_c2f(xin, kw, sc)  # noqa: E731
                plain = lambda: cuda_c2f.c2f_plain(xin, kw, sc)  # noqa: E731
                lib, lib_in = library_c2f(kw, sc, dtype), _nchw(xin)
                macs = H * W * (c1 * 2 * kw.c + kw.n * 18 * kw.c * kw.c + (2 + kw.n) * kw.c * kw.w2.shape[1])
                ins = (xin,)
                desc = f"{H}x{W} {c1}->{kw.w2.shape[1]} n={kw.n}{' shortcut' if sc else ''}"
                tile = cuda_c2f.plan(H, W, kw.c, kw.w2.shape[1], kw.n, dtype)
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
                tile = cuda_c2f.plan(H, W, kw.c, kw.w2.shape[1], kw.n, dtype)
            else:
                xin, kw = args
                B, H, W, C = xin.shape
                kern = lambda: cuda_head.fused_head_level(xin, kw)  # noqa: E731
                plain = lambda: cuda_head.head_level_plain(xin, kw)  # noqa: E731
                lib, lib_in = library_head(kw, dtype), _nchw(xin)
                macs = H * W * (9 * C * (kw.c2 + kw.c3) + 9 * kw.c2 * kw.c2 + 9 * kw.c3 * kw.c3
                                + kw.c2 * 4 * kw.reg_max + kw.c3 * kw.nc)
                ins = (xin,)
                desc = f"{H}x{W} C={C}"
                tile = cuda_head.plan(H, W, C, kw.c2, kw.c3, dtype)
            got, want = kern(), plain()
            torch.cuda.synchronize()
            got, want = (got,) if torch.is_tensor(got) else got, (want,) if torch.is_tensor(want) else want
            err = 0.0
            for g_, w_ in zip(got, want):
                if g_.shape != w_.shape or not torch.isfinite(g_.float()).all():
                    raise AssertionError(f"{name} {desc} {dn}: shape {tuple(g_.shape)} vs {tuple(w_.shape)} or non-finite")
                err = max(err, float((g_.float() - w_.float()).abs().max()))
                if not torch.allclose(g_.float(), w_.float(), atol=atol, rtol=rtol):
                    raise AssertionError(f"{name} {desc} {dn}: kernel disagrees with its plain twin, max |err| {err}")
            ms, pms = cuda_ms(kern), cuda_ms(plain)
            lms = cuda_ms(lambda: lib(lib_in))
            wbytes = _nbytes(*(t for t in vars(kw).values() if torch.is_tensor(t)))
            bound, by = _bound(_nbytes(*ins, *got) + wbytes, 2.0 * B * macs, dn)
            log(
                f"kernels {dn}", card,
                f"{name:13s} {desc:32s} tile={tile[0]}x{tile[1]} smem={tile[2]}B "
                f"max_abs_err={err:.3e} kernel_ms={ms:.4f} plain_ms={pms:.4f} library_ms(cudnn walk)={lms:.4f} "
                f"bound_ms={bound:.4f} ({by})"
            )
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
        ms = cuda_ms(lambda: cuda_nms.nms_keep(cand, top, ft.iou))
        pms = cuda_ms(lambda: cuda_nms.nms_keep_plain(cand, top, ft.iou))
        n_iou = nms_iou_count(cand, ft.iou)
        bound, by = _bound(_nbytes(cand, top) + B * K, 12.0 * n_iou, "float32")
        log(
            f"kernels {dn}", card,
            f"nms_keep      B={B} K={K} kept={int(got.sum())} valid={int((top > 0).sum())} "
            f"max_abs_err=0 kernel_ms={ms:.4f} plain_ms={pms:.4f} library_ms=null bound_ms={bound:.5f} ({by}; "
            f"{n_iou} IoUs x 12 f32 ops)"
        )
        if dtype == torch.bfloat16:
            records["nms_keep"] = dict(ms=ms, plain_ms=pms, library_ms=None, bound_ms=bound, max_abs_err=0.0,
                                       ops_ms=bound if by == "operations" else 0.0,
                                       bytes_ms=bound if by == "bytes" else 0.0)
    return records


# ---------------------------------------------------------------- phase 3 --


def make_pipeline(model, params, dtype, plain):
    from yolo_tpu_torch import FusedDetectTrack

    return FusedDetectTrack(model, params, frame_hw=HW, channels=1, chunk=CHUNK, conf=0.15, iou=0.6, n_max=64,
                            d_max=16, dtype=dtype, plain=plain)


def timed_run(ft, clip):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs, stats = ft.run_clip(clip)  # ends in one device synchronisation
    return outs, stats, time.perf_counter() - t0


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
    from yolo_tpu_torch.ops import _cuda, cuda_c2f, cuda_head, cuda_nms

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

    records = check_kernels(model, params, clip[:CHUNK], card)

    ok_, sk, wk = timed_run(make_pipeline(model, params, torch.float32, plain=False), clip)
    op_, sp, wp = timed_run(make_pipeline(model, params, torch.float32, plain=True), clip)
    worst = compare_runs(ok_, op_, sk, sp)
    log("pipeline f32", card, f"kernels {sk} in {wk:.2f} s | plain {sp} in {wp:.2f} s | tracks, ids, stats equal; "
          f"max |box/conf/vel diff| {worst:.3e}")

    ft = make_pipeline(model, params, torch.bfloat16, plain=False)
    ft.run_clip(clip[:CHUNK])  # warm-up: cuDNN plans, allocator, first launches
    ft.reset()
    ft.timings = []
    counters = (cuda_c2f.fused_c2f, cuda_c2f.fused_c2f_upconcat, cuda_head.fused_head_level, cuda_nms.nms_keep)
    for f in counters:
        f.launches = 0
    ob, sb, wb = timed_run(ft, clip)  # the main path
    launches = {"c2f": cuda_c2f.fused_c2f.launches, "c2f_upconcat": cuda_c2f.fused_c2f_upconcat.launches,
                "head_level": cuda_head.fused_head_level.launches, "nms_keep": cuda_nms.nms_keep.launches}
    split = {}
    for marks in ft.timings:
        for (_, a), (name, b) in zip(marks, marks[1:]):
            split[name] = split.get(name, 0.0) + a.elapsed_time(b)
    same = sum(int((a["det_count"] == b["det_count"]).sum()) for a, b in zip(ob, ok_))
    log("pipeline bf16", card, f"{sb}; {FRAMES} frames in {wb:.3f} s = {FRAMES / wb:.1f} frames/s end to end (host clock, "
          f"upload included); device split per {FRAMES} frames: "
          + ", ".join(f"{k} {v:.1f} ms" for k, v in split.items())
          + f"; tracker {split.get('tracker', 0.0) / FRAMES:.3f} ms/frame; det_count equal to f32 on {same}/{FRAMES} frames")
    log("pipeline bf16", card, f"kernel launches in that run: {launches}")
    for k, v in launches.items():
        if v <= 0:
            raise AssertionError(f"kernel {k} was not launched on the main path")
    if not all(len(o["bbox"]) == CHUNK and o["bbox"].shape[1:] == (64, 4) for o in ob):
        raise AssertionError("unexpected packed output shape")

    if "--profile" in argv:
        from torch.profiler import ProfilerActivity, profile

        dev = torch.from_numpy(clip[:CHUNK]).cuda()
        ft.timings = None
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            ft.process_chunk_device(dev)
            torch.cuda.synchronize()
        print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25))

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
