"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Marked `cuda`: they need an NVIDIA card with nvcc (sm_90a) and skip without
one. Run them there with `python -m pytest --noconftest tests/test_torch_cuda.py`
(the suite's conftest imports JAX, which the card's machine need not have);
chip_smoke.py holds the same kernels at the main path's full shapes.
Tolerances: f32 atol = rtol = 1e-3 (summation order only); bf16 atol = rtol
= 6e-2 (every intermediate map is rounded to bf16, and a one-ulp difference
travels down the chain)."""

import numpy as np
import pytest
import torch

from yolo_tpu_torch.nn import modules as PM
from yolo_tpu_torch.ops import cuda_c2f, cuda_head, cuda_head_cm, cuda_nms

pytestmark = pytest.mark.cuda
TOL = {torch.float32: dict(atol=1e-3, rtol=1e-3), torch.bfloat16: dict(atol=6e-2, rtol=6e-2)}
# sigmoid scores (the channel-major head's cls output) are small: a tighter absolute
# tolerance, and again as logits (bf16: two ulps of the logit rounded before the sigmoid)
CLS_TOL = {torch.float32: dict(atol=1e-5, rtol=1e-3), torch.bfloat16: dict(atol=2e-3, rtol=6e-2)}
LOGIT_TOL = {torch.float32: dict(atol=1e-3, rtol=0.0), torch.bfloat16: dict(atol=6e-2, rtol=1.6e-2)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode; the CPU tests use their plain twins)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _random_convs(module, rng, dtype):
    for m in module.modules():
        if isinstance(m, (PM.ConvBNAct, PM.Conv2d)):
            fan_in = m.weight[0].numel()
            m.weight = torch.from_numpy(rng.uniform(-1, 1, tuple(m.weight.shape)) / np.sqrt(fan_in)).float().to("cuda", dtype)
            m.bias = torch.from_numpy(rng.normal(0, 0.1, tuple(m.bias.shape))).float().to("cuda", dtype)


# (c1, c2, n, shortcut, small channels of the upconcat mode or 0, B, H, W): three mid-size cases, then
# the edge shapes of chip_smoke.py's `[c2f edges]` phase (one frame, odd and undivided maps, n = 1 and 3,
# c = 12, 64 and 96, c1 = 288, both shortcut settings, upconcat with 48 and 192 small channels)
C2F_CASES = [(24, 24, 2, True, 0, 3, 20, 26), (48, 48, 3, True, 0, 3, 20, 26), (144, 96, 2, False, 96, 3, 20, 26)]
C2F_CASES += cuda_c2f.EDGE_SHAPES


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c1,c2,n,shortcut,cs,B,H,W", C2F_CASES)
def test_c2f_kernel_matches_plain(card, dtype, c1, c2, n, shortcut, cs, B, H, W):
    rng = np.random.default_rng(0)
    mod = PM.C2f(c1, c2, n=n, shortcut=shortcut)
    _random_convs(mod, rng, dtype)
    kw = mod.kernel_weights()
    skip = torch.randn(B, H, W, c1 - cs, device=card).to(dtype)
    before = (cuda_c2f.fused_c2f.launches, cuda_c2f.fused_c2f_upconcat.launches)
    if cs:
        small = torch.randn(B, H // 2, W // 2, cs, device=card).to(dtype)
        got = cuda_c2f.fused_c2f_upconcat(small, skip, kw, shortcut)
        want = cuda_c2f.c2f_upconcat_plain(small, skip, kw, shortcut)
    else:
        got = cuda_c2f.fused_c2f(skip, kw, shortcut)
        want = cuda_c2f.c2f_plain(skip, kw, shortcut)
    torch.cuda.synchronize()
    assert (cuda_c2f.fused_c2f.launches, cuda_c2f.fused_c2f_upconcat.launches) == (
        before[0] + (not cs), before[1] + bool(cs)
    )
    plan = cuda_c2f.plan(B, H, W, c1, cs, kw.c, c2, n, dtype)
    assert plan["blocks"] >= B and plan["smem"] <= 232448 and plan["tile"][0] <= H and plan["tile"][1] <= W
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def test_c2f_kernel_refuses_what_it_does_not_take(card):
    """A shape outside the kernel's reach raises; nothing falls back to the twin."""
    mod = PM.C2f(20, 24, n=1, shortcut=False)  # 20 input channels: not a multiple of 8
    _random_convs(mod, np.random.default_rng(0), torch.bfloat16)
    x = torch.randn(1, 8, 8, 20, device=card).to(torch.bfloat16)
    before = cuda_c2f.fused_c2f.launches
    with pytest.raises(ValueError, match="does not take"):
        cuda_c2f.fused_c2f(x, mod.kernel_weights(), False)
    assert cuda_c2f.fused_c2f.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,C,c2,c3,nc", cuda_head.HEAD_EDGES)
def test_head_kernel_matches_plain(card, dtype, B, H, W, C, c2, c3, nc):
    """The `[head edges]` levels: one and three frames, an odd map, a map
    narrower than the tile, P5's C = 192, c3 = 192, nc = 3, 17 and 80, and
    yolov8x's c2 = 80 with C = 320 and 512."""
    kw = cuda_head.HeadWeights.random(C, c2, c3, nc, seed=1, device=card, dtype=dtype)
    x = torch.randn(B, H, W, C, device=card).to(dtype)
    before = (cuda_head.fused_head_level.launches, cuda_head_cm.head_level_cm.launches)
    got_d, got_c = cuda_head.fused_head_level(x, kw)
    want_d, want_c = cuda_head.head_level_plain(x, kw)
    torch.cuda.synchronize()
    assert (cuda_head.fused_head_level.launches, cuda_head_cm.head_level_cm.launches) == (before[0] + 1, before[1])
    assert got_c.dtype == dtype and got_c.shape == (B, H * W, nc)
    plan = cuda_head.plan(B, H, W, C, c2, c3, nc, dtype)
    assert plan["smem"] <= 232448 and plan["tile"][0] <= H and plan["tile"][1] <= W and 1 <= plan["blocks"] <= plan["tiles"]
    torch.testing.assert_close(got_d, want_d, **TOL[dtype])
    torch.testing.assert_close(got_c.float(), want_c.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,W,C,c2,c3,nc", cuda_head.HEAD_EDGES)
def test_head_cm_kernel_matches_plain(card, dtype, B, H, W, C, c2, c3, nc):
    """The `[head edges]` levels through the channel-major entry (sigmoid inside)."""
    kw = cuda_head.HeadWeights.random(C, c2, c3, nc, seed=2, device=card, dtype=dtype)
    x = torch.randn(B, H, W, C, device=card).to(dtype)
    before = (cuda_head_cm.head_level_cm.launches, cuda_head.fused_head_level.launches)
    got_d, got_c = cuda_head_cm.head_level_cm(x, kw)
    want_d, want_c = cuda_head_cm.head_level_cm_plain(x, kw)
    torch.cuda.synchronize()
    assert (cuda_head_cm.head_level_cm.launches, cuda_head.fused_head_level.launches) == (before[0] + 1, before[1])
    assert got_c.dtype == torch.float32 and got_c.shape == (B, H * W, nc)
    torch.testing.assert_close(got_d, want_d, **TOL[dtype])
    torch.testing.assert_close(got_c, want_c, **CLS_TOL[dtype])
    torch.testing.assert_close(torch.logit(got_c.double(), eps=1e-12), torch.logit(want_c.double(), eps=1e-12), **LOGIT_TOL[dtype])


def test_head_kernel_refuses_what_it_does_not_take(card):
    """A level outside the bf16 kernel's reach (C = 20: an input pixel is not a
    whole number of 16-byte copies) raises; nothing falls back to the twin."""
    kw = cuda_head.HeadWeights.random(20, 64, 24, 1, device=card, dtype=torch.bfloat16)
    x = torch.randn(1, 8, 8, 20, device=card).to(torch.bfloat16)
    before = (cuda_head.fused_head_level.launches, cuda_head_cm.head_level_cm.launches)
    with pytest.raises(ValueError, match="do not take"):
        cuda_head.fused_head_level(x, kw)
    with pytest.raises(ValueError, match="do not take"):
        cuda_head_cm.head_level_cm(x, kw)
    assert (cuda_head.fused_head_level.launches, cuda_head_cm.head_level_cm.launches) == before


@pytest.mark.parametrize("B,K", cuda_nms.NMS_EDGES)
def test_nms_kernel_matches_plain(card, B, K):
    """Bit for bit, at one image and a chunk, K from 1 to 4096 (both forms of the
    plan), with ties, duplicates, padding and all-padding images. The twin runs
    16 images at a time: its (B, K, K) IoU matrix at 128 x 4096 would not fit."""
    boxes, scores = cuda_nms.edge_candidates(B, K, seed=K, device=card)
    before = cuda_nms.nms_keep.launches
    got = cuda_nms.nms_keep(boxes, scores, 0.5)
    assert cuda_nms.nms_keep.launches == before + 1
    want = torch.cat([cuda_nms.nms_keep_plain(boxes[i : i + 16], scores[i : i + 16], 0.5) for i in range(0, B, 16)])
    assert got.dtype == torch.bool and torch.equal(got, want)
    assert K == 1 or 0 < int(got.sum()) < int((scores > 0).sum())


def test_nms_plan_forms(card):
    """nms.cu's plan: one launch, a block per image, while an image's boxes, areas
    and mask fit a block (every K of the main path, the predict facade and d_max =
    300, up to K = 1280); two launches (mask rows over many blocks into a scratch of
    K rows of ceil(K / 32) words per image) from K = 1281 on."""
    for B, K in ((128, 64), (1, 64), (1, 1024), (8, 1024), (128, 1024), (128, 1200), (1, 1280), (4096, 64)):
        p = cuda_nms.plan(B, K)
        assert (p["launches"], p["blocks"], p["row_blocks"], p["scratch_words"]) == (1, B, 0, 0), (B, K)
        assert p["smem"] == 20 * K + 4 * (K + 1) * ((K + 31) // 32) <= 227 * 1024 - 1024
    for B, K in ((1, 1281), (1, 4096), (128, 4096)):
        p = cuda_nms.plan(B, K)
        W = (K + 31) // 32
        assert p["launches"] == 2 and p["scratch_words"] == B * K * W and 1 <= p["row_blocks"] <= W, (B, K)
        assert p["blocks"] == B * p["row_blocks"] + -(-B // 4) and p["smem"] == 16 * W


def test_nms_kernel_refuses_what_it_does_not_take(card):
    boxes, scores = cuda_nms.edge_candidates(2, 8, device=card)
    for b, s in ((boxes.double(), scores), (boxes, scores[:, :4]), (boxes[:, :0], scores[:, :0]), (boxes[..., :3], scores)):
        with pytest.raises(ValueError, match="nms_keep takes"):
            cuda_nms.nms_keep(b, s, 0.5)


def _he_normal_params(model, seed: int = 0) -> dict:
    """The seeded tree the d_max=300 test was written with: He-normal convs, zero biases and the
    head's priors, BN folded. `DetectionModel.init` now draws the JAX package's tree, whose small
    activations leave every P5 score of a random frame at the class prior (1.56e-4, above conf 1e-4):
    100 anchors a frame tied exactly, which the kernels' and the twins' last-ulp differences order
    apart, so their tracks could not be held equal."""
    import math

    rng = np.random.default_rng(seed)

    def tree(m):
        if isinstance(m, (PM.ConvBNAct, PM.Conv2d)):
            leaf = {"weight": rng.normal(0.0, math.sqrt(2.0 / (m.c1 * m.k * m.k)), (m.k, m.k, m.c1, m.c2)).astype(np.float32),
                    "bias": np.zeros(m.c2, np.float32)}
            return {"conv": leaf} if isinstance(m, PM.ConvBNAct) else leaf
        return {name: tree(child) for name, child in m.named_children()}

    params = {"model": {str(i): tree(m) for i, m in enumerate(model.layers)}}
    head = model.head
    hp = params["model"][str(len(model.layers) - 1)]
    hp["dfl"] = {"conv": {"weight": np.arange(head.reg_max, dtype=np.float32).reshape(1, 1, head.reg_max, 1)}}
    for l, s in enumerate(head.stride):
        hp["cv2"][str(l)]["2"]["bias"][:] = 1.0
        hp["cv3"][str(l)]["2"]["bias"][:] = math.log(5 / head.nc / (640 / s) ** 2)
    return params


def test_fused_detect_track_d_max_300_kernels_match_plain(card):
    """FusedDetectTrack(d_max=300) gives max_nms = 1200 candidate slots, more than
    the first NMS kernel took: f32 through the kernels equals f32 through the twins in tracks, ids, statuses and stats."""
    from yolo_tpu_torch import DetectionModel, FusedDetectTrack

    model = DetectionModel("yolov8n.yaml", device=card)
    params = _he_normal_params(model)
    clip = np.random.default_rng(5).integers(0, 255, (16, 320, 320, 1), np.uint8)
    clip[:, 100:116, 60:76] = 255
    kw = dict(frame_hw=(320, 320), chunk=8, conf=1e-4, n_max=512, d_max=300, dtype=torch.float32)
    ft = FusedDetectTrack(model, params, **kw)
    assert ft.max_nms == 1200
    before = cuda_nms.nms_keep.launches
    got_outs, got_stats = ft.run_clip(clip)
    assert cuda_nms.nms_keep.launches == before + 2
    want_outs, want_stats = FusedDetectTrack(model, params, plain=True, **kw).run_clip(clip)
    assert got_stats == want_stats and got_stats["detection_frames"] > 0
    for got, want in zip(got_outs, want_outs):
        for k in ("emit", "status", "track_num", "time_since_update", "det_count"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        for k in ("bbox", "confidence", "velocity"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-2, err_msg=k)


@pytest.mark.parametrize("pallas_head2", [False, True])
def test_fused_detect_track_bgr_kernels_match_plain(card, pallas_head2):
    """3-channel BGR chunks through FusedDetectTrack on the card: f32 through
    the kernels equals f32 through the twins in tracks, ids, statuses and stats."""
    from yolo_tpu_torch import DetectionModel, FusedDetectTrack

    model = DetectionModel("yolov8n.yaml", device=card)
    params = model.init(0)
    clip = np.random.default_rng(3).integers(0, 255, (16, 64, 64, 3), np.uint8)
    clip[:, 20:28, 30:38] = 255
    kw = dict(frame_hw=(64, 64), channels=3, chunk=8, conf=1e-4, n_max=8, d_max=4, dtype=torch.float32, pallas_head2=pallas_head2)
    name = cuda_head_cm.head_level_cm if pallas_head2 else cuda_head.fused_head_level
    before = name.launches
    got_outs, got_stats = FusedDetectTrack(model, params, **kw).run_clip(clip)
    assert name.launches == before + 2 * len(model.stride)
    want_outs, want_stats = FusedDetectTrack(model, params, plain=True, **kw).run_clip(clip)
    assert got_stats == want_stats and got_stats["detection_frames"] > 0
    for got, want in zip(got_outs, want_outs):
        for k in ("emit", "status", "track_num", "time_since_update", "det_count"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        for k in ("bbox", "confidence", "velocity"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-2, err_msg=k)


def test_batched_multi_target_tracker_on_the_card_equals_cpu(card):
    from yolo_tpu_torch.kalman.batched import BatchedMultiTargetTracker

    rng = np.random.default_rng(4)
    T, D = 40, 4
    boxes, mask = np.zeros((T, D, 4), np.float32), np.zeros((T, D), bool)
    for t in range(T):
        for i, (x0, y0, vx, vy) in enumerate(((20.0, 30.0, 2.0, 1.0), (200.0, 90.0, -1.5, 0.5))):
            if i == 0 and 10 <= t < 20:
                continue  # a dropout: the track coasts
            cx, cy = x0 + vx * t + rng.normal(0, 0.3), y0 + vy * t + rng.normal(0, 0.3)
            boxes[t, i], mask[t, i] = (cx - 5, cy - 5, cx + 5, cy + 5), True
    on_card, on_cpu = (BatchedMultiTargetTracker(n_max=8, d_max=D, device=d) for d in (card, "cpu"))
    for t in range(15):
        dets = [[*b, 0.9] for b, m in zip(boxes[t], mask[t]) if m]
        got, want = on_card.update(dets), on_cpu.update(dets)
        assert [(g["track_id"], g["status"], g["time_since_update"]) for g in got] == [
            (w["track_id"], w["status"], w["time_since_update"]) for w in want]
        for g, w in zip(got, want):
            np.testing.assert_allclose(g["bbox"], w["bbox"], rtol=0, atol=1e-3)
    got, want = on_card.scan_frames(boxes[15:], mask[15:]), on_cpu.scan_frames(boxes[15:], mask[15:])
    for k in ("emit", "status", "track_num", "time_since_update"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    np.testing.assert_allclose(got["bbox"][got["emit"]], want["bbox"][want["emit"]], rtol=0, atol=1e-3)


def _rich_stream(n_frames=60, seed=3, n_targets=5):
    """tests/test_torch_trackers.py::_rich_stream (that module imports JAX, which the card's
    machine lacks): well separated targets with a dropout, a low-confidence dip, a late
    joiner and a departure → per frame [(xywh, conf, cls), ...]."""
    rng = np.random.default_rng(seed)
    starts = rng.uniform([60, 60], [560, 420], (n_targets, 2))
    vels = rng.uniform(-4, 4, (n_targets, 2))
    frames = []
    for f in range(n_frames):
        dets = []
        for t in range(n_targets):
            if (t == 2 and 20 <= f < 28) or (t == 3 and f < 10) or (t == 4 and f > 45):
                continue
            cx, cy = starts[t] + vels[t] * f
            if not (20 < cx < 620 and 20 < cy < 490):
                continue
            dets.append(([cx, cy, 26 + 2 * t, 18 + t], 0.18 if t == 1 and 30 <= f < 36 else 0.9, t % 3))
        frames.append(dets)
    return frames


@pytest.mark.parametrize("n_max,d_max", [(64, 16), (8, 4)])
def test_batched_byte_tracker_on_the_card_equals_cpu(card, n_max, d_max):
    """update frame by frame, then scan_frames over a second stretch: ids exact, rows 1e-4. With
    d_max 4 the frames of five targets lose their fifth detection, as in JAX, with one warning each."""
    import warnings

    from yolo_tpu_torch.trackers.batched import BatchedBYTETracker

    frames = _rich_stream()
    on_card, on_cpu = (BatchedBYTETracker(n_max=n_max, d_max=d_max, device=d) for d in (card, "cpu"))
    rng = np.random.default_rng(1)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        for f, dets in enumerate(frames[:40]):
            boxes = np.array([d[0] for d in dets], np.float32).reshape(-1, 4) + rng.normal(0, 0.25, (len(dets), 4)).astype(np.float32)
            scores, cls = np.array([d[1] for d in dets], np.float32), np.array([d[2] for d in dets], np.float32)
            got, want = on_card.update(boxes, scores, cls), on_cpu.update(boxes, scores, cls)
            assert got.shape == want.shape, f
            np.testing.assert_array_equal(got[:, 4], want[:, 4])
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-4, err_msg=f"frame {f}")
    assert len([w for w in seen if "d_max" in str(w.message)]) == (2 if d_max < 5 else 0)
    T, D = 20, d_max
    seq = [np.zeros((T, D, 4), np.float32), np.zeros((T, D), np.float32), np.zeros((T, D), np.float32), np.zeros((T, D), bool)]
    for f, dets in enumerate(frames[40:]):
        for i, (b, s, c) in enumerate(dets[:D]):
            seq[0][f, i], seq[1][f, i], seq[2][f, i], seq[3][f, i] = b, s, c, True
    got, want = on_card.scan_frames(*seq), on_cpu.scan_frames(*seq)
    for k in ("emit", "track_id", "det_idx"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in ("xyxy", "score", "cls"):
        np.testing.assert_allclose(got[k][got["emit"]], want[k][want["emit"]], rtol=0, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("tracker", ["bytetrack.yaml", "botsort-none"])
def test_yolo_track_kernels_match_plain(card, tracker, tmp_path):
    """YOLO(best.npz).track on the card, f32, through the kernels and through the plain
    twins (`plain=True`): equal row counts and ids, boxes 1e-2 px, conf 1e-4. BoT-SORT
    runs with gmc_method none (the card's machine has no cv2)."""
    from pathlib import Path

    from yolo_tpu_torch import YOLO

    if tracker == "botsort-none":
        cfg = (Path(__file__).resolve().parents[1] / "yolo_tpu_torch" / "cfg" / "trackers" / "botsort.yaml").read_text()
        tracker = str(tmp_path / "botsort_none.yaml")
        Path(tracker).write_text(cfg.replace("gmc_method: sparseOptFlow", "gmc_method: none"))
    weights = Path(__file__).resolve().parents[1] / "demos" / "artifacts" / "train" / "weights" / "best.npz"
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:512, 0:640]
    frames = []
    for f in range(8):
        img = 30 + rng.normal(0, 2, (512, 640))
        for x0, y0, vx, vy in ((100, 120, 6, 2), (400, 300, -5, 3), (300, 80, 1, 5)):
            img = img + 170 * np.exp(-((xx - x0 - vx * f) ** 2 + (yy - y0 - vy * f) ** 2) / (2 * 4.0**2))
        frames.append(np.repeat(np.clip(img, 0, 255).astype(np.uint8)[..., None], 3, -1))
    runs = []
    for plain in (False, True):
        model = YOLO(str(weights))
        runs.append([model.track(fr, persist=True, tracker=tracker, plain=plain, compute_dtype="float32", verbose=False)[0] for fr in frames])
    n_ids = set()
    for g, w in zip(*runs):
        assert len(g) == len(w) and g.boxes.is_track == w.boxes.is_track
        if len(g):
            np.testing.assert_array_equal(g.boxes.id, w.boxes.id)
            np.testing.assert_allclose(g.boxes.xyxy, w.boxes.xyxy, rtol=0, atol=1e-2)
            np.testing.assert_allclose(g.boxes.conf, w.boxes.conf, rtol=0, atol=1e-4)
            n_ids |= set(g.boxes.id.tolist())
    assert n_ids == {1.0, 2.0, 3.0}


def test_predict_center_torch_on_the_card_equals_numpy(card):
    """The grayscale window scorer on the card, 64 seeded 40x40 ROIs at once and a constant
    ROI: the numpy scorer's index (first maximum) and its score at rel 1e-5."""
    from yolo_tpu_torch.grayscale.scoring import gradient_window_scores, predict_center_torch

    rois = np.random.default_rng(0).integers(0, 256, (64, 40, 40)).astype(np.uint8)
    best, score = predict_center_torch(torch.from_numpy(rois).to(card))
    assert best.is_cuda and score.is_cuda and best.shape == (64, 2)
    for i, roi in enumerate(rois):
        s = gradient_window_scores(roi)
        iy, ix = np.unravel_index(int(np.argmax(s)), s.shape)
        assert tuple(best[i].tolist()) == (iy, ix), i
        assert float(score[i]) == pytest.approx(float(s[iy, ix]), rel=1e-5)
    b, s = predict_center_torch(torch.full((40, 40), 77, dtype=torch.uint8, device=card))
    assert b.tolist() == [0, 0] and float(s) == 77.0


def test_motion_detector_kernels_match_plain(card):
    """chip_smoke's config-5 detector (gray frames, /255, broadcast to the stem, predict_parts and
    NMS at conf 0.15, iou 0.6, max_det 16) on one 128-frame chunk of the panning clip, in f32
    through the kernels and through the twins: equal valid slots, boxes 1e-2 px, scores 1e-4."""
    import chip_smoke
    from yolo_tpu_torch import load_npz

    model, params, _ = load_npz(chip_smoke.WEIGHTS, device=card)
    frames = torch.from_numpy(chip_smoke.make_panning_clip(128)).to(card)
    before = cuda_nms.nms_keep.launches
    got = chip_smoke.motion_detector(model, params, torch.float32, plain=False)(frames)
    want = chip_smoke.motion_detector(model, params, torch.float32, plain=True)(frames)
    assert cuda_nms.nms_keep.launches == before + 1
    assert torch.equal(got["valid"], want["valid"]) and int(got["valid"].sum()) > 0
    torch.testing.assert_close(got["boxes"], want["boxes"], atol=1e-2, rtol=0)
    torch.testing.assert_close(got["scores"], want["scores"], atol=1e-4, rtol=0)


def test_yolo_val_kernels_match_plain(card, tmp_path):
    """YOLO(best.npz).val on the card, f32, through the kernels and through the plain twins
    (`plain=True`), on 8 frames of 640x512 (chip_smoke's copy of the demo's split writer) at
    imgsz 640, batch 3 (a partial last batch): every metric within 1e-4, equal confusion
    matrices, each of kernels 1, 2, 3 and 5 launched once a batch."""
    pytest.importorskip("cv2")
    import chip_smoke
    from yolo_tpu_torch import YOLO

    data = chip_smoke.write_split(tmp_path, 8, 10_000)
    counters = chip_smoke.launch_counters()
    runs = []
    for plain in (False, True):
        before = {k: f.launches for k, f in counters.items()}
        model = YOLO(str(chip_smoke.WEIGHTS))
        runs.append((model.val(data=str(data), imgsz=640, batch=3, plots=False, plain=plain), model.validator))
        launched = {k: f.launches - before[k] for k, f in counters.items()}
        per_batch = {"c2f": 6, "c2f_upconcat": 3, "head_level": 4, "head_level_cm": 0, "nms_keep": 1}
        assert launched == {k: 0 if plain else 3 * n for k, n in per_batch.items()}
    (got, gv), (want, wv) = runs
    assert got["mAP50"] > 0.5
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-4, k
    np.testing.assert_array_equal(gv.confusion_matrix.matrix, wv.confusion_matrix.matrix)


def _train_split(root):
    """chip_smoke's training split cut to 16 + 8 frames of 640x512 (the demo's writer)."""
    import chip_smoke

    chip_smoke.write_split(root, 16, 0, split="train")
    return chip_smoke.write_split(root, 8, 10_000)


def test_train_step_f32_card_matches_cpu(card, tmp_path):
    """chip_smoke's `[train step f32]`: one f32 step of yolov8-small (forward, loss, backward,
    AdamW, BN moments; B = 16 at 640x640) on the card and on the CPU from the same tree and batch,
    within chip_smoke.TRAIN_STEP_TOL."""
    pytest.importorskip("cv2")
    import chip_smoke

    chip_smoke.train_step_f32_phase(_train_split(tmp_path), "card test")


def test_train_val_kernels_match_plain(card, tmp_path):
    """chip_smoke's `[train val kernels]` on weights the trainer made on the card: best.npz after one
    epoch of the IR recipe (batch 8), validated in f32 through the kernels and through the twins:
    metrics within 1e-4, equal confusion matrices and detections."""
    pytest.importorskip("cv2")
    import chip_smoke
    from yolo_tpu_torch import YOLO

    data = _train_split(tmp_path)
    y = YOLO(str(chip_smoke.WEIGHTS))
    y.train(data=str(data), project=str(tmp_path), name="t", plots=False, **{**chip_smoke.TRAIN_RECIPE, "epochs": 1, "batch": 8})
    assert y.metrics["mAP50"] > 0.5
    chip_smoke.train_val_kernels_phase({"finetune": y}, data, "card test")


def _ir_frames(n, h=512, w=640):
    """`n` seeded (h, w, 1) IR frames with two 4-px-sigma targets moving across."""
    rng = np.random.default_rng(1)
    yy, xx = np.mgrid[0:h, 0:w]
    frames = []
    for f in range(n):
        img = 30 + rng.normal(0, 2, (h, w))
        for x0, y0, vx, vy in ((100, 120, 6, 2), (400, 300, -5, 3)):
            img = img + 170 * np.exp(-((xx - x0 - vx * f) ** 2 + (yy - y0 - vy * f) ** 2) / (2 * 4.0**2))
        frames.append(np.clip(img, 0, 255).astype(np.uint8)[..., None])
    return frames


def test_server_kernels_match_plain(card):
    """A DetectionServer on the card answering 8 frames of 640x512 from 2 client threads (1- and 3-channel),
    f32 through the kernels, against a second server f32 through the twins (`plain`): every status 0,
    equal counts and classes, boxes 1e-2 px, conf 1e-4; kernels 1, 2, 3 and 5 launched by the first only."""
    import chip_smoke

    frames = _ir_frames(8)
    jobs = [[(0, f) for f in frames[:4]], [(0, np.repeat(f, 3, -1)) for f in frames[4:]]]
    replies = []
    for plain, path in ((False, chip_smoke.SERVE_PATH), (True, set())):
        with chip_smoke.serving({0: str(chip_smoke.WEIGHTS)}, predict_args={"compute_dtype": "float32", "plain": plain}) as srv:
            (out, _), _ = chip_smoke.counted(path, lambda: chip_smoke.run_clients(srv.port, jobs))
        replies.append([r for rs, _ in out for r in rs])
    assert sum(len(r) for r in replies[0]) >= 8
    chip_smoke.same_dets(*replies, "server kernels vs twins")


def test_predict_resized_frame_native_route(card):
    """YOLO(best.npz).predict of a 300x500 frame (the letterbox scales it by 1.28) on the card through the
    native letterbox, f32 kernels against f32 twins at the f32 gates."""
    import chip_smoke
    from yolo_tpu_torch import YOLO

    frame = np.ascontiguousarray(np.repeat(_ir_frames(1)[0][100:400, 50:550], 3, -1))  # both targets inside
    with chip_smoke.native_letterboxes() as calls:
        got = YOLO(str(chip_smoke.WEIGHTS)).predict(frame, compute_dtype="float32", verbose=False)[0]
    want = YOLO(str(chip_smoke.WEIGHTS)).predict(frame, compute_dtype="float32", plain=True, verbose=False)[0]
    assert calls == [(300, 500, 3)] and len(got) == 2
    chip_smoke.same_dets([got.boxes.data], [want.boxes.data], "predict 300x500")


def _slice_input(kind, card):
    """The device input of one 640x512 IR frame on a new path: its 9 tiles of 256x256 padded to B = 16
    (tiled inference), or its 640x640 letterbox at one of test-time augmentation's scales (1, 0.83
    flipped, 0.67: 640, 544 and 448 square)."""
    import chip_smoke
    from yolo_tpu_torch.engine.predictor import _snap_batch
    from yolo_tpu_torch.nn.tasks import _scale_img
    from yolo_tpu_torch.ops.tiling import slice_tiles, tile_grid

    frame = np.repeat(_ir_frames(1)[0], 3, -1)
    if kind == "tiles":
        grid = tile_grid(512, 640, chip_smoke.TILE, chip_smoke.TILE_OVERLAP)
        tiles = np.zeros((_snap_batch(len(grid)), chip_smoke.TILE, chip_smoke.TILE, 3), np.uint8)
        tiles[: len(grid)] = slice_tiles(frame, grid, chip_smoke.TILE)
        return torch.from_numpy(tiles).to(card).flip(-1).float() / 255.0
    ratio = float(kind)
    x = chip_smoke.letterboxed(frame)
    return _scale_img(x.flip(2) if ratio == 0.83 else x, ratio, 32)


@pytest.mark.parametrize("kind, shape", [("tiles", (16, 256, 256, 3)), ("1.0", (1, 640, 640, 3)), ("0.83", (1, 544, 544, 3)),
                                         ("0.67", (1, 448, 448, 3))], ids=["tiles-B16-256", "tta-640", "tta-544", "tta-448"])
def test_kernels_at_the_tile_and_tta_shapes(card, kind, shape):
    """Kernels 1, 2, 3 and 5 against their twins (f32, TOL; NMS bit for bit) on best.npz's activations at
    the shapes tiled inference and test-time augmentation give them (P2 64x64 at B = 16; 160, 136, 112)."""
    import chip_smoke
    from yolo_tpu_torch import load_npz, params_from_jax

    model, params, _ = load_npz(chip_smoke.WEIGHTS, device=card)
    params_from_jax(model, params, torch.float32)
    x = _slice_input(kind, card)
    assert tuple(x.shape) == shape
    worst = chip_smoke.hold_path_kernels([model], x, f"{kind} {shape}", "card test")
    assert set(worst) == {"c2f", "c2f_upconcat", "head_level", "nms_keep"}


@pytest.mark.parametrize("phase", ["tiled_phase", "tta_phase", "ensemble_phase", "embed_phase", "enhance_phase", "video_phases"])
def test_slice_phases_on_the_card(card, phase, monkeypatch):
    """chip_smoke's phases of the new paths on 4 frames (8 for the enhancement and the video): tiled
    inference, TTA, the ensemble of best.npz and last.npz, embed (f32 kernels against twins at the f32
    gates, each kernel of the path launched), the enhancement on the card against the CPU, and the
    detect_only / single-target video loops."""
    pytest.importorskip("cv2")
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "SLICE_FRAMES", 4)
    monkeypatch.setattr(chip_smoke, "ENHANCE_FRAMES", 8)
    monkeypatch.setattr(chip_smoke, "ENHANCE_CPU_FRAMES", 4)
    monkeypatch.setattr(chip_smoke, "VIDEO_FRAMES", 8)
    getattr(chip_smoke, phase)(np.stack(_ir_frames(8)), "card test")


def test_run_clip_options_on_the_card(card):
    """FusedDetectTrack on the card (f32, 16 frames in chunks of 8): prefetch 1 and 4 give the default
    run's outputs and stats exactly, collect_outputs=False no outputs and the same stats,
    collect_stats=False {}; put_frames stages a chunk on the card that process_chunk_device takes."""
    import chip_smoke
    from yolo_tpu_torch import FusedDetectTrack, load_npz

    model, params, _ = load_npz(chip_smoke.WEIGHTS, device=card)
    clip = np.stack(_ir_frames(16))
    ft = FusedDetectTrack(model, params, chunk=8, dtype=torch.float32)
    want_outs, want_stats = ft.run_clip(clip)
    assert want_stats["detection_frames"] > 0
    for opts in (dict(prefetch=1), dict(prefetch=4), dict(collect_outputs=False), dict(collect_stats=False)):
        ft.reset()
        outs, stats = ft.run_clip(clip, **opts)
        assert stats == ({} if opts.get("collect_stats") is False else want_stats)
        assert len(outs) == (0 if opts.get("collect_outputs") is False else 2)
        for o, w in zip(outs, want_outs):
            for k in o:
                np.testing.assert_array_equal(o[k], w[k], err_msg=f"{opts} {k}")
    ft.reset()
    staged = ft.put_frames(clip[:8])
    assert staged.is_cuda and torch.equal(staged.cpu(), torch.from_numpy(clip[:8]))
    np.testing.assert_array_equal(ft.process_chunk_device(staged).cpu().numpy()[..., 8], want_outs[0]["track_num"])


@pytest.mark.parametrize("k, s, cin, cout, B, H, W", [(3, 1, 192, 64, 2, 20, 26), (3, 2, 1, 16, 2, 64, 80), (1, 1, 48, 40, 1, 2, 3),
                                                       (3, 1, 64, 64, 8, 128, 160)])
def test_int8_conv_on_the_card_equals_cpu(card, k, s, cin, cout, B, H, W):
    """The int8 conv (im2col into torch._int_mm, K, N and M padded for the card's int8 GEMM) on the card
    equals the CPU's exactly, a one-row map (M = 6 < 17) included."""
    from yolo_tpu_torch.nn import quantize as PQ

    rng = np.random.default_rng(cin)
    x = torch.from_numpy(rng.integers(-127, 128, (B, H, W, cin)).astype(np.int8))
    w = rng.integers(-127, 128, (k, k, cin, cout)).astype(np.int8)
    want = PQ.int8_conv(x, PQ.weight_matrix(w, "cpu"), k, s, cout)
    got = PQ.int8_conv(x.to(card), PQ.weight_matrix(w, card), k, s, cout)
    assert torch.equal(got.cpu(), want)


def test_fused_int8_on_the_card_matches_plain(card, monkeypatch):
    """FusedDetectTrack(int8=True) on best.npz, 16 frames of 512x640 in chunks of 8, f32, calibrated on the
    first chunk (its scales within three bf16 ulps between the devices; the runs use the CPU's): the card's
    run (the NMS kernel, the only kernel on the route) equals its twins' run on the card in tracks, ids,
    statuses and stats, boxes within 1e-2 px. Its codes follow each f32 SiLU, whose last bit the card's and
    the CPU's logistic may round apart, and a flipped code moves a box by a quantization step."""
    import chip_smoke
    import yolo_tpu_torch.pipeline.fused as PF
    from yolo_tpu_torch import FusedDetectTrack, load_npz
    from yolo_tpu_torch.nn import quantize as PQ

    model, params, _ = load_npz(chip_smoke.WEIGHTS, device="cpu")
    clip = np.stack(_ir_frames(16))
    kw = dict(chunk=8, conf=0.15, iou=0.6, dtype=torch.float32, int8=True, int8_calib=clip[:8])
    cpu_scales = {}
    real = PQ.calibrate_act_scales

    def calibrate(m, p, cal):
        if not cpu_scales:
            cpu_scales.update(real(m, p, cal))
            on_card = real(type(m)(m.yaml, ch=p["model"]["0"]["conv"]["weight"].shape[2], device=card), p, cal)
            assert all(abs(on_card[k] - v) <= 3 * 2**-7 * v for k, v in cpu_scales.items())
        return dict(cpu_scales)

    monkeypatch.setattr(PF, "calibrate_act_scales", calibrate)
    want_outs, want_stats = FusedDetectTrack(model, params, device=card, plain=True, **kw).run_clip(clip)
    got_outs, got_stats = chip_smoke.counted({"nms_keep"}, lambda: FusedDetectTrack(model, params, device=card, **kw).run_clip(clip))[0]
    assert got_stats == want_stats and want_stats["detection_frames"] > 0
    chip_smoke.compare_runs(got_outs, want_outs, got_stats, want_stats)


def test_predict_settings_phases_on_the_card(card):
    """chip_smoke's `[predict int8]` (f32 kernel against twin, then bf16), `[predict visualize]` (25 arrays)
    and `[predict show]` (headless: one warning, the same Results) on 16 frames."""
    import chip_smoke

    chip_smoke.predict_settings_phase(np.stack(_ir_frames(16)), "card test")


def test_remat_train_step_on_the_card(card):
    """The train form on the card in f32: remat gives the loss of the plain walk within 1e-4 relative and its
    gradients within `[train step f32]`'s tolerance (1e-3 of each tensor's largest)."""
    from yolo_tpu_torch.nn.tasks import DetectionModel, load_train_params, train_leaves

    m = DetectionModel("yolov8-small.yaml", device=card)
    load_train_params(m, m.init(0))
    m.train()
    x = torch.from_numpy(np.stack(_ir_frames(2, 128, 160)).repeat(3, -1)).to(card)
    runs = []
    for remat in (False, True):
        for p in train_leaves(m).values():
            p.grad = None
        loss = sum(o.square().mean() for o in m.forward_features(x.float() / 255.0, remat=remat))
        loss.backward()
        runs.append((loss.item(), [p.grad.clone() for p in train_leaves(m).values() if isinstance(p, torch.nn.Parameter)]))
    loss, grads = runs[1]
    assert abs(loss - runs[0][0]) <= 1e-4 * abs(runs[0][0])
    for a, b in zip(grads, runs[0][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-3 * float(b.abs().max()) + 1e-7)
    m.eval()


def test_train_autobatch_at_640_completes_a_step(card, tmp_path):
    """`YOLO("yolov8-small.yaml").train(batch=-1)` at 640 in bf16: autobatch probes with the trainer's own step
    and picks a batch of at least 16, and steps at that batch run (one epoch of full batches over a 256-image
    split, finite losses)."""
    import chip_smoke
    from yolo_tpu_torch import YOLO

    data = chip_smoke.autobatch_split(tmp_path)
    y = YOLO("yolov8-small.yaml")
    y.train(data=str(data), project=str(tmp_path), name="auto", **chip_smoke.AUTOBATCH_RUN)
    t = y.trainer
    row = t._last_row
    assert 16 <= t.args.batch <= chip_smoke.AUTOBATCH_IMAGES and t.train_loader.batch_size == t.args.batch
    assert len(t.timings) == len(t.train_loader) >= 1
    assert all(np.isfinite(row[f"train/{k}_loss"]) for k in ("box", "cls", "dfl"))


# yolov8n-cls's C2f instances at imgsz 224: (c1, c2, n, H = W), all with the residual
CLS_C2F = [(32, 32, 1, 56), (64, 64, 2, 28), (128, 128, 2, 14), (256, 256, 1, 7)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [1, 32])
@pytest.mark.parametrize("c1,c2,n,hw", CLS_C2F, ids=[f"c{c1 // 2}-{hw}x{hw}" for c1, _, _, hw in CLS_C2F])
def test_c2f_kernel_at_the_classify_shapes(card, dtype, B, c1, c2, n, hw):
    """The C2f kernel against its twin at the four yolov8n-cls instances (c = 16, 32, 64, 128 on 56² to
    7²), B = 1 (predict) and 32 (validation), seeded weights; one launch counted, a plan within the map."""
    mod = PM.C2f(c1, c2, n=n, shortcut=True)
    _random_convs(mod, np.random.default_rng(c1), dtype)
    kw = mod.kernel_weights()
    x = torch.randn(B, hw, hw, c1, device=card, generator=torch.Generator(card).manual_seed(B)).to(dtype)
    before = cuda_c2f.fused_c2f.launches
    got, want = cuda_c2f.fused_c2f(x, kw, True), cuda_c2f.c2f_plain(x, kw, True)
    torch.cuda.synchronize()
    assert cuda_c2f.fused_c2f.launches == before + 1
    plan = cuda_c2f.plan(B, hw, hw, c1, 0, kw.c, c2, n, dtype)
    assert plan["tile"][0] <= hw and plan["tile"][1] <= hw and plan["smem"] <= 232448
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def test_classify_forward_on_the_card_matches_twins(card):
    """yolov8n-cls at full width (nc 1000, the JAX package's initial tree): the f32 probabilities through the
    kernel against the twins (1e-4, top-1 equal) and against the CPU's (1e-4) on 4 seeded 224² images, kernel 1
    launched 4 times a forward; bf16 through the kernel against the bf16 twins (6e-2)."""
    from yolo_tpu_torch import YOLO
    from yolo_tpu_torch.nn.tasks import install_params

    y = YOLO("yolov8n-cls.yaml")
    x = torch.from_numpy(np.random.default_rng(3).uniform(0, 1, (4, 224, 224, 3)).astype(np.float32))
    install_params(y.model, y.params, card, torch.float32)
    before = cuda_c2f.fused_c2f.launches
    got = y.model.predict(x.to(card))
    assert cuda_c2f.fused_c2f.launches == before + 4
    want = y.model.predict(x.to(card), plain=True)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
    assert torch.equal(got.argmax(-1), want.argmax(-1)) and got.shape == (4, 1000)
    cpu = YOLO("yolov8n-cls.yaml", device="cpu")
    install_params(cpu.model, cpu.params, torch.device("cpu"), torch.float32)
    torch.testing.assert_close(got.cpu(), cpu.model.predict(x), atol=1e-4, rtol=0)
    install_params(y.model, y.params, card, torch.bfloat16)
    xb = x.to(card, torch.bfloat16)
    torch.testing.assert_close(y.model.predict(xb), y.model.predict(xb, plain=True), **TOL[torch.bfloat16])


@pytest.mark.parametrize("phase", ["track_reid_phase", "benchmark_phase", "classify_phase"])
def test_new_phases_on_the_card(card, phase, monkeypatch, tmp_path):
    """chip_smoke's `[track botsort reid]`, `[benchmark]` and `[classify]` phases on 8 frames of the IR clip."""
    pytest.importorskip("cv2")
    import chip_smoke
    from yolo_tpu_torch import load_npz

    monkeypatch.setattr(chip_smoke, "TRACK_FRAMES", 8)
    monkeypatch.setattr(chip_smoke, "PREDICT_FRAMES", 8)
    clip = np.stack(_ir_frames(32))
    if phase == "benchmark_phase":
        model, params, _ = load_npz(chip_smoke.WEIGHTS)
        chip_smoke.benchmark_phase(model, params, clip, "card test")
    elif phase == "classify_phase":
        chip_smoke.classify_phase(clip, tmp_path, "card test")
    else:
        chip_smoke.track_reid_phase(clip, "card test")


@pytest.mark.parametrize("nc", [80, 1])
def test_segment_forward_and_nms_on_the_card_match_twins(card, nc):
    """yolov8n-seg at full width from the JAX package's initial tree (nc 80, and nc 1: the head's c3 = 64), two
    seeded 128² images: the f32 predictions and prototypes through kernels 1, 2 and 3 against the twins (boxes
    1e-2 px, scores 1e-4, coefficients and prototypes 1e-3) and against the CPU's (the same), 8 C2f and 3 head
    launches a forward; NMS with the coefficients as extra columns through kernel 5 against its twin (equal
    slots, extras 1e-6); bf16 against the bf16 twins at 6e-2."""
    from yolo_tpu_torch.nn.tasks import SegmentationModel, params_from_jax
    from yolo_tpu_torch.ops.nms import non_max_suppression

    m, cpu = SegmentationModel("yolov8n-seg.yaml", nc=nc), SegmentationModel("yolov8n-seg.yaml", nc=nc, device="cpu")
    params = m.init(0)
    for l in range(3):  # class priors at 0: detections at conf 0.25
        params["model"]["22"]["cv3"][str(l)]["2"]["bias"][:] = 0.0
    params_from_jax(m, params, torch.float32)
    params_from_jax(cpu, params, torch.float32)
    x = torch.from_numpy(np.random.default_rng(5).uniform(0, 1, (2, 128, 128, 3)).astype(np.float32))
    before = (cuda_c2f.fused_c2f.launches + cuda_c2f.fused_c2f_upconcat.launches, cuda_head.fused_head_level.launches)
    preds, protos = m.predict(x.to(card))
    after = (cuda_c2f.fused_c2f.launches + cuda_c2f.fused_c2f_upconcat.launches, cuda_head.fused_head_level.launches)
    assert (after[0] - before[0], after[1] - before[1]) == (8, 3)
    assert preds.shape == (2, 4 + nc + 32, 336) and protos.shape == (2, 32, 32, 32)
    for want, want_protos in (m.predict(x.to(card), plain=True), cpu.predict(x)):
        want, want_protos = want.to(card), want_protos.to(card)
        torch.testing.assert_close(preds[:, :4], want[:, :4], atol=1e-2, rtol=0)
        torch.testing.assert_close(preds[:, 4 : 4 + nc], want[:, 4 : 4 + nc], atol=1e-4, rtol=0)
        torch.testing.assert_close(preds[:, 4 + nc :], want[:, 4 + nc :], atol=1e-3, rtol=0)
        torch.testing.assert_close(protos, want_protos, atol=1e-3, rtol=0)
    n0 = cuda_nms.nms_keep.launches
    got = non_max_suppression(preds, conf_thres=0.25, nc=nc)
    assert cuda_nms.nms_keep.launches == n0 + 1
    want = non_max_suppression(preds, conf_thres=0.25, nc=nc, plain=True)
    assert got["valid"].any() and torch.equal(got["valid"], want["valid"]) and got["extra"].shape == (2, 300, 32)
    for k in ("boxes", "scores", "cls", "extra"):
        torch.testing.assert_close(got[k], want[k], atol=1e-6, rtol=0)
    params_from_jax(m, params, torch.bfloat16)
    xb = x.to(card, torch.bfloat16)
    (pk, prk), (pp, prp) = m.predict(xb), m.predict(xb, plain=True)
    torch.testing.assert_close(pk[:, 4:], pp[:, 4:], **TOL[torch.bfloat16])
    torch.testing.assert_close(prk.float(), prp.float(), **TOL[torch.bfloat16])


def test_segment_phases_on_the_card(card, monkeypatch, tmp_path):
    """chip_smoke's segment phases (`[segment train]`, `[segment train step f32]`, `[segment val kernels]`,
    `[segment predict]`, `[segment forward]`) cut to 32 train and 8 val frames, one epoch at batch 8."""
    pytest.importorskip("cv2")
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "SEG_TRAIN", (32, 40_000))
    monkeypatch.setattr(chip_smoke, "SEG_VAL", (8, 40_001))
    monkeypatch.setattr(chip_smoke, "SEG_RUN", {**chip_smoke.SEG_RUN, "epochs": 1, "batch": 8, "close_mosaic": 0})
    chip_smoke.segment_phases(tmp_path, "card test")


def test_pose_forward_and_nms_on_the_card_match_twins(card):
    """yolov8n-pose at full width from the JAX package's initial tree (nc 1, 17 keypoints; class priors at 0), two
    seeded 128² images: the f32 predictions through kernels 1, 2 and 3 against the twins and against the CPU's (boxes
    and keypoint x, y 1e-2 px, scores and visibilities 1e-4), 8 C2f and 3 head launches a forward; NMS with the 51
    keypoint rows as extra columns through kernel 5 against its twin on the same predictions (every output equal);
    bf16 against the bf16 twins at 6e-2."""
    from yolo_tpu_torch.nn.tasks import PoseModel, params_from_jax
    from yolo_tpu_torch.ops.nms import non_max_suppression

    m, cpu = PoseModel("yolov8n-pose.yaml"), PoseModel("yolov8n-pose.yaml", device="cpu")
    params = m.init(0)
    for l in range(3):
        params["model"]["22"]["cv3"][str(l)]["2"]["bias"][:] = 0.0
    params_from_jax(m, params, torch.float32)
    params_from_jax(cpu, params, torch.float32)
    x = torch.from_numpy(np.random.default_rng(5).uniform(0, 1, (2, 128, 128, 3)).astype(np.float32))
    before = (cuda_c2f.fused_c2f.launches + cuda_c2f.fused_c2f_upconcat.launches, cuda_head.fused_head_level.launches)
    preds = m.predict(x.to(card))
    after = (cuda_c2f.fused_c2f.launches + cuda_c2f.fused_c2f_upconcat.launches, cuda_head.fused_head_level.launches)
    assert (after[0] - before[0], after[1] - before[1]) == (8, 3) and preds.shape == (2, 56, 336)
    px = torch.zeros(56, dtype=torch.bool, device=card)
    px[:4] = True
    px[5:] = torch.arange(51, device=card) % 3 != 2
    for want in (m.predict(x.to(card), plain=True), cpu.predict(x).to(card)):
        torch.testing.assert_close(preds[:, px], want[:, px], atol=1e-2, rtol=0)
        torch.testing.assert_close(preds[:, ~px], want[:, ~px], atol=1e-4, rtol=0)
    n0 = cuda_nms.nms_keep.launches
    got = non_max_suppression(preds, conf_thres=0.25, nc=1)
    assert cuda_nms.nms_keep.launches == n0 + 1
    want = non_max_suppression(preds, conf_thres=0.25, nc=1, plain=True)
    assert got["valid"].any() and got["extra"].shape == (2, 300, 51) and set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    params_from_jax(m, params, torch.bfloat16)
    xb = x.to(card, torch.bfloat16)
    torch.testing.assert_close(m.predict(xb)[:, 4:], m.predict(xb, plain=True)[:, 4:], **TOL[torch.bfloat16])


def test_pose_phases_on_the_card(card, monkeypatch, tmp_path):
    """chip_smoke's pose phases (`[pose train]`, `[pose train step f32]`, `[pose val kernels]`, `[pose predict]`,
    `[pose forward]`, `[pose track]` with a fresh yolov8n-seg whose masks are confident for `[segment track]`) cut to
    32 train and 8 val frames, one epoch at batch 8."""
    pytest.importorskip("cv2")
    import cv2
    import chip_smoke

    from yolo_tpu_torch import YOLO

    monkeypatch.setattr(chip_smoke, "POSE_TRAIN", (32, 50_000))
    monkeypatch.setattr(chip_smoke, "POSE_VAL", (8, 50_001))
    monkeypatch.setattr(chip_smoke, "POSE_RUN", {**chip_smoke.POSE_RUN, "epochs": 1, "batch": 8, "close_mosaic": 0})
    seg_root = tmp_path / "seg"
    chip_smoke.write_seg_split(seg_root, 4, 1, split="val")
    frames = [cv2.imread(str(seg_root / f"images/val/{i}.png")) for i in range(4)]
    seg = YOLO("yolov8n-seg.yaml")
    head = seg.params["model"]["22"]  # coefficients 1 and prototypes near 3: mask logits far from 0
    for l in range(3):
        head["cv4"][str(l)]["2"]["bias"][:] = 1.0
    head["proto"]["cv3"]["bn"]["bias"][:] = 3.0
    chip_smoke.pose_phases(tmp_path / "pose", "card test", (seg, frames))


@pytest.mark.parametrize("nc", [15, 2])
def test_obb_forward_and_rotated_nms_on_the_card_match_twins(card, nc):
    """yolov8n-obb at full width from the JAX package's initial tree (nc 15 as DOTAv1, and nc 2; class priors at 0),
    two seeded 128² images: the f32 predictions through kernels 1, 2 and 3 against the twins and against the CPU's
    (boxes 1e-2 px, scores and angles 1e-4), 8 C2f and 3 head launches a forward and no NMS kernel; the rotated NMS
    (plain torch, not greedy) on the card against the CPU's on the same predictions (every output equal); bf16
    against the bf16 twins at 6e-2."""
    from yolo_tpu_torch.nn.tasks import OBBModel, params_from_jax
    from yolo_tpu_torch.ops.nms import non_max_suppression_rotated

    m, cpu = OBBModel("yolov8n-obb.yaml", nc=nc), OBBModel("yolov8n-obb.yaml", nc=nc, device="cpu")
    params = m.init(0)
    for l in range(3):
        params["model"]["22"]["cv3"][str(l)]["2"]["bias"][:] = 0.0
    params_from_jax(m, params, torch.float32)
    params_from_jax(cpu, params, torch.float32)
    x = torch.from_numpy(np.random.default_rng(5).uniform(0, 1, (2, 128, 128, 3)).astype(np.float32))
    before = (cuda_c2f.fused_c2f.launches + cuda_c2f.fused_c2f_upconcat.launches, cuda_head.fused_head_level.launches,
              cuda_nms.nms_keep.launches)
    preds = m.predict(x.to(card))
    got = non_max_suppression_rotated(preds, conf_thres=0.25, iou_thres=0.7)
    after = (cuda_c2f.fused_c2f.launches + cuda_c2f.fused_c2f_upconcat.launches, cuda_head.fused_head_level.launches,
             cuda_nms.nms_keep.launches)
    assert tuple(a - b for a, b in zip(after, before)) == (8, 3, 0) and preds.shape == (2, 4 + nc + 1, 336)
    for want in (m.predict(x.to(card), plain=True), cpu.predict(x).to(card)):
        torch.testing.assert_close(preds[:, :4], want[:, :4], atol=1e-2, rtol=0)
        torch.testing.assert_close(preds[:, 4:], want[:, 4:], atol=1e-4, rtol=0)
    want = non_max_suppression_rotated(preds.cpu(), conf_thres=0.25, iou_thres=0.7)
    assert got["valid"].any() and got["boxes"].shape == (2, 300, 5) and set(got) == set(want)
    for k in want:
        assert torch.equal(got[k].cpu(), want[k]), k
    params_from_jax(m, params, torch.bfloat16)
    xb = x.to(card, torch.bfloat16)
    torch.testing.assert_close(m.predict(xb)[:, 4:], m.predict(xb, plain=True)[:, 4:], **TOL[torch.bfloat16])


def test_obb_phases_on_the_card(card, monkeypatch, tmp_path):
    """chip_smoke's obb phases (`[obb train]`, `[obb train step f32]`, `[obb val kernels]`, `[obb predict]`,
    `[obb forward]`, `[obb track]`) cut to 32 train and 8 val frames, one epoch at batch 8."""
    pytest.importorskip("cv2")
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "OBB_TRAIN", (32, 60_000))
    monkeypatch.setattr(chip_smoke, "OBB_VAL", (8, 60_001))
    monkeypatch.setattr(chip_smoke, "OBB_RUN", {**chip_smoke.OBB_RUN, "epochs": 1, "batch": 8, "close_mosaic": 0})
    chip_smoke.obb_phases(tmp_path, "card test")
