"""The port's whole slice against the JAX package: FusedDetectTrack on a 16-frame
64x64 clip in chunks of 8 (as tests/test_fused_pipeline.py) gives the same
packed outputs (floats to 1e-3, the forward's summation order differs),
the same statuses, ids, emits and detection counts, and the same contract
stats. Also: the port imports no JAX and nothing of the JAX package, and its
entry points run on the card unless the CPU is asked for."""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_tpu.nn.tasks import DetectionModel as JaxDetectionModel
from yolo_tpu.pipeline import FusedDetectTrack as JaxFusedDetectTrack
from yolo_tpu_torch import DetectionModel, FusedDetectTrack
from yolo_tpu_torch.device import resolve_device
from yolo_tpu_torch.kalman.batched import init_state

from tests.conftest import ROOT


@pytest.mark.parametrize("plain", [False, True])
def test_fused_detect_track_matches_jax(plain):
    jm = JaxDetectionModel("yolov8n.yaml")
    jp = jm.fuse(jm.init(0))
    clip = np.random.default_rng(2).integers(0, 255, (16, 64, 64, 1), np.uint8)
    clip[:, 20:28, 30:38] = 255  # a bright square in every frame
    kw = dict(frame_hw=(64, 64), chunk=8, conf=1e-4, n_max=8, d_max=4)
    want_outs, want_stats = JaxFusedDetectTrack(jm, jp, dtype=jnp.float32, **kw).run_clip(clip)

    params = jax.tree_util.tree_map(np.asarray, jp)
    ft = FusedDetectTrack(DetectionModel("yolov8n.yaml", device="cpu"), params, dtype=torch.float32, device="cpu",
                          plain=plain, **kw)
    assert ft.max_nms == 64
    got_outs, got_stats = ft.run_clip(clip)
    assert got_stats == want_stats and got_stats["detection_frames"] > 0
    assert len(got_outs) == len(want_outs) == 2
    for got, want in zip(got_outs, want_outs):
        for k in ("emit", "status", "track_num", "time_since_update", "det_count"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        for k in ("bbox", "confidence", "velocity"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-3, err_msg=k)
    assert int(ft.state["frame_count"]) == 16
    ft.reset()
    first = ft.process_chunk(clip[:8])  # one chunk from a fresh state = run_clip's first chunk
    for k in first:
        if first[k].dtype.kind == "f":
            np.testing.assert_allclose(first[k], got_outs[0][k], rtol=1e-5, atol=1e-4, err_msg=k)
        else:
            np.testing.assert_array_equal(first[k], got_outs[0][k], err_msg=k)


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"  # any `import jax` now raises
        "import numpy as np, torch\n"
        "import yolo_tpu_torch, chip_smoke\n"
        "from yolo_tpu_torch import DetectionModel, FusedDetectTrack, load_npz\n"
        "from yolo_tpu_torch.ops import cuda_c2f, cuda_head, cuda_nms, nms, _cuda\n"
        "m, p, _ = load_npz(chip_smoke.WEIGHTS, device='cpu')\n"
        "ft = FusedDetectTrack(m, p, frame_hw=(64, 64), chunk=2, device='cpu')\n"
        "outs, stats = ft.run_clip(np.zeros((2, 64, 64, 1), np.uint8))\n"
        "assert stats['frames'] == 2, stats\n"
        "bad = sorted(k for k in sys.modules if k == 'yolo_tpu' or k.startswith('yolo_tpu.'))\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and "clean" in out.stdout, out.stderr[-3000:]


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None) == torch.device("cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DetectionModel("yolov8n.yaml")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_state(4)
    model = DetectionModel("yolov8n.yaml", device="cpu")
    jm = JaxDetectionModel("yolov8n.yaml")
    params = jax.tree_util.tree_map(np.asarray, jm.fuse(jm.init(0)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FusedDetectTrack(model, params, frame_hw=(64, 64), chunk=8)
    assert FusedDetectTrack(model, params, frame_hw=(64, 64), chunk=8, device="cpu").device == torch.device("cpu")
