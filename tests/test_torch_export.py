"""`.pt` checkpoints and `YOLO.export` / `YOLO.save` of the port against the JAX
package: the JAX `save_pt` read by the port, the port's read by the JAX
`load_pt` (equal trees), `train_args` as overrides, plain state_dicts, and the
formats that are not ported. Trees are compared exactly (f32 copies)."""

import jax
import numpy as np
import pytest
import torch

import yolo_tpu
import yolo_tpu_torch
from yolo_tpu.engine.exporter import load_npz as jax_load_npz
from yolo_tpu.nn.torch_export import params_to_state_dict as jax_params_to_state_dict
from yolo_tpu.nn.torch_export import save_pt as jax_save_pt
from yolo_tpu.nn.torch_import import load_pt as jax_load_pt
from yolo_tpu_torch.engine.exporter import load_npz
from yolo_tpu_torch.nn.torch_export import flatten_tree, params_to_state_dict
from yolo_tpu_torch.nn.torch_import import load_pt, load_torch_checkpoint

from tests.conftest import ROOT
from tests.test_torch_predict import _frame_640x512
from tests.test_torch_native_ref import jax_native_reference, torch_threads  # noqa: F401 (autouse fixtures: JAX's native letterbox, built whole; two torch threads)

WEIGHTS = ROOT / "demos" / "artifacts" / "train" / "weights" / "best.npz"


def _flat(tree):
    return {k: np.asarray(v) for k, v in flatten_tree(jax.tree_util.tree_map(np.asarray, tree)).items()}


def _assert_same_tree(got, want):
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    for k in w:
        assert g[k].shape == w[k].shape, k
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.fixture(scope="module")
def jax_pt(tmp_path_factory):
    """best.npz written to .pt by the JAX package's save_pt, with train_args."""
    jm, jp, _ = jax_load_npz(WEIGHTS)
    path = tmp_path_factory.mktemp("pt") / "best.pt"
    jax_save_pt(jm, jp, path, names=jm.names, train_args={"imgsz": 320, "iou": 0.5, "task": "detect", "model": "x.yaml",
                                                             "data": "d.yaml", "device": "tpu", "not_a_cfg_key": 1})
    return path


def test_state_dict_layouts_match_jax():
    """HWIO → OIHW for every 4-D leaf (the DFL's (1, 1, 16, 1) → (1, 16, 1, 1)); the same keys and values."""
    _, jp, _ = jax_load_npz(WEIGHTS)
    _, pp, _ = load_npz(WEIGHTS, device="cpu")
    want, got = jax_params_to_state_dict(jp), params_to_state_dict(pp)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    dfl = [k for k in got if k.endswith("dfl.conv.weight")]
    assert dfl and got[dfl[0]].shape == (1, 16, 1, 1)


def test_jax_pt_loads_into_the_port(jax_pt):
    """The port reads the JAX .pt into the tree load_npz gives (weights_only loading), with names, and
    its predict equals predict from the .npz; train_args become overrides (all cfg keys but model, data, device)."""
    model, params, meta = load_pt(jax_pt, device="cpu")
    _, want, _ = load_npz(WEIGHTS, device="cpu")
    _assert_same_tree(params, want)
    assert meta["names"] == {0: "aircraft"} and meta["train_args"]["imgsz"] == 320
    y = yolo_tpu_torch.YOLO(str(jax_pt), device="cpu")
    assert y.names == {0: "aircraft"} and y.ckpt_path == str(jax_pt)
    assert y.overrides == {"imgsz": 320, "iou": 0.5, "task": "detect", "model": str(jax_pt)}
    assert y.overrides == {k: v for k, v in yolo_tpu.YOLO(str(jax_pt)).overrides.items()}
    frame = _frame_640x512(21)
    kw = dict(imgsz=640, iou=0.7, verbose=False, compute_dtype="float32")
    got = y.predict(frame, **kw)[0].boxes.data
    ref = yolo_tpu_torch.YOLO(str(WEIGHTS), device="cpu").predict(frame, **kw)[0].boxes.data
    assert len(got) == 3
    np.testing.assert_array_equal(got, ref)


def test_port_pt_loads_into_jax(tmp_path, monkeypatch):
    """The port's YOLO.export(format='pt') writes <stem>.pt in the working directory; the JAX load_pt
    reads it into load_npz's tree; both packages load it back."""
    monkeypatch.chdir(tmp_path)
    y = yolo_tpu_torch.YOLO(str(WEIGHTS), device="cpu")
    out = y.export(format="pt")
    assert out.name == "best.pt" and (tmp_path / "best.pt").exists()
    _, jparams, jmeta = jax_load_pt(out)
    _, want, _ = jax_load_npz(WEIGHTS)
    _assert_same_tree(jparams, want)
    assert jmeta["names"] == {0: "aircraft"}
    _, pparams, _ = load_pt(out, device="cpu")
    _assert_same_tree(pparams, y.params)
    ckpt = torch.load(out, weights_only=True)
    assert set(ckpt) == {"state_dict", "yaml", "names", "train_args", "format"} and ckpt["format"] == "yolo_tpu.state_dict.v1"
    # npz export and save: the JAX loader reads them
    assert y.export(format="npz").name == "best.npz"
    _assert_same_tree(jax_load_npz(tmp_path / "best.npz")[1], want)
    y.save(tmp_path / "again.npz")
    _assert_same_tree(load_npz(tmp_path / "again.npz", device="cpu")[1], y.params)


def test_plain_state_dict_and_wrapper(tmp_path):
    """A bare {name: tensor} state_dict (OIHW, num_batches_tracked present) and a {"state_dict": ...}
    wrapper load into the tree of a model given explicitly; without a model and a yaml, ValueError."""
    model, params, _ = load_npz(WEIGHTS, device="cpu")
    sd = {k: torch.from_numpy(v.copy()) for k, v in params_to_state_dict(params).items()}
    sd["model.0.bn.num_batches_tracked"] = torch.tensor(7)
    torch.save(sd, tmp_path / "plain.pt")
    torch.save({"state_dict": sd}, tmp_path / "wrapped.pt")
    for name in ("plain.pt", "wrapped.pt"):
        flat, meta = load_torch_checkpoint(tmp_path / name)
        assert "model.0.bn.num_batches_tracked" in flat and meta == {}
        _, got, _ = load_pt(tmp_path / name, model=model)
        _assert_same_tree(got, params)
        with pytest.raises(ValueError, match="no embedded yaml"):
            load_pt(tmp_path / name)
        jflat, _ = yolo_tpu.nn.torch_import.load_torch_checkpoint(tmp_path / name)
        assert sorted(jflat) == sorted(flat)


def test_unported_export_formats_raise(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    y = yolo_tpu_torch.YOLO("yolov8n.yaml", device="cpu")
    for fmt in ("stablehlo", "orbax", "tflite"):
        with pytest.raises(NotImplementedError, match=fmt):
            y.export(format=fmt)
    with pytest.raises(ValueError, match="unsupported export format"):
        y.export(format="onnx")
    assert y.export(format="pt").name == "yolov8n.pt"
    assert y.overrides == {"model": "yolov8n.yaml", "task": "detect"}
