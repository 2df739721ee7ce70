"""The port's C2f (yolo_tpu_torch C2f → ops/cuda_c2f plain twin on the CPU) against
the JAX package: the Pallas kernel in interpret mode and the module algebra.

Same seeded inputs and fused parameters through both; f32; rtol = atol = 1e-4
(the two sum the convs in different orders)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_tpu.nn import modules as M
from yolo_tpu.ops.pallas_c2f import fused_c2f, fused_c2f_upconcat
from yolo_tpu_torch.nn import modules as PM
from yolo_tpu_torch.ops import cuda_c2f

TOL = dict(rtol=1e-4, atol=1e-4)


def _fused_c2f_params(rng, mod):
    def fuse(m, p):
        return {"conv": {"weight": p["conv"]["weight"], "bias": rng.normal(0, 0.1, (m.c2,)).astype(np.float32)}}

    return {
        "cv1": fuse(mod.cv1, mod.cv1.init(rng)),
        "cv2": fuse(mod.cv2, mod.cv2.init(rng)),
        "m": {
            str(i): {"cv1": fuse(b.cv1, b.cv1.init(rng)), "cv2": fuse(b.cv2, b.cv2.init(rng))}
            for i, b in enumerate(mod.m)
        },
    }


def _port(c1, c2, n, shortcut, p):
    mod = PM.C2f(c1, c2, n=n, shortcut=shortcut)
    mod.load_jax(p, "cpu", torch.float32)
    return mod


@pytest.mark.parametrize(
    "B,H,W,c1,c2,n,shortcut",
    [
        (2, 8, 20, 24, 24, 2, True),  # backbone P2 geometry (yolov8-small-n layer 2)
        (2, 6, 16, 72, 24, 2, False),  # neck P2 (layer 18: concat input, no shortcut)
        (1, 7, 12, 48, 48, 3, True),  # P3 n=3, odd H, B=1
        (4, 5, 8, 16, 32, 1, False),  # n=1 minimal chain
    ],
)
def test_c2f_matches_jax(B, H, W, c1, c2, n, shortcut):
    rng = np.random.default_rng(0)
    jmod = M.C2f(c1, c2, n=n, shortcut=shortcut)
    p = _fused_c2f_params(rng, jmod)
    x = rng.normal(0, 1, (B, H, W, c1)).astype(np.float32)

    got = _port(c1, c2, n, shortcut, p)(torch.from_numpy(x)).numpy()
    want_mod = np.asarray(jmod(p, jnp.asarray(x), M.Ctx(train=False, dtype=jnp.float32)))
    want_pallas = np.asarray(
        fused_c2f(jnp.asarray(x), p, n=n, shortcut=shortcut, block_b=2, interpret=True, dtype=jnp.float32)
    )
    np.testing.assert_allclose(got, want_mod, **TOL)
    np.testing.assert_allclose(got, want_pallas, **TOL)


def test_c2f_upconcat_matches_jax():
    rng = np.random.default_rng(3)
    cs, ck, c2 = 48, 24, 24  # P3→P2 neck geometry (small = 48 channels at half resolution)
    jmod = M.C2f(cs + ck, c2, n=2, shortcut=False)
    p = _fused_c2f_params(rng, jmod)
    small = rng.normal(0, 1, (2, 4, 10, cs)).astype(np.float32)
    skip = rng.normal(0, 1, (2, 8, 20, ck)).astype(np.float32)

    before = cuda_c2f.fused_c2f_upconcat.launches
    got = _port(cs + ck, c2, 2, False, p).call_upconcat(torch.from_numpy(small), torch.from_numpy(skip)).numpy()
    assert cuda_c2f.fused_c2f_upconcat.launches == before  # CPU tensors take the plain twin
    ctx = M.Ctx(train=False, dtype=jnp.float32)
    want_mod = np.asarray(jmod.call_upconcat(p, jnp.asarray(small), jnp.asarray(skip), 2, ctx))
    want_pallas = np.asarray(
        fused_c2f_upconcat(
            jnp.asarray(small), jnp.asarray(skip), p, n=2, shortcut=False, block_b=2, interpret=True,
            dtype=jnp.float32,
        )
    )
    np.testing.assert_allclose(got, want_mod, **TOL)
    np.testing.assert_allclose(got, want_pallas, **TOL)


def test_c2f_kernel_weights_layout():
    """The kernel's flat HWIO weights round-trip to the modules' OIHW weights."""
    rng = np.random.default_rng(5)
    jmod = M.C2f(24, 24, n=2, shortcut=True)
    p = _fused_c2f_params(rng, jmod)
    kw = _port(24, 24, 2, True, p).kernel_weights()
    np.testing.assert_array_equal(kw.w1.numpy(), p["cv1"]["conv"]["weight"].reshape(24, 24))
    np.testing.assert_array_equal(kw.wm[3].numpy(), p["m"]["1"]["cv2"]["conv"]["weight"].reshape(-1, 12))
    np.testing.assert_array_equal(kw.w2.numpy(), p["cv2"]["conv"]["weight"].reshape(48, 24))
    assert (kw.n, kw.c) == (2, 12)
