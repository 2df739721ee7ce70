"""The port's Detect level (ops/cuda_head plain twin on the CPU) against the JAX
package's fused Pallas head kernel in interpret mode and its module walk +
dfl_project, at the P2 input width (C=24) and the P5 one (C=192), which the
TPU's second head kernel could not compile. f32; rtol = atol = 1e-4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_tpu.nn import modules as M
from yolo_tpu.ops.pallas_head import fused_head_level
from yolo_tpu_torch.nn import modules as PM
from yolo_tpu_torch.ops import cuda_head

TOL = dict(rtol=1e-4, atol=1e-4)


def _level_params(rng, C, c2, c3, nc):
    mods_r = [M.ConvBNAct(C, c2, 3), M.ConvBNAct(c2, c2, 3), M.Conv2d(c2, 4 * 16, 1)]
    mods_c = [M.ConvBNAct(C, c3, 3), M.ConvBNAct(c3, c3, 3), M.Conv2d(c3, nc, 1)]

    def fuse_one(m, p):
        if not isinstance(m, M.ConvBNAct):
            return p
        return {"conv": {"weight": p["conv"]["weight"], "bias": rng.normal(0, 0.1, (m.c2,)).astype(np.float32)}}

    p_r = {str(j): fuse_one(m, m.init(rng)) for j, m in enumerate(mods_r)}
    p_c = {str(j): fuse_one(m, m.init(rng)) for j, m in enumerate(mods_c)}
    return mods_r, mods_c, p_r, p_c


def _port_weights(C, c2, c3, nc, p_r, p_c):
    reg = [PM.ConvBNAct(C, c2, 3), PM.ConvBNAct(c2, c2, 3), PM.Conv2d(c2, 64, 1)]
    cls = [PM.ConvBNAct(C, c3, 3), PM.ConvBNAct(c3, c3, 3), PM.Conv2d(c3, nc, 1)]
    for j in range(3):
        reg[j].load_jax(p_r[str(j)], "cpu", torch.float32)
        cls[j].load_jax(p_c[str(j)], "cpu", torch.float32)
    return cuda_head.HeadWeights.from_convs(reg, cls, torch.arange(16, dtype=torch.float32))


@pytest.mark.parametrize(
    "B,H,W,C,nc",
    [
        (2, 8, 20, 24, 1),  # P2 level of yolov8-small-n (merged first conv 64 + 24 = 88 outputs)
        (2, 4, 6, 192, 1),  # P5 level input width
        (1, 5, 8, 48, 3),  # multi-class, odd H
    ],
)
def test_head_level_matches_jax(B, H, W, C, nc):
    c2, c3 = 64, 24
    rng = np.random.default_rng(0)
    mods_r, mods_c, p_r, p_c = _level_params(rng, C, c2, c3, nc)
    x = rng.normal(0, 1, (B, H, W, C)).astype(np.float32)
    proj = jnp.arange(16, dtype=jnp.float32)

    before = cuda_head.fused_head_level.launches
    got_d, got_c = cuda_head.fused_head_level(torch.from_numpy(x), _port_weights(C, c2, c3, nc, p_r, p_c))
    assert cuda_head.fused_head_level.launches == before  # CPU tensors take the plain twin
    pal_d, pal_c = fused_head_level(jnp.asarray(x), p_r, p_c, proj, nc=nc, block_b=2, interpret=True, dtype=jnp.float32)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(pal_d), **TOL)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(pal_c), **TOL)

    # the module walk + dfl_project the kernel replaces
    ctx = M.Ctx(train=False, dtype=jnp.float32)
    b, c = jnp.asarray(x), jnp.asarray(x)
    for j in range(3):
        b = mods_r[j](p_r[str(j)], b, ctx)
        c = mods_c[j](p_c[str(j)], c, ctx)
    want_d = M.dfl_project(b.reshape(B, H * W, 4, 16), proj)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), **TOL)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(c).reshape(B, H * W, nc), **TOL)


def test_dfl_project_matches_jax():
    rng = np.random.default_rng(1)
    box = rng.normal(0, 3, (2, 7, 4, 16)).astype(np.float32)
    proj = np.arange(16, dtype=np.float32)
    got = PM.dfl_project(torch.from_numpy(box), torch.from_numpy(proj)).numpy()
    np.testing.assert_allclose(got, np.asarray(M.dfl_project(jnp.asarray(box), jnp.asarray(proj))), rtol=1e-6, atol=1e-6)
