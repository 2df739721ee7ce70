"""The port's Detect level (ops/cuda_head plain twin on the CPU) against the JAX
package's fused Pallas head kernel in interpret mode and its module walk +
dfl_project, at the P2 input width (C=24) and the P5 one (C=192), which the
TPU's second head kernel could not compile, and at the `[head edges]` shapes;
then the bf16 kernel's weight layout (pack_core), read back through the
addressing of its ldmatrix loads and of its wgmma descriptor. f32; rtol = atol
= 1e-4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_tpu.nn import modules as M
from yolo_tpu.ops.pallas_head import fused_head_level
from yolo_tpu_torch.nn import modules as PM
from yolo_tpu_torch.ops import cuda_head

from tests.test_torch_native_ref import torch_threads  # noqa: F401 (an autouse fixture: two torch threads)

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


@pytest.mark.parametrize("B,H,W,C,c2,c3,nc", cuda_head.HEAD_EDGES)
def test_head_level_matches_jax_at_the_edges(B, H, W, C, c2, c3, nc):
    """The twins the card holds both head kernels against, at the `[head edges]`
    shapes, against the JAX module walk + dfl_project (+ the logistic)."""
    from yolo_tpu_torch.ops import cuda_head_cm

    rng = np.random.default_rng(5)
    mods_r, mods_c, p_r, p_c = _level_params(rng, C, c2, c3, nc)
    x = rng.normal(0, 1, (B, H, W, C)).astype(np.float32)
    kw = _port_weights(C, c2, c3, nc, p_r, p_c)
    got_d, got_c = cuda_head.fused_head_level(torch.from_numpy(x), kw)
    cm_d, cm_c = cuda_head_cm.head_level_cm(torch.from_numpy(x), kw)
    ctx = M.Ctx(train=False, dtype=jnp.float32)
    b, c = jnp.asarray(x), jnp.asarray(x)
    for j in range(3):
        b = mods_r[j](p_r[str(j)], b, ctx)
        c = mods_c[j](p_c[str(j)], c, ctx)
    want_d = np.asarray(M.dfl_project(b.reshape(B, H * W, 4, 16), jnp.arange(16, dtype=jnp.float32)))
    want_c = np.asarray(c).reshape(B, H * W, nc)
    np.testing.assert_allclose(got_d.numpy(), want_d, **TOL)
    np.testing.assert_allclose(got_c.numpy(), want_c, **TOL)
    np.testing.assert_allclose(cm_d.numpy(), want_d, **TOL)
    np.testing.assert_allclose(cm_c.numpy(), 1 / (1 + np.exp(-want_c.astype(np.float64))), rtol=0, atol=1e-5)


# The bf16 kernel's view of one pass of a conv (csrc/head.cuh): chunk q = tap * (kp / 16) + K
# chunk holds `width` outputs x 16 inputs; its 8x8 block (n / 8, k / 8) is 64 halves at
# (2 (n / 8) + k / 8) * 64, row n % 8, column k % 8.
LBO, SBO = 128, 256  # wgmma's no-swizzle descriptor (head.cuh::wg_desc): bytes between K blocks, between N blocks


def _lane_b(lane):  # head.cuh: this lane's row of an ldmatrix.x4 of two n-tiles of B
    return ((lane >> 4) * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * 8


def _conv_views(kw):
    """(name, flat pack slice, f32 HWIO weight, taps, kp, outputs padded, pass width) of every conv in the pack."""
    C, c2, c3, nc = kw.w0.shape[0] // 9, kw.c2, kw.c3, kw.nc
    pad = lambda c, m: -(-c // m) * m  # noqa: E731
    kx, k3, kr, nr = pad(C, 16), pad(c3, 32), pad(c2, 16), pad(c2, 64)
    n1 = pad(c2 + k3, 48)
    convs = [("w0", kw.w0, 9, kx, n1, 48), ("w1r", kw.w1r, 9, kr, nr, 64), ("w1c", kw.w1c, 9, k3, k3, 32),
             ("w2r", kw.w2r, 1, nr, 64, 64), ("w2c", kw.w2c, 1, k3, pad(nc, 16), 16)]
    flat = kw.core().float().numpy()
    at, out = 0, []
    for name, w, taps, kp, npad, width in convs:
        size = taps * kp * npad
        out.append((name, flat[at : at + size], w.numpy(), taps, kp, npad, width))
        at += size
    assert at == flat.size
    return out


@pytest.mark.parametrize("C,c2,c3,nc", [(24, 64, 24, 1), (192, 64, 192, 1), (64, 64, 80, 80), (96, 64, 96, 17),
                                         (320, 80, 320, 80), (48, 72, 48, 3)])
def test_pack_core_round_trips_to_the_head_weights(C, c2, c3, nc):
    """Every conv of the bf16 pack, walked block by block, is the level's weight
    rounded to bf16 with zero pads (inputs past cin, outputs past cout); the
    1x1s too, which the kernel keeps resident (the cls one a pass of 16 outputs
    at a time); c2 = 80 and 72 give the reg conv two passes of 64 outputs."""
    kw = cuda_head.HeadWeights.random(C, c2, c3, nc, seed=3)
    assert kw.core() is kw.core() and kw.core().dtype == torch.bfloat16  # made once
    for name, flat, w, taps, kp, npad, width in _conv_views(kw):
        cin, cout = w.shape[0] // taps, w.shape[1]
        t = flat.reshape(npad // width, taps, kp // 16, width // 8, 2, 8, 8)  # pass, tap, chunk, n/8, k/8, n%8, k%8
        back = t.transpose(1, 2, 4, 6, 0, 3, 5).reshape(taps, kp, npad)  # tap, k, n
        want = np.zeros((taps, kp, npad), np.float32)
        want[:, :cin, :cout] = torch.from_numpy(w).to(torch.bfloat16).float().numpy().reshape(taps, cin, cout)
        np.testing.assert_array_equal(back, want, err_msg=name)


def test_core_layout_through_the_kernel_addressing():
    """The 3x3 reg conv's pack read as the kernel reads it gives W[tap][k][n]:
    through ldmatrix.x4 (lane row addresses, then each thread's mma B fragment)
    and through the wgmma descriptor's block strides (LBO between K halves, SBO
    between groups of 8 outputs)."""
    kw = cuda_head.HeadWeights.random(24, 64, 24, 1, seed=4)
    name, flat, w, taps, kp, npad, width = _conv_views(kw)[1]
    assert name == "w1r"
    W = torch.from_numpy(w).to(torch.bfloat16).float().numpy().reshape(taps, kp, npad)
    chunk = width * 16  # halves of one K chunk of a pass
    for tap in (0, 4, 8):
        for kc in range(kp // 16):
            base = (tap * (kp // 16) + kc) * chunk
            ref = W[tap, kc * 16 : kc * 16 + 16]  # (16 k, 64 n)
            # wgmma: element (k, n) of the chunk at byte (n / 8) SBO + (k / 8) LBO + (n % 8) 16 + (k % 8) 2
            n, k = np.meshgrid(np.arange(64), np.arange(16))
            byte = (n // 8) * SBO + (k // 8) * LBO + (n % 8) * 16 + (k % 8) * 2
            np.testing.assert_array_equal(flat[base + byte // 2], ref)
            # ldmatrix.x4 at lane_b + j * 128: matrix m's rows from lanes 8m..8m+7; thread t takes row t / 4,
            # columns 2 (t % 4) and + 1 of each matrix as its registers 0..3 = b0, b1 of n-tile j, b0, b1 of j + 1
            for j in range(0, 8, 2):
                rows = [[flat[base + _lane_b(8 * m + r) + j * 128 : base + _lane_b(8 * m + r) + j * 128 + 8] for r in range(8)] for m in range(4)]
                for t in range(32):
                    gid, tig = t // 4, t % 4
                    for m in range(4):
                        nt, kh = j + m // 2, m % 2
                        got = rows[m][gid][2 * tig : 2 * tig + 2]
                        np.testing.assert_array_equal(got, ref[kh * 8 + 2 * tig : kh * 8 + 2 * tig + 2, nt * 8 + gid])


def _ldmatrix_b(flat, at, ref, n0):
    """An ldmatrix.x4 of B at `at` (halves; lane l's row at at + lane_b(l)) as the two
    m16n8k16 products after it read it: thread (gid, tig)'s registers are
    ref[8 kh + 2 tig + e, n0 + 8 nt + gid] of 16 K rows `ref`, n-tiles nt = 0, 1."""
    for m in range(4):
        nt, kh = m // 2, m % 2
        for gid in range(8):
            row = flat[at + _lane_b(8 * m + gid) : at + _lane_b(8 * m + gid) + 8]
            for tig in range(4):
                np.testing.assert_array_equal(row[2 * tig : 2 * tig + 2], ref[kh * 8 + 2 * tig : kh * 8 + 2 * tig + 2, n0 + nt * 8 + gid])


@pytest.mark.parametrize("C,c2,c3,nc", [(24, 64, 24, 1), (320, 80, 320, 80), (48, 72, 48, 17)])
def test_one_by_one_packs_through_the_kernel_addressing(C, c2, c3, nc):
    """The resident 1x1s as csrc/head.cuh reads them: the reg one at K chunk
    4 pass + k and side s (n-tiles 2 s, 2 s + 1) for every 64-channel pass of
    the reg conv; the cls one as passes of 16 outputs, pass k0 / 16 at k0 * k3,
    K chunk q at 256 q. Pads read as zeros."""
    kw = cuda_head.HeadWeights.random(C, c2, c3, nc, seed=6)
    views = {v[0]: v for v in _conv_views(kw)}
    _, flat, w, _, nr, _, _ = views["w2r"]
    W2r = np.zeros((nr, 64), np.float32)
    W2r[:c2] = torch.from_numpy(w).to(torch.bfloat16).float().numpy()
    for p in range(nr // 64):
        for k in range(4):
            for s in range(4):
                _ldmatrix_b(flat, (4 * p + k) * 64 * 16 + 2 * s * 128, W2r[(4 * p + k) * 16 : (4 * p + k) * 16 + 16], 16 * s)
    _, flat, w, _, k3, ncp, _ = views["w2c"]
    W2c = np.zeros((k3, ncp), np.float32)
    W2c[:c3, :nc] = torch.from_numpy(w).to(torch.bfloat16).float().numpy()
    for k0 in range(0, nc, 16):
        for q in range(k3 // 16):
            _ldmatrix_b(flat, k0 * k3 + q * 256, W2c[q * 16 : q * 16 + 16, k0 : k0 + 16], 0)
