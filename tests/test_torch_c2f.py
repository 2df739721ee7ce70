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

from tests.test_torch_native_ref import torch_threads  # noqa: F401 (an autouse fixture: two torch threads)

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


def _slices_forward(x, slices, kw, shortcut):
    """The C2f computed from the bf16 kernel's weight slices alone, in the order
    the kernel walks them (f64 sums): cv1 as K chunks per half, each bottleneck
    conv as nine taps, cv2 as concat segments per chunk of output channels."""
    c, n, c1, c2o = kw.c, kw.n, kw.w1.shape[0], kw.w2.shape[1]
    kp = slices.shape[1]
    nk1 = -(-c1 // kp)
    sl = slices.double()
    silu = lambda v: v * torch.sigmoid(v)  # noqa: E731
    xp = torch.nn.functional.pad(x.double(), (0, nk1 * kp - c1))
    halves = []
    for h in (0, 1):
        y = sum(xp[..., j * kp : (j + 1) * kp] @ sl[h * nk1 + j, :, :kp].t() for j in range(nk1))
        halves.append(silu(y[..., :c] + kw.b1[h * c : (h + 1) * c].double()))
    pad_c = lambda m: torch.nn.functional.pad(m, (0, kp - c))  # noqa: E731
    segs, base = halves, 2 * nk1
    for q in range(2 * n):
        src = pad_c(segs[-1] if q % 2 == 0 else t)
        framed = torch.nn.functional.pad(src, (0, 0, 1, 1, 1, 1))
        H, W = src.shape[1:3]
        y = sum(framed[:, ky : ky + H, kx : kx + W] @ sl[base + q * 9 + ky * 3 + kx, :, :kp].t() for ky in range(3) for kx in range(3))
        t = silu(y[..., :c] + kw.bm[q].double())
        if q % 2:
            segs.append(segs[-1] + t if shortcut else t)
    base += 2 * n * 9
    outs = []
    for o in range(-(-c2o // kp)):
        y = sum(pad_c(seg) @ sl[base + o * (2 + n) + s, :, :kp].t() for s, seg in enumerate(segs))
        outs.append(y)
    return silu(torch.cat(outs, -1)[..., :c2o] + kw.b2.double())


@pytest.mark.parametrize(
    "c1,c2,n,shortcut",
    [
        (24, 24, 2, True),  # c = 12: rows and columns padded to 16, cv1 in two chunks of which the second is half empty
        (72, 24, 2, False),  # the upconcat instance's widths: 4.5 chunks of 16 input channels
        (48, 48, 3, True),  # c = 24 padded to 32, n = 3
        (96, 64, 1, False),  # c = 32: nothing padded, n = 1
    ],
)
def test_c2f_weight_slices_layout(c1, c2, n, shortcut):
    """The bf16 kernel's weight slices (`pack_slices`): shape, zero padding, and a
    walk over the slices alone that reproduces the plain twin on the same
    (bf16-representable) weights; f64 against f32 sums, rtol = atol = 1e-4."""
    rng = np.random.default_rng(7)
    jmod = M.C2f(c1, c2, n=n, shortcut=shortcut)
    p = _fused_c2f_params(rng, jmod)
    kw = _port(c1, c2, n, shortcut, p).kernel_weights()
    for name in ("w1", "wm", "w2"):  # the slices hold bf16: compare on weights bf16 holds exactly
        setattr(kw, name, getattr(kw, name).to(torch.bfloat16).float())
    slices = cuda_c2f.pack_slices(kw)
    c = c2 // 2
    kp = -(-c // 16) * 16
    assert slices is kw.slices() or torch.equal(slices, kw.slices())
    assert slices.dtype == torch.bfloat16 and slices.is_contiguous()
    assert tuple(slices.shape) == (2 * -(-c1 // kp) + 18 * n + -(-c2 // kp) * (2 + n), kp, kp + 8)
    n_cv2 = -(-c2 // kp) * (2 + n)
    n_cv1 = 2 * -(-c1 // kp)
    assert not slices[:, :, kp:].any() and not slices[n_cv1:, :, c:kp].any() and not slices[:-n_cv2, c:, :].any()
    assert not slices[-(2 + n) :, c2 - (c2 - 1) // kp * kp :, :].any()  # cv2's last chunk ends at c2o
    np.testing.assert_array_equal(slices[0, :c, : min(kp, c1)].float().numpy(), kw.w1[: min(kp, c1), :c].t().numpy())
    x = torch.from_numpy(rng.normal(0, 1, (2, 5, 6, c1)).astype(np.float32))
    got = _slices_forward(x, slices, kw, shortcut).float().numpy()
    np.testing.assert_allclose(got, cuda_c2f.c2f_plain(x, kw, shortcut).numpy(), **TOL)


@pytest.mark.parametrize("c1,c2,n,shortcut,cs,B,H,W", cuda_c2f.EDGE_SHAPES)
def test_c2f_plain_twin_matches_jax_at_edge_shapes(c1, c2, n, shortcut, cs, B, H, W):
    """The plain twins, which the card run trusts, against the JAX module at the
    edge shapes (f32; the two sum the convs in different orders)."""
    rng = np.random.default_rng(11)
    jmod = M.C2f(c1, c2, n=n, shortcut=shortcut)
    p = _fused_c2f_params(rng, jmod)
    kw = _port(c1, c2, n, shortcut, p).kernel_weights()
    ctx = M.Ctx(train=False, dtype=jnp.float32)
    skip = rng.normal(0, 1, (B, H, W, c1 - cs)).astype(np.float32)
    if cs:
        small = rng.normal(0, 1, (B, H // 2, W // 2, cs)).astype(np.float32)
        got = cuda_c2f.c2f_upconcat_plain(torch.from_numpy(small), torch.from_numpy(skip), kw, shortcut).numpy()
        want = np.asarray(jmod.call_upconcat(p, jnp.asarray(small), jnp.asarray(skip), 2, ctx))
    else:
        got = cuda_c2f.c2f_plain(torch.from_numpy(skip), kw, shortcut).numpy()
        want = np.asarray(jmod(p, jnp.asarray(skip), ctx))
    np.testing.assert_allclose(got, want, **TOL)
