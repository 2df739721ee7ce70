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
from yolo_tpu_torch.ops import cuda_c2f, cuda_head, cuda_nms

pytestmark = pytest.mark.cuda
TOL = {torch.float32: dict(atol=1e-3, rtol=1e-3), torch.bfloat16: dict(atol=6e-2, rtol=6e-2)}


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c1,c2,n,shortcut,cs", [(24, 24, 2, True, 0), (48, 48, 3, True, 0), (144, 96, 2, False, 96)])
def test_c2f_kernel_matches_plain(card, dtype, c1, c2, n, shortcut, cs):
    rng = np.random.default_rng(0)
    mod = PM.C2f(c1, c2, n=n, shortcut=shortcut)
    _random_convs(mod, rng, dtype)
    kw = mod.kernel_weights()
    skip = torch.randn(3, 20, 26, c1 - cs, device=card).to(dtype)
    before = (cuda_c2f.fused_c2f.launches, cuda_c2f.fused_c2f_upconcat.launches)
    if cs:
        small = torch.randn(3, 10, 13, cs, device=card).to(dtype)
        got = cuda_c2f.fused_c2f_upconcat(small, skip, kw, shortcut)
        want = cuda_c2f.c2f_upconcat_plain(small, skip, kw, shortcut)
    else:
        got = cuda_c2f.fused_c2f(skip, kw, shortcut)
        want = cuda_c2f.c2f_plain(skip, kw, shortcut)
    torch.cuda.synchronize()
    assert (cuda_c2f.fused_c2f.launches, cuda_c2f.fused_c2f_upconcat.launches) == (
        before[0] + (not cs), before[1] + bool(cs)
    )
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C,H,W", [(24, 21, 30), (192, 5, 7)])
def test_head_kernel_matches_plain(card, dtype, C, H, W):
    rng = np.random.default_rng(1)
    head = PM.Detect(nc=1, ch=(C,))
    head.to(card)
    _random_convs(head, rng, dtype)
    kw = head.kernel_weights(0)
    x = torch.randn(2, H, W, C, device=card).to(dtype)
    got_d, got_c = cuda_head.fused_head_level(x, kw)
    want_d, want_c = cuda_head.head_level_plain(x, kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(got_d, want_d, **TOL[dtype])
    torch.testing.assert_close(got_c.float(), want_c.float(), **TOL[dtype])


def test_nms_kernel_matches_plain(card):
    g = torch.Generator(device=card).manual_seed(0)
    B, K = 16, 64
    xy = torch.rand(B, K, 2, device=card, generator=g) * 100
    wh = torch.rand(B, K, 2, device=card, generator=g) * 30 + 4
    boxes = torch.cat([xy, xy + wh], -1)
    boxes[:, 1::4] = boxes[:, 0::4]  # duplicates
    scores = torch.sort(torch.rand(B, K, device=card, generator=g).round(decimals=1), 1, descending=True).values
    scores[:, -8:] = -1.0
    got = cuda_nms.nms_keep(boxes, scores, 0.5)
    want = cuda_nms.nms_keep_plain(boxes, scores, 0.5)
    assert torch.equal(got, want)
