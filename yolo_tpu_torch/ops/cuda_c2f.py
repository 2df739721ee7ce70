"""Fused C2f: the wrapper of the CUDA kernel csrc/c2f.cu and its plain PyTorch twin.

Counterpart of yolo_tpu/ops/pallas_c2f.py (`fused_c2f`, `fused_c2f_upconcat`,
both served by `_c2f_kernel`). The kernel computes one whole C2f block with
every intermediate map in shared memory: a block owns one tile of one frame
(a full-width row band where the map is small) and recomputes the 2n-pixel
halo of its conv chain inside the image only. It is bound by operations. In
bf16 every conv, cv1 included, is an implicit GEMM on the tensor cores with
both operands in shared memory: the input pixels are staged by asynchronous
copies, and the weights stream through a two-step ring as the slices that
`pack_slices` lays out, one bulk copy of the copy engine per step, read from
global memory once per block and round of warp items. cv2 runs once over the
kept concat segments with its sums in registers. f32 runs the same tiles on
the CUDA cores (no TF32). A wide or deep block that fits no such tile (the s-x
scales: C2F_WIDTHS) runs the kernel's general instantiation: N chunks of the
weight ring, and where the halo still does not fit, passes of a few
bottlenecks each that hand their concat segments to a last cv2 launch through
a buffer this wrapper allocates. `plan` says what the kernel picks for an
instance and `candidates` what it weighed; the note at the top of csrc/c2f.cu
has the design and what bounds it.

`fused_c2f` / `fused_c2f_upconcat` launch the kernel for a CUDA tensor and
count the call in their `launches` attribute (a split plan's passes are one call); for a CPU tensor they compute
the plain twin (`c2f_plain` / `c2f_upconcat_plain`), which is also what the
kernel is held against on the card.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass, field

import torch

from yolo_tpu_torch.ops import _cuda
from yolo_tpu_torch.ops.conv import conv_hwio, conv_nhwc, silu


def _flat(w: torch.Tensor) -> torch.Tensor:
    """OIHW conv weight → flat HWIO (k*k*cin, cout) f32."""
    return w.float().permute(2, 3, 1, 0).reshape(-1, w.shape[0]).contiguous()


@dataclass
class C2fWeights:
    """One C2f's fused weights in the kernel's layout: f32 HWIO, values already
    rounded to the model's compute dtype."""

    w1: torch.Tensor  # cv1 (c1, 2c)
    b1: torch.Tensor  # (2c,)
    wm: torch.Tensor  # (2n, 9c, c): bottleneck i conv j at 2i + j
    bm: torch.Tensor  # (2n, c)
    w2: torch.Tensor  # cv2 ((2 + n) c, c2o)
    b2: torch.Tensor  # (c2o,)
    _slices: torch.Tensor | None = field(default=None, repr=False)

    @property
    def n(self) -> int:
        return self.wm.shape[0] // 2

    @property
    def c(self) -> int:
        return self.wm.shape[-1]

    def slices(self) -> torch.Tensor:
        """The weights as the bf16 kernel streams them (`pack_slices`), made once."""
        if self._slices is None:
            self._slices = pack_slices(self)
        return self._slices

    @classmethod
    def from_convs(cls, cv1, bottlenecks, cv2) -> "C2fWeights":
        """From the C2f's ConvBNAct modules (OIHW weight + bias each)."""
        convs = [cv for pair in bottlenecks for cv in pair]
        return cls(
            w1=_flat(cv1.weight),
            b1=cv1.bias.float().contiguous(),
            wm=torch.stack([_flat(cv.weight) for cv in convs]),
            bm=torch.stack([cv.bias.float() for cv in convs]),
            w2=_flat(cv2.weight),
            b2=cv2.bias.float().contiguous(),
        )


def pack_slices(kw: C2fWeights) -> torch.Tensor:
    """Every conv of the block as bf16 weight slices (S, kp, kp + 8) with kp = c
    padded to 16: slice[r, k] multiplies input channel k of its K chunk into
    output channel r of its N chunk; rows past the conv's output channels,
    columns k >= c (or past c1 in cv1's last chunk) and the 8 pad columns (they
    keep a slice's rows on distinct shared-memory banks) are zero.
    In the kernel's order:
    - cv1: for each half (y_a, y_b) its ceil(c1 / kp) chunks of kp input channels;
    - each bottleneck conv 2i + j: its 9 taps;
    - cv2: for each chunk of kp output channels its 2 + n concat segments."""
    c, n, c1, c2o = kw.c, kw.n, kw.w1.shape[0], kw.w2.shape[1]
    kp = (c + 15) // 16 * 16

    def slab(w: torch.Tensor) -> torch.Tensor:  # (k <= kp, r <= kp) → (kp, kp + 8)
        out = torch.zeros((kp, kp + 8), dtype=torch.bfloat16, device=w.device)
        out[: w.shape[1], : w.shape[0]] = w.t().to(torch.bfloat16)
        return out

    slabs = [slab(kw.w1[k : k + kp, h * c : (h + 1) * c]) for h in (0, 1) for k in range(0, c1, kp)]
    slabs += [slab(kw.wm[q, t * c : (t + 1) * c]) for q in range(2 * n) for t in range(9)]
    slabs += [slab(kw.w2[s * c : (s + 1) * c, o : o + kp]) for o in range(0, c2o, kp) for s in range(2 + n)]
    return torch.stack(slabs).contiguous()


def _tail(y: torch.Tensor, kw: C2fWeights, shortcut: bool) -> torch.Tensor:
    """Everything after cv1: split, the bottleneck chain, concat, cv2."""
    c = kw.c
    parts = [y[..., :c], y[..., c:]]
    for i in range(kw.n):
        t = conv_hwio(parts[-1], kw.wm[2 * i], kw.bm[2 * i], 3)
        t = conv_hwio(t, kw.wm[2 * i + 1], kw.bm[2 * i + 1], 3)
        parts.append(parts[-1] + t if shortcut else t)
    return conv_hwio(torch.cat(parts, -1), kw.w2, kw.b2, 1)


def c2f_plain(x: torch.Tensor, kw: C2fWeights, shortcut: bool) -> torch.Tensor:
    """Plain twin of the kernel: x (B, H, W, c1) → (B, H, W, c2o) in x's dtype."""
    return _tail(conv_hwio(x, kw.w1, kw.b1, 1), kw, shortcut)


def c2f_upconcat_plain(small: torch.Tensor, skip: torch.Tensor, kw: C2fWeights, shortcut: bool) -> torch.Tensor:
    """Plain twin of the upconcat mode, the JAX package's C2f.call_upconcat
    algebra: cv1 splits along its input channels, the `small` half runs at low
    resolution and only its 2c-channel result is upsampled."""
    cs = small.shape[-1]
    w1 = kw.w1.t()[:, :, None, None]  # (2c, c1, 1, 1)
    ya = conv_nhwc(small, w1[:, :cs])
    yb = conv_nhwc(skip, w1[:, cs:])
    up = ya.repeat_interleave(2, 1).repeat_interleave(2, 2)
    return _tail(silu(up + yb + kw.b1.to(yb.dtype)), kw, shortcut)


# Shapes a tiling can get wrong and the main path lacks; the card run holds the kernel against
# its twin at them and the CPU tests the twin against the JAX module:
# (c1, c2, n, shortcut, small channels of the upconcat mode or 0, B, H, W)
EDGE_SHAPES = [
    (24, 24, 2, True, 0, 1, 7, 12),  # c = 12 (padded to 16), odd H, one frame
    (48, 48, 3, True, 0, 1, 33, 41),  # n = 3, a map no tile divides
    (288, 192, 2, False, 0, 2, 16, 20),  # c1 = 288, c = 96
    (192, 192, 2, True, 0, 1, 16, 20),  # c = 96 with one frame: small tiles over the SMs
    (32, 64, 1, False, 0, 3, 7, 12),  # n = 1
    (64, 128, 1, True, 0, 1, 8, 10),  # c = 64: a width served by the kernel's general instantiation
    (72, 24, 2, False, 48, 1, 14, 22),  # upconcat, 48 small channels
    (288, 96, 2, False, 192, 2, 8, 10),  # upconcat, 192 small channels
    (72, 24, 3, True, 48, 1, 34, 42),  # upconcat with the residual and n = 3
]
# The published widths: every C2f and neck-fold instance, (c1, cs, c, c2o, n, H, W) with cs > 0 for the fold, of
# the models of WIDTH_MODELS at their input sizes, each listed once, under the first model that has it. The s-x
# scales take the kernel's general plan (N chunks, split passes); the card holds the kernel against its twin at
# each of them (chip_smoke.py `[c2f widths]`), and tests/test_torch_c2f.py derives the list from the models.
WIDTH_MODELS = ([(f"yolov8{s}.yaml", None, 640, 640) for s in "nsmlx"] + [("yolov8-small.yaml", s, 512, 640) for s in "nsmlx"]
                + [(f"yolov10{s}.yaml", None, 640, 640) for s in "nsmblx"])  # (yaml, scale or None, H, W)
C2F_WIDTHS = [
    # yolov8n
    (32, 0, 16, 32, 1, 160, 160), (64, 0, 32, 64, 2, 80, 80), (128, 0, 64, 128, 2, 40, 40), (256, 0, 128, 256, 1, 20, 20),
    (384, 256, 64, 128, 1, 40, 40), (192, 128, 32, 64, 1, 80, 80), (192, 0, 64, 128, 1, 40, 40), (384, 0, 128, 256, 1, 20, 20),
    # yolov8s
    (64, 0, 32, 64, 1, 160, 160), (128, 0, 64, 128, 2, 80, 80), (256, 0, 128, 256, 2, 40, 40), (512, 0, 256, 512, 1, 20, 20),
    (768, 512, 128, 256, 1, 40, 40), (384, 256, 64, 128, 1, 80, 80), (384, 0, 128, 256, 1, 40, 40), (768, 0, 256, 512, 1, 20, 20),
    # yolov8m
    (96, 0, 48, 96, 2, 160, 160), (192, 0, 96, 192, 4, 80, 80), (384, 0, 192, 384, 4, 40, 40), (576, 0, 288, 576, 2, 20, 20),
    (960, 576, 192, 384, 2, 40, 40), (576, 384, 96, 192, 2, 80, 80), (576, 0, 192, 384, 2, 40, 40), (960, 0, 288, 576, 2, 20, 20),
    # yolov8l
    (128, 0, 64, 128, 3, 160, 160), (256, 0, 128, 256, 6, 80, 80), (512, 0, 256, 512, 6, 40, 40), (512, 0, 256, 512, 3, 20, 20),
    (1024, 512, 256, 512, 3, 40, 40), (768, 512, 128, 256, 3, 80, 80), (768, 0, 256, 512, 3, 40, 40), (1024, 0, 256, 512, 3, 20, 20),
    # yolov8x
    (160, 0, 80, 160, 3, 160, 160), (320, 0, 160, 320, 6, 80, 80), (640, 0, 320, 640, 6, 40, 40), (640, 0, 320, 640, 3, 20, 20),
    (1280, 640, 320, 640, 3, 40, 40), (960, 640, 160, 320, 3, 80, 80), (960, 0, 320, 640, 3, 40, 40), (1280, 0, 320, 640, 3, 20, 20),
    # yolov8-small n
    (24, 0, 12, 24, 2, 128, 160), (48, 0, 24, 48, 3, 64, 80), (96, 0, 48, 96, 3, 32, 40), (192, 0, 96, 192, 2, 16, 20),
    (288, 192, 48, 96, 2, 32, 40), (144, 96, 24, 48, 2, 64, 80), (72, 48, 12, 24, 2, 128, 160), (144, 0, 48, 96, 2, 32, 40),
    (288, 0, 96, 192, 2, 16, 20),
    # yolov8-small s
    (40, 0, 20, 40, 2, 128, 160), (80, 0, 40, 80, 4, 64, 80), (160, 0, 80, 160, 4, 32, 40), (320, 0, 160, 320, 2, 16, 20),
    (480, 320, 80, 160, 2, 32, 40), (240, 160, 40, 80, 2, 64, 80), (120, 80, 20, 40, 2, 128, 160), (240, 0, 80, 160, 2, 32, 40),
    (480, 0, 160, 320, 2, 16, 20),
    # yolov8-small m
    (56, 0, 28, 56, 3, 128, 160), (112, 0, 56, 112, 6, 64, 80), (224, 0, 112, 224, 6, 32, 40), (448, 0, 224, 448, 3, 16, 20),
    (672, 448, 112, 224, 3, 32, 40), (336, 224, 56, 112, 3, 64, 80), (168, 112, 28, 56, 3, 128, 160), (336, 0, 112, 224, 3, 32, 40),
    (672, 0, 224, 448, 3, 16, 20),
    # yolov8-small l
    (72, 0, 36, 72, 4, 128, 160), (144, 0, 72, 144, 8, 64, 80), (288, 0, 144, 288, 8, 32, 40), (576, 0, 288, 576, 4, 16, 20),
    (864, 576, 144, 288, 4, 32, 40), (432, 288, 72, 144, 4, 64, 80), (216, 144, 36, 72, 4, 128, 160), (432, 0, 144, 288, 4, 32, 40),
    (864, 0, 288, 576, 4, 16, 20),
    # yolov8-small x
    (88, 0, 44, 88, 5, 128, 160), (176, 0, 88, 176, 10, 64, 80), (352, 0, 176, 352, 10, 32, 40), (704, 0, 352, 704, 5, 16, 20),
    (1056, 704, 176, 352, 5, 32, 40), (528, 352, 88, 176, 5, 64, 80), (264, 176, 44, 88, 5, 128, 160), (528, 0, 176, 352, 5, 32, 40),
    (1056, 0, 352, 704, 5, 16, 20),
    # yolov10b
    (128, 0, 64, 128, 2, 160, 160), (256, 0, 128, 256, 4, 80, 80), (512, 0, 256, 512, 4, 40, 40), (768, 512, 128, 256, 2, 80, 80),
]
MODEL = ("barrier", "shared")  # the constants of the plan's cost model (csrc/c2f.cu::Model)


@functools.lru_cache(maxsize=None)
def _entry(lib=None):
    """`yt_c2f_forward` of the kernel library, or of another build of it (`lib`)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    argtypes = [p, p, p] + [p] * 8 + [i] * 13 + [p]
    if lib is None:
        return _cuda.function("yt_c2f_forward", argtypes)
    fn = lib.yt_c2f_forward
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def candidates(B: int, H: int, W: int, c1: int, cs: int, c: int, c2o: int, n: int, dtype, model=None):
    """Every (tile, slices per ring step) the plan weighs for an instance, in its
    order, as dicts with the modelled `cost`; the plan is the first of least
    cost. `model` gives some of the constants named in MODEL other values (a
    measurement's way to ask what each of them decides)."""
    room = 256
    plans, costs, count = (ctypes.c_longlong * (6 * room))(), (ctypes.c_double * room)(), ctypes.c_int(0)
    consts = None if model is None else (ctypes.c_double * len(MODEL))(*(model.get(k, float("nan")) for k in MODEL))
    i = ctypes.c_int
    fn = _cuda.function("yt_c2f_candidates", [i] * 9 + [ctypes.POINTER(ctypes.c_double), i, ctypes.POINTER(ctypes.c_longlong),
                                               ctypes.POINTER(ctypes.c_double), ctypes.POINTER(i)])
    err = fn(B, H, W, c1, cs, c, c2o, n, int(dtype == torch.bfloat16), consts, room, plans, costs, ctypes.byref(count))
    if err < 0:
        raise ValueError(_refusal(c1, cs, c, c2o, n, H, W, dtype))
    _cuda.check(err, "c2f candidates")
    keys = ("th", "tw", "step_slices", "blocks", "blocks_per_sm", "smem")
    return [dict(zip(keys, (int(v) for v in plans[6 * k : 6 * k + 6])), cost=costs[k]) for k in range(min(count.value, room))]


def plan(B: int, H: int, W: int, c1: int, cs: int, c: int, c2o: int, n: int, dtype) -> dict:
    """What the kernel picks for an instance (it depends on the batch: few frames
    take small tiles to spread over the SMs): the output tile, the blocks of the
    launch (no clusters) and how many an SM holds, the shared bytes per block,
    and the matrix instruction; in bf16 also the steps of the weight ring (two),
    the slices per step, the output channels of a ring slice (`ring_chunk`:
    pad16(c) unless N chunks shrink it) and the pixels of a warp item. A split
    plan (`passes` > 1: the chain in passes of `pass_bottlenecks`, then cv2)
    names its cv2 launch's `tail_tile`, `tail_chunk` and `tail_step_slices`, and
    the elements of the concat buffer it needs (`workspace`)."""
    bf16 = dtype == torch.bfloat16
    out = (ctypes.c_longlong * 16)()
    fn = _cuda.function("yt_c2f_plan", [ctypes.c_int] * 9 + [ctypes.POINTER(ctypes.c_longlong)])
    err = fn(B, H, W, c1, cs, c, c2o, n, int(bf16), out)
    if err < 0:
        raise ValueError(_refusal(c1, cs, c, c2o, n, H, W, dtype))
    _cuda.check(err, "c2f plan")
    th, tw, blocks, per_sm, smem, ring, group, item_px, chunk, passes, nb, tth, ttw, tchunk, tgroup, ws = (int(v) for v in out)
    return dict(tile=(th, tw), blocks=blocks, cluster=1, blocks_per_sm=per_sm, smem=smem, ring_steps=ring,
                step_slices=group, ring_chunk=chunk, item_px=item_px, passes=passes, pass_bottlenecks=nb,
                tail_tile=(tth, ttw), tail_chunk=tchunk, tail_step_slices=tgroup, workspace=ws,
                instruction="mma.sync.m16n8k16 + ldmatrix" if bf16 else "fmaf (CUDA cores)")


@functools.lru_cache(maxsize=None)
def _workspace(B: int, H: int, W: int, c1: int, cs: int, c: int, c2o: int, n: int, bf16: bool) -> int:
    """Elements of the concat buffer the instance's plan needs (0 for one launch); the plan is the kernel's,
    asked once per instance."""
    return plan(B, H, W, c1, cs, c, c2o, n, torch.bfloat16 if bf16 else torch.float32)["workspace"]


def _refusal(c1, cs, c, c2o, n, H, W, dtype) -> str:
    return (f"the C2f kernel does not take c1={c1} (small: {cs}), c={c}, c2o={c2o}, n={n} on a {H}x{W} map in {dtype}: "
            "it needs c % 4 == 0, an even map in upconcat mode, in bf16 input channel counts "
            "that are multiples of 8 and an even c2o, and in f32 c2o % 8 == 0")


def _launch(x: torch.Tensor, small: torch.Tensor | None, kw: C2fWeights, shortcut: bool, force=(0, 0, 0), lib=None) -> torch.Tensor:
    """Launch the kernel with the instance's plan, or (measurements only) with the
    tile and ring `force` = (th, tw, slices per ring step), from `lib` where that
    is another build of the kernel library."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused C2f takes f32 or bf16 activations, got {x.dtype}")
    B, H, W, ck = x.shape
    cs = 0 if small is None else small.shape[-1]
    if small is not None and (small.dtype != x.dtype or small.shape != (B, H // 2, W // 2, cs) or H % 2 or W % 2):
        raise ValueError(f"small {tuple(small.shape)} is not a 2x-downsampled partner of skip {tuple(x.shape)}")
    if kw.w1.shape[0] != cs + ck or kw.w1.device != x.device:
        raise ValueError(f"C2f weights take {kw.w1.shape[0]} input channels on {kw.w1.device}, got {cs + ck} on {x.device}")
    x = x.contiguous()
    small = None if small is None else small.contiguous()
    c2o = kw.w2.shape[1]
    bf16 = x.dtype == torch.bfloat16
    out = torch.empty((B, H, W, c2o), device=x.device, dtype=x.dtype)
    ws = 0 if force[0] else _workspace(B, H, W, cs + ck, cs, kw.c, c2o, kw.n, bf16)
    cat = torch.empty(ws, device=x.device, dtype=x.dtype) if ws else None  # a split plan's concat between its passes
    err = _entry(lib)(
        x.data_ptr(), 0 if small is None else small.data_ptr(), out.data_ptr(),
        kw.w1.data_ptr(), kw.b1.data_ptr(), kw.wm.data_ptr(), kw.bm.data_ptr(), kw.w2.data_ptr(), kw.b2.data_ptr(),
        kw.slices().data_ptr() if bf16 else 0, 0 if cat is None else cat.data_ptr(),
        B, H, W, cs + ck, cs, kw.c, c2o, kw.n, int(shortcut), int(bf16), *force,
        _cuda.stream_of(x),
    )
    if err < 0:  # the kernel's own refusals; CUDA's error codes are positive
        raise ValueError(_refusal(cs + ck, cs, kw.c, c2o, kw.n, H, W, x.dtype))
    _cuda.check(err, "c2f kernel")
    return out


def fused_c2f(x: torch.Tensor, kw: C2fWeights, shortcut: bool) -> torch.Tensor:
    """One C2f block: x (B, H, W, c1) → (B, H, W, c2o), in x's dtype (f32 or bf16)."""
    if not x.is_cuda:
        return c2f_plain(x, kw, shortcut)
    out = _launch(x, None, kw, shortcut)
    fused_c2f.launches += 1
    return out


def fused_c2f_upconcat(small: torch.Tensor, skip: torch.Tensor, kw: C2fWeights, shortcut: bool) -> torch.Tensor:
    """C2f(concat(up2x_nearest(small), skip)): small (B, H/2, W/2, cs), skip (B, H, W, ck)."""
    if not skip.is_cuda:
        return c2f_upconcat_plain(small, skip, kw, shortcut)
    out = _launch(skip, small, kw, shortcut)
    fused_c2f_upconcat.launches += 1
    return out


fused_c2f.launches = 0
fused_c2f_upconcat.launches = 0
