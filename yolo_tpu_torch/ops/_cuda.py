"""Build and load the port's hand-written CUDA kernels.

The sources are `yolo_tpu_torch/csrc/*.cu`. At first use they are compiled for
Hopper (`sm_90a`), one `nvcc` per source, all started together, and linked
into one shared library with a plain C interface under
`yolo_tpu_torch/_build/` (named by a hash of the sources, so an edit rebuilds).
The library is loaded with `ctypes`; every C entry returns the CUDA error of
its launch, and `check` raises on a non-zero one.

Nothing here runs at import time: the CPU tests import every module of the
package on a machine without `nvcc` or a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([str(Path(home) / "bin" / "nvcc")] if home else []) + [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]:
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit that builds the port's kernels")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _library_path() -> Path:
    cus, cuhs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in cus + cuhs:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD / f"libyolo_tpu_torch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless the library for these sources exists; returns its path.

    Each source compiles in its own `nvcc` process, all at once; the ptxas
    report (registers, shared memory, spills per kernel) goes to `build.log`.
    """
    out = _library_path()
    if out.exists():
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    cus, _ = _sources()
    procs = []
    for src in cus:
        obj = BUILD / f"{src.stem}.{os.getpid()}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, _, p in procs:
        text, _ = p.communicate()
        log.append(f"== {src.name} (rc {p.returncode})\n{text}")
        if p.returncode:
            failed.append(src.name)
    (BUILD / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in procs)], capture_output=True, text=True
    )
    for _, obj, _ in procs:
        obj.unlink(missing_ok=True)
    if link.returncode:
        raise RuntimeError(f"linking the kernels failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        cdll = ctypes.CDLL(str(build()))
        cdll.yt_error_string.argtypes = [ctypes.c_int]
        cdll.yt_error_string.restype = ctypes.c_char_p
        _lib = cdll
    return _lib


def function(name: str, argtypes: list):
    """A C entry of the library with its argument types declared (pointers and
    streams as c_void_p, so ctypes never cuts them to 32 bits)."""
    fn = getattr(lib(), name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what}: CUDA error {err} ({lib().yt_error_string(err).decode()})")


def mma_weight(w, k: int):
    """A flat HWIO f32 conv weight (k*k*cin, cout) → the tensor-core layout of the
    bf16 kernels: bf16 [k*k][cout padded to 16][cin padded to 16], zero-padded."""
    import torch

    kk = k * k
    cin, cout = w.shape[0] // kk, w.shape[1]
    pad = lambda c: (c + 15) // 16 * 16  # noqa: E731
    out = torch.zeros((kk, pad(cout), pad(cin)), dtype=torch.bfloat16, device=w.device)
    out[:, :cout, :cin] = w.reshape(kk, cin, cout).transpose(1, 2).to(torch.bfloat16)
    return out


def stream_of(t) -> int:
    """The raw handle of PyTorch's current stream on `t`'s device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
