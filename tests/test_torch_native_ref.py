"""The JAX package's native letterbox as the port's tests read it, and the fault this guards against.

JAX's loader (yolo_tpu/native/__init__.py) runs g++ straight into its final `libyolo_preprocess-<hash>.so`, and
any process that finds that name loads it. Under pytest-xdist, a worker that starts while another worker's g++ is
still writing the file loads a truncated library ("file too short"), reports the library unavailable, and keeps
that answer for the rest of the process: its JAX predictor letterboxes with cv2 from then on, and every comparison
with the port's native letterbox on a frame that must be resized fails.

`jax_native_reference` (an autouse fixture: the port's test files that run the JAX package's predictor import it)
builds JAX's own preprocess.cpp, with JAX's flags, into a temporary file beside `yolo_tpu_torch/_build/jax_native/`,
renames it into place (so no process can see it half written), and lets JAX's own loader load it from there, for
the module's duration. The reference stays JAX's code and JAX's source; no JAX file changes.
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import yolo_tpu.native as JN
from yolo_tpu_torch import native as PNAT

TORCH_THREADS = 2  # intra-op threads of torch while a port test module runs in a parallel worker


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    """Two intra-op threads for torch while the module runs in a pytest-xdist worker (an autouse fixture: every port
    test file imports it). Torch's default, a thread per core in each of the parallel workers, spins on the cores that
    the other workers compute on: the Tier-1 run took 1,022-1,210 s with it and 470 s with two. A run in one process
    keeps the default."""
    n = torch.get_num_threads()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        torch.set_num_threads(TORCH_THREADS)
    yield
    torch.set_num_threads(n)


JAX_SRC = Path(JN.__file__).resolve().with_name("preprocess.cpp")
BUILD = Path(PNAT.BUILD) / "jax_native"
_CACHED = {}


def _replace_atomically(path: Path, write) -> None:
    """`write(tmp)` fills a file of this process's own, which is then renamed to `path`: whoever finds `path`
    finds it whole."""
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    write(tmp)
    os.replace(tmp, path)


def jax_reference_library(build: Path = BUILD):
    """JAX's library built whole: its preprocess.cpp copied into `build`, compiled there with JAX's command
    (g++ -O3 -shared -fPIC) under the name JAX's loader looks for, then loaded by JAX's `_load` pointed at that
    directory (its argument types and all). Once per process and directory."""
    if build in _CACHED:
        return _CACHED[build]
    build.mkdir(parents=True, exist_ok=True)
    source = JAX_SRC.read_bytes()
    so = build / f"libyolo_preprocess-{hashlib.sha256(source).hexdigest()[:12]}.so"
    src = build / "preprocess.cpp"
    if not src.exists() or src.read_bytes() != source:
        _replace_atomically(src, lambda tmp: tmp.write_bytes(source))
    if not so.exists():
        _replace_atomically(so, lambda tmp: subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", str(tmp), str(JAX_SRC)],
                                                           check=True, capture_output=True, timeout=120))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JN, "__file__", str(build / "__init__.py"))
        mp.setattr(JN, "_TRIED", False)
        mp.setattr(JN, "_LIB", None)
        lib = JN._load()
    if lib is None:
        raise RuntimeError(f"the JAX package's native library did not load from {so}")
    _CACHED[build] = lib
    return lib


@contextlib.contextmanager
def jax_native_installed(build: Path = BUILD):
    """While the block runs, JAX's `native` module holds the library that `jax_reference_library` built, whatever
    its own loader found before (a failed load of an earlier test file in this process included)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JN, "_LIB", jax_reference_library(build))
        mp.setattr(JN, "_TRIED", True)
        yield JN._LIB


@pytest.fixture(scope="module", autouse=True)
def jax_native_reference():
    with jax_native_installed() as lib:
        yield lib


def _stage_half_written_jax_build(root: Path) -> None:
    """JAX's loader directory as another process leaves it while its g++ is still writing: the source, and the
    library under its final name but cut short within its ELF header, as the linker has just opened it. (Cut
    further in, dlopen may map pages past the end of the file: a load then dies of SIGBUS.)"""
    source = JAX_SRC.read_bytes()
    (root / "preprocess.cpp").write_bytes(source)
    so_name = f"libyolo_preprocess-{hashlib.sha256(source).hexdigest()[:12]}.so"
    (root / so_name).write_bytes(Path(jax_reference_library()._name).read_bytes()[:32])


def test_jax_reference_letterbox_survives_a_half_written_jax_build(tmp_path, monkeypatch):
    """JAX's loader, pointed at a directory holding its library half written, reports the native library
    unavailable (the fault this module guards against). Loaded again in that state through `jax_native_installed`, the
    route the port's test files take, JAX's letterbox works and equals the port's bit for bit (a 1080x1920 frame
    resized into 640x640, one image and a batch of two), and JAX's predictor route sees the library."""
    _stage_half_written_jax_build(tmp_path)
    monkeypatch.setattr(JN, "__file__", str(tmp_path / "__init__.py"))
    monkeypatch.setattr(JN, "_TRIED", False)
    monkeypatch.setattr(JN, "_LIB", None)
    assert not JN.available()
    with pytest.raises(RuntimeError, match="unavailable"):
        JN.letterbox(np.zeros((8, 8, 3), np.uint8), (16, 16))
    monkeypatch.setattr(JN, "_TRIED", False)
    rng = np.random.default_rng(18)
    img = rng.integers(0, 255, (1080, 1920, 3), np.uint8)
    frames = rng.integers(0, 255, (2, 1080, 1920, 3), np.uint8)
    with jax_native_installed():
        assert JN.available()
        want, want_meta = JN.letterbox(img, (640, 640))
        want_b, want_bmeta = JN.letterbox_batch(frames, (640, 640))
    got, got_meta = PNAT.letterbox(img, (640, 640))
    got_b, got_bmeta = PNAT.letterbox_batch(frames, (640, 640))
    assert got_meta == want_meta and got_bmeta == want_bmeta
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_b, want_b)

