"""The port's inference sources (`yolo_tpu_torch/data/loaders.py` and the predictor's
`_iter_source`) against the JAX package's on the same files: the cases of
tests/test_loaders.py. Frames must be equal, and paths, frame indices and order
the same. `LoadTensor` gets a torch tensor where the JAX one gets its array."""

import numpy as np
import pytest
import torch

from yolo_tpu.data import loaders as JL
from yolo_tpu.engine.predictor import _iter_source as jax_iter_source
from yolo_tpu_torch.data import loaders as PL
from yolo_tpu_torch.engine.predictor import _iter_source
from tests.test_torch_native_ref import jax_native_reference, torch_threads  # noqa: F401 (autouse fixtures: JAX's native letterbox, built whole; two torch threads)


@pytest.fixture()
def media_dir(tmp_path):
    import cv2

    rng = np.random.default_rng(0)
    for i in range(3):
        cv2.imwrite(str(tmp_path / f"im{i}.png"), rng.integers(0, 255, (32, 48, 3), np.uint8))
    (tmp_path / "sub").mkdir()
    cv2.imwrite(str(tmp_path / "sub" / "deep.jpg"), rng.integers(0, 255, (16, 24, 3), np.uint8))
    (tmp_path / "notes.txt").write_text("not an image")
    vw = cv2.VideoWriter(str(tmp_path / "v.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), 10, (48, 32))
    for f in range(6):
        vw.write(np.full((32, 48, 3), 40 * f, np.uint8))
    vw.release()
    return tmp_path


def _same_items(got, want):
    assert [(p, i) for p, _, i in got] == [(p, i) for p, _, i in want]
    for (_, g, _), (_, w, _) in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("spec,vid_stride", [
    ("", 1), ("", 2), ("v.mp4", 1), ("v.mp4", 2), ("v.mp4", 4), ("im1.png", 1), ("im*.png", 1), ("*", 3), ("sub", 1),
])
def test_load_images_and_videos_match_jax(media_dir, spec, vid_stride):
    """A directory (recursive, sorted; the .txt skipped), a video at strides 1, 2 and 4, one image,
    globs: the same (path, frame, index) items in the same order."""
    src = media_dir / spec if spec else media_dir
    got = list(PL.LoadImagesAndVideos(src, vid_stride=vid_stride))
    want = list(JL.LoadImagesAndVideos(src, vid_stride=vid_stride))
    assert len(got) > 0
    _same_items(got, want)
    assert len(PL.LoadImagesAndVideos(src)) == len(JL.LoadImagesAndVideos(src))


def test_directory_and_video_counts(media_dir):
    assert len(list(PL.LoadImagesAndVideos(media_dir))) == 3 + 1 + 6
    assert len(list(PL.LoadImagesAndVideos(media_dir / "v.mp4", vid_stride=2))) == 3


def _drain_streams(ls, n):
    got = []
    try:
        for _, images, _ in ls:
            got.append(images[0].copy())
            if len(got) >= n:
                break
    finally:
        ls.close()
    return got


@pytest.mark.parametrize("buffer", [True, False])
def test_load_streams_over_file_match_jax(media_dir, buffer):
    """A video file read as a stream by a reader thread: with `buffer` every frame in order, equal to the
    JAX loader's; without it the newest frame at each tick (timing-dependent), so frames that exist in the file."""
    vid = str(media_dir / "v.mp4")
    got = _drain_streams(PL.LoadStreams([vid], buffer=buffer), 6)
    want = _drain_streams(JL.LoadStreams([vid], buffer=buffer), 6)
    assert all(g.shape == (32, 48, 3) for g in got) and len(got) >= 1
    frames = [f for _, f, _ in JL.LoadImagesAndVideos(vid)]
    if buffer:
        assert len(got) == len(want) == 6
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    for g in got:
        assert any(np.array_equal(g, f) for f in frames)


def test_stream_buffer_keeps_all_frames_in_order(tmp_path):
    """stream_buffer=True through `_iter_source`: every frame of a 25-frame file, in order, as JAX's."""
    import cv2

    vid = tmp_path / "s.mp4"
    vw = cv2.VideoWriter(str(vid), cv2.VideoWriter_fourcc(*"mp4v"), 30, (32, 32))
    for i in range(25):
        vw.write(np.full((32, 32, 3), i * 10 % 255, np.uint8))
    vw.release()
    url = f"file://{vid}"  # "://" routes a path to the stream loader
    got = [(p, i, int(f[0, 0, 0])) for f, p, i in _iter_source([url], stream_buffer=True)]
    want = [(p, i, int(f[0, 0, 0])) for f, p, i in jax_iter_source([url], stream_buffer=True)]
    assert got == want and len(got) == 25
    assert [p for p, _, _ in got] == [url] * 25 and [i for _, i, _ in got] == list(range(25))


def test_routing_matches_jax(media_dir):
    cases = [
        (str(media_dir), PL.LoadImagesAndVideos, JL.LoadImagesAndVideos),
        (str(media_dir / "im0.png"), PL.LoadImagesAndVideos, JL.LoadImagesAndVideos),
        (np.zeros((2, 8, 8, 3), np.uint8), PL.LoadTensor, JL.LoadTensor),
    ]
    for src, port_cls, jax_cls in cases:
        assert isinstance(PL.load_inference_source(src), port_cls) and isinstance(JL.load_inference_source(src), jax_cls)
    assert isinstance(PL.load_inference_source(torch.zeros((2, 8, 8, 3), dtype=torch.uint8)), PL.LoadTensor)
    # a path that merely starts with "screen" is a file
    d = media_dir / "screenshots"
    d.mkdir()
    import cv2

    cv2.imwrite(str(d / "img.png"), np.zeros((8, 8, 3), np.uint8))
    loader = PL.load_inference_source(str(d / "img.png"))
    assert isinstance(loader, PL.LoadImagesAndVideos) and list(loader)[0][1].shape == (8, 8, 3)


def test_screenshots_need_mss(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "mss", None)
    for mod in (PL, JL):
        with pytest.raises(ImportError, match="mss"):
            mod.load_inference_source("screen 0")


def test_missing_sources_raise_like_jax(tmp_path):
    for src in (str(tmp_path / "nope.png"), str(tmp_path / "nope*.png"), str(tmp_path / "clip.mp4")):
        with pytest.raises(FileNotFoundError):
            JL.load_inference_source(src)
        with pytest.raises(FileNotFoundError):
            PL.load_inference_source(src)
    with pytest.raises(ConnectionError):
        JL.load_inference_source(f"file://{tmp_path / 'nope.mp4'}")
    with pytest.raises(ConnectionError):
        PL.load_inference_source(f"file://{tmp_path / 'nope.mp4'}")


@pytest.mark.parametrize("layout", ["nhwc_u8", "nchw_float", "nhwc_gray", "one_image"])
def test_load_tensor_torch_matches_jax_array(layout):
    """The port's LoadTensor on a torch tensor, the JAX one on the same values as a jax array: equal frames and paths."""
    import jax.numpy as jnp

    rng = np.random.default_rng(1)
    x = {
        "nhwc_u8": rng.integers(0, 255, (3, 16, 24, 3), np.uint8),
        "nchw_float": rng.uniform(0, 1, (2, 3, 16, 24)).astype(np.float32),
        "nhwc_gray": rng.integers(0, 255, (2, 16, 24, 1), np.uint8),
        "one_image": rng.integers(0, 255, (16, 24, 3), np.uint8),
    }[layout]
    got = list(PL.LoadTensor(torch.from_numpy(x)))
    want = list(JL.LoadTensor(jnp.asarray(x)))
    _same_items(got, want)
    assert all(f.shape == (16, 24, 3) and f.dtype == np.uint8 for _, f, _ in got)


def test_load_tensor_checks_like_jax():
    import jax.numpy as jnp

    for bad, exc in ((np.full((1, 3, 8, 8), 2.0, np.float32), ValueError), (np.zeros((2, 2), np.uint8), ValueError)):
        with pytest.raises(exc):
            JL.LoadTensor(jnp.asarray(bad))
        with pytest.raises(exc):
            PL.LoadTensor(torch.from_numpy(bad))


def test_iter_source_matches_jax(media_dir):
    """The predictor's source walk on a frame, a list of frames, a 4-D batch (numpy and torch), a PIL
    image, a directory, a glob and a mixed list: the same (path, index) and frames as the JAX walk."""
    import jax.numpy as jnp
    from PIL import Image

    rng = np.random.default_rng(2)
    frame = rng.integers(0, 255, (16, 24, 3), np.uint8)
    batch = rng.integers(0, 255, (2, 16, 24, 3), np.uint8)
    pil = Image.fromarray(frame)
    for src, jsrc in ((frame, frame), ([frame, frame[..., :1]], [frame, frame[..., :1]]), (torch.from_numpy(batch), jnp.asarray(batch)),
                      (batch, batch), (pil, pil), (str(media_dir), str(media_dir)), (str(media_dir / "im*.png"),) * 2,
                      ([frame, str(media_dir / "v.mp4")], [frame, str(media_dir / "v.mp4")])):
        got = [(p, f, i) for f, p, i in _iter_source(src, vid_stride=2)]
        want = [(p, f, i) for f, p, i in jax_iter_source(jsrc, vid_stride=2)]
        _same_items(got, want)
