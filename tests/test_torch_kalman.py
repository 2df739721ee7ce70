"""The port's batched Kalman step against the JAX package's (lax.scan of make_step):
the same detection sequences, with dropouts, duplicate detections (exactly
tied IoUs) and bursts that open and prune tracks, give the same states and
outputs. Integer and boolean fields must be equal; float fields agree to
1e-4 (the 4x4 and 8x8 products sum in another order than XLA's)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolo_tpu.kalman.batched import init_state as jax_init_state
from yolo_tpu.kalman.batched import make_step as jax_make_step
from yolo_tpu_torch.kalman import batched as P

from tests.test_kalman import make_detection_script
from tests.test_torch_native_ref import torch_threads  # noqa: F401 (an autouse fixture: two torch threads)

FLOAT_TOL = dict(rtol=1e-4, atol=1e-4)


def _script(kind: str, n_frames: int, D: int):
    """(T, D, 4) boxes and (T, D) masks."""
    boxes = np.zeros((n_frames, D, 4), np.float32)
    masks = np.zeros((n_frames, D), bool)
    if kind == "crossing":  # two targets, one lost for 40 frames
        for f, dets in enumerate(make_detection_script(n_frames=n_frames, seed=3)):
            for i, d in enumerate(dets[:D]):
                boxes[f, i], masks[f, i] = d[:4], True
        # duplicate the first detection of some frames: identical IoU rows
        for f in range(5, n_frames, 9):
            if masks[f, 0]:
                boxes[f, 2], masks[f, 2] = boxes[f, 0], True
        return boxes, masks
    rng = np.random.default_rng(42)  # churn: bursts, dropouts, near-duplicates
    centers, vels = rng.uniform(50, 450, (6, 2)), rng.uniform(-3, 3, (6, 2))
    for f in range(n_frames):
        k = 0
        for t in range(6):
            if rng.uniform() < 0.3 or k >= D:
                continue
            c = centers[t] + vels[t] * f + rng.normal(0, 1, 2)
            boxes[f, k], masks[f, k] = np.r_[c - 8, c + 8], True
            k += 1
            if rng.uniform() < 0.2 and k < D:  # an exact duplicate
                boxes[f, k], masks[f, k] = boxes[f, k - 1], True
                k += 1
    return boxes, masks


@pytest.mark.parametrize("kind,n_max,D,max_lost", [("crossing", 16, 8, 150), ("churn", 24, 8, 20)])
def test_step_matches_jax(kind, n_max, D, max_lost):
    T = 100
    boxes, masks = _script(kind, T, D)
    jstep = jax_make_step(n_max, D, max_lost, 1, 0.1)

    def body(state, inp):
        return jstep(state, inp[0], inp[1])

    jstate, jouts = jax.jit(lambda s, b, m: jax.lax.scan(body, s, (b, m)))(
        jax_init_state(n_max), jnp.asarray(boxes), jnp.asarray(masks)
    )

    step = P.make_step(n_max, D, max_lost, 1, 0.1, device="cpu")
    state = P.init_state(n_max, device="cpu")
    outs = []
    for f in range(T):
        state, out = step(state, torch.from_numpy(boxes[f]), torch.from_numpy(masks[f]))
        outs.append(out)
    for k, want in jouts.items():
        got = torch.stack([o[k] for o in outs]).numpy()
        want = np.asarray(want)
        if want.dtype.kind == "f":
            np.testing.assert_allclose(got, want, err_msg=k, **FLOAT_TOL)
        else:
            np.testing.assert_array_equal(got, want, err_msg=k)
    for k, want in jstate.items():
        got, want = state[k].numpy(), np.asarray(want)
        if want.dtype.kind == "f":
            np.testing.assert_allclose(got, want, err_msg=k, **FLOAT_TOL)
        else:
            np.testing.assert_array_equal(got, want, err_msg=k)
    assert np.asarray(jouts["emit"]).any() and int(state["next_id"]) > 2


def test_argmax_takes_the_first_of_tied_maxima():
    """The association and slot claims rely on argmax picking the earliest index."""
    x = torch.tensor([[0.2, 0.7, 0.7], [0.7, 0.1, 0.7]])
    assert int(torch.argmax(x)) == 1
    assert torch.argmax(x, 1).tolist() == [1, 0]
    assert torch.tensor([[False, True, True]]).to(torch.int32).argmax(1).tolist() == [1]


def test_inv4_matches_jax():
    from yolo_tpu.kalman.batched import _inv4

    rng = np.random.default_rng(0)
    a = rng.normal(0, 1, (5, 4, 4)).astype(np.float32)
    a = a @ np.swapaxes(a, 1, 2) + 10 * np.eye(4, dtype=np.float32)
    np.testing.assert_allclose(P._inv4(torch.from_numpy(a)).numpy(), np.asarray(_inv4(jnp.asarray(a))), rtol=1e-6, atol=1e-7)
