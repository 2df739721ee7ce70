"""Batched fixed-capacity ByteTrack on the card (counterpart of yolo_tpu/trackers/batched.py).

The same semantics as the host BYTETracker over a slot table: a dict of
(N_max, ...) tensors on one device, the XYAH Kalman predict / update as
batched products over all slots, and the three association stages as greedy
min-cost assignments over a fixed (N_max, D_max) cost matrix. The greedy
picks the globally lowest cost first; it equals the host's optimal
assignment unless two tracks compete for overlapping detections (the JAX
package's parity contract). Axis-aligned boxes only.

The JAX package's greedy is an early-exit `while_loop`. Here it is a fixed
number of rounds, each a masked no-op once no cost is under the threshold,
so the step never waits for the device:
- `update` knows the frame's detection counts on the host, and a stage can
  match no more columns than it has real detections, so it runs that many rounds;
- `scan_frames` takes device tensors and reads nothing back while it runs:
  every stage runs `d_max` rounds, as the JAX loop's `max_matches` allows,
  and on the card the step is one CUDA graph, replayed once a frame.
`torch.argmin` / `argmax` return the first extreme index, as `jnp.argmin` /
`jnp.argmax` do, so ties resolve alike. Ids and frame counters are int32.
"""

from __future__ import annotations

import warnings
from types import SimpleNamespace

import numpy as np
import torch

from yolo_tpu_torch.device import resolve_device
from yolo_tpu_torch.kalman.batched import _inv4

BIG = 1e9
_WP, _WV = 1.0 / 20, 1.0 / 160  # XYAH noise weights: position, velocity (per unit of height)
DEFAULT_ARGS = SimpleNamespace(track_high_thresh=0.25, track_low_thresh=0.1, new_track_thresh=0.25, track_buffer=30,
                               match_thresh=0.8, fuse_score=True)


def init_state(n_max: int = 128, device=None) -> dict:
    """Fresh empty slot table on `device` (None: the card)."""
    dev = resolve_device(device)
    f32, i32 = torch.float32, torch.int32

    def z(*shape, dtype=i32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return {
        "mean": z(n_max, 8, dtype=f32),
        "cov": z(n_max, 8, 8, dtype=f32),
        "state": z(n_max),  # 0 free, 1 tracked, 2 lost
        "is_activated": z(n_max, dtype=torch.bool),
        "track_id": z(n_max),
        "score": z(n_max, dtype=f32),
        "cls": z(n_max, dtype=f32),
        "det_idx": torch.full((n_max,), -1, dtype=i32, device=dev),
        "tracklet_len": z(n_max),
        "last_frame": z(n_max),
        "start_frame": z(n_max),
        "next_id": torch.ones((), dtype=i32, device=dev),
        "frame": z(),
    }


def _xywh_to_xyah(xywh):
    return torch.stack([xywh[..., 0], xywh[..., 1], xywh[..., 2] / xywh[..., 3].clamp(min=1e-6), xywh[..., 3]], -1)


def _mean_to_xyxy(mean):
    w = mean[..., 2] * mean[..., 3]
    h = mean[..., 3]
    return torch.stack([mean[..., 0] - w / 2, mean[..., 1] - h / 2, mean[..., 0] + w / 2, mean[..., 1] + h / 2], -1)


def _iou(a, b):
    """(R, 4) xyxy vs (C, 4) xyxy → (R, C); negative widths count as 0."""
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    aa = (a[:, 2] - a[:, 0]).clamp(min=0) * (a[:, 3] - a[:, 1]).clamp(min=0)
    ab = (b[:, 2] - b[:, 0]).clamp(min=0) * (b[:, 3] - b[:, 1]).clamp(min=0)
    union = aa[:, None] + ab[None, :] - inter + 1e-7
    return inter / union


def _greedy_assign(cost, thresh: float, rounds: int):
    """Masked greedy min-cost assignment: `rounds` times, take the globally
    lowest cost if it is <= thresh and strike its row and column. Returns
    col_match (C,) int32: the row matched to each column, -1 when unmatched.
    Invalid pairs must carry BIG."""
    R, C = cost.shape
    rows = torch.arange(R, device=cost.device)
    cols = torch.arange(C, device=cost.device)
    col_match = torch.full((C,), -1, dtype=torch.int32, device=cost.device)
    for _ in range(rounds):
        go = cost.min() <= thresh  # (indexing by a tensor scalar would wait for the device)
        flat = torch.argmin(cost)
        r, c = flat // C, flat % C
        col_match = torch.where(go & (cols == c), r.to(torch.int32), col_match)
        cost = torch.where(go & ((rows == r)[:, None] | (cols == c)[None, :]), BIG, cost)
    return col_match


def _diag(std):
    """(N, k) standard deviations → (N, k, k) diagonal covariances."""
    return torch.diag_embed(std**2)


def _motion_cov(mean):
    h = mean[:, 3]
    c = lambda v: torch.full_like(h, v)  # noqa: E731
    return _diag(torch.stack([_WP * h, _WP * h, c(1e-2), _WP * h, _WV * h, _WV * h, c(1e-5), _WV * h], -1))


def _innovation_cov(mean):
    h = mean[:, 3]
    return _diag(torch.stack([_WP * h, _WP * h, torch.full_like(h, 1e-1), _WP * h], -1))


def _init_cov(meas):
    h = meas[:, 3]
    c = lambda v: torch.full_like(h, v)  # noqa: E731
    return _diag(torch.stack([2 * _WP * h, 2 * _WP * h, c(1e-2), 2 * _WP * h,
                              10 * _WV * h, 10 * _WV * h, c(1e-5), 10 * _WV * h], -1))


def make_byte_step(
    n_max: int = 128,
    d_max: int = 32,
    track_high_thresh: float = 0.25,
    track_low_thresh: float = 0.1,
    new_track_thresh: float = 0.25,
    match_thresh: float = 0.8,
    fuse_score: bool = True,
    max_time_lost: int = 30,
    device=None,
):
    """Build the ByteTrack step for fixed capacities on `device`.

    step(state, xywh (D, 4), scores (D,), cls (D,), mask (D,), rounds=(r1, r2, r3))
    → (state, out), out = {xyxy (N, 4), track_id, score, cls, det_idx, emit} per
    slot. `rounds` bounds the greedy rounds of the three stages (default
    d_max each); a stage with fewer real columns than its bound gives the same
    result. The state dict passed in is not modified."""
    dev = resolve_device(device)
    F = torch.eye(8, dtype=torch.float32, device=dev)
    F[:4, 4:] = torch.eye(4, device=dev)
    ar_n = torch.arange(n_max, device=dev)
    det_gidx = torch.arange(d_max, dtype=torch.int32, device=dev)
    i32 = torch.int32

    def kf_update(s, matched, z):
        """Batched XYAH measurement update of the `matched` slots; z (N, 4) xyah."""
        S = s["cov"][:, :4, :4] + _innovation_cov(s["mean"])
        K = s["cov"][:, :, :4] @ _inv4(S)  # (N, 8, 4)
        y = z - s["mean"][:, :4]
        mean_u = s["mean"] + torch.einsum("nij,nj->ni", K, y)
        cov_u = s["cov"] - K @ S @ K.transpose(1, 2)
        s["mean"] = torch.where(matched[:, None], mean_u, s["mean"])
        s["cov"] = torch.where(matched[:, None, None], cov_u, s["cov"])

    def apply_match(s, col_match, scores, cls, stage_cols):
        """Commit one stage's matches to the lifecycle fields → (matched slots, the
        detection of each). The Kalman update waits for the last stage: a slot is
        matched in one stage at most, and no stage reads the means."""
        live = stage_cols & (col_match >= 0)
        slot_m = (col_match[None, :] == ar_n[:, None]) & live[None, :]  # (N, D)
        matched = slot_m.any(1)
        src = slot_m.to(i32).argmax(1)
        was_lost = s["state"] == 2
        # update(): tracklet_len += 1; re_activate(): tracklet_len = 0
        s["tracklet_len"] = torch.where(matched, torch.where(was_lost, 0, s["tracklet_len"] + 1), s["tracklet_len"])
        s["state"] = torch.where(matched, 1, s["state"])
        s["is_activated"] = s["is_activated"] | matched
        s["score"] = torch.where(matched, scores[src], s["score"])
        s["cls"] = torch.where(matched, cls[src], s["cls"])
        s["det_idx"] = torch.where(matched, det_gidx[src], s["det_idx"])
        s["last_frame"] = torch.where(matched, s["frame"], s["last_frame"])
        return matched, src

    def step(state, xywh, scores, cls, mask, rounds=(d_max, d_max, d_max)):
        s = dict(state)
        s["frame"] = s["frame"] + 1

        high = mask & (scores >= track_high_thresh)
        second = mask & (scores > track_low_thresh) & ~high
        pool = ((s["state"] == 1) & s["is_activated"]) | (s["state"] == 2)
        unconf = (s["state"] == 1) & ~s["is_activated"]

        # multi_predict over the pool; the height velocity of lost tracks is zeroed first
        mean_in = s["mean"].clone()
        mean_in[:, 7] = torch.where(s["state"] == 2, 0.0, s["mean"][:, 7])
        mean_p = mean_in @ F.T
        cov_p = F @ s["cov"] @ F.T + _motion_cov(mean_in)
        s["mean"] = torch.where(pool[:, None], mean_p, s["mean"])
        s["cov"] = torch.where(pool[:, None, None], cov_p, s["cov"])

        det_xyah = _xywh_to_xyah(xywh)
        det_xyxy = torch.stack([xywh[:, 0] - xywh[:, 2] / 2, xywh[:, 1] - xywh[:, 3] / 2,
                                xywh[:, 0] + xywh[:, 2] / 2, xywh[:, 1] + xywh[:, 3] / 2], -1)
        iou = _iou(_mean_to_xyxy(s["mean"]), det_xyxy)  # (N, D)
        sim = iou * scores[None, :] if fuse_score else iou

        # stage 1: high dets vs tracked (activated) + lost
        cm1 = _greedy_assign(torch.where(pool[:, None] & high[None, :], 1.0 - sim, BIG), match_thresh, rounds[0])
        matched1, src1 = apply_match(s, cm1, scores, cls, high)

        # stage 2: low dets rescue the pool tracks still tracked and unmatched (stage 1
        # already turned its matched lost slots to tracked, hence matched1)
        r_tracked = pool & (s["state"] == 1) & ~matched1
        cm2 = _greedy_assign(torch.where(r_tracked[:, None] & second[None, :], 1.0 - iou, BIG), 0.5, rounds[1])
        matched2, src2 = apply_match(s, cm2, scores, cls, second)
        s["state"] = torch.where(r_tracked & ~matched2, 2, s["state"])  # mark_lost

        # stage 3: unconfirmed tracks vs the remaining high dets; the unmatched are removed
        det_unmatched1 = high & (cm1 < 0)
        cost3 = torch.where(unconf[:, None] & det_unmatched1[None, :], 1.0 - sim, BIG)
        cm3 = _greedy_assign(cost3, 0.7, rounds[2])
        matched3, src3 = apply_match(s, cm3, scores, cls, det_unmatched1)
        s["state"] = torch.where(unconf & ~matched3, 0, s["state"])
        matched = matched1 | matched2 | matched3
        src = torch.where(matched1, src1, torch.where(matched2, src2, src3))
        kf_update(s, matched, torch.where(matched[:, None], det_xyah[src], 0.0))

        # new tracks from the remaining high dets, into free slots in slot order
        new_det = det_unmatched1 & (cm3 < 0) & (scores >= new_track_thresh)
        det_rank = torch.cumsum(new_det, 0) - 1
        free_sorted = torch.sort(torch.where(s["state"] == 0, ar_n, n_max + 1)).values
        slot_of_det = torch.where(new_det, free_sorted[det_rank.clamp(0, n_max - 1)], n_max + 1)
        can_place = new_det & (slot_of_det < n_max)
        place_m = (slot_of_det[None, :] == ar_n[:, None]) & can_place[None, :]
        placed = place_m.any(1)
        src = place_m.to(i32).argmax(1)
        mean_new = torch.cat([det_xyah, torch.zeros((d_max, 4), dtype=torch.float32, device=dev)], -1)
        ids_new = (s["next_id"] + torch.cumsum(can_place, 0) - 1).to(i32)
        s["mean"] = torch.where(placed[:, None], mean_new[src], s["mean"])
        s["cov"] = torch.where(placed[:, None, None], _init_cov(det_xyah)[src], s["cov"])
        s["state"] = torch.where(placed, 1, s["state"])
        s["is_activated"] = torch.where(placed, s["frame"] == 1, s["is_activated"])
        s["track_id"] = torch.where(placed, ids_new[src], s["track_id"])
        s["score"] = torch.where(placed, scores[src], s["score"])
        s["cls"] = torch.where(placed, cls[src], s["cls"])
        s["det_idx"] = torch.where(placed, det_gidx[src], s["det_idx"])
        s["tracklet_len"] = torch.where(placed, 0, s["tracklet_len"])
        s["last_frame"] = torch.where(placed, s["frame"], s["last_frame"])
        s["start_frame"] = torch.where(placed, s["frame"], s["start_frame"])
        s["next_id"] = (s["next_id"] + can_place.sum()).to(i32)

        # expire stale lost tracks
        s["state"] = torch.where((s["state"] == 2) & (s["frame"] - s["last_frame"] > max_time_lost), 0, s["state"])

        # remove_duplicate_stracks(tracked, lost): of a pair at IoU > 0.85 the shorter-lived goes
        tr, lo = s["state"] == 1, s["state"] == 2
        boxes_now = _mean_to_xyxy(s["mean"])
        pair = (_iou(boxes_now, boxes_now) > 0.85) & tr[:, None] & lo[None, :]
        life = s["last_frame"] - s["start_frame"]
        drop_tracked = (pair & (life[:, None] <= life[None, :])).any(1)
        drop_lost = (pair & (life[:, None] > life[None, :])).any(0)
        s["state"] = torch.where(drop_tracked | drop_lost, 0, s["state"])

        out = {
            "xyxy": _mean_to_xyxy(s["mean"]),
            "track_id": s["track_id"],
            "score": s["score"],
            "cls": s["cls"],
            "det_idx": s["det_idx"],
            "emit": (s["state"] == 1) & s["is_activated"],
        }
        return s, out

    return step


class BatchedBYTETracker:
    """The `update()` contract of BYTETracker (rows of [x1, y1, x2, y2, id,
    score, cls, det_idx], in id order) over the slot-table step on `device`
    (None: the card); `scan_frames` runs a whole chunk of detections on the
    device and waits once, when the stacked outputs are copied back."""

    def __init__(self, args=None, frame_rate: int = 30, n_max: int = 128, d_max: int = 32, device=None):
        args = args or DEFAULT_ARGS
        self.n_max, self.d_max = n_max, d_max
        self.device = resolve_device(device)
        self._step = make_byte_step(
            n_max, d_max,
            track_high_thresh=float(args.track_high_thresh),
            track_low_thresh=float(args.track_low_thresh),
            new_track_thresh=float(args.new_track_thresh),
            match_thresh=float(args.match_thresh),
            fuse_score=bool(args.fuse_score),
            max_time_lost=int(frame_rate / 30.0 * args.track_buffer),
            device=self.device,
        )
        self._high, self._low = float(args.track_high_thresh), float(args.track_low_thresh)
        self._warned_dmax = False
        self._graph = None
        self.state = init_state(n_max, self.device)

    def _pack(self, boxes_xywh, scores, cls):
        D = self.d_max
        n = min(len(scores), D)
        if len(scores) > D and not self._warned_dmax:
            self._warned_dmax = True
            warnings.warn(
                f"BatchedBYTETracker: frame has {len(scores)} detections but d_max={D}; extra detections are "
                f"dropped. Construct with a larger d_max (or set YOLO_TPU_DEVICE_TRACKER_DMAX) to track crowded scenes.",
                stacklevel=3,
            )
        xywh = np.zeros((D, 4), np.float32)
        sc = np.zeros((D,), np.float32)
        cl = np.zeros((D,), np.float32)
        mask = np.zeros((D,), bool)
        if n:
            xywh[:n] = np.asarray(boxes_xywh, np.float32).reshape(len(scores), -1)[:n, :4]
            sc[:n] = np.asarray(scores, np.float32)[:n]
            cl[:n] = np.asarray(cls, np.float32)[:n]
            mask[:n] = True
        return xywh, sc, cl, mask

    def update(self, boxes_xywh, scores, cls, img=None, feats=None) -> np.ndarray:
        xywh, sc, cl, mask = self._pack(boxes_xywh, scores, cls)
        # a stage matches at most as many columns as it has real detections
        high = mask & (sc >= self._high)
        n_high, n_second = int(high.sum()), int((mask & (sc > self._low) & ~high).sum())
        dev = self.device
        with torch.no_grad():
            self.state, out = self._step(
                self.state, *(torch.from_numpy(a).to(dev) for a in (xywh, sc, cl, mask)), rounds=(n_high, n_second, n_high)
            )
            rows = torch.cat([out["xyxy"], torch.stack([out[k].float() for k in ("track_id", "score", "cls", "det_idx", "emit")], 1)], 1)
        rows = rows.cpu().numpy()  # the frame's one wait for the device
        keep = np.flatnonzero(rows[:, 8])
        keep = keep[np.argsort(rows[keep, 4], kind="stable")]
        return rows[keep, :8].astype(np.float32)

    def scan_frames(self, xywh_seq, scores_seq, cls_seq, mask_seq) -> dict:
        """Run T frames: (T, D, 4), (T, D), (T, D), (T, D) numpy arrays or tensors → the
        per-slot outputs stacked over T, as numpy. On the card the step is replayed
        from a CUDA graph (one launch a frame instead of ~1,300)."""
        dev = self.device
        seqs = [torch.as_tensor(x, dtype=t, device=dev) for x, t in
                zip((xywh_seq, scores_seq, cls_seq, mask_seq), (torch.float32,) * 3 + (torch.bool,))]
        outs = []
        with torch.no_grad():
            if dev.type == "cuda":
                graph, ins, state, out = self._graphed_step()
                for k, v in self.state.items():
                    state[k].copy_(v)
                for t in range(seqs[0].shape[0]):
                    for buf, x in zip(ins, seqs):
                        buf.copy_(x[t])
                    graph.replay()
                    outs.append({k: v.clone() for k, v in out.items()})
                self.state = {k: v.clone() for k, v in state.items()}
            else:
                for t in range(seqs[0].shape[0]):
                    self.state, out = self._step(self.state, *(x[t] for x in seqs))
                    outs.append(out)
        return {k: torch.stack([o[k] for o in outs]).cpu().numpy() for k in outs[0]}

    def _graphed_step(self):
        """The step captured once in a CUDA graph over static buffers → (graph, the
        four input buffers, the state it updates in place, its outputs)."""
        if self._graph is None:
            D, dev = self.d_max, self.device
            ins = [torch.zeros((D, 4), device=dev), torch.zeros(D, device=dev), torch.zeros(D, device=dev),
                   torch.zeros(D, dtype=torch.bool, device=dev)]
            state = init_state(self.n_max, dev)
            side = torch.cuda.Stream(dev)  # warm-up off the capture, as torch.cuda.graph asks
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                self._step(state, *ins)
            torch.cuda.current_stream(dev).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                new, out = self._step(state, *ins)
                for k, v in new.items():
                    state[k].copy_(v)
            self._graph = (graph, ins, state, out)
        return self._graph

    def reset(self):
        self.state = init_state(self.n_max, self.device)
