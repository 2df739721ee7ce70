"""Batched fixed-capacity Kalman multi-target tracker (counterpart of yolo_tpu/kalman/batched.py).

The track table is a dict of (N_max, …) tensors on the device; one step
predicts every slot, associates detections greedily by IoU, updates the
matched slots, opens new slots in detection order, prunes, and emits.

The step never synchronises with the host, so a whole chunk of frames is
enqueued without a wait:
- the JAX package's early-exit association `while_loop` is a fixed d_max-round
  loop here whose rounds below the IoU threshold are masked no-ops (the
  greedy picks, and so the results, are the same);
- its `lax.cond` around the motion analysis is compute-then-select.
`torch.argmax` returns the first maximal index, as `jnp.argmax` does, so ties
resolve alike. These are plain tensor ops: the step is a few hundred small
launches per frame (launch-bound on the card), not a kernel of its own.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from yolo_tpu_torch.device import resolve_device
from yolo_tpu_torch.kalman.tracker import R_MEAS, _make_F, _make_P0, _make_Q

VEL_HIST = 50  # velocity-history ring capacity per slot

STATUS_NONE = 0
STATUS_DETECTED = 1
STATUS_PREDICTED = 2


def init_state(n_max: int = 64, device=None) -> dict:
    """Fresh empty track table."""
    dev = resolve_device(device)
    f32, i32 = torch.float32, torch.int32

    def z(*shape, dtype=i32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return {
        "x": z(n_max, 8, dtype=f32),
        "P": z(n_max, 8, 8, dtype=f32),
        "active": z(n_max, dtype=torch.bool),
        "is_lost": z(n_max, dtype=torch.bool),
        "age": z(n_max),
        "hits": z(n_max),
        "hit_streak": z(n_max),
        "time_since_update": z(n_max),
        "lost_frames": z(n_max),
        "track_num": z(n_max),
        "vel_hist": z(n_max, VEL_HIST, 2, dtype=f32),
        "vel_count": z(n_max),  # total updates (ring write pointer = count % VEL_HIST)
        "next_id": torch.ones((), dtype=i32, device=dev),
        "frame_count": z(),
    }


def _bbox_to_z(b):
    """(…, 4) xyxy → (…, 4) cxcywh."""
    return torch.stack([(b[..., 0] + b[..., 2]) / 2, (b[..., 1] + b[..., 3]) / 2, b[..., 2] - b[..., 0], b[..., 3] - b[..., 1]], -1)


def _state_to_bbox(x):
    cx, cy, w, h = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def _iou_matrix(det_boxes, trk_boxes):
    """(D, N) IoU between xyxy sets (a degenerate union gives 0)."""
    lt = torch.maximum(det_boxes[:, None, :2], trk_boxes[None, :, :2])
    rb = torch.minimum(det_boxes[:, None, 2:], trk_boxes[None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    a1 = (det_boxes[:, 2] - det_boxes[:, 0]) * (det_boxes[:, 3] - det_boxes[:, 1])
    a2 = (trk_boxes[:, 2] - trk_boxes[:, 0]) * (trk_boxes[:, 3] - trk_boxes[:, 1])
    union = a1[:, None] + a2[None, :] - inter
    return torch.where(union > 0, inter / union, 0.0)


def _motion_analysis(vel_hist, vel_count):
    """Per slot: (prediction confidence, mean velocity (2,), stability) from the
    velocity ring in chronological order; fewer than 5 velocities give confidence 0."""
    dev = vel_hist.device
    n = vel_count.clamp(max=VEL_HIST)
    idx = torch.arange(VEL_HIST, device=dev)
    valid = idx[None, :] < n[:, None]
    start = torch.where(vel_count >= VEL_HIST, vel_count % VEL_HIST, 0)
    order = ((start[:, None] + idx[None, :]) % VEL_HIST).long()
    hist = torch.gather(vel_hist, 1, order[..., None].expand(-1, -1, 2))  # chronological

    mask = valid[..., None].float()
    denom = n.clamp(min=1).float()[:, None]
    mean_v = (hist * mask).sum(1) / denom
    var_v = ((hist - mean_v[:, None]) ** 2 * mask).sum(1) / denom
    std_v = torch.sqrt(var_v)
    speed_stability = 1.0 / (1.0 + std_v.mean(-1))

    headings = torch.atan2(hist[..., 1], hist[..., 0])
    dh = headings[:, 1:] - headings[:, :-1]
    dh = torch.where(dh.abs() < math.pi, dh, dh - 2 * math.pi * torch.sign(dh))
    pair_valid = (idx[None, 1:] < n[:, None]).float()
    m = pair_valid.sum(1).clamp(min=1.0)
    dh_mean = (dh * pair_valid).sum(1) / m
    dh_std = torch.sqrt((((dh - dh_mean[:, None]) ** 2 * pair_valid).sum(1) / m).clamp(min=0))
    dir_consistency = torch.where(n >= 3, 1.0 / (1.0 + dh_std * 10.0), 0.0)

    stability = (speed_stability + dir_consistency) / 2.0
    data_conf = (n.float() / 30.0).clamp(max=1.0)
    confidence = torch.where(n >= 5, stability * data_conf, 0.0)
    return confidence, mean_v, stability


def _inv4(a):
    """Closed-form adjugate inverse of batched 4×4 matrices (the JAX package's formula)."""

    def det3(rows, cols):
        (r0, r1, r2), (c0, c1, c2) = rows, cols
        return (
            a[..., r0, c0] * (a[..., r1, c1] * a[..., r2, c2] - a[..., r1, c2] * a[..., r2, c1])
            - a[..., r0, c1] * (a[..., r1, c0] * a[..., r2, c2] - a[..., r1, c2] * a[..., r2, c0])
            + a[..., r0, c2] * (a[..., r1, c0] * a[..., r2, c1] - a[..., r1, c1] * a[..., r2, c0])
        )

    idx = (0, 1, 2, 3)
    cof = [
        torch.stack([((-1) ** (i + j)) * det3([r for r in idx if r != i], [c for c in idx if c != j]) for j in idx], -1)
        for i in idx
    ]
    adj = torch.stack(cof, -1)  # adjugate = cofactor matrix transposed
    det = sum(a[..., 0, j] * cof[0][..., j] for j in idx)
    return adj / det[..., None, None]


def make_step(n_max: int = 64, d_max: int = 16, max_lost_frames: int = 150, min_hits: int = 1,
              iou_threshold: float = 0.1, device=None):
    """Build the tracking step for fixed capacities on `device`.

    step(state, det_boxes (D, 4) xyxy f32, det_mask (D,) bool) → (state, out),
    out = {bbox (N, 4), status, confidence, track_num, emit, velocity (N, 2),
    time_since_update}. The state dict passed in is not modified."""
    dev = resolve_device(device)
    F = torch.as_tensor(_make_F(), dtype=torch.float32, device=dev)
    Q = torch.as_tensor(_make_Q(), dtype=torch.float32, device=dev)
    R = torch.as_tensor(R_MEAS, dtype=torch.float32, device=dev)
    P0 = torch.as_tensor(_make_P0(), dtype=torch.float32, device=dev)
    ar_d = torch.arange(d_max, device=dev)
    ar_n = torch.arange(n_max, device=dev)
    ar_v = torch.arange(VEL_HIST, device=dev)
    i32 = torch.int32

    def step(state, det_boxes, det_mask):
        s = dict(state)
        s["frame_count"] = s["frame_count"] + 1

        # ---- 1: predict all active tracks
        act = s["active"]
        x_pred = s["x"] @ F.T
        P_pred = F @ s["P"] @ F.T + Q
        s["x"] = torch.where(act[:, None], x_pred, s["x"])
        s["P"] = torch.where(act[:, None, None], P_pred, s["P"])
        s["age"] = s["age"] + act
        s["time_since_update"] = s["time_since_update"] + act
        trk_boxes = _state_to_bbox(s["x"])

        # ---- 2: greedy IoU association, d_max rounds; a round whose best IoU
        # is below the threshold (and every round after it) changes nothing
        iou = _iou_matrix(det_boxes, trk_boxes)
        iou = torch.where(det_mask[:, None] & act[None, :], iou, -1.0)
        det_match = torch.full((d_max,), -1, dtype=i32, device=dev)
        for _ in range(d_max):
            go = iou.max() >= iou_threshold
            flat = torch.argmax(iou)
            d, t = flat // n_max, flat % n_max
            det_match = torch.where(go & (ar_d == d), t.to(i32), det_match)
            iou = torch.where(go & ((ar_d == d)[:, None] | (ar_n == t)[None, :]), -1.0, iou)
        match_m = det_match[None, :] == ar_n[:, None]  # (N, D); -1 never matches
        trk_matched = match_m.any(1)
        claim = match_m.to(i32).argmax(1)  # det index claiming each slot

        # ---- 3: measurement update of the matched tracks (H = [I4 | 0])
        z_all = _bbox_to_z(det_boxes)
        z_per_trk = torch.where(trk_matched[:, None], z_all[claim], 0.0)
        S = s["P"][:, :4, :4] + R
        K = s["P"][:, :, :4] @ _inv4(S)
        y = z_per_trk - s["x"][:, :4]
        x_upd = s["x"] + torch.einsum("nij,nj->ni", K, y)
        P_upd = s["P"] - K @ s["P"][:, :4, :]
        s["x"] = torch.where(trk_matched[:, None], x_upd, s["x"])
        s["P"] = torch.where(trk_matched[:, None, None], P_upd, s["P"])
        s["hits"] = s["hits"] + trk_matched
        s["hit_streak"] = torch.where(trk_matched, s["hit_streak"] + 1, s["hit_streak"])
        s["time_since_update"] = torch.where(trk_matched, 0, s["time_since_update"])
        wptr = s["vel_count"] % VEL_HIST
        ring_mask = (ar_v[None, :] == wptr[:, None]) & trk_matched[:, None]
        s["vel_hist"] = torch.where(ring_mask[..., None], s["x"][:, None, 4:6], s["vel_hist"])
        s["vel_count"] = s["vel_count"] + trk_matched
        s["is_lost"] = s["is_lost"] & ~trk_matched
        s["lost_frames"] = torch.where(trk_matched, 0, s["lost_frames"])

        # ---- 4: unmatched active tracks go or stay lost
        unmatched_trk = act & ~trk_matched
        s["lost_frames"] = torch.where(
            unmatched_trk, torch.where(s["is_lost"], s["lost_frames"] + 1, 1), s["lost_frames"]
        )
        s["is_lost"] = s["is_lost"] | unmatched_trk
        s["hit_streak"] = torch.where(unmatched_trk, 0, s["hit_streak"])
        # a track emitted on its first lost frame takes one extra predict (the
        # reference tracker's getter side effect, kept for parity)
        first_lost = s["is_lost"] & (s["lost_frames"] == 1)
        x_extra = s["x"] @ F.T
        P_extra = F @ s["P"] @ F.T + Q
        s["x"] = torch.where(first_lost[:, None], x_extra, s["x"])
        s["P"] = torch.where(first_lost[:, None, None], P_extra, s["P"])
        s["age"] = s["age"] + first_lost
        s["time_since_update"] = s["time_since_update"] + first_lost

        # ---- 5: new tracks for unmatched detections, in detection order
        unmatched_det = det_mask & (det_match < 0)
        det_rank = torch.cumsum(unmatched_det, 0) - 1
        free_idx = torch.where(~s["active"], ar_n, n_max + 1)
        free_sorted = torch.sort(free_idx).values
        slot_of_det = torch.where(unmatched_det, free_sorted[det_rank.clamp(0, n_max - 1)], n_max + 1)
        can_place = unmatched_det & (slot_of_det < n_max)
        place_m = (slot_of_det[None, :] == ar_n[:, None]) & can_place[None, :]  # (N, D)
        placed = place_m.any(1)
        src = place_m.to(i32).argmax(1)
        x_new = torch.cat([z_all, torch.zeros((d_max, 4), dtype=torch.float32, device=dev)], -1)
        place_num = (s["next_id"] + torch.cumsum(can_place, 0) - 1).to(i32)
        s["x"] = torch.where(placed[:, None], x_new[src], s["x"])
        s["P"] = torch.where(placed[:, None, None], P0[None], s["P"])
        s["active"] = s["active"] | placed
        s["is_lost"] = s["is_lost"] & ~placed
        s["age"] = torch.where(placed, 0, s["age"])
        s["hits"] = torch.where(placed, 1, s["hits"])
        s["hit_streak"] = torch.where(placed, 1, s["hit_streak"])
        s["time_since_update"] = torch.where(placed, 0, s["time_since_update"])
        s["lost_frames"] = torch.where(placed, 0, s["lost_frames"])
        s["track_num"] = torch.where(placed, place_num[src], s["track_num"])
        s["vel_hist"] = torch.where(placed[:, None, None], 0.0, s["vel_hist"])
        s["vel_count"] = torch.where(placed, 0, s["vel_count"])
        s["next_id"] = (s["next_id"] + can_place.sum()).to(i32)

        # ---- 6: prune
        tsu = s["time_since_update"]
        dead = tsu > max_lost_frames
        dead = dead | ((s["age"] < 5) & (s["hit_streak"] == 0) & (tsu > 15))
        dead = dead | ((s["age"] < 10) & (s["hit_streak"] <= 1) & (tsu > 30))
        s["active"] = s["active"] & ~(dead & s["active"])

        # ---- 7: emit confirmed tracks
        confirmed = s["active"] & ((s["hit_streak"] >= min_hits) | (s["frame_count"] <= min_hits) | s["is_lost"])
        is_pred = tsu > 0
        # the motion analysis feeds only the extrapolation of tracks lost for
        # more than one frame; computed always, used only when one exists
        need_ma = torch.any(s["active"] & s["is_lost"] & (s["lost_frames"] > 1))
        conf_ma, avg_ma, _ = _motion_analysis(s["vel_hist"], s["vel_count"])
        conf_m = torch.where(need_ma, conf_ma, 0.0)
        avg_v = torch.where(need_ma, avg_ma, 0.0)

        fa = s["lost_frames"].float()
        high_conf = conf_m > 0.3
        x = s["x"]
        x_hi = torch.cat([x[:, :2] + avg_v * fa[:, None], x[:, 2:]], -1)
        x_lo = torch.cat([x[:, :4] + x[:, 4:8] * fa[:, None], x[:, 4:]], -1)
        time_decay = (1.0 - fa / max_lost_frames).clamp(min=0.1)
        conf_hi = conf_m * time_decay
        conf_lo = (1.0 - fa / (max_lost_frames * 0.5)).clamp(min=0.1)
        lost_long = s["is_lost"] & (fa > 1)
        x_out = torch.where((lost_long & high_conf)[:, None], x_hi, torch.where(lost_long[:, None], x_lo, x))
        conf_lost = torch.where(fa > 1, torch.where(high_conf, conf_hi, conf_lo), 1.0)
        conf_short = (1.0 - tsu.float() / 60.0).clamp(min=0.3)
        confidence = torch.where(is_pred, torch.where(s["is_lost"], conf_lost, conf_short), 1.0)

        out = {
            "bbox": _state_to_bbox(x_out),
            "status": torch.where(confirmed, torch.where(is_pred, STATUS_PREDICTED, STATUS_DETECTED), STATUS_NONE),
            "confidence": torch.where(confirmed, confidence, 0.0),
            "track_num": s["track_num"],
            "emit": confirmed,
            "velocity": x[:, 4:6],
            "time_since_update": tsu,
        }
        return s, out

    return step


class BatchedMultiTargetTracker:
    """Host-friendly wrapper: the `update()` contract of EnhancedMultiTargetTracker
    over the batched step; `scan_frames` runs a whole chunk of frames on the
    device and waits once, when the stacked outputs are copied back."""

    def __init__(self, max_lost_frames: int = 150, min_hits: int = 1, iou_threshold: float = 0.1, n_max: int = 64, d_max: int = 16, device=None):
        self.n_max, self.d_max = n_max, d_max
        self.device = resolve_device(device)
        self._step = make_step(n_max, d_max, max_lost_frames, min_hits, iou_threshold, device=self.device)
        self.state = init_state(n_max, self.device)

    def update(self, detections) -> list[dict]:
        """detections: list of [x1, y1, x2, y2, conf] → list of track-info dicts, in id order."""
        D = self.d_max
        boxes = np.zeros((D, 4), np.float32)
        mask = np.zeros((D,), bool)
        for i, det in enumerate(detections[:D]):
            boxes[i] = det[:4]
            mask[i] = True
        with torch.no_grad():
            self.state, out = self._step(
                self.state, torch.from_numpy(boxes).to(self.device), torch.from_numpy(mask).to(self.device)
            )
        out = {k: v.cpu().numpy() for k, v in out.items()}
        tracks = []
        for i in np.argsort(out["track_num"], kind="stable"):
            if not out["emit"][i]:
                continue
            tracks.append(
                {
                    "track_id": f"T{int(out['track_num'][i]):03d}",
                    "bbox": out["bbox"][i],
                    "confidence": float(out["confidence"][i]),
                    "status": "predicted" if out["status"][i] == STATUS_PREDICTED else "detected",
                    "time_since_update": int(out["time_since_update"][i]),
                    "velocity": out["velocity"][i],
                }
            )
        return tracks

    def scan_frames(self, det_boxes_seq, det_mask_seq) -> dict:
        """Run T frames on the device: (T, D, 4), (T, D) → the step outputs stacked over T, as numpy."""
        boxes = torch.as_tensor(np.asarray(det_boxes_seq), dtype=torch.float32).to(self.device)
        mask = torch.as_tensor(np.asarray(det_mask_seq), dtype=torch.bool).to(self.device)
        state, outs = self.state, []
        with torch.no_grad():
            for t in range(boxes.shape[0]):
                state, out = self._step(state, boxes[t], mask[t])
                outs.append(out)
        self.state = state
        return {k: torch.stack([o[k] for o in outs]).cpu().numpy() for k in outs[0]}
