"""ByteTrack: two-stage (high / low confidence) association MOT (counterpart of
yolo_tpu/trackers/byte_tracker.py), host numpy.

High-score detections match tracked and lost tracks first; low-score
detections rescue the tracked tracks left over; unconfirmed tracks get one
more chance at the remaining high-score detections; what is still left above
`new_track_thresh` starts new tracks; lost tracks expire after
`track_buffer` frames. Axis-aligned boxes only (OBB tracks are not ported).
"""

from __future__ import annotations

import numpy as np

from yolo_tpu_torch.trackers import matching
from yolo_tpu_torch.trackers.basetrack import BaseTrack, TrackState
from yolo_tpu_torch.trackers.kalman_filter import KalmanFilterXYAH


class STrack(BaseTrack):
    """Single tracklet backed by the shared XYAH Kalman filter."""

    shared_kalman = KalmanFilterXYAH()

    def __init__(self, xywh, score, cls):
        super().__init__()
        # xywh: (cx, cy, w, h) [+ the detection's index]
        self._tlwh = np.asarray(
            [xywh[0] - xywh[2] / 2, xywh[1] - xywh[3] / 2, xywh[2], xywh[3]], dtype=np.float32
        )
        self.kalman_filter = None
        self.mean, self.covariance = None, None
        self.is_activated = False
        self.score = score
        self.tracklet_len = 0
        self.cls = cls
        self.idx = xywh[-1] if len(xywh) > 4 else -1

    def predict(self):
        mean_state = self.mean.copy()
        if self.state != TrackState.Tracked:
            mean_state[7] = 0
        self.mean, self.covariance = self.kalman_filter.predict(mean_state, self.covariance)

    @staticmethod
    def multi_predict(stracks: list):
        if len(stracks) == 0:
            return
        multi_mean = np.asarray([st.mean.copy() for st in stracks])
        multi_cov = np.asarray([st.covariance for st in stracks])
        for i, st in enumerate(stracks):
            if st.state != TrackState.Tracked:
                multi_mean[i][7] = 0
        multi_mean, multi_cov = STrack.shared_kalman.multi_predict(multi_mean, multi_cov)
        for i, (mean, cov) in enumerate(zip(multi_mean, multi_cov)):
            stracks[i].mean = mean
            stracks[i].covariance = cov

    @staticmethod
    def multi_gmc(stracks: list, H: np.ndarray):
        """Warp the track states by a 2x3 camera-motion matrix."""
        if len(stracks) == 0:
            return
        R = H[:2, :2]
        R8x8 = np.kron(np.eye(4, dtype=float), R)
        t = H[:2, 2]
        for st in stracks:
            mean = R8x8 @ st.mean
            mean[:2] += t
            st.mean = mean
            st.covariance = R8x8 @ st.covariance @ R8x8.T

    def activate(self, kalman_filter, frame_id: int):
        self.kalman_filter = kalman_filter
        self.track_id = self.next_id()
        self.mean, self.covariance = self.kalman_filter.initiate(self.convert_coords(self._tlwh))
        self.tracklet_len = 0
        self.state = TrackState.Tracked
        if frame_id == 1:
            self.is_activated = True
        self.frame_id = frame_id
        self.start_frame = frame_id

    def re_activate(self, new_track, frame_id: int, new_id: bool = False):
        self.mean, self.covariance = self.kalman_filter.update(
            self.mean, self.covariance, self.convert_coords(new_track.tlwh)
        )
        self.tracklet_len = 0
        self.state = TrackState.Tracked
        self.is_activated = True
        self.frame_id = frame_id
        if new_id:
            self.track_id = self.next_id()
        self.score = new_track.score
        self.cls = new_track.cls
        self.idx = new_track.idx

    def update(self, new_track, frame_id: int):
        self.frame_id = frame_id
        self.tracklet_len += 1
        self.mean, self.covariance = self.kalman_filter.update(
            self.mean, self.covariance, self.convert_coords(new_track.tlwh)
        )
        self.state = TrackState.Tracked
        self.is_activated = True
        self.score = new_track.score
        self.cls = new_track.cls
        self.idx = new_track.idx

    def convert_coords(self, tlwh):
        return self.tlwh_to_xyah(tlwh)

    @property
    def tlwh(self):
        if self.mean is None:
            return self._tlwh.copy()
        ret = self.mean[:4].copy()
        ret[2] *= ret[3]  # a·h → w
        ret[:2] -= ret[2:] / 2
        return ret

    @property
    def xyxy(self):
        ret = self.tlwh.copy()
        ret[2:] += ret[:2]
        return ret

    @property
    def xywh(self):
        ret = self.tlwh.copy()
        ret[:2] += ret[2:] / 2
        return ret

    @property
    def result(self):
        """[x1, y1, x2, y2, track_id, score, cls, det_idx]."""
        return [*self.xyxy, self.track_id, self.score, self.cls, self.idx]

    @staticmethod
    def tlwh_to_xyah(tlwh):
        ret = np.asarray(tlwh, dtype=np.float32).copy()
        ret[:2] += ret[2:] / 2
        ret[2] /= ret[3]
        return ret

    def __repr__(self):
        return f"OT_{self.track_id}_({self.start_frame}-{self.end_frame})"


class BYTETracker:
    """Frame-by-frame MOT manager."""

    def __init__(self, args, frame_rate: int = 30):
        self.tracked_stracks: list[STrack] = []
        self.lost_stracks: list[STrack] = []
        self.removed_stracks: list[STrack] = []
        self.frame_id = 0
        self.args = args
        self.max_time_lost = int(frame_rate / 30.0 * args.track_buffer)
        self.kalman_filter = self.get_kalmanfilter()
        self.reset_id()

    def update(self, boxes_xywh, scores, cls, img=None, feats=None) -> np.ndarray:
        """One tracking step over this frame's detections: boxes_xywh (N, 4)
        centre format, scores (N,), cls (N,) → (M, 8) rows [x1, y1, x2, y2, id,
        score, cls, det_idx] of the activated tracks."""
        self.frame_id += 1
        activated, refind, lost, removed = [], [], [], []
        n = len(scores)
        boxes_xywh = np.asarray(boxes_xywh)
        boxes_xywh = boxes_xywh.reshape(n, -1) if n else boxes_xywh.reshape(0, 4)
        scores = np.asarray(scores)
        cls = np.asarray(cls)

        remain_inds = scores >= self.args.track_high_thresh
        inds_low = scores > self.args.track_low_thresh
        inds_second = inds_low & ~remain_inds

        # the det_idx column is the index into this frame's detections, appended
        # before the high/low split, so rows of either stage map back to their detection
        boxes_with_idx = (
            np.concatenate([boxes_xywh, np.arange(n, dtype=boxes_xywh.dtype).reshape(-1, 1)], axis=-1)
            if n
            else boxes_xywh.reshape(0, boxes_xywh.shape[-1] + 1 if boxes_xywh.ndim == 2 else 5)
        )
        dets = boxes_with_idx[remain_inds]
        dets_second = boxes_with_idx[inds_second]
        # features follow the same split as their detections
        feats = np.asarray(feats) if feats is not None else None
        detections = self.init_track(
            dets, scores[remain_inds], cls[remain_inds], img, feats[remain_inds] if feats is not None else None
        )

        unconfirmed, tracked_stracks = [], []
        for track in self.tracked_stracks:
            (tracked_stracks if track.is_activated else unconfirmed).append(track)

        # first association: high-score dets ↔ tracked + lost
        strack_pool = joint_stracks(tracked_stracks, self.lost_stracks)
        self.multi_predict(strack_pool)
        if img is not None and hasattr(self, "gmc"):
            # the camera-motion estimate masks the detections, as x1y1x2y2
            if len(dets):
                cxy, wh = dets[:, :2], dets[:, 2:4]
                det_tlbr = np.concatenate([cxy - wh / 2, cxy + wh / 2], axis=1)
            else:
                det_tlbr = None
            warp = self.gmc.apply(img, det_tlbr)
            STrack.multi_gmc(strack_pool, warp)
            STrack.multi_gmc(unconfirmed, warp)

        dists = self.get_dists(strack_pool, detections)
        matches, u_track, u_detection = matching.linear_assignment(dists, thresh=self.args.match_thresh)
        for itracked, idet in matches:
            track, det = strack_pool[itracked], detections[idet]
            if track.state == TrackState.Tracked:
                track.update(det, self.frame_id)
                activated.append(track)
            else:
                track.re_activate(det, self.frame_id, new_id=False)
                refind.append(track)

        # second association: low-score dets rescue leftover tracked tracks
        detections_second = self.init_track(
            dets_second, scores[inds_second], cls[inds_second], img, feats[inds_second] if feats is not None else None
        )
        r_tracked = [strack_pool[i] for i in u_track if strack_pool[i].state == TrackState.Tracked]
        dists = matching.iou_distance(r_tracked, detections_second)
        matches, u_track, _ = matching.linear_assignment(dists, thresh=0.5)
        for itracked, idet in matches:
            track, det = r_tracked[itracked], detections_second[idet]
            if track.state == TrackState.Tracked:
                track.update(det, self.frame_id)
                activated.append(track)
            else:
                track.re_activate(det, self.frame_id, new_id=False)
                refind.append(track)
        for it in u_track:
            track = r_tracked[it]
            if track.state != TrackState.Lost:
                track.mark_lost()
                lost.append(track)

        # unconfirmed tracks get one shot at the remaining high-score dets
        detections = [detections[i] for i in u_detection]
        dists = self.get_dists(unconfirmed, detections)
        matches, u_unconfirmed, u_detection = matching.linear_assignment(dists, thresh=0.7)
        for itracked, idet in matches:
            unconfirmed[itracked].update(detections[idet], self.frame_id)
            activated.append(unconfirmed[itracked])
        for it in u_unconfirmed:
            track = unconfirmed[it]
            track.mark_removed()
            removed.append(track)

        # new tracks
        for inew in u_detection:
            track = detections[inew]
            if track.score >= self.args.new_track_thresh:
                track.activate(self.kalman_filter, self.frame_id)
                activated.append(track)

        # expire old lost tracks
        for track in self.lost_stracks:
            if self.frame_id - track.end_frame > self.max_time_lost:
                track.mark_removed()
                removed.append(track)

        self.tracked_stracks = [t for t in self.tracked_stracks if t.state == TrackState.Tracked]
        self.tracked_stracks = joint_stracks(self.tracked_stracks, activated)
        self.tracked_stracks = joint_stracks(self.tracked_stracks, refind)
        self.lost_stracks = sub_stracks(self.lost_stracks, self.tracked_stracks)
        self.lost_stracks.extend(lost)
        self.lost_stracks = sub_stracks(self.lost_stracks, self.removed_stracks)
        self.tracked_stracks, self.lost_stracks = remove_duplicate_stracks(self.tracked_stracks, self.lost_stracks)
        self.removed_stracks.extend(removed)
        if len(self.removed_stracks) > 1000:
            self.removed_stracks = self.removed_stracks[-999:]

        return np.asarray([t.result for t in self.tracked_stracks if t.is_activated], dtype=np.float32)

    def get_kalmanfilter(self):
        return KalmanFilterXYAH()

    def init_track(self, dets, scores, cls, img=None, feats=None):
        return [STrack(xywh, s, c) for (xywh, s, c) in zip(dets, scores, cls)] if len(dets) else []

    def get_dists(self, tracks, detections):
        dists = matching.iou_distance(tracks, detections)
        if self.args.fuse_score:
            dists = matching.fuse_score(dists, detections)
        return dists

    def multi_predict(self, tracks):
        STrack.multi_predict(tracks)

    @staticmethod
    def reset_id():
        STrack.reset_id()

    def reset(self):
        self.tracked_stracks = []
        self.lost_stracks = []
        self.removed_stracks = []
        self.frame_id = 0
        self.kalman_filter = self.get_kalmanfilter()
        self.reset_id()


def joint_stracks(tlista, tlistb):
    exists = {t.track_id for t in tlista}
    return tlista + [t for t in tlistb if t.track_id not in exists]


def sub_stracks(tlista, tlistb):
    drop = {t.track_id for t in tlistb}
    return [t for t in tlista if t.track_id not in drop]


def remove_duplicate_stracks(stracksa, stracksb):
    """Of each tracked / lost pair that overlaps at IoU > 0.85, drop the shorter-lived one."""
    pdist = matching.iou_distance(stracksa, stracksb)
    pairs = np.where(pdist < 0.15)
    life = lambda t: t.frame_id - t.start_frame  # noqa: E731
    dupa = {p for p, q in zip(*pairs) if life(stracksa[p]) <= life(stracksb[q])}
    dupb = {q for p, q in zip(*pairs) if life(stracksa[p]) > life(stracksb[q])}
    resa = [t for i, t in enumerate(stracksa) if i not in dupa]
    resb = [t for i, t in enumerate(stracksb) if i not in dupb]
    return resa, resb
