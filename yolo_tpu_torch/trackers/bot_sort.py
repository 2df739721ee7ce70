"""BoT-SORT: ByteTrack with camera-motion compensation and appearance gating
(counterpart of yolo_tpu/trackers/bot_sort.py), host numpy.

XYWH Kalman state, the GMC warp of the track states each frame, and IoU
costs gated by `proximity_thresh` before the appearance cost is fused in.
With `with_reid`, appearance features come with the detections
(`update(feats=...)`, the `model: auto` form) or, where `model` names a model,
from the crop-and-embed `ReID` encoder: each detection's crop of the frame
through that model's `YOLO.embed` (pooled features of the layer before its
head, on the card unless the tracker is given another device).
"""

from __future__ import annotations

from collections import deque

import numpy as np

from yolo_tpu_torch.trackers import matching
from yolo_tpu_torch.trackers.byte_tracker import BYTETracker, STrack
from yolo_tpu_torch.trackers.gmc import GMC
from yolo_tpu_torch.trackers.kalman_filter import KalmanFilterXYWH


class BOTrack(STrack):
    """STrack with smoothed appearance features and XYWH state."""

    shared_kalman = KalmanFilterXYWH()

    def __init__(self, xywh, score, cls, feat=None, feat_history: int = 50):
        super().__init__(xywh, score, cls)
        self.smooth_feat = None
        self.curr_feat = None
        if feat is not None:
            self.update_features(feat)
        self.features = deque([], maxlen=feat_history)
        self.alpha = 0.9

    def update_features(self, feat):
        feat = feat / (np.linalg.norm(feat) + 1e-9)
        self.curr_feat = feat
        self.smooth_feat = feat if self.smooth_feat is None else self.alpha * self.smooth_feat + (1 - self.alpha) * feat
        self.features.append(feat)
        self.smooth_feat /= np.linalg.norm(self.smooth_feat) + 1e-9

    def predict(self):
        mean_state = self.mean.copy()
        if self.state != 1:  # not Tracked
            mean_state[6] = 0
            mean_state[7] = 0
        self.mean, self.covariance = self.kalman_filter.predict(mean_state, self.covariance)

    def re_activate(self, new_track, frame_id, new_id=False):
        if new_track.curr_feat is not None:
            self.update_features(new_track.curr_feat)
        super().re_activate(new_track, frame_id, new_id)

    def update(self, new_track, frame_id):
        if new_track.curr_feat is not None:
            self.update_features(new_track.curr_feat)
        super().update(new_track, frame_id)

    @property
    def tlwh(self):
        if self.mean is None:
            return self._tlwh.copy()
        ret = self.mean[:4].copy()
        ret[:2] -= ret[2:] / 2
        return ret

    @staticmethod
    def multi_predict(stracks):
        if len(stracks) == 0:
            return
        multi_mean = np.asarray([st.mean.copy() for st in stracks])
        multi_cov = np.asarray([st.covariance for st in stracks])
        for i, st in enumerate(stracks):
            if st.state != 1:
                multi_mean[i][6] = 0
                multi_mean[i][7] = 0
        multi_mean, multi_cov = BOTrack.shared_kalman.multi_predict(multi_mean, multi_cov)
        for i, (mean, cov) in enumerate(zip(multi_mean, multi_cov)):
            stracks[i].mean = mean
            stracks[i].covariance = cov

    def convert_coords(self, tlwh):
        ret = np.asarray(tlwh, dtype=np.float32).copy()
        ret[:2] += ret[2:] / 2
        return ret


class BOTSORT(BYTETracker):
    """BoT-SORT manager."""

    def __init__(self, args, frame_rate: int = 30, device=None):
        """`device`: where the ReID encoder's model runs (None: `args.device` where the
        namespace has one, else the card); `YOLO.track` passes its predictor's device."""
        super().__init__(args, frame_rate)
        self.gmc = GMC(method=args.gmc_method)
        self.proximity_thresh = args.proximity_thresh
        self.appearance_thresh = args.appearance_thresh
        self.encoder = None
        if args.with_reid and getattr(args, "model", "auto") != "auto":
            self.encoder = ReID(args.model, device=device if device is not None else getattr(args, "device", None))

    def get_kalmanfilter(self):
        return KalmanFilterXYWH()

    def init_track(self, dets, scores, cls, img=None, feats=None):
        if len(dets) == 0:
            return []
        if self.args.with_reid and self.encoder is not None and img is not None and feats is None:
            feats = self.encoder(img, np.asarray(dets)[:, :4])
        if self.args.with_reid and feats is not None:
            return [BOTrack(xywh, s, c, f) for (xywh, s, c, f) in zip(dets, scores, cls, feats)]
        return [BOTrack(xywh, s, c) for (xywh, s, c) in zip(dets, scores, cls)]

    def get_dists(self, tracks, detections):
        dists = matching.iou_distance(tracks, detections)
        dists_mask = dists > (1 - self.proximity_thresh)
        if self.args.fuse_score:
            dists = matching.fuse_score(dists, detections)
        # the proximity mask gates the appearance cost only, when every detection carries features
        if self.args.with_reid and len(tracks) and len(detections) \
                and all(getattr(d, "curr_feat", None) is not None for d in detections):
            emb_dists = matching.embedding_distance(tracks, detections) / 2.0
            emb_dists[emb_dists > (1 - self.appearance_thresh)] = 1.0
            emb_dists[dists_mask] = 1.0
            dists = np.minimum(dists, emb_dists)
        return dists

    def multi_predict(self, tracks):
        BOTrack.multi_predict(tracks)

    def reset(self):
        super().reset()
        self.gmc.reset_params()


class ReID:
    """Crop-and-embed re-identification encoder (JAX `ReID`): `YOLO(model)` on `device`, each
    detection's crop embedded at `imgsz` by `YOLO.embed` and L2-normalised."""

    def __init__(self, model: str = "yolov8n.yaml", imgsz: int = 128, device=None):
        from yolo_tpu_torch.engine.model import YOLO

        self.model = YOLO(model, device=device)
        self.imgsz = imgsz

    def __call__(self, img: np.ndarray, dets_xywh: np.ndarray) -> list:
        """img BGR; dets (N, 4) centre xywh → N unit vectors (an 8x8 black crop for a box outside the frame)."""
        h, w = img.shape[:2]
        crops = []
        for cx, cy, bw, bh in np.asarray(dets_xywh, np.float32):
            x1, y1 = max(int(cx - bw / 2), 0), max(int(cy - bh / 2), 0)
            x2, y2 = min(int(cx + bw / 2), w), min(int(cy + bh / 2), h)
            crops.append(img[y1:y2, x1:x2] if x2 > x1 and y2 > y1 else np.zeros((8, 8, 3), np.uint8))
        feats = self.model.embed(crops, imgsz=self.imgsz)
        return [f / max(float(np.linalg.norm(f)), 1e-12) for f in feats]
