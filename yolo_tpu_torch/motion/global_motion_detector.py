"""Global (camera) motion detection per frame (counterpart of
yolo_tpu/motion/global_motion_detector.py; host cv2 and numpy, as there).

LK optical flow on good features with a 75th-percentile inlier filter, ORB +
BFMatcher + RANSAC homography translation, and their hybrid fusion; thresholds
30 / 50 px, the motion-consistency check and the stats (ref:
camera_motion_compensation/global_motion_detector.py GlobalMotionDetector:22).
cv2 is imported inside the functions that use it.
"""

from __future__ import annotations

from collections import deque

import numpy as np


class GlobalMotionDetector:
    """Detects whole-frame (camera) motion between consecutive frames."""

    def __init__(self, method: str = "optical_flow"):
        import cv2

        self.method = method
        self.prev_gray = None
        self.motion_history = deque(maxlen=10)
        self.motion_vectors = deque(maxlen=5)

        self.global_motion_threshold = 30.0  # px: "camera moved"
        self.reset_motion_threshold = 50.0  # px: "reset the filters"
        self.consistency_threshold = 0.7

        self.lk_params = dict(winSize=(21, 21), maxLevel=3, criteria=(cv2.TERM_CRITERIA_EPS | cv2.TERM_CRITERIA_COUNT, 30, 0.01))
        self.feature_params = dict(maxCorners=200, qualityLevel=0.01, minDistance=15, blockSize=7)

        self.stats = {"total_detections": 0, "motion_events": 0, "reset_triggers": 0, "avg_motion_magnitude": 0.0}
        print(f"Global motion detector ready - method: {method}")

    def detect_motion(self, frame):
        """→ (is_motion, magnitude, vector, should_reset)."""
        import cv2

        if self.prev_gray is None:
            # only the grayscale previous frame is ever read — the reference
            # also copies the full color frame each call, pure dead weight
            self.prev_gray = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
            return False, 0.0, np.array([0.0, 0.0]), False

        curr_gray = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
        if self.method == "optical_flow":
            result = self._detect_by_optical_flow(curr_gray)
        elif self.method == "feature_matching":
            result = self._detect_by_feature_matching(curr_gray)
        else:
            result = self._detect_by_hybrid_method(curr_gray)

        self.prev_gray = curr_gray

        self.stats["total_detections"] += 1
        is_motion, magnitude, _, should_reset = result
        if is_motion:
            self.stats["motion_events"] += 1
        if should_reset:
            self.stats["reset_triggers"] += 1
        n = self.stats["total_detections"]
        self.stats["avg_motion_magnitude"] = (self.stats["avg_motion_magnitude"] * (n - 1) + magnitude) / n
        return result

    def _detect_by_optical_flow(self, curr_gray):
        import cv2

        none = (False, 0.0, np.array([0.0, 0.0]), False)
        corners = cv2.goodFeaturesToTrack(self.prev_gray, **self.feature_params)
        if corners is None or len(corners) < 20:
            return none
        next_corners, status, _ = cv2.calcOpticalFlowPyrLK(self.prev_gray, curr_gray, corners, None, **self.lk_params)
        if status is None:
            return none
        good = status.flatten() == 1
        if good.sum() < 10:
            return none
        prev_pts = corners[good].reshape(-1, 2)
        next_pts = next_corners[good].reshape(-1, 2)
        vectors = next_pts - prev_pts
        if len(vectors) > 8:
            median = np.median(vectors, axis=0)
            dist = np.linalg.norm(vectors - median, axis=1)
            inliers = dist < np.percentile(dist, 75)
            if inliers.sum() > 5:
                gvec = vectors[inliers].mean(axis=0)
                magnitude = float(np.linalg.norm(gvec))
                self.motion_history.append(magnitude)
                self.motion_vectors.append(gvec)
                is_motion = magnitude > self.global_motion_threshold
                should_reset = magnitude > self.reset_motion_threshold
                if len(self.motion_vectors) >= 3:
                    consistency = self._calculate_motion_consistency(list(self.motion_vectors)[-3:])
                    if consistency > self.consistency_threshold and is_motion:
                        should_reset = should_reset or magnitude > self.global_motion_threshold * 1.5
                return is_motion, magnitude, gvec, should_reset
        return none

    def _detect_by_feature_matching(self, curr_gray):
        import cv2

        none = (False, 0.0, np.array([0.0, 0.0]), False)
        if not hasattr(self, "_orb"):  # build detector/matcher once, not per frame
            self._orb = cv2.ORB_create(nfeatures=500)
            self._bf = cv2.BFMatcher(cv2.NORM_HAMMING, crossCheck=True)
        orb = self._orb
        kp1, des1 = orb.detectAndCompute(self.prev_gray, None)
        kp2, des2 = orb.detectAndCompute(curr_gray, None)
        if des1 is None or des2 is None or len(des1) < 20 or len(des2) < 20:
            return none
        bf = self._bf
        matches = sorted(bf.match(des1, des2), key=lambda m: m.distance)
        if len(matches) < 20:
            return none
        src = np.float32([kp1[m.queryIdx].pt for m in matches]).reshape(-1, 1, 2)
        dst = np.float32([kp2[m.trainIdx].pt for m in matches]).reshape(-1, 1, 2)
        H, mask = cv2.findHomography(src, dst, cv2.RANSAC, 5.0, maxIters=2000)
        if H is not None and mask is not None and mask.sum() / len(mask) > 0.3:
            translation = H[:2, 2]
            magnitude = float(np.linalg.norm(translation))
            self.motion_history.append(magnitude)
            return (
                magnitude > self.global_motion_threshold,
                magnitude,
                translation,
                magnitude > self.reset_motion_threshold,
            )
        return none

    def _detect_by_hybrid_method(self, curr_gray):
        flow = self._detect_by_optical_flow(curr_gray)
        feat = self._detect_by_feature_matching(curr_gray)
        is_motion = flow[0] or feat[0]
        if flow[1] > 0 and feat[1] > 0:
            magnitude = (flow[1] + feat[1]) / 2.0
            vector = (flow[2] + feat[2]) / 2.0
        elif flow[1] > 0:
            magnitude, vector = flow[1], flow[2]
        else:
            magnitude, vector = feat[1], feat[2]
        should_reset = (flow[3] and feat[3]) or magnitude > self.reset_motion_threshold * 1.2
        return is_motion, magnitude, vector, should_reset

    @staticmethod
    def _calculate_motion_consistency(vectors) -> float:
        if len(vectors) < 2:
            return 0.0
        angles = [np.arctan2(v[1], v[0]) for v in vectors]
        diffs = []
        for i in range(1, len(angles)):
            d = abs(angles[i] - angles[i - 1])
            if d > np.pi:
                d = 2 * np.pi - d
            diffs.append(d)
        return max(0.0, 1.0 - float(np.mean(diffs)) / np.pi)

    def get_stats(self):
        n = self.stats["total_detections"]
        motion_rate = self.stats["motion_events"] / n if n else 0.0
        reset_rate = self.stats["reset_triggers"] / n if n else 0.0
        return {
            "total_detections": n,
            "motion_events": self.stats["motion_events"],
            "reset_triggers": self.stats["reset_triggers"],
            "motion_detection_rate": f"{motion_rate:.1%}",
            "reset_trigger_rate": f"{reset_rate:.1%}",
            "avg_motion_magnitude": f"{self.stats['avg_motion_magnitude']:.2f}px",
        }

    def reset_stats(self):
        self.stats = {"total_detections": 0, "motion_events": 0, "reset_triggers": 0, "avg_motion_magnitude": 0.0}
