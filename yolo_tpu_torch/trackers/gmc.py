"""Camera-motion compensation of BoT-SORT (counterpart of yolo_tpu/trackers/gmc.py), host cv2.

Estimates a 2x3 affine warp between consecutive frames by sparse optical flow
(the default), ORB, SIFT or ECC, on frames downscaled 2x. cv2 is imported only
by the methods that need it, so `gmc_method: none` runs on a machine without
cv2; any other method raises cv2's ImportError there.
"""

from __future__ import annotations

import copy
import warnings

import numpy as np


class GMC:
    """Camera motion estimator returning 2x3 warp matrices."""

    def __init__(self, method: str = "sparseOptFlow", downscale: int = 2):
        self.method = method
        self.downscale = max(1, downscale)
        if self.method in {"none", "None", None}:
            self.method = None
        elif self.method not in ("orb", "sift", "ecc", "sparseOptFlow"):
            raise ValueError(f"unknown GMC method: {method}")
        else:
            import cv2

            if self.method == "orb":
                self.detector = cv2.FastFeatureDetector_create(20)
                self.extractor = cv2.ORB_create()
                self.matcher = cv2.BFMatcher(cv2.NORM_HAMMING)
            elif self.method == "sift":
                self.detector = cv2.SIFT_create(nOctaveLayers=3, contrastThreshold=0.02, edgeThreshold=20)
                self.extractor = self.detector
                self.matcher = cv2.BFMatcher(cv2.NORM_L2)
            elif self.method == "ecc":
                self.warp_mode = cv2.MOTION_EUCLIDEAN
                self.criteria = (cv2.TERM_CRITERIA_EPS | cv2.TERM_CRITERIA_COUNT, 100, 1e-6)
            else:
                self.feature_params = dict(
                    maxCorners=1000, qualityLevel=0.01, minDistance=1, blockSize=3, useHarrisDetector=False, k=0.04
                )

        self.prevFrame = None
        self.prevKeyPoints = None
        self.prevDescriptors = None
        self.initializedFirstFrame = False

    def apply(self, raw_frame: np.ndarray, detections=None) -> np.ndarray:
        """Estimate warp from the previous frame to this one."""
        if self.method in ("orb", "sift"):
            return self.apply_features(raw_frame, detections)
        if self.method == "ecc":
            return self.apply_ecc(raw_frame)
        if self.method == "sparseOptFlow":
            return self.apply_sparseoptflow(raw_frame)
        return np.eye(2, 3)

    def _gray_small(self, raw_frame):
        import cv2

        frame = cv2.cvtColor(raw_frame, cv2.COLOR_BGR2GRAY) if raw_frame.ndim == 3 else raw_frame
        if self.downscale > 1:
            h, w = frame.shape
            frame = cv2.resize(frame, (w // self.downscale, h // self.downscale))
        return frame

    def apply_sparseoptflow(self, raw_frame) -> np.ndarray:
        import cv2

        H = np.eye(2, 3)
        frame = self._gray_small(raw_frame)
        keypoints = cv2.goodFeaturesToTrack(frame, mask=None, **self.feature_params)
        if not self.initializedFirstFrame or self.prevKeyPoints is None:
            self.prevFrame = frame.copy()
            self.prevKeyPoints = copy.copy(keypoints)
            self.initializedFirstFrame = True
            return H
        if keypoints is None:
            # still advance prev state: returning with a stale prevFrame would
            # make the next call estimate a TWO-frame displacement and apply it
            # as one frame's compensation (double-warp)
            self.prevFrame = frame.copy()
            self.prevKeyPoints = None
            return H
        matched, st, _ = cv2.calcOpticalFlowPyrLK(self.prevFrame, frame, self.prevKeyPoints, None)
        prev_pts = self.prevKeyPoints[st.flatten() == 1] if st is not None else np.zeros((0, 1, 2))
        curr_pts = matched[st.flatten() == 1] if st is not None else np.zeros((0, 1, 2))
        if len(prev_pts) > 4:
            M, inliers = cv2.estimateAffinePartial2D(prev_pts, curr_pts, cv2.RANSAC)
            if M is not None:
                H = M
                if self.downscale > 1:
                    H[0, 2] *= self.downscale
                    H[1, 2] *= self.downscale
        else:
            warnings.warn("GMC: not enough matching points", stacklevel=2)
        self.prevFrame = frame.copy()
        self.prevKeyPoints = copy.copy(keypoints)
        return H

    def apply_ecc(self, raw_frame) -> np.ndarray:
        import cv2

        H = np.eye(2, 3, dtype=np.float32)
        frame = self._gray_small(raw_frame)
        if not self.initializedFirstFrame:
            self.prevFrame = frame.copy()
            self.initializedFirstFrame = True
            return H
        try:
            # parity note: like the reference (gmc.py apply_ecc), the ECC warp's
            # translation is NOT rescaled by downscale — upstream quirk kept
            _, H = cv2.findTransformECC(self.prevFrame, frame, H, self.warp_mode, self.criteria, None, 1)
        except cv2.error as e:
            warnings.warn(f"GMC ECC failed: {e}", stacklevel=2)
        self.prevFrame = frame.copy()
        return H

    def apply_features(self, raw_frame, detections=None) -> np.ndarray:
        import cv2

        H = np.eye(2, 3)
        frame = self._gray_small(raw_frame)
        h, w = frame.shape
        # mask out borders and detection boxes so features sit on background
        mask = np.zeros_like(frame)
        mask[int(0.02 * h) : int(0.98 * h), int(0.02 * w) : int(0.98 * w)] = 255
        if detections is not None:
            for det in detections:
                tlbr = (np.asarray(det[:4]) / self.downscale).astype(int)
                mask[tlbr[1] : tlbr[3], tlbr[0] : tlbr[2]] = 0
        keypoints = self.detector.detect(frame, mask)
        keypoints, descriptors = self.extractor.compute(frame, keypoints)
        if not self.initializedFirstFrame or self.prevDescriptors is None:
            self.prevFrame = frame.copy()
            self.prevKeyPoints = copy.copy(keypoints)
            self.prevDescriptors = copy.copy(descriptors)
            self.initializedFirstFrame = True
            return H
        if descriptors is None or len(keypoints) < 5:
            # advance prev state (see apply_sparseoptflow) — a degenerate frame
            # must not leave the matcher comparing across a frame gap
            self.prevFrame = frame.copy()
            self.prevKeyPoints = copy.copy(keypoints)
            self.prevDescriptors = copy.copy(descriptors)
            return H
        knn = self.matcher.knnMatch(self.prevDescriptors, descriptors, 2)
        good = [m for pair in knn if len(pair) == 2 for m, n in [pair] if m.distance < 0.75 * n.distance]
        if len(good) > 4:
            prev_pts = np.float32([self.prevKeyPoints[m.queryIdx].pt for m in good])
            curr_pts = np.float32([keypoints[m.trainIdx].pt for m in good])
            M, _ = cv2.estimateAffinePartial2D(prev_pts, curr_pts, cv2.RANSAC)
            if M is not None:
                H = M
                if self.downscale > 1:
                    H[0, 2] *= self.downscale
                    H[1, 2] *= self.downscale
        self.prevFrame = frame.copy()
        self.prevKeyPoints = copy.copy(keypoints)
        self.prevDescriptors = copy.copy(descriptors)
        return H

    def reset_params(self):
        self.prevFrame = None
        self.prevKeyPoints = None
        self.prevDescriptors = None
        self.initializedFirstFrame = False
