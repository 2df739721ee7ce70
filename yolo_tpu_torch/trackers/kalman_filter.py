"""SORT-style constant-velocity Kalman filters of the MOT trackers (counterpart of
yolo_tpu/trackers/kalman_filter.py), host numpy.

8-state filters with measurement-scaled noise:
  XYAH: (cx, cy, aspect, height, + velocities), ByteTrack's;
  XYWH: (cx, cy, w, h, + velocities), BoT-SORT's.
Position noise is 1/20 and velocity noise 1/160 of the height (or width).
`multi_predict` predicts all tracks at once.
"""
from __future__ import annotations

import numpy as np
import scipy.linalg

# chi-square 0.95 quantiles for gating distance (ref table)
chi2inv95 = {1: 3.8415, 2: 5.9915, 3: 7.8147, 4: 9.4877, 5: 11.070, 6: 12.592, 7: 14.067, 8: 15.507, 9: 16.919}


class KalmanFilterXYAH:
    """CV Kalman filter over (cx, cy, a, h) measurements."""

    def __init__(self):
        ndim, dt = 4, 1.0
        self._motion_mat = np.eye(2 * ndim, 2 * ndim)
        for i in range(ndim):
            self._motion_mat[i, ndim + i] = dt
        self._update_mat = np.eye(ndim, 2 * ndim)
        self._std_weight_position = 1.0 / 20
        self._std_weight_velocity = 1.0 / 160

    def _std(self, measurement):
        return [
            2 * self._std_weight_position * measurement[3],
            2 * self._std_weight_position * measurement[3],
            1e-2,
            2 * self._std_weight_position * measurement[3],
        ]

    def initiate(self, measurement: np.ndarray):
        mean_pos = measurement
        mean_vel = np.zeros_like(mean_pos)
        mean = np.r_[mean_pos, mean_vel]
        std = self._std(measurement) + [
            10 * self._std_weight_velocity * measurement[3],
            10 * self._std_weight_velocity * measurement[3],
            1e-5,
            10 * self._std_weight_velocity * measurement[3],
        ]
        covariance = np.diag(np.square(std))
        return mean, covariance

    def _motion_cov_std(self, mean):
        return (
            [
                self._std_weight_position * mean[3],
                self._std_weight_position * mean[3],
                1e-2,
                self._std_weight_position * mean[3],
            ],
            [
                self._std_weight_velocity * mean[3],
                self._std_weight_velocity * mean[3],
                1e-5,
                self._std_weight_velocity * mean[3],
            ],
        )

    def predict(self, mean, covariance):
        std_pos, std_vel = self._motion_cov_std(mean)
        motion_cov = np.diag(np.square(np.r_[std_pos, std_vel]))
        mean = self._motion_mat @ mean
        covariance = self._motion_mat @ covariance @ self._motion_mat.T + motion_cov
        return mean, covariance

    def multi_predict(self, mean: np.ndarray, covariance: np.ndarray):
        """Vectorized predict over (N, 8) means and (N, 8, 8) covariances."""
        std_pos = np.stack(
            [
                self._std_weight_position * mean[:, 3],
                self._std_weight_position * mean[:, 3],
                1e-2 * np.ones_like(mean[:, 3]),
                self._std_weight_position * mean[:, 3],
            ],
            axis=-1,
        )
        std_vel = np.stack(
            [
                self._std_weight_velocity * mean[:, 3],
                self._std_weight_velocity * mean[:, 3],
                1e-5 * np.ones_like(mean[:, 3]),
                self._std_weight_velocity * mean[:, 3],
            ],
            axis=-1,
        )
        sqr = np.square(np.concatenate([std_pos, std_vel], axis=-1))
        motion_cov = np.stack([np.diag(s) for s in sqr])
        mean = mean @ self._motion_mat.T
        covariance = self._motion_mat[None] @ covariance @ self._motion_mat.T[None] + motion_cov
        return mean, covariance

    def project(self, mean, covariance):
        std = [
            self._std_weight_position * mean[3],
            self._std_weight_position * mean[3],
            1e-1,
            self._std_weight_position * mean[3],
        ]
        innovation_cov = np.diag(np.square(std))
        mean = self._update_mat @ mean
        covariance = self._update_mat @ covariance @ self._update_mat.T
        return mean, covariance + innovation_cov

    def update(self, mean, covariance, measurement):
        projected_mean, projected_cov = self.project(mean, covariance)
        chol, lower = scipy.linalg.cho_factor(projected_cov, lower=True, check_finite=False)
        kalman_gain = scipy.linalg.cho_solve(
            (chol, lower), (covariance @ self._update_mat.T).T, check_finite=False
        ).T
        innovation = measurement - projected_mean
        new_mean = mean + innovation @ kalman_gain.T
        new_covariance = covariance - kalman_gain @ projected_cov @ kalman_gain.T
        return new_mean, new_covariance

    def gating_distance(self, mean, covariance, measurements, only_position: bool = False, metric: str = "maha"):
        projected_mean, projected_cov = self.project(mean, covariance)
        if only_position:
            projected_mean, projected_cov = projected_mean[:2], projected_cov[:2, :2]
            measurements = measurements[:, :2]
        d = measurements - projected_mean
        if metric == "gaussian":
            return np.sum(d * d, axis=1)
        chol = np.linalg.cholesky(projected_cov)
        z = scipy.linalg.solve_triangular(chol, d.T, lower=True, check_finite=False, overwrite_b=True)
        return np.sum(z * z, axis=0)


class KalmanFilterXYWH(KalmanFilterXYAH):
    """Same filter over (cx, cy, w, h) measurements (ref :289). Noise scales
    with both w and h instead of h alone."""

    def initiate(self, measurement):
        mean = np.r_[measurement, np.zeros_like(measurement)]
        std = [
            2 * self._std_weight_position * measurement[2],
            2 * self._std_weight_position * measurement[3],
            2 * self._std_weight_position * measurement[2],
            2 * self._std_weight_position * measurement[3],
            10 * self._std_weight_velocity * measurement[2],
            10 * self._std_weight_velocity * measurement[3],
            10 * self._std_weight_velocity * measurement[2],
            10 * self._std_weight_velocity * measurement[3],
        ]
        return mean, np.diag(np.square(std))

    def _motion_cov_std(self, mean):
        return (
            [
                self._std_weight_position * mean[2],
                self._std_weight_position * mean[3],
                self._std_weight_position * mean[2],
                self._std_weight_position * mean[3],
            ],
            [
                self._std_weight_velocity * mean[2],
                self._std_weight_velocity * mean[3],
                self._std_weight_velocity * mean[2],
                self._std_weight_velocity * mean[3],
            ],
        )

    def multi_predict(self, mean, covariance):
        std_pos = np.stack(
            [
                self._std_weight_position * mean[:, 2],
                self._std_weight_position * mean[:, 3],
                self._std_weight_position * mean[:, 2],
                self._std_weight_position * mean[:, 3],
            ],
            axis=-1,
        )
        std_vel = np.stack(
            [
                self._std_weight_velocity * mean[:, 2],
                self._std_weight_velocity * mean[:, 3],
                self._std_weight_velocity * mean[:, 2],
                self._std_weight_velocity * mean[:, 3],
            ],
            axis=-1,
        )
        sqr = np.square(np.concatenate([std_pos, std_vel], axis=-1))
        motion_cov = np.stack([np.diag(s) for s in sqr])
        mean = mean @ self._motion_mat.T
        covariance = self._motion_mat[None] @ covariance @ self._motion_mat.T[None] + motion_cov
        return mean, covariance

    def project(self, mean, covariance):
        std = [
            self._std_weight_position * mean[2],
            self._std_weight_position * mean[3],
            self._std_weight_position * mean[2],
            self._std_weight_position * mean[3],
        ]
        innovation_cov = np.diag(np.square(std))
        mean = self._update_mat @ mean
        covariance = self._update_mat @ covariance @ self._update_mat.T
        return mean, covariance + innovation_cov
