"""Feature statistics for metric loops: ``FeatureStats`` accumulates the
count, mean and covariance of feature batches, and ``frechet_distance``
compares two of them. The port's own copy of the part of
``afldm_tpu/utils/metric_utils.py`` that VAE validation needs (numpy and
scipy on the host)."""

import warnings

import numpy as np


class FeatureStats:
    """Raw features and/or their running sum and sum of outer products, in
    float64."""

    def __init__(self, capture_all=False, capture_mean_cov=False,
                 max_items=None):
        self.capture_all = capture_all
        self.capture_mean_cov = capture_mean_cov
        self.max_items = max_items
        self.num_items = 0
        self.num_features = None
        self.all_features = None
        self.raw_mean = None
        self.raw_cov = None

    def set_num_features(self, num_features):
        if self.num_features is not None:
            if num_features != self.num_features:
                raise ValueError(f"{num_features} features, expected "
                                 f"{self.num_features}")
            return
        self.num_features = num_features
        self.all_features = []
        self.raw_mean = np.zeros(num_features, np.float64)
        self.raw_cov = np.zeros((num_features, num_features), np.float64)

    def is_full(self):
        return (self.max_items is not None
                and self.num_items >= self.max_items)

    def append(self, x):
        """``x``: (items, features), numpy or a tensor."""
        if hasattr(x, "detach"):
            x = x.detach().cpu().numpy()
        x = np.asarray(x, np.float32)
        if x.ndim != 2:
            raise ValueError(f"features must be 2D, got shape {x.shape}")
        if self.max_items is not None:
            if self.num_items >= self.max_items:
                return
            x = x[: self.max_items - self.num_items]
        self.set_num_features(x.shape[1])
        self.num_items += x.shape[0]
        if self.capture_all:
            self.all_features.append(x)
        if self.capture_mean_cov:
            x64 = x.astype(np.float64)
            self.raw_mean += x64.sum(axis=0)
            self.raw_cov += x64.T @ x64

    def get_all(self):
        return np.concatenate(self.all_features, axis=0)

    def get_mean_cov(self):
        mean = self.raw_mean / self.num_items
        cov = self.raw_cov / self.num_items - np.outer(mean, mean)
        return mean, cov

    def merge(self, other):
        """Add another worker's statistics into these."""
        if other.num_features is None:
            return self
        self.set_num_features(other.num_features)
        self.num_items += other.num_items
        if self.capture_all:
            self.all_features.extend(other.all_features)
        if self.capture_mean_cov:
            self.raw_mean += other.raw_mean
            self.raw_cov += other.raw_cov
        return self


def frechet_distance(stats_a, stats_b):
    """|mu_a - mu_b|^2 + tr(C_a + C_b - 2 sqrtm(C_a C_b)) of two
    ``FeatureStats`` with mean and covariance captured. Singular
    covariances (few samples against the feature count) get an eps*I
    offset before the matrix square root."""
    import scipy.linalg

    def sqrtm(x):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")   # LinAlgWarning on singular x
            s = np.real(scipy.linalg.sqrtm(x))
        err = (np.linalg.norm(s @ s - x) /
               max(float(np.linalg.norm(x)), 1e-30))
        return s, err

    mu_a, cov_a = stats_a.get_mean_cov()
    mu_b, cov_b = stats_b.get_mean_cov()
    m = float(np.square(mu_a - mu_b).sum())
    s, err = sqrtm(cov_a @ cov_b)
    if not np.isfinite(err) or err > 1e-2:
        eps = 1e-6 * np.eye(cov_a.shape[0])
        s, _ = sqrtm((cov_a + eps) @ (cov_b + eps))
    return float(m + np.trace(cov_a + cov_b - 2.0 * s))
