"""Frechet distance for FID-style metrics.

The port of ``textflux_tpu/evaluation/fid.py``: host numpy, as there. The
reference shells out to `pytorch_fid` and runs the LPIPS package
(eval/eval_fid_lpips.py:75-184); neither ships feature weights offline
here, so this module provides the distribution math plus a pluggable
feature extractor protocol: any callable images -> (N, D) features. For
strict FID parity use textflux_torch.evaluation.inception (the pytorch_fid
InceptionV3 graph as an nn.Module, pool3 features, loading locally provided
torch weights).
"""

from __future__ import annotations

from typing import Callable, Iterable, Tuple

import numpy as np


def gaussian_stats(features: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(mean, covariance) of an (N, D) feature matrix."""
    features = np.atleast_2d(features)
    if features.shape[0] < 2:
        # np.cov's ddof=1 divides by N-1: one sample silently yields an
        # all-NaN covariance and FID: nan downstream
        raise ValueError(
            f"FID statistics need >= 2 samples, got {features.shape[0]}")
    mu = features.mean(axis=0)
    sigma = np.cov(features, rowvar=False)
    return mu, np.atleast_2d(sigma)


def _sqrtm_psd(mat: np.ndarray) -> np.ndarray:
    """Matrix square root via eigendecomposition (symmetrize first)."""
    sym = (mat + mat.T) / 2.0
    vals, vecs = np.linalg.eigh(sym)
    vals = np.clip(vals, 0.0, None)
    return (vecs * np.sqrt(vals)) @ vecs.T


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """||mu1-mu2||^2 + Tr(S1 + S2 - 2 sqrt(S1 S2))."""
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2

    offset = np.eye(sigma1.shape[0]) * eps
    s1h = _sqrtm_psd(sigma1 + offset)   # one eigh of the 2048x2048, not two
    covmean = _sqrtm_psd(s1h @ (sigma2 + offset) @ s1h)
    # sqrt(S1 S2) trace via the symmetric similarity transform above
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


def fid_from_features(real: np.ndarray, fake: np.ndarray) -> float:
    return frechet_distance(*gaussian_stats(real), *gaussian_stats(fake))


def fid_from_images(
    real_images: Iterable[np.ndarray],
    fake_images: Iterable[np.ndarray],
    extractor: Callable[[np.ndarray], np.ndarray],
    batch_size: int = 32,
) -> float:
    """FID over image iterables with a pluggable feature extractor."""

    def features(images) -> np.ndarray:
        feats, batch = [], []
        for img in images:
            batch.append(img)
            if len(batch) == batch_size:
                feats.append(np.asarray(extractor(np.stack(batch))))
                batch = []
        if batch:
            feats.append(np.asarray(extractor(np.stack(batch))))
        return np.concatenate(feats, axis=0)

    return fid_from_features(features(real_images), features(fake_images))
