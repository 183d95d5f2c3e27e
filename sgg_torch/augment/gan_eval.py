"""Generated-feature quality metrics: FID and precision/recall/density/
coverage.

Counterpart of ``sgg_tpu/augment/gan_eval.py`` (reference
``augment/gan_eval.py``, itself from instance_selection_for_gans / prdc):
the Fréchet distance between Gaussian fits of real and generated feature
banks, in float64 numpy with scipy's ``sqrtm``, and the PRDC manifold
metrics over k-NN radii. The distance matrices run in float32 on a torch
device (the card unless the caller asks for the CPU), as the JAX
package's run on its device.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from sgg_torch.device import resolve_device


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """||mu1-mu2||^2 + Tr(C1 + C2 - 2 sqrt(C1 C2)) (gan_eval.py:9-60)."""
    from scipy import linalg
    diff = mu1 - mu2
    # sqrtm's matrix alone: scipy 1.18 drops the disp=False that returned
    # it beside an error estimate
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            raise ValueError("large imaginary component in sqrtm")
        covmean = covmean.real
    return float(diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))


def compute_fid(fake: np.ndarray, real: np.ndarray,
                truncate: int = None) -> float:
    """FID over (N, D) feature banks (gan_eval.py:63-74)."""
    if truncate is None:
        truncate = real.shape[-1]
    f = np.asarray(fake, np.float64)[:, :truncate]
    r = np.asarray(real, np.float64)[:, :truncate]
    return frechet_distance(f.mean(0), np.cov(f, rowvar=False),
                            r.mean(0), np.cov(r, rowvar=False))


def _pairwise_distance(a: np.ndarray, b: np.ndarray = None,
                       device="cuda") -> np.ndarray:
    """The Euclidean distance matrix on ``device`` in float32, |a|^2 +
    |b|^2 - 2ab clipped at 0 (the reference's sklearn
    ``pairwise_distances``)."""
    dev = resolve_device(device)
    a = torch.as_tensor(np.asarray(a, np.float32)).to(dev)
    b = a if b is None else torch.as_tensor(np.asarray(b, np.float32)).to(dev)
    d2 = ((a * a).sum(1)[:, None] + (b * b).sum(1)[None]
          - 2.0 * (a @ b.T))
    return torch.sqrt(torch.clamp(d2, min=0.0)).cpu().numpy()


def _knn_radii(feats: np.ndarray, k: int, device="cuda") -> np.ndarray:
    """Distance to the k-th nearest neighbour (excluding self)."""
    d = _pairwise_distance(feats, device=device)
    return np.partition(d, k, axis=-1)[:, k]


def compute_prdc(real: np.ndarray, fake: np.ndarray, nearest_k: int = 5,
                 device="cuda") -> Dict[str, float]:
    """Precision/recall/density/coverage (gan_eval.py:265-309)."""
    real_r = _knn_radii(real, nearest_k, device)
    fake_r = _knn_radii(fake, nearest_k, device)
    d_rf = _pairwise_distance(real, fake, device)
    precision = float((d_rf < real_r[:, None]).any(axis=0).mean())
    recall = float((d_rf < fake_r[None]).any(axis=1).mean())
    density = float((1.0 / nearest_k)
                    * (d_rf < real_r[:, None]).sum(axis=0).mean())
    coverage = float((d_rf.min(axis=1) < real_r).mean())
    return dict(precision=precision, recall=recall, density=density,
                coverage=coverage)
