"""Moore-Penrose pseudoinverse for the CUR ``U`` matrix.

Counterpart of ``anncur_tpu/ops/pinv.py``: a float64 host path
(numpy/LAPACK, the reference's ``np.linalg.pinv`` numerics) and a torch
float32 path on the tensor's device, both with an explicit relative
cutoff, plus the noise-adaptive cutoffs.
"""

from __future__ import annotations

import numpy as np
import torch


def pinv(mat: torch.Tensor, rcond: float | None = None) -> torch.Tensor:
    """SVD-based f32 pseudoinverse on ``mat``'s device; singular values
    below ``rcond * s_max`` are cut. rcond defaults to ``max(m, n) * eps``
    of float32, as numpy's default."""
    mat = torch.as_tensor(mat).float()
    if rcond is None:
        rcond = max(mat.shape[-2], mat.shape[-1]) * float(np.finfo(np.float32).eps)
    return torch.linalg.pinv(mat, rtol=rcond)


def noise_rcond(mat) -> float:
    """Noise-adaptive relative pinv cutoff (Gavish-Donoho 2014 optimal
    hard threshold for singular values, unknown-noise form):
    ``omega(beta) * sigma_med / sigma_max`` with ``beta`` the aspect ratio
    (paper eq. 5 approximation). Use when the matrix's structure may sit
    near the compute noise floor; see ``anncur_tpu/ops/pinv.py``."""
    mat = np.asarray(mat, dtype=np.float64)
    m, n = mat.shape[-2], mat.shape[-1]
    beta = min(m, n) / max(m, n)
    omega = 0.56 * beta**3 - 0.95 * beta**2 + 1.82 * beta + 1.43
    sv = np.linalg.svd(mat, compute_uv=False)
    if sv[..., 0] == 0:
        return 0.0
    return float(omega * np.median(sv, axis=-1) / sv[..., 0])


def pinv_f64(mat, rcond: float | None = None) -> np.ndarray:
    """Host float64 pseudoinverse. Scores arrive as float32, so singular
    values below float32 noise are noise: the default cutoff is f32
    machine precision, not numpy's f64 one (keeping them gives a U with
    huge entries that destroys float32 downstream matmuls)."""
    mat = np.asarray(mat, dtype=np.float64)
    if rcond is None:
        rcond = max(mat.shape[-2], mat.shape[-1]) * float(np.finfo(np.float32).eps)
    return np.linalg.pinv(mat, rcond=rcond)


def auto_rcond(mat, kappa_threshold: float = 1e4) -> float | None:
    """Condition-aware cutoff: the Gavish-Donoho noise threshold only when
    the matrix is ill-conditioned (kappa >= ``kappa_threshold``), else
    None (the f32-eps default). All-signal spectra stay moderate
    (kappa ~ 1e2) and must not be truncated; noise-reaching spectra
    explode. Measurements behind the rule: ``anncur_tpu/ops/pinv.py``."""
    mat = np.asarray(mat, dtype=np.float64)
    sv = np.linalg.svd(mat, compute_uv=False)
    if sv[..., 0] == 0:
        return 0.0
    kappa = float(sv[..., 0] / max(float(sv[..., -1]), 1e-300))
    if kappa < kappa_threshold:
        return None
    return noise_rcond(mat)
