"""CUR matrix-decomposition index.

Counterpart of ``anncur_tpu/core/cur.py``. Given exact cross-encoder
scores of ``k_r`` anchor queries against all items (``R``, k_r x m) and of
all queries against ``k_c`` anchor items (``C``, n x k_c), approximate the
full score matrix as ``C @ U @ R`` with ``U = pinv(C[row_idxs, :])``
(reference ``CURApprox``, eval/matrix_approx_zeshel.py:19-126), including
the 'rows'/'cols' latent factorization and the oracle-U variant. Every
matmul runs in true f32 (``utils/device.py::true_f32``, whatever the caller
set).
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Optional

import numpy as np
import torch

from anncur_tpu_torch.ops.mips import topk_stable
from anncur_tpu_torch.ops.pinv import auto_rcond, noise_rcond, pinv, pinv_f64
from anncur_tpu_torch.utils.device import DeviceLike, resolve_device, true_f32


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    with true_f32():
        return a @ b


@dataclasses.dataclass(frozen=True)
class CurIndex:
    """Latent-factor form of the CUR approximation.

    approx_preference='rows':  latent_rows = C (n x k_c),
                               latent_cols = U @ R (k_c x m)
    approx_preference='cols':  latent_rows = C @ U (n x k_r),
                               latent_cols = R (k_r x m)
    """

    latent_rows: torch.Tensor  # (n, k) f32
    latent_cols: torch.Tensor  # (k, m) f32
    row_idxs: torch.Tensor  # (k_r,) anchor row (query) ids
    col_idxs: torch.Tensor  # (k_c,) anchor col (item) ids
    approx_preference: str = "rows"

    @property
    def n_rows(self) -> int:
        return self.latent_rows.shape[0]

    @property
    def n_cols(self) -> int:
        return self.latent_cols.shape[1]

    def reconstruct(self) -> torch.Tensor:
        """Full (n x m) approximate score matrix."""
        return _mm(self.latent_rows, self.latent_cols)

    def _ids(self, idxs) -> torch.Tensor:
        return _as_long(idxs, self.latent_rows.device)

    def get_rows(self, row_idxs) -> torch.Tensor:
        """(len(row_idxs), m) rows of the approximation."""
        return _mm(self.latent_rows[self._ids(row_idxs), :], self.latent_cols)

    def get_cols(self, col_idxs) -> torch.Tensor:
        """(n, len(col_idxs)) columns of the approximation."""
        return _mm(self.latent_rows, self.latent_cols[:, self._ids(col_idxs)])

    def get(self, row_idxs, col_idxs) -> torch.Tensor:
        """The (len(row_idxs), len(col_idxs)) block of the approximation."""
        return _mm(self.latent_rows[self._ids(row_idxs), :], self.latent_cols[:, self._ids(col_idxs)])

    def get_complete_row(self, sparse_rows: torch.Tensor) -> torch.Tensor:
        """(q, k_c) exact scores of new queries against the anchor items ->
        (q, m) approximate scores against all items ('rows' only)."""
        if self.approx_preference != "rows":
            raise ValueError("get_complete_row requires an index built with approx_preference='rows'")
        return _mm(_as_f32(sparse_rows, self.latent_cols.device), self.latent_cols)

    def get_complete_col(self, sparse_cols: torch.Tensor) -> torch.Tensor:
        """Dual: (k_r, c) exact scores of the anchor queries against new
        items -> (n, c) approximate scores of every query ('cols' only;
        reference: matrix_approx_zeshel.py:88-98)."""
        if self.approx_preference != "cols":
            raise ValueError("get_complete_col requires an index built with approx_preference='cols'")
        return _mm(self.latent_rows, _as_f32(sparse_cols, self.latent_rows.device))

    def topk_in_row(self, sparse_rows: torch.Tensor, k: int):
        """(scores, indices) of the approximate top-k items for new queries."""
        return topk_stable(self.get_complete_row(sparse_rows), k)

    def topk_in_col(self, sparse_cols: torch.Tensor, k: int):
        """(scores, indices) of the approximate top-k queries for new items,
        one row per item."""
        return topk_stable(self.get_complete_col(sparse_cols).T, k)


def _as_f32(x, device) -> torch.Tensor:
    if torch.is_tensor(x):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def _as_long(x, device) -> torch.Tensor:
    if torch.is_tensor(x):
        return x.to(device=device, dtype=torch.long)
    return torch.as_tensor(np.asarray(x, np.int64), device=device)


def build_cur(
    rows,  # R: (k_r, m) anchor-query scores against all items
    cols,  # C: (n, k_c) all-query scores against anchor items
    row_idxs,
    col_idxs,
    approx_preference: str = "rows",
    full_matrix=None,  # oracle-U (reference :46-47)
    rcond=None,
    validate: bool = True,
    pinv_impl: str = "auto",
    return_u: bool = False,
    device: Optional[DeviceLike] = None,
):
    """Build a CUR index from anchor rows/cols of the score matrix.

    Inputs are numpy arrays or tensors; the index lives on ``device``
    (default: ``rows``'s device if it is a tensor, else the card; raises
    without CUDA unless ``device="cpu"``).

    ``pinv_impl``: 'f64_host' (numpy float64 LAPACK, the reference's
    numerics; 'auto' picks it) or 'f32' (torch on ``device``).
    ``rcond``: a float cutoff, None (f32-eps relative), 'noise'
    (Gavish-Donoho, ``ops/pinv.py::noise_rcond``) or 'auto' (noise cutoff
    only for ill-conditioned matrices, ``ops/pinv.py::auto_rcond``).
    ``full_matrix`` gives the oracle ``U = pinv(C) @ A @ pinv(R)``.
    ``return_u`` also returns U (incremental item addition needs it)."""
    if device is None:
        device = rows.device if torch.is_tensor(rows) else "cuda"
    device = resolve_device(device)
    rows = _as_f32(rows, device)
    cols = _as_f32(cols, device)
    row_idxs = _as_long(row_idxs, device)
    col_idxs = _as_long(col_idxs, device)

    if rows.shape[0] != row_idxs.shape[0]:
        raise ValueError(f"rows {tuple(rows.shape)} vs row_idxs {tuple(row_idxs.shape)}")
    if cols.shape[1] != col_idxs.shape[0]:
        raise ValueError(f"cols {tuple(cols.shape)} vs col_idxs {tuple(col_idxs.shape)}")
    if validate and not torch.allclose(cols[row_idxs, :], rows[:, col_idxs], atol=1e-4):
        # anchor intersection consistency (reference assertion at :44)
        raise ValueError("rows/cols intersection mismatch: R[:, col_idxs] != C[row_idxs, :]")

    if isinstance(rcond, str):
        if rcond not in ("noise", "auto"):
            raise ValueError(f"rcond={rcond!r} not in (None, float, 'noise', 'auto')")
        # one threshold per inverted matrix: the oracle branch inverts
        # both C and R, whose spectra differ
        fn = noise_rcond if rcond == "noise" else auto_rcond
        _rcond = lambda m: fn(m.cpu().numpy())  # noqa: E731
    else:
        _rcond = lambda m: rcond  # noqa: E731
    if pinv_impl in ("auto", "f64_host"):
        _pinv = lambda m: torch.as_tensor(  # noqa: E731
            pinv_f64(m.cpu().numpy(), _rcond(m)).astype(np.float32), device=device
        )
    elif pinv_impl == "f32":
        _pinv = lambda m: pinv(m, _rcond(m))  # noqa: E731
    else:
        raise ValueError(f"pinv_impl={pinv_impl!r} not in ('auto','f32','f64_host')")

    if full_matrix is not None:
        full_matrix = _as_f32(full_matrix, device)
        u = _mm(_mm(_pinv(cols), full_matrix), _pinv(rows))  # (k_c, k_r)
    else:
        u = _pinv(cols[row_idxs, :])  # (k_c, k_r)

    if approx_preference == "rows":
        latent_rows, latent_cols = cols, _mm(u, rows)
    elif approx_preference == "cols":
        latent_rows, latent_cols = _mm(cols, u), rows
    else:
        raise ValueError(f"approx_preference={approx_preference!r} not in ('rows','cols')")
    index = CurIndex(latent_rows, latent_cols, row_idxs, col_idxs, approx_preference)
    return (index, u) if return_u else index


def save_cur_index(path: str, index: CurIndex) -> None:
    """Persist the latent factors + anchor ids as a numpy pickle, the
    format of ``anncur_tpu.core.cur.save_cur_index``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as fout:
        pickle.dump(
            {
                "latent_rows": index.latent_rows.cpu().numpy(),
                "latent_cols": index.latent_cols.cpu().numpy(),
                "row_idxs": index.row_idxs.cpu().numpy().astype(np.int32),
                "col_idxs": index.col_idxs.cpu().numpy().astype(np.int32),
                "approx_preference": index.approx_preference,
                "format_version": 1,
            },
            fout,
        )


def load_cur_index(path: str, device: DeviceLike = "cuda") -> CurIndex:
    """The index saved at ``path``, on ``device`` (raises without CUDA
    unless ``device="cpu"``)."""
    dev = resolve_device(device)
    with open(path, "rb") as fin:
        d = pickle.load(fin)
    return CurIndex(
        latent_rows=torch.as_tensor(np.asarray(d["latent_rows"], np.float32), device=dev),
        latent_cols=torch.as_tensor(np.asarray(d["latent_cols"], np.float32), device=dev),
        row_idxs=torch.as_tensor(np.asarray(d["row_idxs"]), device=dev).long(),
        col_idxs=torch.as_tensor(np.asarray(d["col_idxs"]), device=dev).long(),
        approx_preference=d["approx_preference"],
    )


def build_cur_from_matrix(
    matrix,
    row_idxs,
    col_idxs,
    approx_preference: str = "rows",
    oracle: bool = False,
    rcond=None,
    pinv_impl: str = "auto",
    device: Optional[DeviceLike] = None,
) -> CurIndex:
    """Slice the anchor rows and columns out of a dense matrix and build
    (``oracle`` passes the whole matrix as ``full_matrix``). The index lives
    on ``device`` (default: ``matrix``'s device if it is a tensor, else the
    card)."""
    if device is None:
        device = matrix.device if torch.is_tensor(matrix) else "cuda"
    device = resolve_device(device)
    matrix = _as_f32(matrix, device)
    row_idxs = _as_long(row_idxs, device)
    col_idxs = _as_long(col_idxs, device)
    return build_cur(
        rows=matrix[row_idxs, :],
        cols=matrix[:, col_idxs],
        row_idxs=row_idxs,
        col_idxs=col_idxs,
        approx_preference=approx_preference,
        full_matrix=matrix if oracle else None,
        rcond=rcond,
        validate=False,
        pinv_impl=pinv_impl,
        device=device,
    )
