"""Exact maximum-inner-product search (MIPS), plain PyTorch.

Counterpart of ``anncur_tpu/ops/mips.py``. The top-k is a STABLE
descending sort of an order-preserving integer key of the scores:
``torch.topk`` does not promise the lowest-index tie-break that
``lax.top_k`` gives, and a float sort ties -0.0 with +0.0 where
``lax.top_k`` ranks +0.0 above -0.0. This module is also the plain
version of kernel B (``ops/mips_kernel.py``), of its int8 entry too.
:func:`mips_topk_sharded` is the search over items sharded on a mesh:
kernel B on each rank's shard, then the candidates merged.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from anncur_tpu_torch.parallel.mesh import all_gather_cat

# "Excluded" score fill, as anncur_tpu/ops/mips.py::NEG_INF: never selected
# by a top-k over real scores, and representable in float32.
NEG_INF = -1e30

# float dtype -> (integer view of its bits, mask of every bit but the sign)
_KEY_VIEW = {
    torch.float32: (torch.int32, 0x7FFFFFFF),
    torch.float64: (torch.int64, 0x7FFFFFFFFFFFFFFF),
    torch.float16: (torch.int16, 0x7FFF),
    torch.bfloat16: (torch.int16, 0x7FFF),
}


def order_key(scores: torch.Tensor) -> torch.Tensor:
    """Signed integer keys in the order ``lax.top_k`` ranks floats: the
    IEEE bits, with the magnitude bits of negative values flipped. So
    +0.0 ranks above -0.0, and -inf below every finite value."""
    view = _KEY_VIEW.get(scores.dtype)
    if view is None:  # integer scores order as they are
        return scores
    itype, mag = view
    bits = scores.contiguous().view(itype)
    return torch.where(bits < 0, bits ^ mag, bits)


def _topk_of_keys(scores, keys, k):
    _, idx = torch.sort(keys, dim=-1, descending=True, stable=True)
    idx = idx[..., :k]
    return torch.gather(scores, -1, idx), idx


def topk_stable(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, int64 indices) of the k largest entries along the last
    axis, descending, ties to the lowest index, +0.0 above -0.0
    (``lax.top_k``'s order)."""
    return _topk_of_keys(scores, order_key(scores), k)


def masked_topk(
    scores: torch.Tensor,  # (q, n)
    k: int,
    valid: Optional[torch.Tensor] = None,  # (n,) or (q, n) bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """top-k over scores with invalid positions filled with ``NEG_INF``,
    as ``anncur_tpu.ops.mips.masked_topk``."""
    if valid is not None:
        scores = torch.where(valid, scores, torch.tensor(NEG_INF, dtype=scores.dtype, device=scores.device))
    return topk_stable(scores, k)


def check_exclude(exclude: Optional[torch.Tensor], q: int, k: int, n_valid: int) -> int:
    """Entries per row of an exclusion list (0 for None); raises unless it
    is an integer (q, S) tensor with k <= n_valid - S, which leaves every
    row k candidates whatever the list holds."""
    if exclude is None:
        return 0
    if exclude.dim() != 2 or exclude.shape[0] != q or exclude.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"exclude must be an int32/int64 ({q}, S) tensor, got {exclude.dtype} {tuple(exclude.shape)}")
    n_ex = exclude.shape[1]
    if k > n_valid - n_ex:
        raise ValueError(f"exclusions leave fewer than k candidates: k={k} > n_valid - S = {n_valid} - {n_ex}")
    return n_ex


def pad_items(items: torch.Tensor, multiple: int) -> Tuple[torch.Tensor, int]:
    """(items zero-padded on the row axis to a multiple of ``multiple``,
    n_valid = the original row count), as ``anncur_tpu.ops.mips.pad_items``."""
    n = items.shape[0]
    rem = (-n) % multiple
    if rem:
        items = torch.cat([items, items.new_zeros((rem,) + tuple(items.shape[1:]))])
    return items, n


def mips_topk(
    queries: torch.Tensor,  # (q, d) f32
    items: torch.Tensor,  # (n, d) f32
    k: int,
    n_valid: Optional[int] = None,
    exclude: Optional[torch.Tensor] = None,  # (q, S) int ids per query
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact MIPS: scores = Q @ Iᵀ in f32, top-k per query over the first
    ``n_valid`` items (default: all), never an id of that query's row of
    ``exclude``: :func:`select_topk` of the scores."""
    return select_topk(queries.float() @ items.float().T, k, n_valid, exclude)


def mips_topk_int8_plain(
    queries: torch.Tensor,  # (q, d) f32
    items,  # ops/quantized.py::QuantizedItems: values (n, d) int8, scales (n, 1) f32
    k: int,
    n_valid: Optional[int] = None,
    exclude: Optional[torch.Tensor] = None,  # (q, S) int ids per query
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of kernel B's int8 entry: (queries @ values^T in
    f32) x scale, then :func:`select_topk` (lax.top_k's order, padded and
    excluded columns never taken)."""
    scores = (queries.float() @ items.values.float().T) * items.scales[:, 0].float()
    return select_topk(scores, k, n_valid, exclude)


def select_topk(
    scores: torch.Tensor,  # (q, n) f32
    k: int,
    n_valid: Optional[int] = None,
    exclude: Optional[torch.Tensor] = None,  # (q, S) int ids per query
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k per row over the first ``n_valid`` columns (default: all),
    never an id of that row's ``exclude`` list. Entries of ``exclude``
    outside [0, n_valid) are ignored and duplicates are allowed; the caller
    keeps k <= n_valid - S. Padded and excluded columns rank below every
    real score, so this equals JAX's ``approx.at[rows, ids].set(-inf)`` +
    ``lax.top_k`` whenever that one does not run out of candidates."""
    n = scores.shape[1]
    n_valid = n if n_valid is None else int(n_valid)
    if not 1 <= k <= n_valid <= n:
        raise ValueError(f"mips_topk needs 1 <= k <= n_valid <= n, got k={k} n_valid={n_valid} n={n}")
    check_exclude(exclude, scores.shape[0], k, n_valid)
    if n_valid == n and exclude is None:
        return topk_stable(scores, k)
    # below every int32 key: never selected while k real candidates remain
    keys = order_key(scores).long()
    keys[:, n_valid:] = -(1 << 32)
    if exclude is not None:
        ex = exclude.to(device=scores.device, dtype=torch.long)
        ex = torch.where((ex >= 0) & (ex < n_valid), ex, n)  # ignored -> a spare column
        keys = torch.cat([keys, keys.new_zeros((keys.shape[0], 1))], dim=1)
        keys.scatter_(1, ex, -(1 << 32))
        keys = keys[:, :n]
    return _topk_of_keys(scores, keys, k)


def mips_topk_sharded(
    queries: torch.Tensor,  # (q, d) f32, the same on every rank
    items: torch.Tensor,  # (n, d), n divisible by the mesh axis (pad_items first)
    k: int,
    mesh,
    axis: str = "data",
    n_valid: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mesh-sharded exact MIPS (``anncur_tpu.ops.mips.mips_topk_sharded``):
    each rank of ``axis`` searches its contiguous shard of ``items`` and
    every rank returns the global (scores (q, k), ids (q, k)), ties to the
    lowest global id. Every rank calls it with the same arguments.
    ``n_valid``: the number of real items (the rest are padding rows)."""
    n_items = items.shape[0]
    n_dev = mesh.shape[axis]
    if n_items % n_dev != 0:
        raise ValueError(
            f"items count {n_items} must be divisible by mesh axis {axis}={n_dev}; "
            "pad with pad_items() first"
        )
    shard = n_items // n_dev
    base = mesh.coords[axis] * shard
    n_valid = n_items if n_valid is None else int(n_valid)
    return topk_of_shards(queries, items[base: base + shard], k, mesh, axis, base, n_valid)


def topk_of_shards(
    queries: torch.Tensor,
    shard_items: torch.Tensor,  # (shard, d): this rank's rows, global ids base..base+shard-1
    k: int,
    mesh,
    axis: str,
    base: int,
    n_valid: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The global top-k from each rank's shard: kernel B over the shard's
    valid rows (``ops/mips_kernel.py``, the plain version on CPU tensors),
    ids offset by ``base``; a shard short of candidates fills its list with
    its padded rows at ``NEG_INF``, as JAX's masked columns. The (q,
    n_dev * k_local) candidates are all-gathered in rank order and the
    global top-k taken with :func:`topk_stable`: equal scores keep rank,
    then id, order, so ties go to the lowest global id."""
    from anncur_tpu_torch.ops.mips_kernel import mips_topk_fused

    q, shard = queries.shape[0], shard_items.shape[0]
    k_local = min(k, shard)
    valid = min(max(n_valid - base, 0), shard)
    take = min(k_local, valid)
    dev = queries.device
    s = torch.full((q, k_local), NEG_INF, dtype=torch.float32, device=dev)
    i = (base + torch.arange(k_local, device=dev)).expand(q, k_local).clone()
    if take:
        s_t, i_t = mips_topk_fused(queries, shard_items, take, valid)
        s[:, :take], i[:, :take] = s_t, i_t + base
    i[:, take:] = base + valid + torch.arange(k_local - take, device=dev)
    s_all = all_gather_cat(s, mesh, axis, dim=1)
    i_all = all_gather_cat(i, mesh, axis, dim=1)
    s_fin, j = topk_stable(s_all, k)
    return s_fin, torch.gather(i_all, 1, j)
