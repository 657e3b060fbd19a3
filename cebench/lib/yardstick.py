"""The yardstick's arithmetic: the card's peaks, a kernel launch's bytes
and operations, a sequence's model FLOPs, and the statistics of a window.

Peaks are NVIDIA's data-sheet figures for one H100 SXM (dense, 700 W).
A launch's bound is the least time the card could take for what its
inputs need: max(bytes / HBM bandwidth, operations / peak).
"""

from __future__ import annotations

import math
import statistics
from typing import Iterable, List, Optional, Sequence, Tuple

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12}
# the peak every model-FLOP share is taken against
MFU_PEAK = PEAK_OPS["bf16"]


def bound_s(nbytes: float, ops: float, peak: float = PEAK_OPS["bf16"]) -> float:
    """The least seconds a launch can take: bytes at HBM bandwidth or
    operations at ``peak``, whichever is slower."""
    return max(nbytes / HBM_BYTES_PER_S, ops / peak)


def attention_cost(b: int, g: int, s: int, nh: int, hd: int, n_keys: int, elem_bytes: int) -> Tuple[float, float]:
    """(bytes, operations) that one kernel A launch needs: q read and the
    output written whole, k and v at the ``n_keys`` valid keys only (summed
    over the batch), the (b, s) bool mask; QKᵀ and PV over valid keys,
    a multiply-add counted as 2 operations."""
    row = nh * hd * elem_bytes
    nbytes = 2 * b * g * row + 2 * n_keys * row + b * s
    ops = 4 * nh * g * n_keys * hd
    return float(nbytes), float(ops)


def mips_cost(q: int, d: int, n_valid: int, k: int, n_excluded: int, item_bytes: int = 4) -> Tuple[float, float]:
    """(bytes, operations) that one kernel B launch needs: the f32 queries,
    the ``n_valid`` real item rows and each query's exclusion list read,
    the (q, k) f32 scores and int64 ids written; 2 q n_valid d operations.
    The operations are counted once, at the bf16 peak, whatever route
    computes them (three TF32 passes on the tensor cores, or an FFMA chain),
    so the share reads the same work whatever implements it."""
    nbytes = 4 * q * d + item_bytes * n_valid * d + 8 * q * n_excluded + q * k * (4 + 8)
    ops = 2 * q * n_valid * d
    return float(nbytes), float(ops)


def encoder_weights(hidden: int, layers: int, ffn: int) -> int:
    """Weights of an encoder's matrix products (q, k, v, out and the two
    MLP matrices of every layer): the non-embedding count that model FLOPs
    are taken over (bert-base: 84,934,656)."""
    return layers * (4 * hidden * hidden + 2 * hidden * ffn)


def seq_flops(hidden: int, layers: int, ffn: int, seq_len: int) -> float:
    """Model FLOPs of one sequence's forward: 2 N L for the weights' products
    and 4 layers L² hidden for QKᵀ and PV (bert-base: 45.9 GFLOP at L = 256,
    22.3 GFLOP at L = 128)."""
    return 2.0 * encoder_weights(hidden, layers, ffn) * seq_len + 4.0 * layers * seq_len * seq_len * hidden


def percentile(values: Sequence[float], pct: float) -> float:
    """The ``pct`` percentile by linear interpolation between order
    statistics (numpy's default), over every value given."""
    xs = sorted(float(v) for v in values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * pct / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate_over_window(units: Iterable[Tuple[float, float, float]], window_start: float, deadline: float) -> Optional[float]:
    """Work per second over a window: ``units`` are (start, end, work) of
    each unit of work; those started before ``deadline`` count whole, and the
    time runs from ``window_start`` to the end of the last of them. None
    when no unit started in time."""
    counted = [(s, e, w) for s, e, w in units if s < deadline]
    if not counted:
        return None
    end = max(e for _, e, _ in counted)
    return sum(w for _, _, w in counted) / (end - window_start)


def spread(values: Sequence[float]) -> float:
    """The distance between the first and third quartiles as a share of
    the median (``statistics.quantiles(values, n=4)``)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


def union_seconds(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: Iterable[Tuple[float, float]], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The (start, end) stretches of [lo, hi] that no interval covers."""
    out, t = [], lo
    for s, e in sorted(intervals):
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]


def group_kernel(name: str) -> str:
    """A device kernel's group by its name (the grouping of the port's
    ``cli/profile_ce.py``)."""
    if "attention_fwd_" in name:
        return "kernel_A_attention"
    if "attention_bwd_dkv_" in name:
        return "kernel_C_attention_bwd_dkv"
    if "attention_bwd_dq_" in name:
        return "kernel_D_attention_bwd_dq"
    if "mips_" in name:  # score, select and sort kernels
        return "kernel_B_mips_topk"
    low = name.lower()
    if any(t in low for t in ("gemm", "xmma", "cutlass", "nvjet", "cublas")):
        return "matmul"
    if "memcpy" in low or "memset" in low:
        return "copy"
    return "other"


def share_pct(num: float, den: float) -> Optional[float]:
    """100 num / den, or None when there is nothing to divide by."""
    if not den or den <= 0 or num is None:
        return None
    return 100.0 * num / den
