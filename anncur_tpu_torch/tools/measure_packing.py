"""Entity-length bucketing of the score-matrix build, measured.

Counterpart of ``tools/measure_packing.py``. Entity corpora under three
length regimes (``full``: every entity at le; ``mixed``: half of them
truncated short descriptions; ``short``: four in five short), and for
each: the padding ratio of the entity axis, and the pairs/s of
``ScoreMatrixBuilder`` (a) with every entity padded to le = 128 and (b)
bucketed, entities grouped by length into le in {32, 64, 96, 128}, one
build per bucket, the columns scattered back. Bucketing drops only
padding, which the attention masks, so the bucketed scores must equal
the padded ones (``max_abs_err_over_std``).

JAX measured bucketing slower (0.59x and 0.69x,
``benchmarks/packing_measurement.json``), since each bucket was a program
of its own. The port compiles nothing per shape; what the card shows is
recorded. The tool only measures: the builder has no bucketed mode.

    python -m anncur_tpu_torch.tools.measure_packing [--n_ments 32]
    python -m anncur_tpu_torch.tools.measure_packing --quick

The full run is bert-base in bf16 (random weights from seed 0) over 32 x
2,048 pairs of 128-token mentions and entities on the card; ``--quick``
is JAX's quick shape (a tiny f32 CE, 8 x 256 pairs of 32 tokens, buckets
8, 16, 24, 32) on the CPU. Writes
``results/torch/packing_measurement[_quick].json``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from anncur_tpu_torch.indexer.score_matrix import ScoreMatrixBuilder
from anncur_tpu_torch.models.bert import BertSpec
from anncur_tpu_torch.models.crossencoder import CrossEncoder
from anncur_tpu_torch.tools import _common
from anncur_tpu_torch.utils.device import resolve_device

REGIMES = ("full", "mixed", "short")


def synth_lengths(regime: str, n: int, le: int, rng) -> np.ndarray:
    """Entity token lengths (CLS and SEP included) under a regime."""
    if regime == "full":
        return np.full(n, le, np.int32)
    if regime == "mixed":  # half full documents, half truncated short descriptions
        return _mix(rng, n, le, rng.integers(8, le, size=n), 0.5)
    if regime == "short":  # a title and one sentence dominate
        return _mix(rng, n, le, rng.integers(8, le // 2, size=n), 0.8)
    raise ValueError(regime)


def _mix(rng, n, le, short, frac_short):
    """``short`` where a uniform draw falls below ``frac_short``, else le
    (the draws in JAX's order: the short lengths, then the uniforms)."""
    return np.where(rng.random(n) < frac_short, short, np.full(n, le)).astype(np.int32)


def bucket_of(lengths, buckets):
    """{bucket: entity indices}: each entity in the smallest bucket that
    holds its length."""
    order = {}
    for i, n in enumerate(lengths):
        order.setdefault(min(b for b in buckets if b >= n), []).append(i)
    return order


def measure(builder, ment_toks, ent_toks, lengths, buckets, device):
    """One regime: the padded build, then the bucketed one, each after a
    warm-up of one block of its shapes (handles and kernel loads: the port
    compiles nothing per shape, where JAX compiled each shape first);
    returns (padded scores, bucketed scores, padded seconds, bucketed
    seconds, buckets)."""
    bm, be = builder.ment_block, builder.ent_block
    builder(ment_toks[:bm], ent_toks[:be])
    _common.sync(device)
    t0 = time.perf_counter()
    padded = builder(ment_toks, ent_toks)
    _common.sync(device)
    padded_s = time.perf_counter() - t0

    order = bucket_of(lengths, buckets)
    for b, idxs in sorted(order.items()):
        builder(ment_toks[:bm], ent_toks[idxs[:be]][:, :b])
    _common.sync(device)
    t0 = time.perf_counter()
    bucketed = np.zeros_like(padded)
    for b, idxs in sorted(order.items()):
        bucketed[:, idxs] = builder(ment_toks, ent_toks[idxs][:, :b])
    _common.sync(device)
    return padded, bucketed, padded_s, time.perf_counter() - t0, order


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--quick", action="store_true", help="JAX's quick shapes on the CPU")
    ap.add_argument("--n_ments", type=int, default=None, help="mentions per regime (32; 8 with --quick)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.quick else args.device)
    out_path = args.out or os.path.join(
        _common.RESULTS_DIR, "packing_measurement_quick.json" if args.quick else "packing_measurement.json")
    if args.quick:
        spec, lm, n_ments, n_ents, buckets = BertSpec.tiny(vocab_size=512), 32, 8, 256, (8, 16, 24, 32)
        dtype, blocks = torch.float32, dict(ment_block=4, ent_block=8, pair_pad_multiple=16)
    else:
        spec, lm, n_ments, n_ents, buckets = BertSpec(), 128, 32, 2048, (32, 64, 96, 128)
        dtype, blocks = torch.bfloat16, dict(ment_block=32, ent_block=64, pair_pad_multiple=32)
    n_ments = args.n_ments or n_ments
    blocks["ment_block"] = min(blocks["ment_block"], n_ments)
    le = lm
    rng = np.random.default_rng(0)
    ce = CrossEncoder(spec, compute_dtype=dtype, device=device, seed=0)
    builder = ScoreMatrixBuilder(ce, device=device, **blocks)
    ment_toks = rng.integers(1, spec.vocab_size, size=(n_ments, lm)).astype(np.int32)

    out = {"device": _common.card(device), "dtype": str(dtype).replace("torch.", ""), "buckets": list(buckets),
           "shape": {"n_ments": n_ments, "n_ents": n_ents, "le": le}, "compile_per_shape": "none", "regimes": {}}
    for regime in REGIMES:
        lengths = synth_lengths(regime, n_ents, le, rng)
        ent_toks = np.zeros((n_ents, le), np.int32)
        for i, n in enumerate(lengths):
            ent_toks[i, :n] = rng.integers(1, spec.vocab_size, size=n)
        padded, bucketed, padded_s, bucketed_s, order = measure(builder, ment_toks, ent_toks, lengths, buckets, device)
        err = float(np.abs(padded - bucketed).max())
        out["regimes"][regime] = {
            "padding_ratio": float(1.0 - lengths.sum() / (n_ents * le)),
            "bucket_sizes": {str(b): len(i) for b, i in sorted(order.items())},
            "padded_pairs_per_s": n_ments * n_ents / padded_s,
            "bucketed_pairs_per_s": n_ments * n_ents / bucketed_s,
            "bucketed_speedup": padded_s / bucketed_s,
            "max_abs_err": err,
            "max_abs_err_over_std": err / float(np.abs(padded).std() + 1e-9),
        }
        print(json.dumps({regime: out["regimes"][regime]}), flush=True)
    _common.write_json(out_path, out)
    return out


if __name__ == "__main__":
    main()
