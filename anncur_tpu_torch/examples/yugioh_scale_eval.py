"""BASELINE config #1 at full scale: the transductive CUR eval on a
yugioh-sized (3,374 x 10,031) score matrix.

Counterpart of ``examples/yugioh_scale_eval.py``. The matrix is
synthetic, rank 200 plus noise (ZeShEL and trained checkpoints are not
in the repo); the point is the harness at the reference's scale and
sweep grid: CUR at n_ment_anchors x n_ent_anchors in {50, 100, 200, 500,
1000, 2000}^2, top-k 10, k_retvr 500, one seed
(``evalx.transductive.run_transductive_eval``); then ``cur_oracle``
against ``cur`` at (500, 500); then the heat map of the grid's
non-anchor recall. The heat map needs matplotlib: where it is not
installed the example says it drew none and still completes (plotting is
not the device path).

    python -m anncur_tpu_torch.examples.yugioh_scale_eval [out_dir] [--device cpu] [--grid 100 500]

``--grid`` replaces the anchor counts of both axes (a 2 x 2 grid with two
values). Writes ``retrieval_wrt_exact_crossenc.json`` (the harness's
schema) and ``yugioh_scale_eval.json`` (times and headline recalls) into
``out_dir`` (default ``results/torch/yugioh_scale_eval``).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from anncur_tpu_torch.evalx.transductive import run_approx_eval_w_seed, run_transductive_eval
from anncur_tpu_torch.tools import _common
from anncur_tpu_torch.utils.device import resolve_device

N_MENTS, N_ENTS, RANK = 3374, 10031, 200
GRID = (50, 100, 200, 500, 1000, 2000)
RECALL = "exact_vs_reranked_approx_retvr~common_frac_mean"


def make_matrix(n_ments=N_MENTS, n_ents=N_ENTS, rank=RANK, seed=0):
    """The example's rank-``rank`` matrix plus 0.05 noise, drawn as JAX's."""
    rng = np.random.default_rng(seed)
    mat = (rng.standard_normal((n_ments, rank)) @ rng.standard_normal((rank, n_ents))).astype(np.float32)
    mat += 0.05 * rng.standard_normal(mat.shape).astype(np.float32)
    return mat


def sweep(mat, out_dir, grid=GRID, device="cuda"):
    """The CUR grid at top-k 10, k_retvr 500, one seed: the harness's
    result tree and the seconds it took."""
    t0 = time.time()
    res = run_transductive_eval(
        mat, out_dir, methods=("cur",), n_seeds=1, n_ment_anchors_vals=list(grid), n_ent_anchors_vals=list(grid),
        top_k_vals=[10], top_k_retvr_vals=[500], device=device,
    )
    _common.sync(device)
    return res, time.time() - t0


def heat_map(res, out_dir):
    """The grid's heat map file, or None where matplotlib is missing."""
    try:
        from anncur_tpu_torch.evalx.plots import heat_map_from_transductive
    except ImportError as err:
        print(f"heat map: not drawn ({err}); plotting is not the device path", flush=True)
        return None
    return heat_map_from_transductive(res, "cur", 10, 500, out_dir)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("out_dir", nargs="?", default=os.path.join(_common.RESULTS_DIR, "yugioh_scale_eval"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--grid", type=int, nargs="+", default=list(GRID), help="anchor counts of both axes")
    ap.add_argument("--oracle_point", type=int, nargs=2, default=[500, 500], metavar=("M", "E"))
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    print(f"device: {_common.card(device)}")
    print(f"synthesizing {N_MENTS}x{N_ENTS} rank-{RANK} score matrix...", flush=True)
    mat = make_matrix(N_MENTS, N_ENTS, RANK)

    res, dt = sweep(mat, args.out_dir, args.grid, device)
    n_points = sum(1 for k in res["cur"] for r in res["cur"][k] for _ in res["cur"][k][r])
    print(f"full cur sweep: {n_points} grid points x 1 seed in {dt:.1f}s ({dt / max(n_points, 1):.2f}s per "
          "evaluation)", flush=True)
    summary = {"device": _common.card(device), "shape": [N_MENTS, N_ENTS], "rank": RANK, "grid": args.grid,
               "n_points": n_points, "sweep_s": dt, "s_per_point": dt / max(n_points, 1)}

    # the oracle's upper bound at one grid point (its full-matrix f64 pinv
    # is the dominant cost, as in the reference)
    m, e = args.oracle_point
    t0 = time.time()
    oracle = run_approx_eval_w_seed("cur_oracle", mat, m, e, 10, 500, seed=0, device=device)
    plain = run_approx_eval_w_seed("cur", mat, m, e, 10, 500, seed=0, device=device)
    _common.sync(device)
    summary["oracle_point"] = {"anchors": [m, e], "cur_oracle_recall": oracle["all"][RECALL],
                               "cur_recall": plain["all"][RECALL], "seconds": time.time() - t0}
    print(f"oracle vs cur @ ({m},{e}): recall {100 * oracle['all'][RECALL]:.2f}% vs {100 * plain['all'][RECALL]:.2f}% "
          f"({summary['oracle_point']['seconds']:.1f}s)", flush=True)

    node = res["cur"]["top_k=10"]["k_retvr=500"]
    summary["points"] = {}
    for key, r in node.items():
        summary["points"][key] = {"non_anchor_recall": r["non_anchor"][RECALL],
                                  "rel_frob": r["non_anchor"]["approx_error_relative"]}
    for key in ("anc_n_m=500~anc_n_e=500", "anc_n_m=2000~anc_n_e=2000"):
        if key in node:
            p = summary["points"][key]
            print(f"  cur {key}: non-anchor recall@10={100 * p['non_anchor_recall']:.2f}%  "
                  f"rel.frob={p['rel_frob']:.4f}")
    summary["heat_map"] = heat_map(res, args.out_dir)
    if summary["heat_map"]:
        print(f"heat map: {summary['heat_map']}")
    _common.write_json(os.path.join(args.out_dir, "yugioh_scale_eval.json"), summary)
    return summary


if __name__ == "__main__":
    main()
