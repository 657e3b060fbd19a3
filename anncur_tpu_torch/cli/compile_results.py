"""Compile per-method eval results into comparison tables + plots.

A copy of ``anncur_tpu/cli/compile_results.py`` over the port's
``evalx/aggregate.py`` and ``evalx/plots.py``: the same flags and output
files. It touches no tensors, so it takes no ``--device``; it needs
``matplotlib`` (through ``evalx/plots.py``).

Parity with eval/compile_emnlp_retrieval_eval_wrt_exact_crossenc.py:
flattens per-method res.json files into one combined key-value JSON,
pivots recall-vs-cost tables per top_k (cost = top_k_retvr +
n_ent_anchors for CUR-family methods, :247-258), emits CSVs and the
RQ1/RQ2-style recall-vs-cost plot.
"""

from __future__ import annotations

import argparse
import glob
import json
import logging
import os

import numpy as np

from anncur_tpu_torch.evalx.aggregate import (
    best_recall_at_cost,
    combine_result_files,
    compile_rqs,
    recall_vs_cost_table,
    write_csv,
)
from anncur_tpu_torch.evalx.plots import plot_ce_baselines_from_pivot, plot_recall_vs_cost

LOGGER = logging.getLogger("anncur_tpu_torch.compile_results")


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--res_dir", required=True, help="dir containing method=*_s=* subdirs")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--top_k_vals", nargs="+", type=int, default=[1, 10, 50, 100])
    p.add_argument(
        "--nm_train",
        type=int,
        default=0,
        help="anchor/train-mention count tag for the RQ pivot keys",
    )
    p.add_argument(
        "--no_rq_pivots",
        action="store_true",
        help="skip the per-RQ pivot CSVs / RQ5-RQ6 plots",
    )
    p.add_argument(
        "--style",
        choices=["default", "paper"],
        default="default",
        help="'paper' applies the reference's paper-figure styling "
        "(method display names/colors, fonts, legend layout; "
        "evalx/paper_style.py)",
    )
    p.add_argument(
        "--latex",
        action="store_true",
        help="with --style paper: emit the reference's literal LaTeX "
        "labels (requires a TeX install)",
    )
    args = p.parse_args(argv)

    os.makedirs(args.out_dir, exist_ok=True)
    combine_result_files(
        os.path.join(args.res_dir, "method=*", "res.json"),
        os.path.join(args.out_dir, "combined.json"),
    )

    method_dirs = sorted(glob.glob(os.path.join(args.res_dir, "method=*")))
    for top_k in args.top_k_vals:
        # seed-average the recall-vs-cost rows per method: keeping the
        # last-seen seed dir made these CSVs single-seed while the RQ
        # pivots below average — the two outputs disagreed
        method_seed_rows = {}
        for d in method_dirs:
            method = os.path.basename(d).split("=", 1)[1].split("_s=")[0]
            path = os.path.join(d, "res.json")
            if not os.path.exists(path):
                continue
            with open(path) as fin:
                res = json.load(fin)
            rows = recall_vs_cost_table(res, method, top_k)
            if rows:
                method_seed_rows.setdefault(method, []).append(rows)
        method_rows = {}
        for method, seed_rows in method_seed_rows.items():
            by_key = {}
            for rows in seed_rows:
                for row in rows:
                    key = tuple(sorted((k, v) for k, v in row.items() if k != "recall"))
                    by_key.setdefault(key, []).append(row)
            rows = []
            for grouped in by_key.values():
                row = dict(grouped[0])
                row["recall"] = float(np.mean([g["recall"] for g in grouped]))
                rows.append(row)
            method_rows[method] = rows
            write_csv(rows, os.path.join(args.out_dir, f"recall_vs_cost_{method}_k{top_k}.csv"))
        if method_rows:
            plot_recall_vs_cost(
                method_rows,
                os.path.join(args.out_dir, f"recall_vs_cost_k{top_k}.pdf"),
                top_k=top_k,
                style=args.style,
                latex=args.latex,
            )
            # equal-cost comparison (reference compile equal-cost mode,
            # compile_...py:247-258): best recall per method within each
            # CE-call budget
            eq_rows = []
            for budget in (64, 100, 200, 500, 1000):
                row = {"cost_budget": budget}
                for method, rows in method_rows.items():
                    best = best_recall_at_cost(rows, budget)
                    row[method] = round(best["recall"], 4) if best else ""
                eq_rows.append(row)
            write_csv(eq_rows, os.path.join(args.out_dir, f"equal_cost_k{top_k}.csv"))

    if not args.no_rq_pivots:
        # generic per-RQ pivots (reference process_res_for_rq,
        # compile_...py:219-277) + RQ5/RQ6 CE-only-baseline plots
        # collect ALL seeds per method and average numeric leaves —
        # keeping only the last-seen seed silently reported single-seed
        # numbers for a multi-seed sweep (the reference pipeline
        # seed-averages before compiling)
        per_method_seeds = {}
        for d in method_dirs:
            path = os.path.join(d, "res.json")
            if not os.path.exists(path):
                continue
            method = os.path.basename(d).split("=", 1)[1].split("_s=")[0]
            with open(path) as fin:
                per_method_seeds.setdefault(method, []).append(json.load(fin))

        def _avg_trees(trees):
            if isinstance(trees[0], dict):
                return {
                    k: _avg_trees([t[k] for t in trees if k in t])
                    for k in trees[0]
                }
            try:
                return float(sum(float(t) for t in trees) / len(trees))
            except (TypeError, ValueError):
                return trees[0]

        per_method = {m: _avg_trees(ts) for m, ts in per_method_seeds.items()}
        if per_method:
            csvs_by_rq = compile_rqs(per_method, args.nm_train, args.out_dir)
            rq_x = {
                "RQ2_Model_Performance_At_Equal_Test_Cost": ("cost", "RQ5"),
                "RQ1_Model_Performance_At_Equal_Num_Retrieved": ("top_k_retvr", "RQ6"),
            }
            for rq_name, csvs in csvs_by_rq.items():
                if rq_name not in rq_x:
                    continue
                x_prefix, tag = rq_x[rq_name]
                for csv_path in csvs:
                    base = os.path.splitext(os.path.basename(csv_path))[0]
                    plot_ce_baselines_from_pivot(
                        csv_path,
                        os.path.join(
                            args.out_dir, "plots", tag, f"{tag}_ce_baselines_{base}.pdf"
                        ),
                        x_prefix=x_prefix,
                        style=args.style,
                        latex=args.latex,
                    )
    LOGGER.info("compiled results -> %s", args.out_dir)


if __name__ == "__main__":
    main()
