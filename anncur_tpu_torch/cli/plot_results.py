"""Render plots from eval result JSONs (heat maps from transductive
results, score-distribution plots from score matrices) — the plot layer
of the reference (utils/plot_emnlp_retrieval_eval_wrt_exact_crossenc.py,
run_retrieval_eval_wrt_exact_crossenc.py:392-510).

A copy of ``anncur_tpu/cli/plot_results.py`` over the port's
``evalx/plots.py``: the same flags and files. It touches no tensors, so
it takes no ``--device``; it needs ``matplotlib``."""

from __future__ import annotations

import argparse
import json
import logging
import os

import numpy as np

from anncur_tpu_torch.evalx.plots import (
    heat_map_from_transductive,
    plot_score_distribution,
    rq7_heatmaps,
)
from anncur_tpu_torch.indexer.score_matrix import load_score_matrix

LOGGER = logging.getLogger("anncur_tpu_torch.plot_results")


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--transductive_json", default="")
    p.add_argument("--score_matrix", default="", help="pickle for score-distribution plot")
    p.add_argument("--out_dir", required=True)
    p.add_argument("--methods", nargs="+", default=["cur", "cur_oracle"])
    p.add_argument("--top_k", type=int, default=10)
    p.add_argument("--top_k_retvr", type=int, default=500)
    p.add_argument("--splits", nargs="+", default=["non_anchor", "all"])
    p.add_argument(
        "--rq7",
        action="store_true",
        help="emit the RQ7 multi-metric family (recall + relative "
        "approx-error heat maps) instead of recall-only maps",
    )
    args = p.parse_args(argv)

    os.makedirs(args.out_dir, exist_ok=True)
    made = []
    if args.transductive_json:
        with open(args.transductive_json) as fin:
            res = json.load(fin)
        if args.rq7:
            made += rq7_heatmaps(
                res,
                args.out_dir,
                methods=args.methods,
                top_k_vals=[args.top_k],
                top_k_retvr_vals=[args.top_k_retvr],
                splits=args.splits,
            )
        else:
            for method in args.methods:
                for split in args.splits:
                    out = heat_map_from_transductive(
                        res, method, args.top_k, args.top_k_retvr, args.out_dir, split=split
                    )
                    if out:
                        made.append(out)
    if args.score_matrix:
        mat = np.asarray(load_score_matrix(args.score_matrix)["ment_to_ent_scores"])
        made.append(
            plot_score_distribution(mat, os.path.join(args.out_dir, "score_distribution.pdf"))
        )
    LOGGER.info("plots: %s", made)


if __name__ == "__main__":
    main()
