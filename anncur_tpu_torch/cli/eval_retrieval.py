"""Retrieval eval CLI: transductive or inductive (fixed-splits) modes.

Counterpart of ``anncur_tpu/cli/eval_retrieval.py`` over the port's
``evalx/transductive.py`` and ``evalx/inductive.py``: the same flags and
result files, plus ``--device`` (the projections and the transductive
grid run there). Parity with
eval/run_retrieval_eval_wrt_exact_crossenc.py:513-559 and
eval/run_retrieval_eval_wrt_exact_crossenc_w_fixed_train_test_splits.py:
510-588, driven off precomputed score-matrix pickles.
"""

from __future__ import annotations

import argparse
import logging

import numpy as np

from anncur_tpu_torch.cli import _common
from anncur_tpu_torch.evalx.inductive import run_inductive_eval
from anncur_tpu_torch.evalx.transductive import run_transductive_eval
from anncur_tpu_torch.indexer.score_matrix import load_score_matrix

LOGGER = logging.getLogger("anncur_tpu_torch.eval_retrieval")


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--mode", choices=["transductive", "inductive"], required=True)
    p.add_argument("--score_matrix", required=True, help="exact CE score-matrix pickle")
    p.add_argument("--train_score_matrix", default="", help="train split pickle (inductive cur)")
    p.add_argument("--res_dir", required=True)
    p.add_argument("--methods", nargs="+", default=["cur", "cur_oracle"])
    p.add_argument("--n_seeds", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--top_k_vals", nargs="+", type=int, default=None)
    p.add_argument("--top_k_retvr_vals", nargs="+", type=int, default=None)
    p.add_argument("--n_ment_anchors_vals", nargs="+", type=int, default=None)
    p.add_argument("--n_ent_anchors_vals", nargs="+", type=int, default=None)
    p.add_argument("--bienc_scores_pkl", default="", help="pickle with (n_m,n_e) bienc score matrix")
    p.add_argument("--ment_file", default="", help="raw mentions (needed for method tfidf)")
    p.add_argument("--ent_file", default="", help="raw entities (needed for method tfidf)")
    p.add_argument("--misc", default="")
    p.add_argument(
        "--rcond", default="",
        help="pinv cutoff for CUR methods: empty = f32-eps default, a float, "
             "'noise' for the Gavish-Donoho adaptive threshold, or 'auto' "
             "(noise threshold only when the anchor intersection is "
             "ill-conditioned — fixes the near-square anchor collapse, "
             "ops/pinv.py::auto_rcond)",
    )
    _common.add_device_arg(p)
    args = p.parse_args(argv)
    device = _common.device_of(args)
    rcond = None
    if args.rcond:
        rcond = args.rcond if args.rcond in ("noise", "auto") else float(args.rcond)

    data = load_score_matrix(args.score_matrix)
    exact = np.asarray(data["ment_to_ent_scores"], np.float32)
    LOGGER.info("loaded exact scores %s", exact.shape)

    bienc_scores = None
    if args.bienc_scores_pkl:
        import pickle

        with open(args.bienc_scores_pkl, "rb") as fin:
            bienc_scores = np.asarray(pickle.load(fin)["scores"], np.float32)

    tfidf_scores = None
    if "tfidf" in args.methods:
        if args.mode == "transductive":
            raise SystemExit(
                "method 'tfidf' is inductive-only (the reference's tfidf "
                "baseline lives in the fixed-splits eval) — it would fail "
                "AFTER the other methods' full sweep otherwise"
            )
        if not (args.ment_file and args.ent_file):
            raise SystemExit("method tfidf requires --ment_file and --ent_file")
        from anncur_tpu_torch.data import load_entities, load_mentions
        from anncur_tpu_torch.data.tfidf import compute_ent_embeds_w_tfidf, compute_ment_embeds_w_tfidf

        kb2local, entities = load_entities(args.ent_file)
        mentions = load_mentions(args.ment_file, kb2local)
        ment_idxs = data.get("arg_dict", {}).get("ment_idxs")
        # full context string, matching the reference tfidf baseline
        # (utils/data_process.py:380, ..._w_fixed_train_test_splits.py:369)
        ment_texts = [
            " ".join([m["context_left"], m["mention"], m["context_right"]])
            for m in mentions
        ]
        if ment_idxs is not None:
            ment_texts = [ment_texts[i] for i in ment_idxs]
        if len(ment_texts) != exact.shape[0]:
            raise SystemExit(
                f"tfidf: {len(ment_texts)} mention texts != {exact.shape[0]} matrix rows "
                "(use the split pickle's source world)"
            )
        ment_embeds = compute_ment_embeds_w_tfidf(entities, ment_texts)
        ent_embeds = compute_ent_embeds_w_tfidf(entities)
        tfidf_scores = ment_embeds @ ent_embeds.T

    if args.mode == "transductive":
        run_transductive_eval(
            exact,
            res_dir=args.res_dir,
            methods=args.methods,
            n_seeds=args.n_seeds,
            n_ment_anchors_vals=args.n_ment_anchors_vals,
            n_ent_anchors_vals=args.n_ent_anchors_vals,
            top_k_vals=args.top_k_vals,
            top_k_retvr_vals=args.top_k_retvr_vals,
            bienc_scores=bienc_scores,
            misc=args.misc,
            rcond=rcond,
            device=device,
        )
    else:
        train = None
        if args.train_score_matrix:
            train = np.asarray(
                load_score_matrix(args.train_score_matrix)["ment_to_ent_scores"], np.float32
            )
        for method in args.methods:
            run_inductive_eval(
                exact,
                train,
                res_dir=args.res_dir,
                method=method,
                seed=args.seed,
                top_k_vals=args.top_k_vals,
                top_k_retvr_vals=args.top_k_retvr_vals,
                n_ent_anchors_vals=args.n_ent_anchors_vals,
                bienc_scores=bienc_scores,
                tfidf_scores=tfidf_scores,
                misc=args.misc,
                rcond=rcond,
                device=device,
            )


if __name__ == "__main__":
    main()
