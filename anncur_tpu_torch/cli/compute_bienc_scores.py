"""Compute the dense bi-encoder score matrix for eval baselines.

Counterpart of ``anncur_tpu/cli/compute_bienc_scores.py``: the same
flags and the {'scores': (n_m, n_e)} pickle that eval_retrieval's
'bienc' method reads (the reference computes this inline per eval run,
run_retrieval_eval_wrt_exact_crossenc.py:270-283), plus ``--device``.
Both towers embed through ``evalx/retrieve_rerank.py::embed_tokenized``
(kernel A in every layer on the card); the product is
``evalx/rank_probe.py::bienc_score_matrix``, a true-f32 matmul on the
device. The matrix is dense: (mentions x entities) f32 lives on the
device once. Weights come from a checkpoint of either package; the
towers compute in bf16, as the JAX CLI's do.
"""

from __future__ import annotations

import argparse
import logging
import os
import pickle

import numpy as np
import torch

from anncur_tpu_torch.cli import _common
from anncur_tpu_torch.evalx.rank_probe import bienc_score_matrix
from anncur_tpu_torch.evalx.retrieve_rerank import embed_tokenized
from anncur_tpu_torch.indexer.score_matrix import load_score_matrix
from anncur_tpu_torch.models.tokenizer import WordPieceTokenizer

LOGGER = logging.getLogger("anncur_tpu_torch.compute_bienc_scores")

COMPUTE_DTYPE = torch.bfloat16


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--score_matrix", required=True,
                   help="CE score-matrix pickle: provides mention tokens + entity ids")
    p.add_argument("--ent_tokens_file", required=True)
    p.add_argument("--vocab_file", required=True)
    p.add_argument("--bienc_ckpt", default="")
    p.add_argument("--pooling_type", default="cls_w_lin")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--out_file", required=True)
    p.add_argument("--seed", type=int, default=0)
    _common.add_arch_args(p)
    _common.add_device_arg(p)
    args = p.parse_args(argv)
    device = _common.device_of(args)

    data = load_score_matrix(args.score_matrix)
    ment_toks = np.asarray(data["mention_tokens_list"], np.int32)
    ent_toks = np.load(args.ent_tokens_file).astype(np.int32)

    tokenizer = WordPieceTokenizer.from_vocab_file(args.vocab_file)
    bienc = _common.biencoder(
        _common.spec_of(args, tokenizer.vocab_size), args.bienc_ckpt, args.pooling_type, COMPUTE_DTYPE,
        device, args.seed, LOGGER, "no --bienc_ckpt: random bi-encoder",
    )
    ment_embeds = embed_tokenized(bienc, ment_toks, args.batch_size, "input")
    ent_embeds = embed_tokenized(bienc, ent_toks, args.batch_size, "label")
    scores = bienc_score_matrix(ment_embeds, ent_embeds, device=device)

    os.makedirs(os.path.dirname(args.out_file) or ".", exist_ok=True)
    with open(args.out_file, "wb") as fout:
        pickle.dump({"scores": scores}, fout)
    LOGGER.info("wrote %s %s", args.out_file, scores.shape)


if __name__ == "__main__":
    main()
