"""Build the entity-to-anchor-entity CE score pickle for the
fixed-anchor-entity baselines (producer for the e2e files the reference
consumes, see indexer/ent2ent.py).

Counterpart of ``anncur_tpu/cli/build_ent2ent.py``: the same flags,
anchors (k-means++ over ``--ent_embeds_file``, else a seeded random
draw, the JAX CLI's numpy draw) and pickle, plus ``--device``. The
scores come from the port's ``ScoreMatrixBuilder`` over
``default_mesh()``, as the JAX CLI's (kernel A in every CE forward on the
card): entity-sharded over the ranks of a ``torchrun`` launch, rank 0
writing the pickle; one rank in a plain process. The CE computes in bf16,
as the JAX CLI's does.
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np
import torch

from anncur_tpu_torch.cli import _common
from anncur_tpu_torch.indexer.ent2ent import build_ent_to_ent_scores, kmeanspp_anchor_ids, save_ent_to_ent_pickle
from anncur_tpu_torch.indexer.score_matrix import ScoreMatrixBuilder
from anncur_tpu_torch.parallel.mesh import mesh_session
from anncur_tpu_torch.parallel.multihost import world
from anncur_tpu_torch.models.tokenizer import WordPieceTokenizer

LOGGER = logging.getLogger("anncur_tpu_torch.build_ent2ent")

COMPUTE_DTYPE = torch.bfloat16


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ent_tokens_file", required=True)
    p.add_argument("--vocab_file", required=True)
    p.add_argument("--crossenc_ckpt", default="")
    p.add_argument("--ent_embeds_file", default="",
                   help="npy of bienc entity embeddings for anchor selection; "
                        "random selection if absent")
    p.add_argument("--n_anchors", type=int, default=100)
    p.add_argument("--out_file", required=True)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ment_block", type=int, default=8)
    p.add_argument("--ent_block", type=int, default=64)
    _common.add_arch_args(p)
    _common.add_device_arg(p)
    args = p.parse_args(argv)
    device = _common.device_of(args)

    ent_toks = np.load(args.ent_tokens_file).astype(np.int32)
    tokenizer = WordPieceTokenizer.from_vocab_file(args.vocab_file)
    if args.ent_embeds_file and os.path.exists(args.ent_embeds_file):
        embeds = np.load(args.ent_embeds_file).astype(np.float32)
        anchors = kmeanspp_anchor_ids(embeds, args.n_anchors, args.seed)
    else:
        rng = np.random.default_rng(args.seed)
        anchors = np.asarray(sorted(rng.choice(ent_toks.shape[0], size=args.n_anchors, replace=False)))

    ce = _common.crossencoder(
        _common.spec_of(args, tokenizer.vocab_size), args.crossenc_ckpt, "default", COMPUTE_DTYPE, device,
        args.seed, LOGGER, "no --crossenc_ckpt: random cross-encoder",
    )
    with mesh_session(device) as mesh:
        builder = ScoreMatrixBuilder(ce, ment_block=args.ment_block, ent_block=args.ent_block, device=device, mesh=mesh)
        scores = build_ent_to_ent_scores(builder, ent_toks, anchors)
    if world()[0] == 0:
        save_ent_to_ent_pickle(args.out_file, scores, anchors)
        LOGGER.info("wrote %s %s", args.out_file, scores.shape)


if __name__ == "__main__":
    main()
