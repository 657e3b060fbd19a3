"""Entity-linking e2e CLI: bi-encoder retrieval + cross-encoder rerank
vs gold labels (parity with eval/run_cross_encoder_w_binenc_retriever_
zeshel.py:286-416) and bi-encoder-only eval (run_biencoder_eval_zeshel
.py:29-111).

Counterpart of ``anncur_tpu/cli/eval_retrieve_rerank.py``: the same flags
and files, plus ``--device``. On the card the towers and the CE run
kernel A, the dense search kernel B (``DenseIndex``). The encoders
compute in bf16, as the JAX CLI's do. The retrieval runs over
``default_mesh()``, as the JAX CLI's: sharded over the ranks of a
``torchrun`` launch (rank 0 writes the files), one rank in a plain
process.
"""

from __future__ import annotations

import argparse
import json
import logging
import os

import numpy as np

import torch

from anncur_tpu_torch.cli import _common
from anncur_tpu_torch.data import load_entities, load_mentions, tokenize_entities, tokenize_mentions
from anncur_tpu_torch.evalx.retrieve_rerank import (
    run_biencoder_eval,
    run_from_precomputed_preds,
    run_retrieve_rerank_eval,
)
from anncur_tpu_torch.models.tokenizer import WordPieceTokenizer
from anncur_tpu_torch.parallel.mesh import mesh_session

LOGGER = logging.getLogger("anncur_tpu_torch.eval_retrieve_rerank")

COMPUTE_DTYPE = torch.bfloat16


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ment_file", default="")
    p.add_argument("--ent_file", default="")
    p.add_argument("--ent_tokens_file", default="")
    p.add_argument("--vocab_file", default="")
    p.add_argument("--bienc_ckpt", default="")
    p.add_argument("--crossenc_ckpt", default="")
    p.add_argument("--bienc_only", action="store_true")
    p.add_argument(
        "--from_precomputed",
        action="store_true",
        help="recompute res.json from saved topk-pred JSONs in --res_dir "
        "(no models; reference run_w_precomp_results mode)",
    )
    p.add_argument("--res_dir", required=True)
    p.add_argument("--top_k", type=int, default=64)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--max_ment_len", type=int, default=128)
    p.add_argument("--max_ent_len", type=int, default=128)
    p.add_argument("--n_ment", type=int, default=-1)
    p.add_argument(
        "--ment_start",
        type=int,
        default=0,
        help="first mention of this job's chunk (reference --n_ment_start); "
        "chunk topk-pred JSONs recombine via cli.combine_chunks --mode topk_preds",
    )
    p.add_argument("--pooling_type", default="cls_w_lin")
    p.add_argument("--seed", type=int, default=0)
    _common.add_arch_args(p)
    _common.add_device_arg(p)
    args = p.parse_args(argv)

    if args.from_precomputed:
        res = run_from_precomputed_preds(args.res_dir)
        LOGGER.info("metrics from precomputed preds: %s", json.dumps(res, indent=2))
        return

    for flag in ("ment_file", "ent_file", "vocab_file"):
        if not getattr(args, flag):
            p.error(f"--{flag} is required unless --from_precomputed")
    device = _common.device_of(args)

    tokenizer = WordPieceTokenizer.from_vocab_file(args.vocab_file)
    kb2local, entities = load_entities(args.ent_file)
    mentions = load_mentions(args.ment_file, kb2local)
    if args.n_ment > 0 or args.ment_start > 0:
        stop = args.ment_start + args.n_ment if args.n_ment > 0 else len(mentions)
        mentions = mentions[args.ment_start : stop]
    ment_toks = tokenize_mentions(mentions, tokenizer, args.max_ment_len)
    if args.ent_tokens_file and os.path.exists(args.ent_tokens_file):
        ent_toks = np.load(args.ent_tokens_file).astype(np.int32)
    else:
        ent_toks = tokenize_entities(entities, tokenizer, args.max_ent_len)
    gt = np.asarray([m["label_id"] for m in mentions], np.int32)

    spec = _common.spec_of(args, tokenizer.vocab_size)
    bienc = _common.biencoder(
        spec, args.bienc_ckpt, args.pooling_type, COMPUTE_DTYPE, device, args.seed, LOGGER,
        "no --bienc_ckpt: random bi-encoder",
    )

    os.makedirs(args.res_dir, exist_ok=True)
    if args.bienc_only:
        res = run_biencoder_eval(bienc, ment_toks, ent_toks, gt, args.top_k, args.batch_size)
        with open(os.path.join(args.res_dir, "res.json"), "w") as fout:
            json.dump(res, fout, indent=4)
        LOGGER.info("bienc-only metrics: %s", res)
        return

    ce = _common.crossencoder(
        spec, args.crossenc_ckpt, "default", COMPUTE_DTYPE, device, args.seed + 1, LOGGER,
        "no --crossenc_ckpt: random cross-encoder",
    )
    with mesh_session(device) as mesh:
        res = run_retrieve_rerank_eval(
            bienc, ce, ment_toks, ent_toks, gt,
            top_k=args.top_k, batch_size=args.batch_size, mesh=mesh, res_dir=args.res_dir,
        )
    LOGGER.info("retrieve+rerank metrics: %s", json.dumps(res, indent=2))


if __name__ == "__main__":
    main()
