"""Offline index build CLI: exact CE score matrix for one world.

Counterpart of ``anncur_tpu/cli/build_score_matrix.py`` (parity with
eval/run_cross_encoder_for_ment_ent_matrix_zeshel.py:284-400): the same
flags, mention-range chunk jobs (--n_ment_start/--n_ment, with the
``_start_<n>`` suffix), the ``chunks_start_<n>`` resume directory and
the pickled output schema, plus ``--device``. The matrix comes from the
port's ``ScoreMatrixBuilder`` over ``default_mesh()``, as the JAX CLI's
(kernel A in every CE forward on the card): under ``torchrun
--nproc_per_node N`` the entities are sharded over the N ranks and rank 0
writes the chunks and the pickle; in a plain process it is one rank.
``require_accelerator()`` has no counterpart: its role goes to
``--device``. The CE computes in bf16, as the JAX CLI's does.
"""

from __future__ import annotations

import argparse
import logging
import os
import pickle

import numpy as np
import torch

from anncur_tpu_torch.cli import _common
from anncur_tpu_torch.data import load_entities, load_mentions, tokenize_entities, tokenize_mentions
from anncur_tpu_torch.indexer.score_matrix import ScoreMatrixBuilder, save_score_matrix
from anncur_tpu_torch.models.tokenizer import WordPieceTokenizer
from anncur_tpu_torch.parallel.mesh import mesh_session
from anncur_tpu_torch.parallel.multihost import world

LOGGER = logging.getLogger("anncur_tpu_torch.build_score_matrix")

COMPUTE_DTYPE = torch.bfloat16


def _chunk_suffix(args) -> str:
    """Equal-size chunk jobs sharing one --res_dir write distinct files:
    the start offset joins the name (the reference's {misc} suffix plays
    this role; it is added for chunk jobs)."""
    suffix = args.misc
    if args.n_ment_start > 0 and "start" not in suffix:
        suffix += f"_start_{args.n_ment_start}"
    return suffix


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ment_file", required=True)
    p.add_argument("--ent_file", required=True)
    p.add_argument("--ent_tokens_file", default="")
    p.add_argument("--vocab_file", required=True)
    p.add_argument("--ckpt_path", default="", help="trained cross-encoder checkpoint")
    p.add_argument("--cross_enc_type", default="default", choices=["default", "w_embeds"])
    p.add_argument("--res_dir", required=True)
    p.add_argument("--n_ment_start", type=int, default=0)
    p.add_argument("--n_ment", type=int, default=-1, help="-1 = all")
    p.add_argument("--max_ment_len", type=int, default=128)
    p.add_argument("--max_ent_len", type=int, default=128)
    p.add_argument("--ment_block", type=int, default=8)
    p.add_argument("--ent_block", type=int, default=64)
    p.add_argument("--mode", default="scores", choices=["scores", "embeds"])
    p.add_argument("--misc", default="", help="output filename suffix (reference {misc})")
    p.add_argument("--seed", type=int, default=0)
    _common.add_arch_args(p)
    _common.add_device_arg(p)
    args = p.parse_args(argv)
    device = _common.device_of(args)
    with mesh_session(device) as mesh:
        _build(args, mesh, device)


def _build(args, mesh, device) -> None:

    tokenizer = WordPieceTokenizer.from_vocab_file(args.vocab_file)
    kb2local, entities = load_entities(args.ent_file)
    mentions = load_mentions(args.ment_file, kb2local)

    end = len(mentions) if args.n_ment < 0 else min(args.n_ment_start + args.n_ment, len(mentions))
    mentions = mentions[args.n_ment_start : end]
    LOGGER.info("scoring mentions [%d, %d) x %d entities", args.n_ment_start, end, len(entities))

    ment_toks = tokenize_mentions(mentions, tokenizer, args.max_ment_len)
    if args.ent_tokens_file and os.path.exists(args.ent_tokens_file):
        ent_toks = np.load(args.ent_tokens_file).astype(np.int32)
    else:
        ent_toks = tokenize_entities(entities, tokenizer, args.max_ent_len)

    ce = _common.crossencoder(
        _common.spec_of(args, tokenizer.vocab_size), args.ckpt_path, args.cross_enc_type, COMPUTE_DTYPE,
        device, args.seed, LOGGER, "no --ckpt_path: using randomly initialized cross-encoder",
    )
    builder = ScoreMatrixBuilder(ce, ment_block=args.ment_block, ent_block=args.ent_block, device=device, mesh=mesh)
    writer = world()[0] == 0

    os.makedirs(args.res_dir, exist_ok=True)
    if args.mode == "embeds":
        m_emb, e_emb = builder.paired_embeds(ment_toks, ent_toks)
        out = os.path.join(
            args.res_dir,
            f"ment_and_ent_embeds_n_m_{len(mentions)}_n_e_{len(entities)}"
            f"_all_layers_False{_chunk_suffix(args)}.pkl",
        )
        if writer:
            with open(out, "wb") as fout:
                pickle.dump({"ment_embeds": m_emb, "ent_embeds": e_emb}, fout)
            LOGGER.info("wrote %s", out)
        return

    chunk_dir = os.path.join(args.res_dir, f"chunks_start_{args.n_ment_start}")
    scores = builder(
        ment_toks,
        ent_toks,
        chunk_dir=chunk_dir,
        progress_cb=lambda f: LOGGER.info("progress %.2f", f),
    )
    out = os.path.join(
        args.res_dir,
        f"ment_to_ent_scores_n_m_{len(mentions)}_n_e_{len(entities)}"
        f"_all_layers_False{_chunk_suffix(args)}.pkl",
    )
    if not writer:
        return
    save_score_matrix(
        out,
        ment_to_ent_scores=scores,
        mention_tokens_list=ment_toks,
        entity_id_list=np.arange(len(entities)),
        entity_tokens_list=ent_toks,
        test_data=mentions,
        arg_dict=vars(args),
    )
    LOGGER.info("wrote %s", out)


if __name__ == "__main__":
    main()
