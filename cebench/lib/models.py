"""The system under test, built as a user builds it: the port's
``CrossEncoder``, ``BiEncoder`` and ``CurRetriever`` from a configuration
file and the weights, tokens and R the run made from its seed."""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from cebench.lib import world
from cebench.lib.harness import wrap_counting

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def bert_spec(cfg: Dict[str, Any]):
    """The port's ``BertSpec`` of a configuration; bert-base's ``gelu`` is
    the exact erf form, which the port computes when told so."""
    from anncur_tpu_torch.models.bert import BertSpec

    if cfg["hidden_act"] not in ("gelu", "gelu_pytorch_tanh"):
        raise ValueError(f"hidden_act={cfg['hidden_act']!r}")
    return BertSpec(
        vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"], num_layers=cfg["num_hidden_layers"],
        num_heads=cfg["num_attention_heads"], intermediate_size=cfg["intermediate_size"],
        max_position_embeddings=cfg["max_position_embeddings"], type_vocab_size=cfg["type_vocab_size"],
        layer_norm_eps=cfg["layer_norm_eps"], initializer_range=cfg["initializer_range"],
        hidden_dropout=cfg["hidden_dropout_prob"], attention_dropout=cfg["attention_probs_dropout_prob"],
        gelu_approximate=cfg["hidden_act"] != "gelu",
    )


def pair_len(cfg: Dict[str, Any]) -> int:
    """Mention ⧺ entity without its [CLS], padded to the pair multiple (the
    port's ``padded_pair_len``: 128 + 128 - 1 -> 256)."""
    dep = cfg["deployment"]
    raw = dep["max_input_len"] + dep["max_label_len"] - 1
    mult = min(dep["pair_pad_multiple"], cfg["max_position_embeddings"])
    return raw + (-raw) % mult


def make_ce(run) -> Tuple[Any, Dict[str, Any]]:
    """(the port's CrossEncoder, the benchmark's own weights tree on the
    device). Every row the CE is handed is counted as ``ce_pairs``."""
    from anncur_tpu_torch.models.crossencoder import CrossEncoder

    cfg, dep = run.cfg, run.cfg["deployment"]
    with run.spans.span("setup.weights"):
        tree = world.ce_weights(cfg, run.seed, run.device)
        ce = CrossEncoder(
            bert_spec(cfg), cross_enc_type=dep["cross_enc_type"], pooling_type=dep["pooling_type"],
            compute_dtype=DTYPES[dep["compute_dtype"]], device=run.device, params=world.host_tree(tree),
        )
    wrap_counting(ce, "score", lambda a, kw: run.count("ce_pairs", int(np.shape(a[0])[0])))
    return ce, tree


def make_items(run) -> torch.Tensor:
    """(n_items, Le) int32 entity tokens on the device."""
    cfg, dep = run.cfg, run.cfg["deployment"]
    gen = world.generator(run.seed, "items", run.device)
    le = dep["max_label_len"]
    return world.tokens(gen, dep["n_items"], le, cfg["vocab_size"], world.entity_tags(le), run.device)


def make_mentions(run, n: int, tag: str) -> torch.Tensor:
    """(n, Lm) int32 mention tokens on the device, the stream ``tag``."""
    cfg, dep = run.cfg, run.cfg["deployment"]
    gen = world.generator(run.seed, tag, run.device)
    lm = dep["max_input_len"]
    return world.tokens(gen, n, lm, cfg["vocab_size"], world.mention_tags(lm), run.device)


def make_train(run) -> torch.Tensor:
    """R: (k_q, n_items) f32 train matrix on the device, low rank plus
    full-rank noise."""
    dep = run.cfg["deployment"]
    gen = world.generator(run.seed, "train", run.device)
    return world.train_matrix(gen, dep["n_anchor_queries"], dep["n_items"], dep["train_rank"], dep["train_noise"],
                              run.device)


def make_retriever(run, ce, items: torch.Tensor, train: torch.Tensor):
    """The port's ``CurRetriever.build`` over the world, with R as the
    anchor queries' scores and anchor items drawn from the run's seed."""
    from anncur_tpu_torch.core.retriever import CurRetriever
    from anncur_tpu_torch.indexer.score_matrix import ScoreMatrixBuilder
    from anncur_tpu_torch.models.tokenizer import WordPieceTokenizer, make_test_vocab

    dep = run.cfg["deployment"]
    anchor_queries = make_mentions(run, dep["n_anchor_queries"], "anchor_queries")
    with run.spans.span("setup.index"):
        return CurRetriever.build(
            ce, WordPieceTokenizer(make_test_vocab()), anchor_queries.cpu().numpy(), items.cpu().numpy(),
            n_anchor_items=dep["n_anchor_items"], builder=ScoreMatrixBuilder(ce, device=run.device),
            seed=world.subseed(run.seed, "anchors"), train_scores=train.cpu().numpy(),
            max_query_len=dep["max_input_len"], pair_pad_multiple=dep["pair_pad_multiple"], device=run.device,
        )
