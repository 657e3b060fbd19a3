"""Synthetic entity-linking worlds for tests and benchmarks.

Counterpart of ``anncur_tpu/data/synthetic.py`` on the port's
``WordPieceTokenizer``: for one seed it makes the same numpy draws, so
the worlds and token matrices equal the JAX module's.

The reference has no test data generator (and ZeShEL itself is not
shipped); this module fabricates worlds with the exact file formats the
loaders expect, plus in-memory token matrices, so every pipeline stage
can run end-to-end hermetically.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from anncur_tpu_torch.data.tokenization import tokenize_entities, tokenize_mentions
from anncur_tpu_torch.models.tokenizer import WordPieceTokenizer, make_test_vocab

_WORDS = [
    "alpha", "beta", "gamma", "delta", "epsilon", "zeta", "eta", "theta",
    "iota", "kappa", "lam", "mu", "nu", "xi", "omicron", "pi", "rho",
    "sigma", "tau", "upsilon", "phi", "chi", "psi", "omega", "castle",
    "dragon", "sword", "magic", "robot", "planet", "star", "ship",
]


def make_tokenizer() -> WordPieceTokenizer:
    return WordPieceTokenizer(make_test_vocab(_WORDS))


def make_world(
    rng: np.random.Generator,
    n_ents: int = 50,
    n_ments: int = 30,
    world: str = "synthville",
) -> Tuple[List[Dict], List[Tuple[str, str]]]:
    """Random mentions/entities over a tiny vocabulary; every mention's
    gold entity title appears verbatim in its text."""
    entities = []
    for i in range(n_ents):
        title = " ".join(rng.choice(_WORDS, size=2))
        desc = " ".join(rng.choice(_WORDS, size=12))
        entities.append((title, desc))
    mentions = []
    for i in range(n_ments):
        label = int(rng.integers(0, n_ents))
        mentions.append(
            {
                "mention": entities[label][0],
                "mention_id": f"m{i}",
                "context_left": " ".join(rng.choice(_WORDS, size=int(rng.integers(0, 20)))),
                "context_right": " ".join(rng.choice(_WORDS, size=int(rng.integers(0, 20)))),
                "context_doc_id": f"d{i}",
                "type": "synth",
                "label_id": label,
                "world": world,
            }
        )
    return mentions, entities


def write_world_files(
    root: str,
    mentions: List[Dict],
    entities: List[Tuple[str, str]],
    world: str = "synthville",
    split: str = "test",
) -> Dict[str, str]:
    """Write raw files in the on-disk formats the ZeShEL loaders parse."""
    doc_dir = os.path.join(root, "documents")
    ment_dir = os.path.join(root, "processed", f"{split}_worlds")
    os.makedirs(doc_dir, exist_ok=True)
    os.makedirs(ment_dir, exist_ok=True)
    ent_file = os.path.join(doc_dir, f"{world}.json")
    with open(ent_file, "w") as fout:
        for i, (title, text) in enumerate(entities):
            fout.write(json.dumps({"document_id": f"E{i}", "title": title, "text": text}) + "\n")
    ment_file = os.path.join(ment_dir, f"{world}_mentions.jsonl")
    with open(ment_file, "w") as fout:
        for m in mentions:
            fout.write(
                json.dumps(
                    {
                        # canonical PROCESSED (BLINK) schema — what the
                        # preprocessor and the reference's processed
                        # files use; load_mentions also accepts the raw
                        # keys (text/label_document_id/corpus/category)
                        "mention_id": m["mention_id"],
                        "mention": m["mention"],
                        "context_left": m["context_left"],
                        "context_right": m["context_right"],
                        "context_doc_id": m["context_doc_id"],
                        "label_id": f"E{m['label_id']}",
                        "world": world,
                        "type": m["type"],
                    }
                )
                + "\n"
            )
    return {"ent_file": ent_file, "ment_file": ment_file}


def make_tokenized_world(
    seed: int = 0,
    n_ents: int = 50,
    n_ments: int = 30,
    max_ment_len: int = 32,
    max_ent_len: int = 32,
):
    """(mention_tokens (n_m, Lm), entity_tokens (n_e, Le), gt_labels,
    tokenizer) fully in memory."""
    rng = np.random.default_rng(seed)
    tokenizer = make_tokenizer()
    mentions, entities = make_world(rng, n_ents, n_ments)
    ment_toks = tokenize_mentions(mentions, tokenizer, max_ment_len)
    ent_toks = tokenize_entities(entities, tokenizer, max_ent_len)
    gt = np.asarray([m["label_id"] for m in mentions], np.int32)
    return ment_toks, ent_toks, gt, tokenizer
