"""Everything a run makes from its seed: the model's weights, token ids,
the train score matrix R and the entity embeddings.

Weights are drawn on the run's device with a ``torch.Generator`` in a few
large calls, in f32 (the type the port holds its parameters in and casts
to bf16 at each product): one normal draw for every matrix, then zeros and
ones for the biases and LayerNorm scales. The tree has the port's
parameter layout; the plain reference reads the device tensors, the port
gets host copies of the same values.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CLS_ID, SEP_ID = 101, 102
ENT_START_ID, ENT_END_ID, ENT_TITLE_ID = 1, 2, 3
FIRST_WORD_ID = 999  # ids below are [PAD], [unused*], [UNK], [CLS], [SEP], [MASK] and punctuation


def load_config(name: str, overrides: Dict[str, Any] = None) -> Dict[str, Any]:
    """``configs/<name>.json``, with ``overrides`` merged over its top level
    and its ``deployment`` (for tests at small sizes)."""
    with open(os.path.join(HERE, "configs", f"{name}.json")) as fin:
        cfg = json.load(fin)
    for key, val in (overrides or {}).items():
        if key == "deployment":
            cfg["deployment"] = {**cfg["deployment"], **val}
        else:
            cfg[key] = val
    return cfg


def subseed(seed: int, tag: str) -> int:
    """An independent 62-bit seed for one stream of a run (weights, tokens,
    arrivals...): the same (seed, tag) always gives the same one."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF] + [ord(c) for c in tag]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> np.uint64(2))


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(subseed(seed, tag))


def bert_leaves(cfg: Dict[str, Any]) -> List[Tuple[Tuple, Tuple[int, ...], str]]:
    """(path, shape, kind) of every leaf of one BERT in the port's layout
    (``models/bert.py::init_bert_params``); kind is normal, zeros or ones."""
    h, i = cfg["hidden_size"], cfg["intermediate_size"]
    out = [
        (("embeddings", "word"), (cfg["vocab_size"], h), "normal"),
        (("embeddings", "position"), (cfg["max_position_embeddings"], h), "normal"),
        (("embeddings", "token_type"), (cfg["type_vocab_size"], h), "normal"),
        (("embeddings", "ln_scale"), (h,), "ones"),
        (("embeddings", "ln_bias"), (h,), "zeros"),
    ]
    for li in range(cfg["num_hidden_layers"]):
        for name in ("q", "k", "v", "out"):
            out.append((("layers", li, "attn", f"{name}_kernel"), (h, h), "normal"))
            out.append((("layers", li, "attn", f"{name}_bias"), (h,), "zeros"))
        out.append((("layers", li, "attn", "ln_scale"), (h,), "ones"))
        out.append((("layers", li, "attn", "ln_bias"), (h,), "zeros"))
        out.append((("layers", li, "mlp", "in_kernel"), (h, i), "normal"))
        out.append((("layers", li, "mlp", "in_bias"), (i,), "zeros"))
        out.append((("layers", li, "mlp", "out_kernel"), (i, h), "normal"))
        out.append((("layers", li, "mlp", "out_bias"), (h,), "zeros"))
        out.append((("layers", li, "mlp", "ln_scale"), (h,), "ones"))
        out.append((("layers", li, "mlp", "ln_bias"), (h,), "zeros"))
    out.append((("pooler", "kernel"), (h, h), "normal"))
    out.append((("pooler", "bias"), (h,), "zeros"))
    return out


def _put(tree, path, val):
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        if isinstance(key, int):
            while len(node) <= key:
                node.append({} if not isinstance(nxt, int) else [])
            node = node[key]
        else:
            node = node.setdefault(key, [] if isinstance(nxt, int) else {})
    node[path[-1]] = val


def make_weights(leaves, seed: int, std: float, device) -> Dict[str, Any]:
    """A tree of f32 device tensors: every normal leaf a view of one
    normal(0, std) draw, the rest views of one zeros and one ones buffer."""
    sizes = {kind: sum(int(np.prod(shape)) for _, shape, k in leaves if k == kind) for kind in ("normal", "zeros", "ones")}
    gen = generator(seed, "weights", device)
    bufs = {
        "normal": torch.randn(sizes["normal"], generator=gen, device=device).mul_(std),
        "zeros": torch.zeros(sizes["zeros"], device=device),
        "ones": torch.ones(sizes["ones"], device=device),
    }
    offs = {kind: 0 for kind in bufs}
    tree: Dict[str, Any] = {}
    for path, shape, kind in leaves:
        n = int(np.prod(shape))
        _put(tree, path, bufs[kind][offs[kind]: offs[kind] + n].view(shape))
        offs[kind] += n
    return tree


def host_tree(tree):
    """The same tree with host numpy leaves (what the port's constructors
    take); one copy per leaf."""
    if isinstance(tree, dict):
        return {k: host_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [host_tree(v) for v in tree]
    return tree.detach().cpu().numpy()


def ce_weights(cfg, seed: int, device):
    """The cross-encoder's tree: ``bert`` and the 'default' head's
    ``score_linear`` (h -> 1)."""
    leaves = [(("bert",) + p, s, k) for p, s, k in bert_leaves(cfg)]
    leaves += [(("score_linear", "kernel"), (cfg["hidden_size"], 1), "normal"),
               (("score_linear", "bias"), (1,), "zeros")]
    return make_weights(leaves, seed, cfg["random_weight_std"], device)


def bienc_weights(cfg, seed: int, device):
    """The separate bi-encoder's tree: ``input_bert`` and ``label_bert``
    (no linear heads: ``add_linear_layer`` is false)."""
    leaves = []
    for tower in ("input_bert", "label_bert"):
        leaves += [((tower,) + p, s, k) for p, s, k in bert_leaves(cfg)]
    return make_weights(leaves, seed, cfg["random_weight_std"], device)


def tokens(gen: torch.Generator, n: int, length: int, vocab: int, tags: Sequence[Tuple[int, int]], device) -> torch.Tensor:
    """(n, length) int32 token ids on ``device``: [CLS] words [SEP], every
    row full length, with the (position, id) ``tags`` set in each row."""
    out = torch.randint(FIRST_WORD_ID, vocab, (n, length), generator=gen, device=device, dtype=torch.int32)
    out[:, 0] = CLS_ID
    out[:, length - 1] = SEP_ID
    for pos, tag in tags:
        out[:, pos] = tag
    return out


def mention_tags(length: int) -> List[Tuple[int, int]]:
    """A mention span tagged [unused0] ... [unused1] near the middle of its
    context window."""
    mid = length // 2
    return [(mid - 4, ENT_START_ID), (mid + 4, ENT_END_ID)]


def entity_tags(length: int) -> List[Tuple[int, int]]:
    """[CLS] title [unused2] description [SEP]: the title's end tag."""
    return [(min(6, length - 2), ENT_TITLE_ID)]


def train_matrix(gen: torch.Generator, n_rows: int, n_items: int, rank: int, noise: float, device) -> torch.Tensor:
    """(n_rows, n_items) f32 score matrix on ``device`` with a decaying,
    full-rank spectrum: a standard normal (n_rows, rank) times a standard
    normal (rank, n_items), plus ``noise`` times a standard normal
    (n_rows, n_items)."""
    a = torch.randn(n_rows, rank, generator=gen, device=device)
    b = torch.randn(rank, n_items, generator=gen, device=device)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        low = a @ b
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return low.add_(torch.randn(n_rows, n_items, generator=gen, device=device), alpha=noise)
