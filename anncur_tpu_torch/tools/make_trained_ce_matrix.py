"""A trained cross-encoder's score matrix, for matched-recall calibration.

Counterpart of ``tools/make_trained_ce_matrix.py``: it trains a small CE
on a synthetic world at yugioh scale (10,000 entities), holds the eval
mentions out of training, and scores the train and eval mentions against
every entity with the port's ``ScoreMatrixBuilder``. Two worlds:

- ``shared`` (default): entity titles are two rare words drawn with reuse
  from a pool of 1,200, so entities form families that share surface
  forms and half the negatives share one title word with the gold; the
  matrix is heavy-tailed;
- ``rare``: titles are two of 4,096 rare words, nearly disjoint; the
  matrix is close to low rank.

The file is a float16 ``.npz`` with ``scores`` ((n_train + n_q) x
n_ents), ``n_train``, ``n_q``, ``gt_eval`` and ``meta`` (the spectrum's
s2/s1 and 97%-energy rank, gold-in-top-64 of the unseen eval rows, the
final training loss), the layout ``adaptive_matched_recall`` reads. The
two packages draw different random numbers, so the port's matrix is not
JAX's entry by entry; its spectrum and gold ranks are the comparison.

    python -m anncur_tpu_torch.tools.make_trained_ce_matrix [--world rare]
    python -m anncur_tpu_torch.tools.make_trained_ce_matrix --quick --device cpu

Runs on the card unless ``--device cpu`` says otherwise. Writes
``results/torch/trained_ce_matrix[_hard][_quick].npz``; the committed
``benchmarks/`` files stay JAX's.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from anncur_tpu_torch.config import Config
from anncur_tpu_torch.data.synthetic import _WORDS
from anncur_tpu_torch.data.tokenization import tokenize_entities, tokenize_mentions
from anncur_tpu_torch.indexer.score_matrix import ScoreMatrixBuilder
from anncur_tpu_torch.models.bert import BertSpec
from anncur_tpu_torch.models.crossencoder import CrossEncoder
from anncur_tpu_torch.models.tokenizer import WordPieceTokenizer, make_test_vocab
from anncur_tpu_torch.tools import _common
from anncur_tpu_torch.train.data import EntLinkDataset, crossenc_batches, mine_negatives
from anncur_tpu_torch.train.trainer import Trainer
from anncur_tpu_torch.utils.device import resolve_device


def _rare_words(rng, n_rare):
    """``n_rare`` distinct seven-letter words."""
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    words, seen = [], set()
    while len(words) < n_rare:
        w = "".join(rng.choice(letters, size=7))
        if w not in seen:
            seen.add(w)
            words.append(w)
    return words


def _mention(rng, i, title, label, world):
    return {
        "mention": title, "mention_id": f"m{i}",
        "context_left": " ".join(rng.choice(_WORDS, size=int(rng.integers(0, 20)))),
        "context_right": " ".join(rng.choice(_WORDS, size=int(rng.integers(0, 20)))),
        "context_doc_id": f"d{i}", "type": "synth", "label_id": label, "world": world,
    }


def _tokenized(mentions, entities, rare, max_len):
    tokenizer = WordPieceTokenizer(make_test_vocab(list(_WORDS) + rare))
    gt = np.asarray([m["label_id"] for m in mentions], np.int32)
    return tokenize_mentions(mentions, tokenizer, max_len), tokenize_entities(entities, tokenizer, max_len), gt, tokenizer


def make_big_world(rng, n_ents, n_ments, max_len=32, n_rare=4096):
    """The ``rare`` world: titles are two distinct rare words, no two
    entities share a title, 12 common words of description; the gold
    title appears verbatim in its mention. (mention tokens, entity tokens,
    gold ids, tokenizer)."""
    rare = _rare_words(rng, n_rare)
    titles, entities = set(), []
    while len(entities) < n_ents:
        t = tuple(rng.choice(n_rare, size=2, replace=False))
        if t in titles:
            continue
        titles.add(t)
        entities.append((f"{rare[t[0]]} {rare[t[1]]}", " ".join(rng.choice(_WORDS, size=12))))
    mentions = []
    for i in range(n_ments):
        label = int(rng.integers(0, n_ents))
        mentions.append(_mention(rng, i, entities[label][0], label, "calibville"))
    return _tokenized(mentions, entities, rare, max_len)


def make_shared_world(rng, n_ents, n_ments, max_len=32, n_rare=1200):
    """The ``shared`` world: titles are two rare words drawn with reuse
    from ``n_rare`` (about 2 n_ents / n_rare entities per word). Returns
    the ``rare`` world's four values and ``hard_negs``: per mention, the
    entities that share exactly one title word with its gold."""
    rare = _rare_words(rng, n_rare)
    titles, pairs = set(), []
    while len(pairs) < n_ents:
        t = tuple(sorted(rng.choice(n_rare, size=2, replace=False)))
        if t in titles:
            continue
        titles.add(t)
        pairs.append(t)
    word_to_ents = [[] for _ in range(n_rare)]
    for i, (a, b) in enumerate(pairs):
        word_to_ents[a].append(i)
        word_to_ents[b].append(i)
    entities = [(f"{rare[a]} {rare[b]}", " ".join(rng.choice(_WORDS, size=12))) for a, b in pairs]
    mentions, hard_negs = [], []
    for i in range(n_ments):
        label = int(rng.integers(0, n_ents))
        hard_negs.append(np.asarray([e for w in pairs[label] for e in word_to_ents[w] if e != label], np.int32))
        mentions.append(_mention(rng, i, entities[label][0], label, "hardville"))
    return (*_tokenized(mentions, entities, rare, max_len), hard_negs)


def spectrum(mat, n_train, n_q, gold):
    """(s2/s1 of the centred train rows, their 97%-energy rank, the share of
    eval rows whose gold ranks in the top 64)."""
    sv = np.linalg.svd(mat[:n_train] - mat[:n_train].mean(axis=0), compute_uv=False)
    energy = np.cumsum(sv ** 2) / np.sum(sv ** 2)
    rows = mat[n_train:n_train + n_q]
    rank_of_gold = (rows > rows[np.arange(n_q), gold][:, None]).sum(axis=1)
    return float(sv[1] / sv[0]), int(np.searchsorted(energy, 0.97) + 1), float((rank_of_gold < 64).mean())


def train_kwargs(quick, batch=64):
    """The training config's fields, JAX's: 4 negatives, one micro-batch;
    the quick run at batch 16 and lr 1e-3, the full one at ``batch`` and
    3e-4 (the 4-layer spec sits at ln 5 at 1e-3, JAX's finding)."""
    return dict(model_type="cross_enc", loss_type="ce", num_negs=4, train_batch_size=16 if quick else batch,
                grad_acc_steps=1, learning_rate=1e-3 if quick else 3e-4, num_epochs=1000)


def ce_spec(vocab_size, quick, **kw):
    """The quick spec is the tiny one; the full run's 4 layers of 128 learn
    a general matching circuit, which 2 layers of 64 do not (JAX's finding)."""
    if quick:
        return BertSpec.tiny(vocab_size=vocab_size, **kw)
    return BertSpec.tiny(vocab_size=vocab_size, hidden_size=128, num_layers=4, num_heads=8, intermediate_size=512, **kw)


def train_negatives(data, gt, train_slice, hard_negs, num_negs, device):
    """Random negatives; in the shared world half of them share one title
    word with the gold, so the CE must grade its matching, not only detect
    a rare word."""
    negs = mine_negatives(data, "random", num_negs, seed=0, device=device)
    if hard_negs is not None:
        nrng = np.random.default_rng(1)
        n_hard = num_negs // 2
        for j, mi in enumerate(range(train_slice.start, train_slice.stop)):
            sibs = hard_negs[mi][hard_negs[mi] != gt[mi]]
            if sibs.size:
                negs[j, :n_hard] = nrng.choice(sibs, size=n_hard, replace=sibs.size < n_hard)
    return negs


def train_ce(ce, cfg, data, negs, steps):
    """``steps`` Trainer steps over the unshuffled batches from the
    Trainer's own initial params: (the train state, each step's loss)."""
    trainer = Trainer(cfg, ce, total_steps=steps)
    state = trainer.init_state()
    t0, losses = time.time(), []
    while state.step < steps:
        for batch in crossenc_batches(data, negs, cfg.train_batch_size, shuffle=False):
            losses.append(float(trainer.train_step(state, trainer._shard_batch(batch))["loss"]))
            if state.step % 200 == 0:
                print(f"  step {state.step} loss {losses[-1]:.4f} ({time.time() - t0:.0f}s)", flush=True)
            if state.step >= steps:
                break
    return state, losses


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--quick", action="store_true", help="JAX's quick shapes: 400 entities, 30 steps")
    ap.add_argument("--out", default=None)
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--world", choices=["shared", "rare"], default="shared")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    name = "trained_ce_matrix" + ("_hard" if args.world == "shared" else "") + ("_quick" if args.quick else "")
    out_path = args.out or os.path.join(_common.RESULTS_DIR, name + ".npz")

    if args.quick:
        n_ents, n_train, n_q, n_extra, steps = 400, 60, 16, 200, 30
    else:
        n_ents, n_train, n_q, n_extra, steps = 10000, 500, 128, 8000, args.steps
    n_ments = n_train + n_q + n_extra
    rng = np.random.default_rng(0)
    hard_negs = None
    if args.world == "shared":
        ment, ent, gt, tokenizer, hard_negs = make_shared_world(rng, n_ents, n_ments, n_rare=120 if args.quick else 1200)
    else:
        ment, ent, gt, tokenizer = make_big_world(rng, n_ents, n_ments)
    ce = CrossEncoder(ce_spec(tokenizer.vocab_size, args.quick), "default", compute_dtype=torch.float32, device=device)

    # rows [0, n_train) are the train queries, [n_train, n_train + n_q) the
    # eval queries; only the rest feed gradient steps
    train_slice = slice(n_train + n_q, n_ments)
    data = EntLinkDataset(ment[train_slice], ent, gt[train_slice])
    with tempfile.TemporaryDirectory() as res_dir:
        cfg = Config(**train_kwargs(args.quick, args.batch), base_res_dir=res_dir)
        negs = train_negatives(data, gt, train_slice, hard_negs, cfg.num_negs, device)
        t0 = time.time()
        state, losses = train_ce(ce, cfg, data, negs, steps)
    train_s = time.time() - t0
    loss = losses[-1]
    print(f"CE trained {state.step} steps, final loss {loss:.4f} ({train_s:.0f}s)", flush=True)
    if not np.isfinite(loss):
        raise SystemExit(f"training diverged: loss {loss}")

    builder = ScoreMatrixBuilder(ce, ment_block=8 if args.quick else 16, ent_block=8 if args.quick else 256,
                                 pair_pad_multiple=32, device=device)
    t0 = time.time()
    mat = np.asarray(builder(ment[: n_train + n_q], ent), np.float32)
    _common.sync(device)
    score_s = time.time() - t0
    gold = gt[n_train:n_train + n_q]
    s2_s1, rank97, in_top64 = spectrum(mat, n_train, n_q, gold)
    print(f"scored {(n_train + n_q) * n_ents} pairs in {score_s:.1f}s; spectrum: s2/s1={s2_s1:.4f}, "
          f"97%-energy rank={rank97}; gold-in-top-64 (unseen queries): {in_top64:.3f}", flush=True)
    meta = {
        "quick": bool(args.quick), "world": args.world, "n_ents": n_ents, "train_steps": int(state.step),
        "final_loss": loss, "s2_over_s1": s2_s1, "rank_97pct_energy": rank97, "gold_in_top64_frac": in_top64,
        "train_wall_s": train_s, "score_wall_s": score_s, "device": _common.card(device),
        "recipe": "anncur_tpu_torch/tools/make_trained_ce_matrix.py (eval rows unseen)",
    }
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    np.savez_compressed(out_path, scores=mat.astype(np.float16), n_train=n_train, n_q=n_q, gt_eval=gold,
                        meta=json.dumps(meta))
    print("wrote", out_path, flush=True)
    return meta


if __name__ == "__main__":
    main()
