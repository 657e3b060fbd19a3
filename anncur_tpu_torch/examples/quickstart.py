"""End-to-end quickstart on synthetic data: every stage of the engine in
one script, at ``BertSpec.tiny`` so it finishes fast.

Counterpart of ``examples/quickstart.py``, stage for stage:

1. a synthetic world (64 entities, 48 mentions of 32 tokens);
2. a bi-encoder trained with in-batch negatives;
3. a cross-encoder trained (random negatives; a random CE would score a
   near rank-one matrix and make recall meaningless);
4. the offline exact CE score matrix of 32 train mentions against every
   entity (``ScoreMatrixBuilder``, 8 x 8 blocks, pair pad 64);
5. the CUR index (``CurRetriever.build``, 16 anchor items);
6. online queries for the 16 unseen mentions (``query_tokens_batch``,
   top-5 of 24 retrieved and reranked), their recall against the exact
   CE ranking;
7. one text query.

    python -m anncur_tpu_torch.examples.quickstart [--device cpu]

On the card the tiny spec computes in f32, so the attention runs kernel
A's and kernels C and D's f32 bodies, and the top-k kernel B. It departs
from JAX's example in one setting, said in its summary too: the spec's
attention dropout is 0 (hidden dropout stays 0.1). With dropout on the
attention probabilities training takes the plain attention, as JAX's
takes its XLA attention instead of the flash kernel, and kernels C and D
would not run. Checkpoints go to a temporary directory; the summary is
printed and returned.
"""

from __future__ import annotations

import argparse
import tempfile
import time

import numpy as np
import torch

from anncur_tpu_torch.config import Config
from anncur_tpu_torch.core.metrics import topk_overlap_frac
from anncur_tpu_torch.core.retriever import CurRetriever
from anncur_tpu_torch.data.synthetic import make_tokenized_world
from anncur_tpu_torch.indexer.score_matrix import ScoreMatrixBuilder
from anncur_tpu_torch.models.bert import BertSpec
from anncur_tpu_torch.models.biencoder import BiEncoder
from anncur_tpu_torch.models.crossencoder import CrossEncoder
from anncur_tpu_torch.train.data import EntLinkDataset
from anncur_tpu_torch.train.trainer import Trainer
from anncur_tpu_torch.utils.device import resolve_device


# the one departure from JAX's quickstart, printed with its summary
DEPARTURE = ("attention dropout 0 where JAX's quickstart has 0.1 (hidden dropout 0.1 in both): with dropout on the "
             "attention probabilities training takes the plain attention, and kernels C and D would not run")
CE_CONFIG = dict(model_type="cross_enc", loss_type="ce", neg_strategy="random", num_negs=4, num_epochs=40,
                 train_batch_size=16, grad_acc_steps=1, learning_rate=1e-3)
CE_STEPS = 120


def make_spec(vocab_size, **kw):
    return BertSpec.tiny(**{"vocab_size": vocab_size, "max_position_embeddings": 128, "attention_dropout": 0.0, **kw})


def train_cross_encoder(spec, data, res_dir, device):
    """Stage 3: the CE from the Trainer's seeded initial params, 120 steps
    over random negatives. (the CE, its steps)."""
    ce = CrossEncoder(spec, compute_dtype=torch.float32, device=device)
    cfg = Config(**CE_CONFIG, base_res_dir=res_dir)
    return ce, Trainer(cfg, ce, total_steps=CE_STEPS).train(data, dev_data=None).step


def index_and_query(ce, tokenizer, ment_toks, ent_toks, device):
    """Stages 4-6: the exact CE scores of the first 32 mentions against
    every item, the 16-anchor CUR index, the top-5 of 24 for the other 16
    mentions and their recall against the exact CE ranking. (the
    retriever, the retrieved ids, the exact top-5, the recall)."""
    builder = ScoreMatrixBuilder(ce, ment_block=8, ent_block=8, pair_pad_multiple=64, device=device)
    retriever = CurRetriever.build(ce, tokenizer, train_query_tokens=ment_toks[:32], item_tokens=ent_toks,
                                   n_anchor_items=16, builder=builder, max_query_len=32)
    test = ment_toks[32:]
    _, idx = retriever.query_tokens_batch(test, top_k=5, top_k_retvr=24)
    exact = builder(test, ent_toks)
    exact_top = np.argsort(-exact, axis=1, kind="stable")[:, :5]
    return retriever, idx, exact_top, float(topk_overlap_frac(idx, exact_top).mean())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    print(f"device: {device}")
    out = {"device": str(device), "departs_from_reference": DEPARTURE}

    # 1. data
    ment_toks, ent_toks, gt, tokenizer = make_tokenized_world(
        seed=0, n_ents=64, n_ments=48, max_ment_len=32, max_ent_len=32)
    data = EntLinkDataset(ment_toks, ent_toks, gt)
    spec = make_spec(tokenizer.vocab_size)
    print(f"world: {data.n_ments} mentions x {data.n_ents} entities")

    with tempfile.TemporaryDirectory() as res_dir:
        # 2. a bi-encoder with in-batch negatives
        cfg = Config(model_type="bi_enc", loss_type="ce", neg_strategy="in_batch", num_epochs=2, train_batch_size=16,
                     grad_acc_steps=1, learning_rate=5e-4, base_res_dir=res_dir)
        bienc = BiEncoder(spec, pooling_type="cls", embed_dim=spec.hidden_size, compute_dtype=torch.float32,
                          device=device)
        t0 = time.time()
        out["bienc_steps"] = Trainer(cfg, bienc, total_steps=12).train(data, dev_data=None).step
        print(f"bi-encoder trained ({out['bienc_steps']} steps) in {time.time() - t0:.1f}s")

        # 3. the cross-encoder, the expensive scorer worth indexing
        t0 = time.time()
        ce, out["ce_steps"] = train_cross_encoder(spec, data, res_dir, device)
        print(f"cross-encoder trained ({out['ce_steps']} steps) in {time.time() - t0:.1f}s")

    # 4-6. the offline index, then online queries (unseen mentions)
    retriever, _, _, out["recall"] = index_and_query(ce, tokenizer, ment_toks, ent_toks, device)
    print(f"CUR index built: {len(retriever.anchor_item_ids)} anchor items, "
          f"latent {tuple(retriever.index.latent_cols.shape)}")
    out["cost_per_query"] = retriever.cost_per_query + 24
    print(f"top-5 recall vs exact CE ranking: {out['recall']:.3f} "
          f"(cost {retriever.cost_per_query}+24 CE calls/query vs {data.n_ents} brute force)")

    # 7. one text query
    out["text_query"] = retriever.query("alpha beta", context_left="gamma", top_k=3)
    print(f"text query -> {out['text_query']}")
    print(f"departs from the JAX quickstart: {DEPARTURE}")
    return out


if __name__ == "__main__":
    main()
