"""End-to-end entity linking: bi-encoder retrieval + cross-encoder rerank.

Counterpart of ``anncur_tpu/evalx/retrieve_rerank.py`` (reference
eval/run_cross_encoder_w_binenc_retriever_zeshel.py:80-221), the
baseline annCUR is compared with at matched CE budget: both towers embed
on the card (kernel A in every layer), retrieval is ``DenseIndex``
(kernel B), and the rerank scores each mention's candidates with the
serving side's pair scorer (``indexer/score_matrix.py::
crossenc_rerank_scores``, on ``make_pair_scorer``), so its pairs have the
train matrix's shape. The prediction files have
the JAX package's schema: either package reads the other's. With
``mesh=`` the retrieval is sharded over the mesh's ``data`` axis
(``DenseIndex(mesh=)``, kernel B on each rank's shard, as JAX's
``mips_topk_sharded``); every rank calls the eval in lockstep and gets
the same result.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from anncur_tpu_torch.core.metrics import score_topk_preds
from anncur_tpu_torch.indexer.score_matrix import crossenc_rerank_scores, tokens_on
from anncur_tpu_torch.models.biencoder import BiEncoder
from anncur_tpu_torch.models.crossencoder import CrossEncoder
from anncur_tpu_torch.ops.dense_index import DenseIndex
from anncur_tpu_torch.parallel.multihost import world
from anncur_tpu_torch.utils.tracker import TRACER

LOGGER = logging.getLogger(__name__)


@torch.no_grad()
def embed_tokenized(
    encoder: BiEncoder, tokens, batch_size: int = 64, which: str = "label"
) -> np.ndarray:
    """(n, embed_dim) f32 numpy embeddings of ``tokens`` by the input
    (``which='input'``) or label tower, ``batch_size`` rows per forward,
    the last batch zero-padded to full size (reference:
    eval/eval_utils.py:59-92). Traced: a ``tower.forward`` span per
    forward, ``embed.to_host`` around the copy out."""
    fn = encoder.encode_input if which == "input" else encoder.encode_label
    toks = tokens_on(encoder.device, tokens)
    n = toks.shape[0]
    out = []
    for i in range(0, n, batch_size):
        with TRACER.span("tower.forward"):
            block = toks[i:i + batch_size]
            take = block.shape[0]
            if take < batch_size:
                block = torch.cat([block, block.new_zeros((batch_size - take, block.shape[1]))])
            out.append(fn(block)[:take])
    with TRACER.span("embed.to_host"):
        return torch.cat(out).cpu().numpy()


def run_retrieve_rerank_eval(
    bienc: BiEncoder,
    ce: CrossEncoder,
    ment_tokens: np.ndarray,
    ent_tokens: np.ndarray,
    gt_labels: np.ndarray,
    top_k: int = 64,
    batch_size: int = 64,
    mesh=None,
    res_dir: Optional[str] = None,
    ment_start: int = 0,
    n_ment: int = -1,
) -> Dict:
    """{'bienc': metrics, 'crossenc': metrics, ...}: retrieval-only vs
    retrieval + rerank accuracy/MRR/recall against the gold labels
    (reference: run, run_cross_encoder_w_binenc_retriever_zeshel.py:80-221),
    and 'seconds' of each stage on the host clock (each ends in a copy to
    the host, so in the device's work too).

    ``ment_start``/``n_ment`` slice the mention range for chunked jobs
    (reference :102); ``res_dir`` receives res.json and the per-mention
    top-k predictions in the reference's file schema."""
    gt_labels = np.asarray(gt_labels)
    if n_ment > 0 or ment_start > 0:
        stop = ment_start + n_ment if n_ment > 0 else ment_tokens.shape[0]
        ment_tokens = ment_tokens[ment_start:stop]
        gt_labels = gt_labels[ment_start:stop]
        if ment_tokens.shape[0] == 0:
            raise ValueError(
                f"empty mention slice: ment_start={ment_start} n_ment={n_ment} "
                "is at/past the mention count; check the chunk grid"
            )
    seconds = {}
    t0 = time.perf_counter()
    LOGGER.info("embedding %d entities", ent_tokens.shape[0])
    label_embeds = embed_tokenized(bienc, ent_tokens, batch_size, "label")
    t1 = time.perf_counter()
    ment_embeds = embed_tokenized(bienc, ment_tokens, batch_size, "input")
    t2 = time.perf_counter()
    seconds.update(embed_entities=t1 - t0, embed_mentions=t2 - t1)

    k = min(top_k, ent_tokens.shape[0])
    index = DenseIndex(label_embeds, mesh=mesh, device=bienc.device)
    t3 = time.perf_counter()
    bi_scores, bi_idx = index.search(ment_embeds, k)
    t4 = time.perf_counter()
    seconds.update(index_build=t3 - t2, search=t4 - t3)

    LOGGER.info("CE reranking top-%d candidates", k)
    ce_scores = crossenc_rerank_scores(ce, ment_tokens, ent_tokens, bi_idx)
    seconds["rerank"] = time.perf_counter() - t4

    res = {
        "bienc": score_topk_preds(gt_labels, bi_idx, bi_scores),
        "crossenc": score_topk_preds(gt_labels, bi_idx, ce_scores),
        "n_ments": int(ment_tokens.shape[0]),
        "n_ents": int(ent_tokens.shape[0]),
        "top_k": int(k),
    }
    if res_dir is not None and world()[0] == 0:  # over a mesh rank 0 writes
        os.makedirs(res_dir, exist_ok=True)
        with open(os.path.join(res_dir, "res.json"), "w") as fout:
            json.dump(res, fout, indent=4)
        # per-mention top-k predictions in the reference's file schema
        # ({"indices": [[...]], "scores": [[...]]}; reference :186-188)
        with open(os.path.join(res_dir, "gt_labels.txt"), "w") as fout:
            json.dump(gt_labels.tolist(), fout)
        with open(os.path.join(res_dir, "bienc_topk_preds.txt"), "w") as fout:
            json.dump({"indices": bi_idx.tolist(), "scores": bi_scores.tolist()}, fout)
        with open(os.path.join(res_dir, "crossenc_topk_preds_w_bienc_retrvr.txt"), "w") as fout:
            json.dump({"indices": bi_idx.tolist(), "scores": ce_scores.tolist()}, fout)
    res["seconds"] = seconds
    return res


def run_from_precomputed_preds(res_dir: str) -> Dict:
    """Metrics from saved top-k prediction files, no models (reference:
    run_w_precomp_results, run_cross_encoder_w_binenc_retriever_zeshel.py:
    224-272). Reads gt_labels.txt, bienc_topk_preds.txt and
    crossenc_topk_preds_w_bienc_retrvr.txt from ``res_dir`` (written by
    either package) and rewrites res.json."""
    with open(os.path.join(res_dir, "gt_labels.txt")) as fin:
        gt_labels = np.asarray(json.load(fin))
    with open(os.path.join(res_dir, "bienc_topk_preds.txt")) as fin:
        bi = json.load(fin)
    with open(os.path.join(res_dir, "crossenc_topk_preds_w_bienc_retrvr.txt")) as fin:
        ce = json.load(fin)
    res = {
        "bienc": score_topk_preds(gt_labels, np.asarray(bi["indices"]), np.asarray(bi["scores"])),
        "crossenc": score_topk_preds(gt_labels, np.asarray(ce["indices"]), np.asarray(ce["scores"])),
        "n_ments": int(len(gt_labels)),
        "from_precomputed": True,
    }
    with open(os.path.join(res_dir, "res.json"), "w") as fout:
        json.dump(res, fout, indent=4)
    return res


def run_biencoder_eval(
    bienc: BiEncoder,
    ment_tokens: np.ndarray,
    ent_tokens: np.ndarray,
    gt_labels: np.ndarray,
    top_k: int = 100,
    batch_size: int = 64,
) -> Dict:
    """Dense-retrieval-only metrics against the gold labels, exact search
    through ``DenseIndex`` (the reference's run_biencoder_eval_zeshel.py:
    29-111)."""
    label_embeds = embed_tokenized(bienc, ent_tokens, batch_size, "label")
    ment_embeds = embed_tokenized(bienc, ment_tokens, batch_size, "input")
    k = min(top_k, ent_tokens.shape[0])
    scores, idx = DenseIndex(label_embeds, device=bienc.device).search(ment_embeds, k)
    return score_topk_preds(np.asarray(gt_labels), idx, scores)
