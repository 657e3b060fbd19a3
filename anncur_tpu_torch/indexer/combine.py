"""Combine chunked score-matrix computations.

A copy of ``anncur_tpu/indexer/combine.py`` over the port's
``indexer/score_matrix.py`` (the same pickle and chunk formats).

Parity with the reference chunk combiner
(eval/combine_chunked_computations.py:125-250): concatenates per-chunk
outputs in mention order, asserting that entity id/token lists are
identical across chunks. Chunks here are the .npz files written by
ScoreMatrixBuilder (or full reference-style pickles via
``combine_pickles``).
"""

from __future__ import annotations

import glob
import json
import logging
import os
import pickle
from typing import List, Optional

import numpy as np

from anncur_tpu_torch.indexer.score_matrix import load_score_matrix, save_score_matrix

LOGGER = logging.getLogger(__name__)


def combine_chunks(chunk_dir: str, n_ments: Optional[int] = None) -> np.ndarray:
    """Concatenate chunk_<start>.npz files into a full score matrix."""
    files = glob.glob(os.path.join(chunk_dir, "chunk_*.npz"))
    if not files:
        raise FileNotFoundError(f"no chunk files in {chunk_dir}")
    chunks = []
    for f in files:
        data = np.load(f)
        chunks.append((int(data["row_start"]), data["scores"]))
    chunks.sort(key=lambda c: c[0])
    expect = 0
    rows: List[np.ndarray] = []
    for start, scores in chunks:
        if start != expect:
            raise ValueError(f"chunk gap: expected row {expect}, found chunk at {start}")
        rows.append(scores)
        expect = start + scores.shape[0]
    out = np.concatenate(rows, axis=0)
    if n_ments is not None and out.shape[0] != n_ments:
        raise ValueError(f"combined {out.shape[0]} rows != expected {n_ments}")
    return out


def combine_pickles(chunk_paths: List[str], out_path: str, overwrite: bool = False) -> None:
    """Combine reference-format score-matrix pickles (mention-range
    chunks of one world) into a single pickle; asserts identical entity
    lists (reference: combine_chunked_computations.py:209-210)."""
    if os.path.exists(out_path) and not overwrite:
        raise FileExistsError(f"{out_path} exists; pass overwrite=True")
    datas = [load_score_matrix(p) for p in chunk_paths]
    ent_ids = datas[0]["entity_id_list"]
    for d in datas[1:]:
        if not np.array_equal(d["entity_id_list"], ent_ids):
            raise ValueError("entity_id_list mismatch across chunks")
    scores = np.concatenate([d["ment_to_ent_scores"] for d in datas], axis=0)
    ment_tokens = np.concatenate([d["mention_tokens_list"] for d in datas], axis=0)
    save_score_matrix(
        out_path,
        ment_to_ent_scores=scores,
        mention_tokens_list=ment_tokens,
        entity_id_list=ent_ids,
        entity_tokens_list=datas[0].get("entity_tokens_list"),
        test_data=[d.get("test_data") for d in datas],
        arg_dict={"combined_from": chunk_paths},
    )
    LOGGER.info("combined %d chunks -> %s (%s)", len(datas), out_path, scores.shape)


def combine_topk_preds(
    chunk_files: List[str],
    out_path: str,
    expected_rows: Optional[int] = None,
    overwrite: bool = False,
) -> dict:
    """Merge chunked retrieve-and-rerank top-k prediction JSONs.

    Parity with the reference's second combiner mode,
    ``combine_bi_plus_cross_eval_results``
    (eval/combine_chunked_computations.py:20-122): each chunk file is a
    JSON ``{"indices": [[...]], "scores": [[...]]}`` over a mention
    range; rows are concatenated in the given (mention) order. Unlike the
    reference's interactive overwrite prompt, an existing output raises
    unless ``overwrite=True``.
    """
    if os.path.exists(out_path) and not overwrite:
        raise FileExistsError(f"{out_path} exists; pass overwrite=True")
    combined = {"indices": [], "scores": []}
    width = None
    for f in chunk_files:
        with open(f) as fin:
            preds = json.load(fin)
        if len(preds["indices"]) != len(preds["scores"]):
            raise ValueError(
                f"{f}: {len(preds['indices'])} index rows != "
                f"{len(preds['scores'])} score rows"
            )
        w = len(preds["indices"][0]) if preds["indices"] else None
        if width is None:
            width = w
        elif w is not None and w != width:
            raise ValueError(f"{f}: top-k width {w} != {width} of earlier chunks")
        combined["indices"] += preds["indices"]
        combined["scores"] += preds["scores"]
        LOGGER.info("%s: %d rows", f, len(preds["indices"]))
    if expected_rows is not None and len(combined["indices"]) != expected_rows:
        raise ValueError(
            f"combined {len(combined['indices'])} rows != expected {expected_rows}"
        )
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as fout:
        json.dump(combined, fout)
    LOGGER.info(
        "combined %d chunks -> %s (%d rows)",
        len(chunk_files),
        out_path,
        len(combined["indices"]),
    )
    return combined


def combine_rr_chunk_dirs(
    chunk_dirs: List[str],
    out_dir: str,
    overwrite: bool = False,
) -> None:
    """Merge chunked retrieve-and-rerank result DIRS into one res_dir
    that ``run_from_precomputed_preds`` can consume directly: both
    topk-pred JSONs are row-concatenated and the per-chunk
    ``gt_labels.txt`` flat lists are concatenated in the same order
    (the file-level :func:`combine_topk_preds` alone cannot merge the
    gt file, which a re-scoring run requires)."""
    os.makedirs(out_dir, exist_ok=True)
    for name in ("bienc_topk_preds.txt", "crossenc_topk_preds_w_bienc_retrvr.txt"):
        combine_topk_preds(
            [os.path.join(d, name) for d in chunk_dirs],
            os.path.join(out_dir, name),
            overwrite=overwrite,
        )
    gt_out = os.path.join(out_dir, "gt_labels.txt")
    if os.path.exists(gt_out) and not overwrite:
        raise FileExistsError(f"{gt_out} exists; pass overwrite=True")
    gt: List[int] = []
    for d in chunk_dirs:
        with open(os.path.join(d, "gt_labels.txt")) as fin:
            gt += json.load(fin)
    n_rows = None
    with open(os.path.join(out_dir, "bienc_topk_preds.txt")) as fin:
        n_rows = len(json.load(fin)["indices"])
    if len(gt) != n_rows:
        raise ValueError(f"{len(gt)} gt labels != {n_rows} prediction rows")
    with open(gt_out, "w") as fout:
        json.dump(gt, fout)
    LOGGER.info("combined %d chunk dirs -> %s (%d mentions)", len(chunk_dirs), out_dir, len(gt))
