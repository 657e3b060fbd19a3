"""Train/test mention splits of a score matrix for CUR experiments.

A copy of ``anncur_tpu/indexer/splits.py`` over the port's
``indexer/score_matrix.py`` (the same pickle and chunk formats).

Parity with utils/split_zeshel_ment2ent_for_cur_exps.py:25-129: random
mention splits for each (nm_train x split_idx), train further divided
into train_train / train_dev by ``dev_frac``; per-split pickles carry the
row indices so chunk provenance survives.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from anncur_tpu_torch.indexer.score_matrix import save_score_matrix

LOGGER = logging.getLogger(__name__)


def split_score_matrix(
    scores: np.ndarray,  # (n_m, n_e)
    mention_tokens: np.ndarray,
    entity_ids: np.ndarray,
    out_dir: str,
    nm_train_vals: Sequence[int] = (100, 500, 2000),
    n_splits: int = 1,
    dev_frac: float = 0.2,
    seed: int = 0,
) -> List[Dict[str, str]]:
    """Writes {train,train_train,train_dev,test}.pkl per (nm_train, split).

    Returns the list of file-path dicts.
    """
    n_m = scores.shape[0]
    rng = np.random.default_rng(seed)
    out = []
    for nm_train in nm_train_vals:
        if nm_train >= n_m:
            LOGGER.warning("nm_train=%d >= n_ments=%d; skipping", nm_train, n_m)
            continue
        for split_idx in range(n_splits):
            perm = rng.permutation(n_m)
            train_idxs = np.sort(perm[:nm_train])
            test_idxs = np.sort(perm[nm_train:])
            n_dev = max(1, int(dev_frac * nm_train))
            train_perm = rng.permutation(nm_train)
            tt_idxs = train_idxs[np.sort(train_perm[n_dev:])]
            td_idxs = train_idxs[np.sort(train_perm[:n_dev])]

            d = os.path.join(out_dir, f"nm_train={nm_train}_split={split_idx}")
            os.makedirs(d, exist_ok=True)
            paths = {}
            for name, idxs in (
                ("train", train_idxs),
                ("train_train", tt_idxs),
                ("train_dev", td_idxs),
                ("test", test_idxs),
            ):
                path = os.path.join(d, f"{name}.pkl")
                save_score_matrix(
                    path,
                    ment_to_ent_scores=scores[idxs],
                    mention_tokens_list=mention_tokens[idxs],
                    entity_id_list=entity_ids,
                    arg_dict={"ment_idxs": idxs.tolist(), "nm_train": int(nm_train), "split_idx": split_idx},
                )
                paths[name] = path
            out.append(paths)
    return out
