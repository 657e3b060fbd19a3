"""Split a score matrix into train/test mention splits for CUR
experiments (parity with utils/split_zeshel_ment2ent_for_cur_exps.py).

A copy of ``anncur_tpu/cli/split_matrix.py`` over the port's modules (it touches no
tensors, so it takes no ``--device``).
"""

from __future__ import annotations

import argparse
import logging

import numpy as np

from anncur_tpu_torch.indexer.score_matrix import load_score_matrix
from anncur_tpu_torch.indexer.splits import split_score_matrix


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--score_matrix", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--nm_train_vals", nargs="+", type=int, default=[100, 500, 2000])
    p.add_argument("--n_splits", type=int, default=1)
    p.add_argument("--dev_frac", type=float, default=0.2)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    data = load_score_matrix(args.score_matrix)
    split_score_matrix(
        np.asarray(data["ment_to_ent_scores"], np.float32),
        np.asarray(data["mention_tokens_list"]),
        np.asarray(data["entity_id_list"]),
        args.out_dir,
        nm_train_vals=args.nm_train_vals,
        n_splits=args.n_splits,
        dev_frac=args.dev_frac,
        seed=args.seed,
    )


if __name__ == "__main__":
    main()
