"""Report numerical rank of score matrices
(parity with eval/compute_m2e_matrix_ranks.py:29-56).

A copy of ``anncur_tpu/cli/rank_probe.py`` over the port's
``evalx/rank_probe.py::matrix_rank_report`` (a host SVD: it touches no
tensors, so it takes no ``--device``).
"""

from __future__ import annotations

import argparse
import json
import logging

import numpy as np

from anncur_tpu_torch.evalx.rank_probe import matrix_rank_report
from anncur_tpu_torch.indexer.score_matrix import load_score_matrix


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--score_matrices", nargs="+", required=True)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)

    reports = {}
    for path in args.score_matrices:
        mat = np.asarray(load_score_matrix(path)["ment_to_ent_scores"], np.float32)
        reports[path] = matrix_rank_report(mat)
        print(path, json.dumps(reports[path]))
    if args.out:
        with open(args.out, "w") as fout:
            json.dump(reports, fout, indent=2)
    return reports


if __name__ == "__main__":
    main()
