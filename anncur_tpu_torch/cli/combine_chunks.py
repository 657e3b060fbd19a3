"""Combine chunked computations: score-matrix pickles or
retrieve-and-rerank top-k prediction JSONs
(parity with eval/combine_chunked_computations.py — `m2e` mode with
:20-122's bi+cross topk-pred merging as `topk_preds`).

A copy of ``anncur_tpu/cli/combine_chunks.py`` over the port's modules (it touches no
tensors, so it takes no ``--device``).
"""

from __future__ import annotations

import argparse
import logging

from anncur_tpu_torch.indexer.combine import (
    combine_pickles,
    combine_rr_chunk_dirs,
    combine_topk_preds,
)


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument(
        "--mode",
        choices=["pickles", "topk_preds", "rr_dirs"],
        default="pickles",
        help="pickles: score-matrix chunks; topk_preds: "
        "crossenc_topk_preds_w_bienc_retrvr.txt-style JSON chunks; "
        "rr_dirs: whole retrieve-rerank result dirs (merges both pred "
        "files AND gt_labels.txt so --from_precomputed re-scoring works "
        "on the output)",
    )
    p.add_argument("--chunks", nargs="+", required=True, help="chunk files/dirs in mention order")
    p.add_argument("--out", required=True)
    p.add_argument("--overwrite", action="store_true")
    p.add_argument(
        "--expected_rows",
        type=int,
        default=None,
        help="assert the combined topk_preds row count (e.g. world n_ments)",
    )
    args = p.parse_args(argv)
    if args.mode == "pickles":
        combine_pickles(args.chunks, args.out, overwrite=args.overwrite)
    elif args.mode == "rr_dirs":
        combine_rr_chunk_dirs(args.chunks, args.out, overwrite=args.overwrite)
    else:
        combine_topk_preds(
            args.chunks,
            args.out,
            expected_rows=args.expected_rows,
            overwrite=args.overwrite,
        )


if __name__ == "__main__":
    main()
