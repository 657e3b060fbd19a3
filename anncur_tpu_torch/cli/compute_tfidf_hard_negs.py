"""Precompute TF-IDF hard negatives per world -> JSON {indices, scores}
(parity with utils/compute_tfidf_hard_negs.py:24-92).

Counterpart of ``anncur_tpu/cli/compute_tfidf_hard_negs.py``: the same
flags and JSON, plus ``--device``. The mine is
``train/negatives.py::tfidf_topk``: the port's exact MIPS (kernel B on
the card) over dense tf-idf rows as wide as the fitted vocabulary.
"""

from __future__ import annotations

import argparse
import json
import logging
import os

from anncur_tpu_torch.cli import _common
from anncur_tpu_torch.data import load_entities, load_mentions
from anncur_tpu_torch.train.negatives import tfidf_topk

LOGGER = logging.getLogger("anncur_tpu_torch.compute_tfidf_hard_negs")


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ment_file", required=True)
    p.add_argument("--ent_file", required=True)
    p.add_argument("--out_file", required=True)
    p.add_argument("--num_negs", type=int, default=100)
    _common.add_device_arg(p)
    args = p.parse_args(argv)
    device = _common.device_of(args)

    kb2local, entities = load_entities(args.ent_file)
    mentions = load_mentions(args.ment_file, kb2local)
    # reference embeds the FULL context string, not the bare surface form
    # (get_hard_negs_tfidf, utils/data_process.py:373-381): short surface
    # strings give near-degenerate tf-idf vectors and weak negatives
    ment_texts = [" ".join([m["context_left"], m["mention"], m["context_right"]]) for m in mentions]
    k = min(args.num_negs + 1, len(entities))
    scores, idx = tfidf_topk(ment_texts, entities, k, device)

    out = {"indices": [], "scores": []}
    for i, m in enumerate(mentions):
        keep = [(int(j), float(s)) for j, s in zip(idx[i], scores[i]) if j != m["label_id"]]
        keep = keep[: args.num_negs]
        out["indices"].append([j for j, _ in keep])
        out["scores"].append([s for _, s in keep])
    os.makedirs(os.path.dirname(args.out_file) or ".", exist_ok=True)
    with open(args.out_file, "w") as fout:
        json.dump(out, fout)
    LOGGER.info("wrote %s (%d mentions x %d negs)", args.out_file, len(mentions), args.num_negs)


if __name__ == "__main__":
    main()
