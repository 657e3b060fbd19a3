"""Pre-tokenize all entities of a world -> .npy (n_ents, L).

Parity with utils/tokenize_entities.py:21-63.

A copy of ``anncur_tpu/cli/tokenize_entities.py`` over the port's modules (it touches no
tensors, so it takes no ``--device``).
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np

from anncur_tpu_torch.data import load_entities, tokenize_entities
from anncur_tpu_torch.models.tokenizer import WordPieceTokenizer

LOGGER = logging.getLogger("anncur_tpu_torch.tokenize_entities")


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ent_file", required=True)
    p.add_argument("--vocab_file", required=True)
    p.add_argument("--out_file", required=True)
    p.add_argument("--max_len", type=int, default=128)
    args = p.parse_args(argv)

    tokenizer = WordPieceTokenizer.from_vocab_file(args.vocab_file)
    _, entities = load_entities(args.ent_file)
    tokens = tokenize_entities(entities, tokenizer, args.max_len)
    os.makedirs(os.path.dirname(args.out_file) or ".", exist_ok=True)
    np.save(args.out_file, tokens)
    LOGGER.info("wrote %s %s", args.out_file, tokens.shape)


if __name__ == "__main__":
    main()
