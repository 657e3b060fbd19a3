"""Raw ZeShEL -> BLINK-format preprocessing CLI
(parity with utils/preprocess_zeshel.py:120-152).

A copy of ``anncur_tpu/cli/preprocess_zeshel.py`` over the port's modules (it touches no
tensors, so it takes no ``--device``).
"""

from __future__ import annotations

import argparse
import logging

from anncur_tpu_torch.data.preprocess import preprocess_zeshel_data


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--root_data_dir", required=True)
    args = p.parse_args(argv)
    preprocess_zeshel_data(args.root_data_dir)


if __name__ == "__main__":
    main()
