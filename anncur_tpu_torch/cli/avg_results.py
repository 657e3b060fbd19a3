"""Average res.json metric dicts across domains
(parity with eval/avg_zeshel_results.py:65-111).

A copy of ``anncur_tpu/cli/avg_results.py`` over the port's modules (it touches no
tensors, so it takes no ``--device``).
"""

from __future__ import annotations

import argparse
import glob
import json
import logging
import os

from anncur_tpu_torch.data.zeshel import N_MENTS_ZESHEL
from anncur_tpu_torch.evalx.aggregate import avg_results

LOGGER = logging.getLogger("anncur_tpu_torch.avg_results")


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--res_glob", required=True, help="glob of per-domain res.json; domain name = parent dir")
    p.add_argument("--out", required=True)
    p.add_argument("--metric_key", default="", help="optional nested key path a.b.c into each res.json")
    args = p.parse_args(argv)

    per_domain = {}
    for path in sorted(glob.glob(args.res_glob)):
        domain = os.path.basename(os.path.dirname(path))
        with open(path) as fin:
            res = json.load(fin)
        for part in [k for k in args.metric_key.split(".") if k]:
            res = res[part]
        per_domain[domain] = res
    weights = {d: N_MENTS_ZESHEL.get(d, 1) for d in per_domain}
    avg = avg_results(per_domain, weights)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as fout:
        json.dump({"per_domain": per_domain, "avg": avg}, fout, indent=2)
    LOGGER.info("wrote %s (%d domains)", args.out, len(per_domain))


if __name__ == "__main__":
    main()
