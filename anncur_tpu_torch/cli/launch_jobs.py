"""Generate/launch train + eval job grids of the port's CLIs
(parity with utils/launch_eval_and_bienc_distill_jobs.py:147-550).

Counterpart of ``anncur_tpu/cli/launch_jobs.py`` over
``utils/launcher.py``: the same flags, plus ``--device``, which is passed
on to every job (default: none, so each job runs on its CLI's default
device, the card). A failed job makes the launch exit non-zero after the
remaining jobs ran.
"""

from __future__ import annotations

import argparse
import json
import logging

from anncur_tpu_torch.utils.launcher import launch, make_eval_jobs, make_train_jobs

LOGGER = logging.getLogger("anncur_tpu_torch.launch_jobs")


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--kind", choices=["train", "eval"], required=True)
    p.add_argument("--base_config", default="", help="train: base config json")
    p.add_argument("--grid", required=True, help="JSON dict of param -> list of values")
    p.add_argument("--result_probe", default="", help="skip-done path template over grid keys")
    p.add_argument("--mode", default="inductive", help="eval: transductive|inductive")
    p.add_argument("--score_matrix_template", default="")
    p.add_argument("--res_dir_template", default="")
    p.add_argument("--extra_args", default="")
    p.add_argument("--backend", default="print", help="print | local | template with {cmd}")
    p.add_argument("--no_skip_done", action="store_true")
    p.add_argument("--device", default="", help="--device for every job (default: the jobs' own, cuda)")
    args = p.parse_args(argv)

    grid = json.loads(args.grid)
    device = args.device or None
    if args.kind == "train":
        jobs = make_train_jobs(args.base_config, grid, result_probe=args.result_probe or None, device=device)
    else:
        jobs = make_eval_jobs(
            args.mode, args.score_matrix_template, args.res_dir_template, grid, args.extra_args, device=device
        )
    try:
        return launch(jobs, backend=args.backend, skip_done=not args.no_skip_done)
    except RuntimeError as err:
        raise SystemExit(str(err)) from err


if __name__ == "__main__":
    main()
