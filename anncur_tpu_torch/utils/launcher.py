"""Job-grid launcher.

Counterpart of ``anncur_tpu/utils/launcher.py`` (parity with the
reference SLURM launcher, utils/launch_eval_and_bienc_distill_jobs.py:
22-550): expands parameter grids (domains x neg strategies x nm_train x
ckpt metrics) into train / eval command lines of the port's CLIs
(``python -m anncur_tpu_torch.cli.*``, the JAX package's flags), skips
jobs whose result files already exist (the reference's resume,
:179-185, 537-545), and submits through a pluggable backend: 'print'
(emit shell lines), 'local' (run serially) or a template string for any
scheduler (e.g. 'sbatch ... {cmd}').

The commands carry ``--device`` only where the caller passes
``device``; without it each job runs on its CLI's default device, the
card. A job started here inherits this process's environment, with the
port's checkout put first on ``PYTHONPATH`` so that ``python -m`` finds
the package from any working directory. Where the JAX launcher logs a
failed job and returns, this one runs the remaining jobs and then
raises: a sweep with a failed job is a failed launch.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import shlex
import subprocess
import sys
from typing import Dict, Iterable, List, Optional, Sequence

LOGGER = logging.getLogger(__name__)

# the launcher's own interpreter, not whatever `python` resolves to on
# PATH (a different venv/system python breaks every generated job)
PYTHON = shlex.quote(sys.executable or "python")
# the directory that holds the anncur_tpu_torch package
CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _fmt_value(v) -> str:
    # dict-typed Config fields parse with json.loads: repr() would emit
    # single quotes that json rejects, killing every job at argparse time
    if isinstance(v, (dict, bool)):
        return shlex.quote(json.dumps(v))
    return shlex.quote(str(v))


def _fmt_overrides(overrides: Dict) -> str:
    parts = []
    for k, v in overrides.items():
        if isinstance(v, (list, tuple)):
            # quote each element: values with spaces/metacharacters would
            # otherwise split into extra args (or execute) under shell=True
            parts.append(f"--{k} " + " ".join(_fmt_value(x) for x in v))
        else:
            parts.append(f"--{k} {_fmt_value(v)}")
    return " ".join(parts)


def _device_arg(device: Optional[str]) -> str:
    return f" --device {shlex.quote(device)}" if device else ""


def make_train_jobs(
    base_config: str,
    grid: Dict[str, Sequence],
    result_probe: Optional[str] = None,
    device: Optional[str] = None,
) -> List[Dict]:
    """Cartesian product of grid values -> train commands.

    ``result_probe``: format string over grid keys; job skipped if the
    formatted path exists (reference skip-done logic, :179-185).
    """
    jobs = []
    keys = list(grid.keys())
    for combo in itertools.product(*(grid[k] for k in keys)):
        overrides = dict(zip(keys, combo))
        probe = result_probe.format(**overrides) if result_probe else None
        done = probe is not None and os.path.exists(probe)
        cmd = (
            f"{PYTHON} -m anncur_tpu_torch.cli.train --config {shlex.quote(base_config)} "
            + _fmt_overrides(overrides)
            + _device_arg(device)
        )
        jobs.append({"cmd": cmd, "overrides": overrides, "done": done, "probe": probe})
    return jobs


def make_eval_jobs(
    mode: str,
    score_matrix_template: str,
    res_dir_template: str,
    grid: Dict[str, Sequence],
    extra_args: str = "",
    device: Optional[str] = None,
) -> List[Dict]:
    """Eval command grid over (domain, nm_train, method, ...) templates."""
    jobs = []
    keys = list(grid.keys())
    for combo in itertools.product(*(grid[k] for k in keys)):
        overrides = dict(zip(keys, combo))
        score_matrix = score_matrix_template.format(**overrides)
        res_dir = res_dir_template.format(**overrides)
        if mode != "inductive" and "method" in overrides and "{method}" not in res_dir_template:
            # run_transductive_eval writes ONE fixed-name json per res_dir:
            # method-gridded jobs sharing a dir would clobber each other and
            # skip-done would mis-skip every method after the first
            res_dir = os.path.join(res_dir, f"method={overrides['method']}")
        probe = os.path.join(
            res_dir, f"method={overrides.get('method', 'cur')}_s={overrides.get('seed', 0)}", "res.json"
        ) if mode == "inductive" else os.path.join(res_dir, "retrieval_wrt_exact_crossenc.json")
        done = os.path.exists(probe)
        cmd = (
            f"{PYTHON} -m anncur_tpu_torch.cli.eval_retrieval --mode {mode} "
            f"--score_matrix {shlex.quote(score_matrix)} --res_dir {shlex.quote(res_dir)} "
        )
        if "method" in overrides:
            cmd += f"--methods {overrides['method']} "
        if "seed" in overrides:
            cmd += f"--seed {overrides['seed']} "
        if "train_score_matrix" in overrides:
            cmd += f"--train_score_matrix {shlex.quote(str(overrides['train_score_matrix']))} "
        cmd += extra_args
        cmd = cmd.strip() + _device_arg(device)
        jobs.append({"cmd": cmd, "overrides": overrides, "done": done, "probe": probe})
    return jobs


def _job_env() -> Dict[str, str]:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (CHECKOUT, env.get("PYTHONPATH", "")) if p)
    return env


def launch(jobs: Iterable[Dict], backend: str = "print", skip_done: bool = True) -> List[Dict]:
    """Run/emit the pending jobs; returns the jobs launched.

    backend: 'print' | 'local' | a template containing '{cmd}'
    (e.g. \"sbatch --partition=gpu --wrap '{cmd}'\"). A job whose command
    exits non-zero is marked ``failed``; the remaining jobs still run (one
    failure must not abort an unattended sweep), then RuntimeError names
    the failed ones."""
    jobs = list(jobs)  # a generator would be exhausted before the count log
    launched = []
    for job in jobs:
        if skip_done and job.get("done"):
            LOGGER.info("skip (done): %s", job.get("probe"))
            continue
        if backend == "print":
            print(job["cmd"])
        else:
            cmd = job["cmd"] if backend == "local" else backend.format(cmd=job["cmd"])
            LOGGER.info("running: %s", cmd)
            rc = subprocess.run(cmd, shell=True, env=_job_env()).returncode
            if rc != 0:
                job["failed"] = True
                LOGGER.error("job failed (rc=%d): %s", rc, cmd)
                continue
        launched.append(job)
    failed = [j for j in jobs if j.get("failed")]
    LOGGER.info(
        "%d launched, %d skipped, %d failed",
        len(launched), len(jobs) - len(launched) - len(failed), len(failed),
    )
    if failed:
        raise RuntimeError(f"{len(failed)} of {len(jobs)} jobs failed: " + "; ".join(j["cmd"] for j in failed))
    return launched
