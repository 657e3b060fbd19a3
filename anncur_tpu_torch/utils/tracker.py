"""Experiment tracking + profiling.

Counterpart of ``anncur_tpu/utils/tracker.py``; the profiler is
``torch.profiler`` in place of ``jax.profiler``.

The reference streams losses/LR/progress fractions to wandb with an
online -> offline fallback chain (models/pairwise_trainer.py:183-189,
run_cross_encoder_for_ment_ent_matrix_zeshel.py:351-377). This tracker
keeps that contract with zero mandatory dependencies: metrics append to
a JSONL file and mirror to the logger; if wandb is importable AND
usable, it is attached transparently (never required, never fatal —
and unlike the reference, no API keys are ever hardcoded; see the
explicit warning about run_retrieval_..._w_fixed_train_test_splits.py:458
in SURVEY §5.5).

Profiling: :func:`trace_profile` wraps a block in a ``torch.profiler``
trace of the host and, where there is one, the card (the reference's PL
'simple' profiler analogue, SURVEY §5.1), written as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from typing import Any, Dict, Optional

LOGGER = logging.getLogger(__name__)


class ExperimentTracker:
    def __init__(
        self,
        run_dir: str,
        project: str = "anncur_tpu",  # the JAX package's project name: one dashboard
        config: Optional[Dict] = None,
        use_wandb: bool = False,
    ):
        self.run_dir = run_dir
        os.makedirs(run_dir, exist_ok=True)
        self.metrics_path = os.path.join(run_dir, "metrics.jsonl")
        self._t0 = time.time()
        self._step = 0
        self._wandb = None
        if config:
            with open(os.path.join(run_dir, "tracker_config.json"), "w") as fout:
                json.dump(config, fout, indent=2, default=str)
        if use_wandb:
            self._wandb = self._try_wandb(project, run_dir, config)

    @staticmethod
    def _try_wandb(project, run_dir, config):
        """online -> offline -> disabled fallback chain (reference
        behavior, pairwise_trainer.py:183-189)."""
        try:
            import wandb  # noqa

            for mode in ("online", "offline"):
                try:
                    run = wandb.init(project=project, dir=run_dir, config=config, mode=mode)
                    LOGGER.info("wandb attached (mode=%s)", mode)
                    return run
                except Exception:
                    continue
        except ImportError:
            pass
        LOGGER.info("wandb unavailable; tracking to %s only", run_dir)
        return None

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None) -> None:
        step = self._step if step is None else step
        self._step = step + 1
        rec = {"step": step, "time": round(time.time() - self._t0, 3)}
        rec.update({k: (float(v) if hasattr(v, "__float__") else v) for k, v in metrics.items()})
        with open(self.metrics_path, "a") as fout:
            fout.write(json.dumps(rec) + "\n")
        if self._wandb is not None:
            try:
                self._wandb.log(metrics, step=step)
            except Exception:
                pass

    def progress(self, name: str, frac: float) -> None:
        """Progress-fraction stream (reference 'frac_done'/'eval_ctr_frac'
        logging)."""
        self.log({f"{name}_frac": round(frac, 4)})

    def alert(self, message: str) -> None:
        LOGGER.error("ALERT: %s", message)
        self.log({"alert": message})

    def finish(self) -> None:
        if self._wandb is not None:
            try:
                self._wandb.finish()
            except Exception:
                pass


@contextlib.contextmanager
def trace_profile(log_dir: Optional[str], enabled: bool = True):
    """``torch.profiler`` trace context; the trace is written to
    ``log_dir/trace.json`` (open it in Perfetto or chrome://tracing)."""
    if not enabled or not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    LOGGER.info("profile trace written to %s", log_dir)


class StageTimer:
    """Named wall-clock stage timing (the 'simple profiler' analogue)."""

    def __init__(self):
        self.times: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.time()
        try:
            yield
        finally:
            self.times[name] = self.times.get(name, 0.0) + time.time() - t0

    def report(self) -> Dict[str, float]:
        total = sum(self.times.values()) or 1.0
        return {
            name: {"seconds": round(t, 3), "frac": round(t / total, 3)}
            for name, t in sorted(self.times.items(), key=lambda kv: -kv[1])
        }
