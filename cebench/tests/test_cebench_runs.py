"""Whole runs of every cell at a tiny size on the CPU: the harness past
its look for a card, the driver's set-up, window and check. A sound run is
correct; the control (the reference one precision lower, in the
program's place) and each fault a cell can have, planted in the timed
path, are not. And nothing a run loads or any benchmark source imports is
JAX, Flax or the JAX package."""

import functools
import json
import os
import re
import subprocess
import sys

import pytest
import torch

from cebench import control
from cebench.lib import harness
from cebench.lib.trace import PACKAGE
from cebench.tests.tiny import TINY

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = sorted(TINY)
SEED = 2**31 + 11


@pytest.fixture(autouse=True)
def _threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def tiny_run(cell, seconds=1.5):
    return harness.execute(harness.Run(cell, SEED, seconds, False, "cpu", overrides=TINY[cell]))


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    res = tiny_run(cell)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    e2e = {m["name"] for m in harness.load_benchmark()["end_to_end"] if cell in m.get("workloads", [cell])}
    assert set(res["metrics"]) == e2e
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    run = harness.Run(cell, SEED, 1.5, False, "cpu", overrides=TINY[cell])
    gaps = control.gaps(run)
    assert set(gaps) <= set(run.limits)
    assert any(not v <= run.limits[k] for k, v in gaps.items()), gaps


def _patch_all(monkeypatch, module_name, attr, factory):
    original = getattr(sys.modules[module_name], attr)
    # the broken function carries the original's launch counters, which
    # the original counts through its module's binding
    bad = functools.update_wrapper(factory(original), original)
    for name, mod in list(sys.modules.items()):
        if mod is not None and (name == PACKAGE or name.startswith(PACKAGE + ".")):
            for key, val in list(vars(mod).items()):
                if val is original:
                    monkeypatch.setattr(mod, key, bad)


def half_batch_mean(monkeypatch, cell):
    """The second half of every forward's outputs replaced by the mean of
    the first half's."""
    from anncur_tpu_torch.models.biencoder import BiEncoder
    from anncur_tpu_torch.models.crossencoder import CrossEncoder

    def broken(fn):
        def method(self, *a, **kw):
            out = fn(self, *a, **kw).clone()
            half = out.shape[0] // 2
            if half:
                out[half:] = out[:half].mean(0)
            return out
        return method

    cls, attr = (BiEncoder, "encode_input") if cell.startswith("bienc") else (CrossEncoder, "score")
    monkeypatch.setattr(cls, attr, broken(getattr(cls, attr)))


def answer_altered(monkeypatch, cell):
    """Every seventh CE score, or tower embedding, replaced where it is
    produced by its neighbour's: the answers of one pair given to
    another."""
    from anncur_tpu_torch.models.biencoder import BiEncoder
    from anncur_tpu_torch.models.crossencoder import CrossEncoder

    def broken(fn):
        def method(self, *a, **kw):
            out = fn(self, *a, **kw).clone()
            out[::7] = out.roll(-1, 0)[::7]
            return out
        return method

    cls, attr = (BiEncoder, "encode_input") if cell.startswith("bienc") else (CrossEncoder, "score")
    monkeypatch.setattr(cls, attr, broken(getattr(cls, attr)))


def kernel_b_ids_shifted(monkeypatch, cell):
    """Kernel B answers the next id after each of its picks."""
    import anncur_tpu_torch.ops.mips_kernel  # noqa: F401

    def factory(fn):
        def mips_topk_fused(queries, items, k, n_valid=None, exclude=None):
            s, i = fn(queries, items, k, n_valid, exclude)
            nv = items.shape[0] if n_valid is None else n_valid
            return s, (i + 1) % nv
        return mips_topk_fused

    _patch_all(monkeypatch, "anncur_tpu_torch.ops.mips_kernel", "mips_topk_fused", factory)


FAULTS = {
    "ce-yugioh.fixed-c600.open": [half_batch_mean, answer_altered, kernel_b_ids_shifted],
    "ce-yugioh.build": [half_batch_mean, answer_altered],
    "ce-yugioh.adaptive-b210r8": [half_batch_mean, answer_altered, kernel_b_ids_shifted],
    "bienc-military.dense-top64": [half_batch_mean, answer_altered, kernel_b_ids_shifted],
}


@pytest.mark.parametrize("cell, fault", [(c, f) for c in CELLS for f in FAULTS[c]],
                         ids=lambda x: x if isinstance(x, str) else x.__name__)
def test_a_planted_fault_is_not_correct(monkeypatch, cell, fault):
    fault(monkeypatch, cell)
    res = tiny_run(cell)
    assert not res["correct"], res["checks"]


def test_no_run_loads_jax_or_the_jax_package():
    """Each cell's set-up at a tiny size in a fresh process: nothing loaded
    has a top-level name jax, jaxlib, flax or anncur_tpu."""
    code = (
        "import sys, json; sys.path.insert(0, %r)\n"
        "import importlib, torch\n"
        "from cebench.lib import harness\n"
        "from cebench.tests.tiny import TINY\n"
        "for cell in sorted(TINY):\n"
        "    run = harness.Run(cell, 3, 1.0, False, 'cpu', overrides=TINY[cell])\n"
        "    run.launches.install()\n"
        "    importlib.import_module('cebench.drivers.' + run.traffic['driver']).setup(run)\n"
        "import cebench.control, cebench.sweep, cebench.run\n"
        "print(json.dumps(harness.forbidden_modules()))\n" % os.path.dirname(HERE)
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_no_benchmark_source_imports_jax_or_the_jax_package():
    pattern = re.compile(r"^\s*(?:import|from)\s+(jax|jaxlib|flax|anncur_tpu)(?:[.\s,]|$)", re.MULTILINE)
    found = []
    for root, _, files in os.walk(HERE):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(root, name)) as fin:
                    found += [(name, m.group(1)) for m in pattern.finditer(fin.read())]
    assert found == []


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "anncur_tpu_torch_extra", sys)
    assert "anncur_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "anncur_tpu.core", sys)
    assert "anncur_tpu" in harness.forbidden_modules()


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_at_the_cells_own_size(cell):
    """On the card: the control at bert-base widths and the cell's sizes,
    three seeds, against the cell's own limits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    seconds = harness.load_benchmark()["run_seconds"]
    for seed in (101, 2**31 + 3, 77777):
        run = harness.Run(cell, seed, seconds, False, "cuda:0")
        gaps = control.gaps(run)
        print(json.dumps({"control": cell, "seed": seed, "gaps": gaps}))
        assert any(not v <= run.limits[k] for k, v in gaps.items()), (seed, gaps)


@pytest.mark.cuda
@pytest.mark.parametrize("cell, fault", [(c, f) for c in CELLS for f in FAULTS[c]],
                         ids=lambda x: x if isinstance(x, str) else x.__name__)
def test_a_planted_fault_fails_at_the_cells_own_size(monkeypatch, cell, fault):
    """On the card: a whole run at bert-base widths and the cell's own
    sizes and load, with the fault planted in the timed path, judged by
    the cell's own limits (a short window: the check's sample is the
    same size)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    fault(monkeypatch, cell)
    res = harness.execute(harness.Run(cell, 2**31 + 101, 12, False, "cuda:0"))
    print(json.dumps({"fault": fault.__name__, "cell": cell, "checks": res["checks"]}))
    assert not res["correct"], res["checks"]
