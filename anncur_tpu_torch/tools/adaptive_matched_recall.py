"""Matched-recall budget search: the smallest adaptive budget whose recall@10
matches the fixed-anchor path at cost 600.

Counterpart of ``tools/adaptive_matched_recall.py``, the evidence behind
the budget of ``bench.py`` line 3. An oracle sweep with no encoder: on
yugioh-scale synthetic score matrices (10,000 items, 500 train rows,
BASELINE config #1's shape; effective ranks 50, 150 and 400) and on the
committed trained cross-encoder matrices (``benchmarks/trained_ce_matrix*
.npz``, read, never written), it measures the recall@10 of the port's
fused adaptive engine (``core/adaptive_fused.py``) across budgets, CUR at
3, 5 and 8 rounds and AXN at 3 and 5, against the fixed-anchor path at
cost 600 (500 anchors + 100 rerank), and the early-stop engine's recall
and average budget per (base, ceiling) config. The headline is the
worst case across scenarios (``compute_headline``), as JAX's.

    python -m anncur_tpu_torch.tools.adaptive_matched_recall
    python -m anncur_tpu_torch.tools.adaptive_matched_recall --tiny --device cpu

``--tiny`` is JAX's ``--quick`` (16 queries, 80 train rows, 1,000 items
and the ``*_quick.npz`` matrices). The sweep runs on the card unless
``--device cpu`` says otherwise; on the CPU it holds torch to one thread,
since a threaded batched ``linalg.solve_ex`` of 158 rows or more hangs
there. ``--only`` and ``--es_only`` update a prior artifact (``--out``):
a scenario the artifact lacks is swept whole by ``--only`` and skipped
with a warning by ``--es_only``; ``--budgets`` sets the grid of every
budget sweep that runs, and with ``--es_only`` it re-sweeps the budgets
as well. Writes ``results/torch/adaptive_matched_recall[_tiny].json``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from anncur_tpu_torch.core.adaptive_fused import (
    adaptive_recall_oracle_early_stop,
    fixed_anchor_recall,
    matched_recall_budget,
)
from anncur_tpu_torch.tools import _common
from anncur_tpu_torch.utils.device import resolve_device

BENCH_DIR = os.path.join(_common.CHECKOUT, "benchmarks")
TRAINED_CE = (("trained_ce_matrix.npz", "trained_ce"), ("trained_ce_matrix_hard.npz", "trained_ce_hard"))
# (n_q, n_train, n_items, budgets, fixed anchors, fixed rerank, seeds,
# ranks, early-stop configs (base, base rounds, ceiling, escalation rounds))
FULL = dict(
    n_q=128, n_train=500, n_items=10000, budgets=(60, 100, 150, 200, 250, 300, 400, 600),
    fixed=(500, 100), seeds=(0, 1, 2), ranks=(50, 150, 400),
    es_configs=((60, 5, 300, 5), (100, 5, 210, 8), (100, 5, 250, 8), (100, 5, 300, 5), (100, 5, 450, 5),
                (150, 5, 450, 5)),
)
TINY = dict(
    n_q=16, n_train=80, n_items=1000, budgets=(30, 60, 120, 240), fixed=(200, 40), seeds=(0,), ranks=(60,),
    es_configs=((30, 3, 120, 3),),
)
METHODS = (("cur", (3, 5, 8)), ("axn", (3, 5)))


def make_matrix(seed, n_q, n_train, n_items, rank, noise):
    """(query rows, train rows) of a rank-``rank`` matrix plus noise, as
    JAX's ``make_matrix`` draws them."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n_q + n_train, rank)).astype(np.float32)
    b = rng.standard_normal((rank, n_items)).astype(np.float32)
    m = a @ b + noise * np.sqrt(rank) * rng.standard_normal((n_q + n_train, n_items)).astype(np.float32)
    return m[:n_q], m[n_q:]


def load_trained_ce(path):
    """(query rows, train rows, meta) of a ``make_trained_ce_matrix`` file:
    its eval rows are mentions the CE never trained on."""
    d = np.load(path)
    scores = np.asarray(d["scores"], np.float32)
    n_train, n_q = int(d["n_train"]), int(d["n_q"])
    return scores[n_train:n_train + n_q], scores[:n_train], json.loads(str(d["meta"]))


def axn_rank_of(train):
    """Twice the smallest rank that holds 97% of the centred train rows'
    spectral energy, capped at full rank (JAX's rule)."""
    s = np.linalg.svd(train - train.mean(axis=0), compute_uv=False)
    energy = np.cumsum(s ** 2) / np.sum(s ** 2)
    return int(min(2 * (int(np.searchsorted(energy, 0.97)) + 1), min(train.shape)))


def early_stop_sweep(full, train, fixed_anc, fixed_retvr, seeds, configs, device="cuda"):
    """Recall, average budget and escalated share of the early-stop engine
    per (base, ceiling) config, beside the fixed-anchor recall at cost
    ``fixed_anc + fixed_retvr``. On the card unless ``device`` says
    otherwise; raises without CUDA when no device is given."""
    device = resolve_device(device)
    fixed = float(np.mean([fixed_anchor_recall(full, train, fixed_anc, fixed_retvr, 10, s, device) for s in seeds]))
    out = {"fixed_recall": fixed, "fixed_cost": fixed_anc + fixed_retvr, "configs": {}}
    for base, base_rounds, ceiling, esc_rounds in configs:
        runs = [adaptive_recall_oracle_early_stop(full, train, base, base_rounds, ceiling, esc_rounds, top_k=10,
                                                  seed=s, device=device) for s in seeds]
        recall = float(np.mean([r[0] for r in runs]))
        out["configs"][f"b{base}r{base_rounds}_e{ceiling}r{esc_rounds}"] = {
            "base_budget": base, "base_rounds": base_rounds, "escalate_budget": ceiling,
            "escalate_rounds": esc_rounds, "recall": recall,
            "avg_budget": float(np.mean([r[1] for r in runs])),
            "frac_escalated": float(np.mean([r[2] for r in runs])), "matches_fixed": bool(recall >= fixed),
        }
    return out


def budget_sweeps(full, train, rank, grid, budgets, device):
    """Every (method, rounds) variant's matched-recall budget search."""
    axn_rank = axn_rank_of(train)
    scen = {}
    for method, rounds_grid in METHODS:
        for n_rounds in rounds_grid:
            res = matched_recall_budget(
                full, train, fixed_n_anchors=grid["fixed"][0], fixed_top_k_retvr=grid["fixed"][1], top_k=10,
                n_rounds=n_rounds, seeds=grid["seeds"], budgets=budgets, method=method,
                device=device, axn_rank=axn_rank if method == "axn" else None,
            )
            res["rank"] = rank
            res["effective_speedup_at_matched_recall"] = (
                None if res["matched_budget"] is None else round(res["fixed_cost"] / res["matched_budget"], 2))
            scen[f"{method}_r{n_rounds}"] = res
            print(json.dumps({f"{method}_r{n_rounds}": res}), flush=True)
    return scen


def compute_headline(out, max_round_width=64):
    """The ``headline_*`` fields of ``out``, in place, by JAX's policy: per
    scenario the smallest matched budget over its variants (ties to fewer
    rounds, then CUR), and the scenario where that is largest; variants
    whose round width (budget / rounds) exceeds ``max_round_width`` are
    left out. The early-stop headline is the config that matches the
    fixed recall on every scenario with the smallest worst-case average
    budget."""

    def variants(scen):
        return {mk: r for mk, r in scen.items() if isinstance(r, dict) and r.get("matched_budget") is not None
                and r["matched_budget"] / r["n_rounds"] <= max_round_width}

    per_scen_best = {}
    for key, scen in out["scenarios"].items():
        matched = variants(scen)
        if matched:
            per_scen_best[key] = min(matched, key=lambda mk: (
                matched[mk]["matched_budget"], matched[mk]["n_rounds"], 0 if mk.startswith("cur") else 1))
    if per_scen_best:
        worst = max(per_scen_best, key=lambda k: out["scenarios"][k][per_scen_best[k]]["matched_budget"])
        res = out["scenarios"][worst][per_scen_best[worst]]
        out.update(
            headline_scenario=worst, headline_method=per_scen_best[worst].split("_r")[0],
            headline_n_rounds=res["n_rounds"], headline_matched_budget=res["matched_budget"],
            headline_axn_rank=res.get("axn_rank"),
            headline_policy=f"worst-case across scenarios; round width <= {max_round_width}",
            per_scenario_best={k: out["scenarios"][k][v]["matched_budget"] for k, v in per_scen_best.items()},
        )
    else:
        out["headline_scenario"] = None

    es_ok = None
    es_scens = [s for s in out["scenarios"].values() if "early_stop" in s]
    common = set.intersection(*(set(s["early_stop"]["configs"]) for s in es_scens)) if es_scens else set()
    for ck in sorted(common):
        rows = [s["early_stop"]["configs"][ck] for s in es_scens]
        r0 = rows[0]
        width = max(r0["base_budget"] / r0["base_rounds"], r0["escalate_budget"] / max(1, r0["escalate_rounds"]))
        if width > max_round_width or not all(r["matches_fixed"] for r in rows):
            continue
        worst_avg = max(r["avg_budget"] for r in rows)
        if es_ok is None or worst_avg < es_ok["worst_avg_budget"]:
            es_ok = {
                "config": ck, **{k: r0[k] for k in ("base_budget", "base_rounds", "escalate_budget",
                                                   "escalate_rounds")},
                "worst_avg_budget": worst_avg,
                "per_scenario_avg_budget": {k: s["early_stop"]["configs"][ck]["avg_budget"]
                                            for k, s in out["scenarios"].items() if "early_stop" in s},
            }
    out["headline_early_stop"] = es_ok


def scenarios(grid, tiny):
    """(name, rank or None, trained-CE path or None) of every scenario: the
    synthetic spectra, then each committed trained-CE matrix present."""
    found = [(f"rank{r}", r, None) for r in grid["ranks"]]
    for fname, name in TRAINED_CE:
        path = os.path.join(BENCH_DIR, fname.replace(".npz", "_quick.npz") if tiny else fname)
        if os.path.exists(path):
            found.append((name, None, path))
        else:
            print(f"# no {path}; {name} scenario skipped", file=sys.stderr)
    return found


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--tiny", action="store_true", help="JAX's --quick shapes, the *_quick.npz matrices")
    ap.add_argument("--only", default="", help="comma-separated scenarios to sweep; the rest kept from --out")
    ap.add_argument("--es_only", action="store_true",
                    help="re-run only the early-stop sweep of the scenarios --out holds (and the budget "
                    "sweeps too when --budgets is given)")
    ap.add_argument("--reheadline", action="store_true", help="recompute only the headline of --out")
    ap.add_argument("--budgets", type=int, nargs="+", default=None, help="the budget grid of the sweeps")
    ap.add_argument("--max-round-width", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    threads = torch.get_num_threads()
    if device.type == "cpu":
        torch.set_num_threads(1)  # the threaded batched solve hangs at S >= ~158 on the CPU
    try:
        return run(args, device)
    finally:
        torch.set_num_threads(threads)


def run(args, device):
    out_path = args.out or os.path.join(
        _common.RESULTS_DIR, "adaptive_matched_recall_tiny.json" if args.tiny else "adaptive_matched_recall.json")
    if args.reheadline:
        with open(out_path) as fin:
            out = json.load(fin)
        compute_headline(out, args.max_round_width)
        _common.write_json(out_path, out)
        return out

    grid = TINY if args.tiny else FULL
    budgets = tuple(sorted(set(args.budgets))) if args.budgets else grid["budgets"]
    out = {
        "tiny": bool(args.tiny), "device": _common.card(device),
        "shape": {k: grid[k] for k in ("n_q", "n_train", "n_items")},
        "fixed": {"n_anchors": grid["fixed"][0], "top_k_retvr": grid["fixed"][1]}, "budgets": list(budgets),
        "scenarios": {},
    }
    todo = scenarios(grid, args.tiny)
    if args.only or args.es_only:
        with open(out_path) as fin:
            out["scenarios"] = json.load(fin).get("scenarios", {})
        if args.only:
            want = set(args.only.split(","))
            missing = want - {s[0] for s in todo}
            if missing:
                raise SystemExit(f"--only names unknown scenarios: {sorted(missing)}")
            todo = [s for s in todo if s[0] in want]
    skipped = []
    for name, rank, path in todo:
        if args.es_only and name not in out["scenarios"]:
            print(f"# warning: {name} is not in {out_path}; --es_only skips it (sweep it with --only {name})",
                  file=sys.stderr, flush=True)
            skipped.append(name)
            continue
        if rank is not None:
            full, train = make_matrix(7, grid["n_q"], grid["n_train"], grid["n_items"], rank, noise=0.05)
            meta = None
        else:
            full, train, meta = load_trained_ce(path)
        print(f"# {name}", flush=True)
        scen = out["scenarios"].get(name, {}) if args.es_only else {}
        if not args.es_only or args.budgets:
            scen.update(budget_sweeps(full, train, rank, grid, budgets, device))
        if meta is not None:
            scen["trained_ce_meta"] = meta
        scen["early_stop"] = early_stop_sweep(full, train, *grid["fixed"], grid["seeds"], grid["es_configs"], device)
        print(json.dumps({f"{name}.early_stop": scen["early_stop"]}), flush=True)
        out["scenarios"][name] = scen
    if skipped:
        out["skipped_scenarios"] = skipped
    compute_headline(out, args.max_round_width)
    _common.write_json(out_path, out)
    return out


if __name__ == "__main__":
    main()
