"""Result aggregation across domains/worlds.

A copy of ``anncur_tpu/evalx/aggregate.py``, which imports no JAX; the port
keeps its own so it imports nothing of the JAX package.

Parity with eval/avg_zeshel_results.py:20-111 (macro + mention-weighted
micro averages of res.json metric dicts) and the flat combined key-value
export of eval/compile_emnlp_retrieval_eval_wrt_exact_crossenc.py:280-355.
"""

from __future__ import annotations

import csv
import glob
import itertools
import json
import logging
import os
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

LOGGER = logging.getLogger(__name__)


def _to_float(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return None


def avg_results(
    per_domain: Dict[str, Dict],
    weights: Optional[Dict[str, float]] = None,
) -> Dict[str, Dict[str, float]]:
    """Macro + (weighted) micro averages of flat metric dicts
    (reference: get_avg_perf, eval/avg_zeshel_results.py:20-63)."""
    metrics = defaultdict(list)
    wvals = defaultdict(list)
    for domain, res in per_domain.items():
        w = (weights or {}).get(domain, 1.0)
        for metric, val in res.items():
            f = _to_float(val)
            if f is None:
                continue
            metrics[metric].append(f)
            wvals[metric].append((f, w))
    macro = {m: float(np.mean(vals)) for m, vals in metrics.items()}
    micro = {
        m: float(sum(v * w for v, w in vw) / max(sum(w for _, w in vw), 1e-30))
        for m, vw in wvals.items()
    }
    return {"macro": macro, "micro": micro}


def flatten_result_tree(tree: Dict, prefix: str = "") -> Dict[str, float]:
    """Nested eval JSON -> flat {joined~key: value}
    (reference: create_combine_result_file, compile_...py:280-355)."""
    out = {}
    for key, val in tree.items():
        path = f"{prefix}~{key}" if prefix else str(key)
        if isinstance(val, dict):
            out.update(flatten_result_tree(val, path))
        else:
            f = _to_float(val)
            if f is not None:
                out[path] = f
    return out


def combine_result_files(result_glob: str, out_path: str) -> Dict[str, float]:
    """Glob per-method res.json files into one flat key-value JSON."""
    combined = {}
    for path in sorted(glob.glob(result_glob)):
        with open(path) as fin:
            tree = json.load(fin)
        tag = os.path.basename(os.path.dirname(path))
        combined.update(flatten_result_tree(tree, tag))
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as fout:
        json.dump(combined, fout, indent=2, sort_keys=True)
    LOGGER.info("combined %s -> %s (%d keys)", result_glob, out_path, len(combined))
    return combined


def recall_vs_cost_table(
    result: Dict,
    method: str,
    top_k: int,
    metric: str = "exact_vs_reranked_approx_retvr~common_frac_mean",
) -> List[Dict[str, float]]:
    """Extract (cost, recall) rows from an inductive res.json: cost =
    top_k_retvr + n_ent_anchors for CUR-family, top_k_retvr otherwise
    (reference cost model: compile_...py:247-258)."""
    rows = []
    tree = result.get(f"top_k={top_k}", {})
    budget_method = _is_budget_method(method)  # one detection site, case-insensitive
    for kr_key, by_anchor in tree.items():
        kr = int(kr_key.split("=")[1])
        for anc_key, metrics in by_anchor.items():
            n_anc = int(anc_key.split("=")[-1])
            cost = kr + n_anc if budget_method else kr
            if metric in metrics:
                rows.append(
                    {"cost": cost, "top_k_retvr": kr, "n_ent_anchors": n_anc, "recall": metrics[metric]}
                )
    rows.sort(key=lambda r: r["cost"])
    return rows


def best_recall_at_cost(rows: Sequence[Dict], max_cost: float) -> Optional[Dict]:
    """Best recall among configurations within a CE-call budget."""
    feasible = [r for r in rows if r["cost"] <= max_cost]
    return max(feasible, key=lambda r: r["recall"]) if feasible else None


# ---------------------------------------------------------------------------
# Generic per-RQ pivot machinery (parity with process_res_for_rq /
# plot_processed_results, eval/compile_emnlp_retrieval_eval_wrt_exact_
# crossenc.py:103-277): a flat combined_res {key: {val_type: value}} is
# pivoted into fixed-params -> var-params -> x-axis-params, taking the max
# over configurations that collapse to the same cell, then written as one
# CSV per fixed-param combination.
# ---------------------------------------------------------------------------

DEFAULT_RQ_TEMPLATE = (
    "nm_train={nm_train}~top_k_retvr={top_k_retvr}~top_k={top_k}"
    "~model={model}~anc_n_e={anc_n_e}"
)

#: The paper's research-question pivots (reference compile_...py:437-467),
#: over the params our result trees actually sweep (no ckpt/split_idx/
#: graph_config axes here; process_res_for_rq stays generic over any
#: template if those are needed).
RQ_DEFINITIONS: Dict[str, Dict] = {
    "RQ1_Model_Performance_At_Equal_Num_Retrieved": {
        "var_params": ["model", "anc_n_e"],
        "fixed_params": ["nm_train", "top_k"],
        "x_axis_params": ["top_k_retvr"],
        "val_type": "prec@k",
        "same_cost": False,
    },
    "RQ2_Model_Performance_At_Equal_Test_Cost": {
        "var_params": ["model"],
        "fixed_params": ["nm_train", "top_k"],
        "x_axis_params": ["top_k_retvr", "anc_n_e"],
        "val_type": "prec@k",
        "same_cost": True,
    },
}

#: Methods whose online cost includes the anchor-entity CE calls
#: (reference same-cost rule, compile_...py:247-258).
BUDGET_METHOD_TAGS = ("cur", "fixed_anc_ent", "axn")


def _is_budget_method(name: str) -> bool:
    low = name.lower()
    return any(tag in low for tag in BUDGET_METHOD_TAGS)


def combined_res_from_inductive(
    per_method: Dict[str, Dict],
    nm_train: int,
    metric: str = "exact_vs_reranked_approx_retvr~common_frac_mean",
    template: str = DEFAULT_RQ_TEMPLATE,
    val_type: str = "prec@k",
) -> tuple:
    """Flatten {method: inductive res tree} into the reference's flat
    combined_res (create_combine_result_file, compile_...py:280-355) and
    collect the swept param values.

    Returns ``(combined_res, all_param_vals)`` where combined_res maps
    ``nm_train=..~top_k_retvr=..~top_k=..~model=..~anc_n_e=..`` to
    ``{val_type: 100*metric}``.
    """
    combined: Dict[str, Dict[str, float]] = {}
    vals = {k: set() for k in ("nm_train", "top_k_retvr", "top_k", "model", "anc_n_e")}
    for model, tree in per_method.items():
        vals["model"].add(model)
        for tk_key, by_kr in tree.items():
            if not str(tk_key).startswith("top_k="):
                continue
            top_k = int(str(tk_key).split("=")[1])
            vals["top_k"].add(top_k)
            for kr_key, by_anc in by_kr.items():
                kr = int(str(kr_key).split("=")[1])
                vals["top_k_retvr"].add(kr)
                for anc_key, metrics in by_anc.items():
                    n_anc = int(str(anc_key).split("=")[-1])
                    vals["anc_n_e"].add(n_anc)
                    if metric not in metrics:
                        continue
                    key = template.format(
                        nm_train=nm_train,
                        top_k_retvr=kr,
                        top_k=top_k,
                        model=model,
                        anc_n_e=n_anc,
                    )
                    combined[key] = {val_type: 100.0 * float(metrics[metric])}
    vals["nm_train"].add(nm_train)
    all_param_vals = {k: sorted(v) for k, v in vals.items()}
    all_param_vals["model"] = sorted(per_method)
    return combined, all_param_vals


def process_res_for_rq(
    combined_res: Dict[str, Dict[str, float]],
    template: str,
    all_param_vals: Dict[str, Sequence],
    fixed_params: Sequence[str],
    var_params: Sequence[str],
    x_axis_params: Sequence[str],
    val_type: str = "prec@k",
    same_cost: bool = False,
) -> Dict[str, Dict[str, Dict[str, float]]]:
    """[combined key] -> [fixed_key][var_key][x_key] pivot
    (reference: process_res_for_rq, compile_...py:219-277).

    With ``same_cost``, x_axis_params must be exactly
    ``["top_k_retvr", "anc_n_e"]`` and x keys become ``cost=<total CE
    calls>``: top_k_retvr + anc_n_e for budget methods (CUR family),
    top_k_retvr alone otherwise; duplicate cells keep the max value.
    """
    if same_cost and list(x_axis_params) != ["top_k_retvr", "anc_n_e"]:
        raise ValueError(
            "same_cost requires x_axis_params == ['top_k_retvr', 'anc_n_e'], "
            f"got {list(x_axis_params)}"
        )
    final: Dict[str, Dict[str, Dict[str, float]]] = defaultdict(
        lambda: defaultdict(dict)
    )
    fixed_grid = [all_param_vals[p] for p in fixed_params]
    var_grid = [all_param_vals[p] for p in var_params]
    x_grid = [all_param_vals[p] for p in x_axis_params]
    for fixed_vals in itertools.product(*fixed_grid):
        fixed_key = "~".join(f"{p}={v}" for p, v in zip(fixed_params, fixed_vals))
        for var_vals in itertools.product(*var_grid):
            var_key = "~".join(f"{p}={v}" for p, v in zip(var_params, var_vals))
            for x_vals in itertools.product(*x_grid):
                if same_cost:
                    cost = x_vals[0] + x_vals[1] if _is_budget_method(var_key) else x_vals[0]
                    x_key = f"cost={cost}"
                else:
                    x_key = "~".join(
                        f"{p}={v}" for p, v in zip(x_axis_params, x_vals)
                    )
                params = dict(zip(fixed_params, fixed_vals))
                params.update(zip(var_params, var_vals))
                params.update(zip(x_axis_params, x_vals))
                comb_key = template.format(**params)
                if comb_key not in combined_res:
                    continue
                val = combined_res[comb_key][val_type]
                cell = final[fixed_key][var_key]
                cell[x_key] = max(cell[x_key], val) if x_key in cell else val
    return {k: {vk: dict(vv) for vk, vv in v.items()} for k, v in final.items()}


def trim_row_name(row_name: str) -> str:
    """Drop var params that are irrelevant to a method so equivalent rows
    merge (reference: _trim_row_name, compile_...py:53-100): budget
    methods keep model+anc_n_e; embedding baselines keep only model."""
    parts = row_name.split("~")
    model = next(
        (p.split("=", 1)[1] for p in parts if p.startswith("model=")), row_name
    )
    keep = ("model", "anc_n_e") if _is_budget_method(model) else ("model",)
    return "~".join(
        p if p.split("=")[0] in keep else f"{p.split('=')[0]}=None" for p in parts
    )


def write_rq_pivot_csvs(
    processed_res: Dict[str, Dict[str, Dict[str, float]]],
    res_dir: str,
    var_params: Sequence[str],
    same_cost: bool = False,
    trim_fn: Optional[Callable[[str], str]] = trim_row_name,
) -> List[str]:
    """One CSV per fixed-param combination: rows = var-param combos
    (trimmed + max-merged), columns = x-axis keys (reference:
    plot_processed_results, compile_...py:103-208)."""
    row_name = "~".join(var_params)
    paths: List[str] = []
    os.makedirs(res_dir, exist_ok=True)
    for fixed_key, by_var in processed_res.items():
        col_keys: List[str] = []
        for cells in by_var.values():
            for ck in cells:
                if ck not in col_keys:
                    col_keys.append(ck)
        if same_cost:
            col_keys = sorted(col_keys, key=lambda x: float(x.split("=")[1]))
        merged: Dict[str, Dict[str, str]] = {}
        for var_key, cells in by_var.items():
            name = trim_fn(var_key) if trim_fn else var_key
            row = {ck: f"{v:.2f}" for ck, v in cells.items()}
            if name in merged:
                prev = merged[name]
                for ck, v in row.items():
                    prev[ck] = (
                        f"{max(float(v), float(prev[ck])):.2f}" if ck in prev else v
                    )
            else:
                merged[name] = dict(row, **{row_name: name})
        path = os.path.join(res_dir, f"{fixed_key}.csv")
        with open(path, "w", newline="") as fout:
            writer = csv.DictWriter(fout, fieldnames=[row_name] + col_keys)
            writer.writeheader()
            writer.writerows(merged.values())
        paths.append(path)
    LOGGER.info("wrote %d pivot CSVs to %s", len(paths), res_dir)
    return paths


def compile_rqs(
    per_method: Dict[str, Dict],
    nm_train: int,
    out_dir: str,
    metric: str = "exact_vs_reranked_approx_retvr~common_frac_mean",
    rqs: Optional[Dict[str, Dict]] = None,
) -> Dict[str, List[str]]:
    """End-to-end RQ compilation from per-method inductive result trees:
    flatten -> pivot per RQ -> processed_res.json + pivot CSVs
    (reference: run, compile_...py:358-505)."""
    # flatten once per distinct val_type used by the RQ specs — a spec
    # with a custom val_type would otherwise KeyError against cells
    # stored under the default label
    specs = rqs or RQ_DEFINITIONS
    combined_by_vt: Dict[str, tuple] = {}
    for spec in specs.values():
        vt = spec.get("val_type", "prec@k")
        if vt not in combined_by_vt:
            combined_by_vt[vt] = combined_res_from_inductive(
                per_method, nm_train, metric, val_type=vt
            )
    out: Dict[str, List[str]] = {}
    for rq_name, spec in specs.items():
        combined, all_param_vals = combined_by_vt[spec.get("val_type", "prec@k")]
        processed = process_res_for_rq(
            combined_res=combined,
            template=DEFAULT_RQ_TEMPLATE,
            all_param_vals=all_param_vals,
            fixed_params=spec["fixed_params"],
            var_params=spec["var_params"],
            x_axis_params=spec["x_axis_params"],
            val_type=spec.get("val_type", "prec@k"),
            same_cost=spec.get("same_cost", False),
        )
        rq_dir = os.path.join(out_dir, "RQs", rq_name)
        os.makedirs(rq_dir, exist_ok=True)
        with open(os.path.join(rq_dir, "processed_res.json"), "w") as fout:
            json.dump(processed, fout, indent=4)
        out[rq_name] = write_rq_pivot_csvs(
            processed,
            os.path.join(rq_dir, "plots"),
            spec["var_params"],
            same_cost=spec.get("same_cost", False),
        )
    return out


def write_csv(rows: Sequence[Dict], path: str) -> None:
    if not rows:
        return
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", newline="") as fout:
        writer = csv.DictWriter(fout, fieldnames=list(rows[0].keys()))
        writer.writeheader()
        writer.writerows(rows)
