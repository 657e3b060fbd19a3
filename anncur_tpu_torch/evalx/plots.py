"""Result plotting.

A copy of ``anncur_tpu/evalx/plots.py``, which imports no JAX; the port
keeps its own so it imports nothing of the JAX package.

Parity with the reference plotting layer: anchor-grid heat maps
(eval/matrix_approx_zeshel.py:129-183, used by
run_retrieval_eval_wrt_exact_crossenc.py:392-510) and the
recall-vs-cost / recall-vs-retrieved curves of the RQ plot suite
(utils/plot_emnlp_retrieval_eval_wrt_exact_crossenc.py). Uses a
non-interactive matplotlib backend so it runs headless.
"""

from __future__ import annotations

import logging
import os
from contextlib import nullcontext
from typing import Dict, List, Optional, Sequence

import numpy as np

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

LOGGER = logging.getLogger(__name__)


def plot_heat_map(
    val_matrix: np.ndarray,
    row_vals: Sequence,
    col_vals: Sequence,
    out_path: str,
    title: Optional[str] = None,
    xlabel: str = "Number of anchor entities",
    ylabel: str = "Number of anchor mentions",
) -> str:
    """Anchor-grid metric heat map (reference: plot_heat_map,
    eval/matrix_approx_zeshel.py:129-183)."""
    val_matrix = np.asarray(val_matrix, float)
    size = 12 if np.nanmax(val_matrix) > 100 else 8
    fig, ax = plt.subplots(figsize=(size, size))
    ax.imshow(val_matrix)
    ax.set_xticks(np.arange(len(col_vals)))
    ax.set_yticks(np.arange(len(row_vals)))
    ax.set_xticklabels(col_vals)
    ax.set_yticklabels(row_vals)
    plt.setp(ax.get_xticklabels(), rotation=45, ha="right", rotation_mode="anchor", fontsize=16)
    plt.setp(ax.get_yticklabels(), fontsize=16)
    for i in range(len(row_vals)):
        for j in range(len(col_vals)):
            ax.text(j, i, f"{val_matrix[i, j]:.1f}", ha="center", va="center", color="w", fontsize=14)
    ax.set_xlabel(xlabel, fontsize=16)
    ax.set_ylabel(ylabel, fontsize=16)
    if title:
        ax.set_title(title)
    fig.tight_layout()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path)
    plt.close(fig)
    return out_path


def heat_map_from_transductive(
    eval_res: Dict,
    method: str,
    top_k: int,
    top_k_retvr: int,
    out_dir: str,
    metric: str = "exact_vs_reranked_approx_retvr~common_frac_mean",
    split: str = "non_anchor",
    name_tag: str = "",
) -> Optional[str]:
    """Build the (n_ment_anchors x n_ent_anchors) heat map from a
    transductive result tree (reference: plot, run_retrieval_eval_wrt_
    exact_crossenc.py:404-510)."""
    node = eval_res.get(method, {}).get(f"top_k={top_k}", {}).get(f"k_retvr={top_k_retvr}", {})
    if not node:
        return None
    rows, cols = set(), set()
    for key in node:
        m_part, e_part = key.split("~")
        rows.add(int(m_part.split("=")[1]))
        cols.add(int(e_part.split("=")[1]))
    rows, cols = sorted(rows), sorted(cols)
    mat = np.full((len(rows), len(cols)), np.nan)
    for i, r in enumerate(rows):
        for j, c in enumerate(cols):
            entry = node.get(f"anc_n_m={r}~anc_n_e={c}")
            if entry and split in entry and metric in entry[split]:
                mat[i, j] = 100 * entry[split][metric]
    tag = f"_{name_tag}" if name_tag else ""
    out = os.path.join(
        out_dir, f"heatmap_{method}_k={top_k}_retvr={top_k_retvr}_{split}{tag}.pdf"
    )
    label = name_tag or f"recall@{top_k}"
    return plot_heat_map(mat, rows, cols, out, title=f"{method}: {label} ({split})")


def plot_recall_vs_cost(
    method_rows: Dict[str, List[Dict]],
    out_path: str,
    top_k: int,
    title: Optional[str] = None,
    style: str = "default",
    latex: bool = False,
) -> str:
    """Recall-vs-CE-call-budget curves for several methods
    (reference RQ1/RQ2 plots; rows from aggregate.recall_vs_cost_table).
    For each method, plots the best recall achievable within each cost.
    ``style='paper'`` applies the reference's paper styling (method
    display names/colors, large fonts, dashed y-grid, legend above —
    utils/plot_emnlp...py:75-104, 205-221)."""
    from .paper_style import legend_above, paper_rc

    paper = style == "paper"
    ctx = paper_rc(latex=latex) if paper else nullcontext()
    with ctx:
        fig, ax = plt.subplots(figsize=(8, 5) if paper else (7, 5))
        for method, rows in method_rows.items():
            if not rows:
                continue
            costs = sorted({r["cost"] for r in rows})
            best = []
            for c in costs:
                feas = [r["recall"] for r in rows if r["cost"] <= c]
                best.append(100 * max(feas))
            ax.plot(costs, best, marker="o", **_series_kwargs(method, paper, latex))
        ax.set_xlabel("Inference Cost" if paper else "CE calls per query (cost)")
        ax.set_ylabel(
            (r"Top-$k$-Recall" + f" ($k$={top_k})")
            if paper
            else f"Top-{top_k} recall vs exact (%)"
        )
        ax.set_xscale("log")
        if paper:
            legend_above(ax)
        else:
            ax.grid(alpha=0.3)
            ax.legend()
        if title:
            ax.set_title(title)
        fig.tight_layout()
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        fig.savefig(out_path, bbox_inches="tight")
        plt.close(fig)
    return out_path


def _series_kwargs(method: str, paper: bool, latex: bool) -> dict:
    """label/color kwargs for one method series: paper display name +
    reference color under ``style='paper'``, raw key + default color
    cycle otherwise."""
    if not paper:
        return {"label": method}
    from .paper_style import method_color, method_display, split_model_key

    key, sub = split_model_key(method)
    return {
        "label": method_display(key, sub, latex=latex),
        "color": method_color(key, sub),
    }


def plot_recall_vs_domain_size(
    per_domain: Dict[str, Dict[str, float]],
    out_path: str,
    metric_label: str = "recall@k (%)",
    style: str = "default",
    latex: bool = False,
) -> str:
    """RQ3-style plot: recall vs number of entities per domain
    (reference: plot family at utils/plot_emnlp...py:442-546).
    per_domain: {domain: {'n_ents': int, 'recall': float 0..1}}.
    ``style='paper'`` renders the reference's bar-per-domain layout
    with the royalblue secondary number-of-items axis (510-516)."""
    items = sorted(per_domain.items(), key=lambda kv: kv[1]["n_ents"])
    if style == "paper":
        from .paper_style import SECONDARY_AXIS_COLOR, paper_rc

        with paper_rc(latex=latex):
            fig, ax1 = plt.subplots(figsize=(10, 5))
            xs = np.arange(len(items))
            ax1.bar(
                xs,
                [100 * v["recall"] for _, v in items],
                width=0.6,
                color="yellowgreen",
            )
            ax1.set_xticks(xs)
            ax1.set_xticklabels([n for n, _ in items], fontsize=13, rotation=30, ha="right")
            ax1.set_xlabel("Item Domains", fontsize=16)
            ax1.set_ylabel(metric_label, fontsize=16)
            ax2 = ax1.twinx()
            ax2.plot(
                xs,
                [v["n_ents"] for _, v in items],
                "-*",
                color=SECONDARY_AXIS_COLOR,
            )
            ax2.set_yscale("log")
            ax2.set_ylabel("Number of items", fontsize=16)
            ax2.yaxis.label.set_color(SECONDARY_AXIS_COLOR)
            plt.setp(ax2.get_yticklabels(), fontsize=12, color=SECONDARY_AXIS_COLOR)
            ax2.grid(False)
            fig.tight_layout()
            os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
            fig.savefig(out_path, bbox_inches="tight")
            plt.close(fig)
        return out_path
    fig, ax = plt.subplots(figsize=(7, 5))
    xs = [v["n_ents"] for _, v in items]
    ys = [100 * v["recall"] for _, v in items]
    ax.plot(xs, ys, marker="o")
    for (name, v), x, y in zip(items, xs, ys):
        ax.annotate(name, (x, y), fontsize=8, rotation=30)
    ax.set_xscale("log")
    ax.set_xlabel("number of entities in domain")
    ax.set_ylabel(metric_label)
    ax.grid(alpha=0.3)
    fig.tight_layout()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path)
    plt.close(fig)
    return out_path


def plot_recall_vs_train_size(
    by_train_size: Dict[int, Dict[str, float]],
    out_path: str,
    metric_label: str = "recall@k (%)",
    style: str = "default",
    latex: bool = False,
) -> str:
    """RQ4-style plot: recall vs number of anchor/train mentions
    (reference: plot family at utils/plot_emnlp...py:550+).
    by_train_size: {nm_train: {method: recall 0..1}}.
    ``style='paper'`` applies display names/colors + paper layout."""
    from .paper_style import legend_above, paper_rc

    paper = style == "paper"
    ctx = paper_rc(latex=latex) if paper else nullcontext()
    with ctx:
        fig, ax = plt.subplots(figsize=(8, 5) if paper else (7, 5))
        sizes = sorted(by_train_size)
        methods = sorted({m for v in by_train_size.values() for m in v})
        for method in methods:
            ys = [100 * by_train_size[s][method] for s in sizes if method in by_train_size[s]]
            xs = [s for s in sizes if method in by_train_size[s]]
            ax.plot(xs, ys, marker="o", **_series_kwargs(method, paper, latex))
        ax.set_xscale("log")
        ax.set_xlabel(
            "Number of Train Queries" if paper else "number of train/anchor mentions"
        )
        ax.set_ylabel(metric_label)
        if paper:
            legend_above(ax)
        else:
            ax.grid(alpha=0.3)
            ax.legend()
        fig.tight_layout()
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        fig.savefig(out_path, bbox_inches="tight")
        plt.close(fig)
    return out_path


def plot_ce_baselines_from_pivot(
    csv_path: str,
    out_path: str,
    x_prefix: str = "cost",
    model_tags: Sequence[str] = ("cur", "fixed_anc_ent", "fixed_anc_ent_cur"),
    x_vals: Optional[Sequence[int]] = None,  # default: every x column in the CSV
    xlabel: Optional[str] = None,
    title: Optional[str] = None,
    style: str = "default",
    latex: bool = False,
) -> Optional[str]:
    """RQ5/RQ6-style grouped bar chart of the CE-only baseline family
    (CUR vs fixedITEM vs itemCUR) read from an RQ1/RQ2 pivot CSV
    (reference: plot_rq_5_6_performance_vs_topk_retrieved_or_cost_for_
    CE_only_baselines, utils/plot_emnlp...py:244-440). ``x_prefix`` is
    'cost' for the equal-test-cost family (RQ5, from RQ2 CSVs) and
    'top_k_retvr' for equal-num-retrieved (RQ6, from RQ1 CSVs); rows
    whose model matches a tag contribute their best value per x."""
    import csv as _csv

    with open(csv_path) as fin:
        reader = _csv.DictReader(fin)
        rows = list(reader)
        row_key = reader.fieldnames[0]
    if x_vals is None:
        # take every budget column present — a hardcoded list silently
        # dropped pivot columns outside it (e.g. RQ2 cost sums like 74)
        x_vals = sorted(
            int(c.split("=", 1)[1])
            for c in reader.fieldnames[1:]
            if c.startswith(f"{x_prefix}=") and c.split("=", 1)[1].isdigit()
        )
    y_vals: Dict[str, Dict[int, float]] = {}
    for row in rows:
        model = next(
            (
                p.split("=", 1)[1]
                for p in row[row_key].split("~")
                if p.startswith("model=")
            ),
            row[row_key],
        )
        if model.lower() not in tuple(t.lower() for t in model_tags):
            continue
        # keep anc_n_e subscript when present (RQ6 annCUR_100 vs _200)
        anc = next(
            (
                p.split("=", 1)[1]
                for p in row[row_key].split("~")
                if p.startswith("anc_n_e=") and not p.endswith("=None")
            ),
            None,
        )
        label = f"{model}_{anc}" if anc else model
        for x in x_vals:
            cell = row.get(f"{x_prefix}={x}", "")
            if cell in ("", None):
                continue
            v = float(cell)
            cur = y_vals.setdefault(label, {})
            cur[x] = max(cur.get(x, 0.0), v)
    if not y_vals:
        return None
    from .paper_style import legend_above, paper_rc

    paper = style == "paper"
    ctx = paper_rc(latex=latex) if paper else nullcontext()
    with ctx:
        fig, ax = plt.subplots(figsize=(10, 5) if paper else (8, 5))
        labels = sorted(y_vals)
        xs_all = [x for x in x_vals if any(x in y_vals[m] for m in labels)]
        width = 0.8 / max(len(labels), 1)
        for mi, m in enumerate(labels):
            # plot only cells the method actually has: a 0.0 stand-in bar is
            # indistinguishable from a measured 0% recall
            pts = [(i, y_vals[m][x]) for i, x in enumerate(xs_all) if x in y_vals[m]]
            if not pts:
                continue
            ax.bar(
                [i + mi * width for i, _ in pts],
                [v for _, v in pts],
                width=width,
                **_series_kwargs(m, paper, latex),
            )
        ax.set_xticks([i + 0.4 - width / 2 for i in range(len(xs_all))])
        ax.set_xticklabels([str(x) for x in xs_all])
        ax.set_xlabel(
            xlabel
            or ("Inference Cost" if x_prefix == "cost" else "Number of Items Retrieved")
        )
        ax.set_ylabel(r"Top-$k$-Recall" if paper else "Top-k recall vs exact (%)")
        if paper:
            legend_above(ax, ncol=max(1, (len(labels) + 1) // 2))
        else:
            ax.legend()
            ax.grid(alpha=0.3, axis="y")
        if title:
            ax.set_title(title)
        fig.tight_layout()
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        fig.savefig(out_path, bbox_inches="tight")
        plt.close(fig)
    return out_path


def rq7_heatmaps(
    eval_res: Dict,
    out_dir: str,
    methods: Sequence[str] = ("cur",),
    top_k_vals: Sequence[int] = (10,),
    top_k_retvr_vals: Sequence[int] = (500,),
    splits: Sequence[str] = ("non_anchor",),
) -> List[str]:
    """RQ7 multi-metric heat-map family: anchor-grid maps of BOTH
    recall (prec_at_k) and relative Frobenius approximation error per
    method/top_k/top_k_retvr/split (reference: plot_rq7_heatmaps,
    utils/plot_emnlp...py:704-775)."""
    metrics = {
        "exact_vs_reranked_approx_retvr~common_frac_mean": "prec_at_k",
        "approx_error_relative": "approx_error",
    }
    made = []
    for method in methods:
        for top_k in top_k_vals:
            for kr in top_k_retvr_vals:
                for split in splits:
                    for metric, tag in metrics.items():
                        out = heat_map_from_transductive(
                            eval_res,
                            method,
                            top_k,
                            kr,
                            out_dir,
                            metric=metric,
                            split=split,
                            name_tag=tag,
                        )
                        if out:
                            made.append(out)
    return made


def plot_score_distribution(
    score_matrix: np.ndarray, out_path: str, n_sample: int = 20
) -> str:
    """Per-mention score distributions (reference RQ0 plots)."""
    rng = np.random.default_rng(0)
    idx = rng.choice(score_matrix.shape[0], size=min(n_sample, score_matrix.shape[0]), replace=False)
    fig, ax = plt.subplots(figsize=(7, 5))
    for i in idx:
        sv = np.sort(score_matrix[i])[::-1]
        ax.plot(sv, alpha=0.4, lw=0.8)
    ax.set_xlabel("entity rank")
    ax.set_ylabel("CE score")
    ax.set_xscale("log")
    fig.tight_layout()
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path)
    plt.close(fig)
    return out_path
