"""Paper-figure styling for the RQ plot families.

A copy of ``anncur_tpu/evalx/paper_style.py``, which imports no JAX; the port
keeps its own so it imports nothing of the JAX package.

Reproduces the reference's paper styling conventions
(reference utils/plot_emnlp_retrieval_eval_wrt_exact_crossenc.py:
method display names and color assignments at 75-104, 264-294, 471-474;
dashed y-grid + large fonts + legend-above-axes layout at 205-229,
346-360; the RQ3 secondary number-of-items axis at 510-516) without a
LaTeX toolchain: the reference renders ``\\textsc{annCUR}\\textsubscript
{100}`` via usetex, we render the same label as mathtext
``annCUR$_{100}$`` so figures build headless anywhere. Pass
``latex=True`` to emit the reference's literal LaTeX strings when a TeX
install is available.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Optional

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

# canonical method key (ours) -> (plain display base, reference color,
# per-subscript color overrides). Colors follow the reference exactly:
# TF-IDF lightseagreen, DE_base gold, DE_base+ce darkorange,
# DE_bert+ce maroon, annCUR yellowgreen (50 yellowgreen / 100 limegreen
# / 200 darkgreen), fixedITEM darkblue, itemCUR turquoise/teal.
_METHOD_STYLE = {
    "tfidf": ("TF-IDF", "lightseagreen", {}),
    "bienc": ("DE", "gold", {"base": "gold", "base+ce": "darkorange", "bert+ce": "maroon"}),
    "cur": ("annCUR", "yellowgreen", {"50": "yellowgreen", "100": "limegreen", "200": "darkgreen"}),
    "cur_oracle": ("annCUR", "olivedrab", {}),
    "fixed_anc_ent": ("fixedITEM", "darkblue", {}),
    "fixed_anc_ent_cur": ("itemCUR", "turquoise", {"100": "turquoise", "200": "teal"}),
    "adacur": ("adaCUR", "mediumseagreen", {}),
    "axn": ("AXN", "slateblue", {}),
}


def method_display(
    model: str, subscript: Optional[str] = None, latex: bool = False
) -> str:
    """Paper display label for a canonical method key.

    ``subscript`` carries the anchor-item count (annCUR_100) or the DE
    variant (base+ce). Unknown methods pass through unchanged, so user
    extensions still plot.
    """
    base, _, _ = _METHOD_STYLE.get(model, (model, None, {}))
    sub = None if subscript in (None, "", "None") else str(subscript)
    if latex:
        lbl = r"\textsc{%s}" % base
        if sub is not None:
            lbl += r"\textsubscript{%s}" % sub
        return lbl
    if sub is not None:
        return f"{base}$_{{{sub}}}$"
    return base


def method_color(model: str, subscript: Optional[str] = None) -> Optional[str]:
    """Reference color for a method (None for unknown methods: let the
    matplotlib cycle assign one)."""
    entry = _METHOD_STYLE.get(model)
    if entry is None:
        return None
    _, base_color, subs = entry
    sub = None if subscript in (None, "", "None") else str(subscript)
    return subs.get(sub, base_color)


def split_model_key(label: str):
    """Split a pivot row label like 'cur_100' / 'fixed_anc_ent_cur_200'
    into (canonical method, subscript). Longest method key wins so
    'fixed_anc_ent_cur_200' doesn't match 'fixed_anc_ent'."""
    for key in sorted(_METHOD_STYLE, key=len, reverse=True):
        if label == key:
            return key, None
        if label.startswith(key + "_"):
            return key, label[len(key) + 1 :]
    return label, None


# reference RQ3 secondary-axis color (plot_emnlp...py:511)
SECONDARY_AXIS_COLOR = "royalblue"


@contextmanager
def paper_rc(latex: bool = False):
    """rc context matching the paper figures: 16-24pt fonts, dashed
    y-grid, PDF-friendly embedded fonts. usetex only on request."""
    rc = {
        "font.size": 16,
        "axes.labelsize": 24,
        "axes.titlesize": 24,
        "xtick.labelsize": 20,
        "ytick.labelsize": 20,
        "legend.fontsize": 17,
        "grid.linestyle": "--",
        "axes.grid": True,
        "axes.grid.axis": "y",
        "pdf.fonttype": 42,
        "text.usetex": bool(latex),
    }
    with matplotlib.rc_context(rc):
        yield


def legend_above(ax, ncol: Optional[int] = None, x0: float = 0.0):
    """Reference legend placement: a single row above the axes
    (plot_emnlp...py:217-221, 359-360)."""
    handles, labels = ax.get_legend_handles_labels()
    if not handles:
        return None
    return ax.figure.legend(
        handles=handles,
        labels=labels,
        bbox_to_anchor=(x0, 1.02),
        loc="lower left",
        ncol=ncol or len(handles),
        bbox_transform=ax.transAxes,
        handletextpad=0.5,
        columnspacing=1,
    )
