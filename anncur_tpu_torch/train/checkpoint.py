"""Checkpointing: pytree save/load + top-k retention by dev metric.

Counterpart of ``anncur_tpu/train/checkpoint.py`` (parity with the
reference's two ModelCheckpoint callbacks: top-k by dev_{loss|mrr} and
end-of-epoch 'eoe-{epoch}-last', models/pairwise_trainer.py:214-237).
Format: pickled numpy pytrees + a JSON manifest, the JAX package's.

What crosses packages: a checkpoint's ``params`` are the JAX-layout tree
with numpy leaves, so a JAX checkpoint's params load into the port
(``load_params_`` of either model) and the port's into JAX. The port
writes its optimizer state as ``{"count", "mu", "nu"}`` with the moments
keyed by parameter path, and its generator state as a uint8 array of
``torch.Generator.get_state()``. Loading a JAX checkpoint here reads its
JAX-only leaves (typed PRNG keys, optax states) as :class:`ForeignLeaf`
placeholders without importing JAX or optax; :func:`adam_moments` finds
the Adam count and moments in either layout, so the port resumes a JAX
run's optimizer (a JAX key cannot seed a torch generator). JAX reads the
port's params, step and moments as numpy; its optax state classes are
not written here.
"""

from __future__ import annotations

import json
import logging
import os
import pickle
from typing import Any, Dict, List, Optional, Tuple

import torch

LOGGER = logging.getLogger(__name__)

_FOREIGN_MODULES = ("anncur_tpu", "jax", "jaxlib", "optax", "chex")


class ForeignLeaf(tuple):
    """Stand-in for a pickled object of the JAX package or its libraries
    (a ``_KeyLeaf``, an optax state): the constructor arguments it was
    pickled with, and its attributes."""

    def __new__(cls, *args):
        return super().__new__(cls, args)


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".")[0] in _FOREIGN_MODULES:
            return ForeignLeaf
        return super().find_class(module, name)


def _to_host(tree):
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    if torch.is_tensor(tree):
        return tree.detach().cpu().numpy()
    if isinstance(tree, torch.Generator):
        return tree.get_state().numpy()
    return tree


def flat_paths(tree, prefix: str = "") -> Dict[str, Any]:
    """{JAX path ('input_bert/layers/0/attn/q_kernel'): leaf} of a nested
    dict/list tree, the names ``train/optimizer.py::named_parameters``
    gives."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)) and not isinstance(tree, ForeignLeaf):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out: Dict[str, Any] = {}
    for key, val in items:
        out.update(flat_paths(val, f"{prefix}/{key}" if prefix else str(key)))
    return out


def adam_moments(opt_state) -> Tuple[int, Dict[str, Any], Dict[str, Any]]:
    """(count, mu, nu) of a checkpoint's optimizer state, the moments keyed
    by parameter path: the port's ``{"count", "mu", "nu"}``, or the Adam
    state inside a JAX checkpoint's optax chain (a 3-field
    ``ScaleByAdamState`` read as a :class:`ForeignLeaf` of count and two
    param trees)."""
    if isinstance(opt_state, dict) and {"count", "mu", "nu"} <= set(opt_state):
        return int(opt_state["count"]), dict(opt_state["mu"]), dict(opt_state["nu"])
    stack = [opt_state]
    while stack:
        node = stack.pop()
        if isinstance(node, ForeignLeaf) and len(node) == 3 and all(isinstance(t, dict) for t in node[1:]):
            return int(node[0]), flat_paths(node[1]), flat_paths(node[2])
        if isinstance(node, (list, tuple)):
            stack.extend(reversed(node))
    raise ValueError("no Adam moments in the checkpoint's opt_state")


def save_pytree(path: str, tree: Any, metadata: Optional[Dict] = None) -> None:
    """Pickle ``tree`` with tensors as numpy arrays and a generator as its
    uint8 state."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as fout:
        pickle.dump({"tree": _to_host(tree), "metadata": metadata or {}}, fout)


def load_pytree(path: str) -> Tuple[Any, Dict]:
    """(tree, metadata) of a file written by either package's
    ``save_pytree``; leaves are numpy arrays and Python scalars."""
    with open(path, "rb") as fin:
        data = _Unpickler(fin).load()
    return data["tree"], data.get("metadata", {})


class TopKCheckpointManager:
    """Keep the best-k checkpoints by a metric (mode 'min' or 'max') plus
    rolling end-of-epoch checkpoints."""

    def __init__(self, ckpt_dir: str, k: int = 2, metric: str = "loss", mode: str = "min"):
        self.ckpt_dir = ckpt_dir
        self.k = k
        self.metric = metric
        self.mode = mode
        self.manifest_path = os.path.join(ckpt_dir, "manifest.json")
        self.entries: List[Dict] = []
        if os.path.exists(self.manifest_path):
            with open(self.manifest_path) as fin:
                manifest = json.load(fin)
            old_metric = manifest.get("metric", metric)
            if old_metric != metric:
                # resuming with a DIFFERENT ckpt metric: old values would
                # compete numerically against the new metric's values and
                # corrupt top-k retention — start the top-k list fresh
                LOGGER.warning(
                    "manifest metric %r != configured %r; ignoring %d old "
                    "top-k entries", old_metric, metric,
                    len(manifest.get("topk", [])),
                )
            else:
                self.entries = manifest.get("topk", [])

    def _write_manifest(self) -> None:
        os.makedirs(self.ckpt_dir, exist_ok=True)
        with open(self.manifest_path, "w") as fout:
            json.dump(
                {"topk": self.entries, "metric": self.metric, "mode": self.mode},
                fout,
                indent=2,
            )

    def maybe_save(self, tree: Any, value: float, step: int, epoch: int) -> Optional[str]:
        """Save if the value ranks in the current top-k; evict the worst."""
        name = f"{self.metric}={value:.6f}-step={step}.ckpt"
        path = os.path.join(self.ckpt_dir, name)
        entry = {"path": path, "value": float(value), "step": int(step), "epoch": int(epoch)}
        candidates = self.entries + [entry]
        candidates.sort(key=lambda e: e["value"], reverse=self.mode == "max")
        keep = candidates[: self.k]
        if entry not in keep:
            return None
        save_pytree(path, tree, metadata=entry)
        for old in self.entries:
            if old not in keep and os.path.exists(old["path"]):
                os.remove(old["path"])
        self.entries = keep
        self._write_manifest()
        return path

    def save_end_of_epoch(self, tree: Any, epoch: int, step: int) -> str:
        path = os.path.join(self.ckpt_dir, f"eoe-{epoch}-last.ckpt")
        save_pytree(path, tree, metadata={"epoch": int(epoch), "step": int(step)})
        with open(os.path.join(self.ckpt_dir, "last.json"), "w") as fout:
            json.dump({"path": path, "epoch": int(epoch), "step": int(step)}, fout)
        # rolling: only the newest eoe is reachable through last.json
        # (reference PL end-of-epoch callback keeps save_top_k=1,
        # pairwise_trainer.py:228-237) — prune older ones
        for name in os.listdir(self.ckpt_dir):
            if name.startswith("eoe-") and name != os.path.basename(path):
                try:
                    os.remove(os.path.join(self.ckpt_dir, name))
                except FileNotFoundError:
                    pass
        return path

    def best_path(self) -> Optional[str]:
        return self.entries[0]["path"] if self.entries else None

    def latest_eoe(self) -> Optional[Dict]:
        meta = os.path.join(self.ckpt_dir, "last.json")
        if os.path.exists(meta):
            with open(meta) as fin:
                return json.load(fin)
        return None
