"""Optimizer: AdamW with decay/no-decay groups + warmup-linear LR.

Counterpart of ``anncur_tpu/train/optimizer.py::make_optimizer`` (parity
with reference utils/optimizer.py:17-90), the same transformation in the
same order, written out by hand on a dict of named tensors:

1. zero the frozen grads (``type_optimization`` patterns), so the clip
   norm is the trainable subset's;
2. clip by global norm with optax's rule: scale by ``max_norm / norm``
   only when ``norm >= max_norm``, no epsilon (``clip_grad_norm_`` adds
   1e-6 and clamps, which is another rule);
3. Adam WITHOUT bias correction (the reference's ``AdamW(...,
   correct_bias=False)``), b1=0.9, b2=0.999, eps=1e-6 outside the sqrt
   (``torch.optim.AdamW`` bias-corrects and decays before the step);
4. decoupled weight decay under the decay mask (not biases or LayerNorm);
5. scale by ``-schedule(count)``, count from 0, warmup-linear starting at
   ``lr / warmup``;
6. zero the frozen update again (weight decay would move frozen params).

Names are the JAX pytree paths (``bert/layers/11/attn/q_kernel``,
``score_linear/kernel``): :func:`named_parameters` gives them for a
module built by ``models/bert.py::params_module``. The moments and the
count live in a plain dict and are updated in place.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

_LAYER_TOP = ["layers/11/"]
_LAYER_TOP4 = ["layers/11/", "layers/10/", "layers/9/", "layers/8/"]

PATTERNS_OPTIMIZER: Dict[str, Optional[List[str]]] = {
    "additional_layers": ["linear", "pooler"],
    "top_layer": ["linear", "pooler"] + _LAYER_TOP,
    "top4_layers": ["linear", "pooler"] + _LAYER_TOP4,
    "all_encoder_layers": ["linear", "pooler", "layers/"],
    "all": None,  # everything trainable
    "": None,
    "embeddings": ["embeddings/"],
}

NO_DECAY_SUBSTRINGS = ("bias", "ln_scale", "ln_bias")

Params = Dict[str, torch.Tensor]


def named_parameters(module: nn.Module) -> Dict[str, nn.Parameter]:
    """The module's parameters keyed by their JAX pytree path."""
    return {name.replace(".", "/"): p for name, p in module.named_parameters()}


def warmup_linear_schedule(lr: float, total_steps: int, warmup_proportion: float) -> Callable[[int], float]:
    """Linear lr/warmup -> lr over the warmup steps, then linear lr -> 0 at
    total steps (optax ``join_schedules`` of two ``linear_schedule``s,
    evaluated in f32 as JAX does)."""
    warmup = max(1, int(total_steps * warmup_proportion))
    decay = max(1, total_steps - warmup)

    def schedule(count: int) -> float:
        if count < warmup:
            init, end, steps, t = lr / warmup, lr, warmup, count
        else:
            init, end, steps, t = lr, 0.0, decay, count - warmup
        t = min(max(t, 0), steps)
        frac = np.float32(1) - np.float32(t) / np.float32(steps)
        return float(np.float32(init - end) * frac + np.float32(end))

    return schedule


class Optimizer:
    """``make_optimizer``'s transformation. ``init(params)`` gives the
    state; ``update(grads, state, params)`` returns the updates (to add to
    the params, :func:`apply_updates`) and advances the state in place."""

    def __init__(
        self,
        names: List[str],
        learning_rate: float = 1e-5,
        weight_decay: float = 0.01,
        total_steps: int = 10000,
        warmup_proportion: float = 0.01,
        max_grad_norm: float = 1.0,
        type_optimization: str = "all",
    ):
        if type_optimization not in PATTERNS_OPTIMIZER:
            # the reference raises on unknown types (utils/optimizer.py:28-30)
            raise ValueError(
                f"type_optimization={type_optimization!r} not in {sorted(PATTERNS_OPTIMIZER)}"
            )
        patterns = PATTERNS_OPTIMIZER[type_optimization]
        self.frozen = {n for n in names if patterns is not None and not any(t in n for t in patterns)}
        self.decay = {n for n in names if not any(s in n.rsplit("/", 1)[-1] for s in NO_DECAY_SUBSTRINGS)}
        self.schedule = warmup_linear_schedule(learning_rate, total_steps, warmup_proportion)
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm
        self.b1, self.b2, self.eps = 0.9, 0.999, 1e-6
        self.sharded: set = set()
        self.tp_group = None

    def tensor_parallel(self, sharded, group) -> None:
        """Gradients of the ``sharded`` names are this rank's blocks under
        tensor parallelism: their squares are summed over ``group`` for the
        clip norm; the replicated ones count once."""
        self.sharded, self.tp_group = set(sharded), group

    def init(self, params: Params) -> Dict:
        zeros = lambda: {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()}  # noqa: E731
        return {"count": 0, "mu": zeros(), "nu": zeros()}

    @torch.no_grad()
    def update(self, grads: Params, state: Dict, params: Params) -> Params:
        g = {n: torch.zeros_like(t) if n in self.frozen else t.float() for n, t in grads.items()}
        if self.sharded:
            import torch.distributed as dist

            own = sum((g[n] * g[n]).sum() for n in self.sharded).reshape(1).clone()
            dist.all_reduce(own, group=self.tp_group)
            norm = torch.sqrt(sum((t * t).sum() for n, t in g.items() if n not in self.sharded) + own[0])
        else:
            norm = torch.sqrt(sum((t * t).sum() for t in g.values()))
        if not bool(norm < self.max_grad_norm):
            g = {n: (t / norm) * self.max_grad_norm for n, t in g.items()}
        lr = self.schedule(state["count"])
        state["count"] += 1
        out = {}
        for n, t in g.items():
            mu, nu = state["mu"][n], state["nu"][n]
            mu.mul_(self.b1).add_(t * (1 - self.b1))
            nu.mul_(self.b2).add_((t * t) * (1 - self.b2))
            u = mu / (torch.sqrt(nu) + self.eps)
            if n in self.decay:
                u = u + self.weight_decay * params[n].float()
            out[n] = -lr * u
        for n in self.frozen:
            out[n] = torch.zeros_like(out[n])
        return out


def make_optimizer(params: Params, **kw) -> Optimizer:
    """``anncur_tpu``'s ``make_optimizer`` over ``params`` (JAX paths ->
    tensors); keyword arguments as :class:`Optimizer`."""
    return Optimizer(list(params), **kw)


@torch.no_grad()
def apply_updates(params: Params, updates: Params) -> None:
    """params += updates, in place (``optax.apply_updates``)."""
    for n, p in params.items():
        p.add_(updates[n].to(p.dtype))
