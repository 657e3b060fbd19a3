"""BERT encoder for inference, in PyTorch.

Counterpart of ``anncur_tpu/models/bert.py`` with the same numerics:

- bf16 compute with f32 params cast at each dense layer,
- LayerNorm in f32, cast back to the compute dtype,
- embeddings summed in f32, cast, then normalised,
- gelu tanh under bf16 and erf otherwise (``BertSpec.gelu_approximate``),
- an additive key mask of -1e9 inside attention,
- the final layer computed only at CLS or at ``out_positions``,
- the tanh pooler in f32.

Attention always goes through ``ops/attention.py``, which launches kernel
A on CUDA tensors. Parameters keep the JAX pytree layout (``embeddings``,
``layers[i].attn|mlp``, ``pooler``; kernels ``(in, out)``), so a JAX
checkpoint maps one to one (``models/convert.py``). No dropout, no remat:
training is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from anncur_tpu_torch.ops.attention import attention

BertParams = Dict[str, Any]  # nested dict of arrays, the JAX layout


@dataclasses.dataclass(frozen=True)
class BertSpec:
    """Architecture hyperparameters (bert-base-uncased defaults); the
    fields of ``anncur_tpu.models.bert.BertSpec``."""

    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    # kept for field parity with the JAX spec; the port always runs
    # attention through ops/attention.py (kernel A on the card)
    attention_impl: str = "xla"
    # True = tanh approximation, False = exact erf, None = tanh under
    # bf16 compute and erf otherwise (the JAX package's measured rule)
    gelu_approximate: Optional[bool] = None

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @classmethod
    def tiny(cls, **kw) -> "BertSpec":
        """Small spec for tests."""
        defaults = dict(
            vocab_size=512,
            hidden_size=64,
            num_layers=2,
            num_heads=4,
            intermediate_size=128,
            max_position_embeddings=128,
        )
        defaults.update(kw)
        return cls(**defaults)


def init_bert_params(rng: np.random.Generator, spec: BertSpec) -> BertParams:
    """Random f32 params in the JAX pytree layout: normal(0, initializer_
    range) weights, zero biases, unit LayerNorm scales. Draws come from
    ``rng`` (numpy), so they differ from ``jax.random``'s; tests that
    compare the packages carry one tree across with ``models/convert.py``."""
    std = spec.initializer_range
    h, i = spec.hidden_size, spec.intermediate_size

    def normal(*shape):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(std)

    def ones(n):
        return np.ones((n,), np.float32)

    def zeros(n):
        return np.zeros((n,), np.float32)

    params: BertParams = {
        "embeddings": {
            "word": normal(spec.vocab_size, h),
            "position": normal(spec.max_position_embeddings, h),
            "token_type": normal(spec.type_vocab_size, h),
            "ln_scale": ones(h),
            "ln_bias": zeros(h),
        },
        "layers": [],
        "pooler": {"kernel": normal(h, h), "bias": zeros(h)},
    }
    for _ in range(spec.num_layers):
        params["layers"].append(
            {
                "attn": {
                    "q_kernel": normal(h, h), "q_bias": zeros(h),
                    "k_kernel": normal(h, h), "k_bias": zeros(h),
                    "v_kernel": normal(h, h), "v_bias": zeros(h),
                    "out_kernel": normal(h, h), "out_bias": zeros(h),
                    "ln_scale": ones(h), "ln_bias": zeros(h),
                },
                "mlp": {
                    "in_kernel": normal(h, i), "in_bias": zeros(i),
                    "out_kernel": normal(i, h), "out_bias": zeros(h),
                    "ln_scale": ones(h), "ln_bias": zeros(h),
                },
            }
        )
    return params


def params_module(tree, device: torch.device) -> nn.Module:
    """Nested dict/list of arrays -> ModuleDict/ModuleList/ParameterDict
    holding f32 parameters (no grad), same keys as the JAX tree."""
    if isinstance(tree, (list, tuple)):
        return nn.ModuleList([params_module(t, device) for t in tree])
    if all(not isinstance(v, (dict, list, tuple)) for v in tree.values()):
        return nn.ParameterDict(
            {
                key: nn.Parameter(
                    torch.tensor(np.asarray(val, np.float32), device=device),
                    requires_grad=False,
                )
                for key, val in tree.items()
            }
        )
    return nn.ModuleDict({key: params_module(val, device) for key, val in tree.items()})


# --------------------------------------------------------------------- #
# forward
# --------------------------------------------------------------------- #


def _layer_norm(x, scale, bias, eps):
    # in f32 whatever the compute dtype, cast back; one fused LayerNorm
    # (written out as mean/var/rsqrt ops it took ~30% of the CE forward's
    # device time on the H100, PERF.md)
    return F.layer_norm(x.float(), (x.shape[-1],), scale, bias, eps).to(x.dtype)


def _dense(x, kernel, bias, dtype):
    return x @ kernel.to(dtype) + bias.to(dtype)


def _gelu(x, approximate=None):
    if approximate is None:
        approximate = x.dtype == torch.bfloat16
    return F.gelu(x, approximate="tanh" if approximate else "none")


def _encoder_layer(x, key_valid, lp, spec: BertSpec, dtype, rows=None):
    """One encoder layer. ``rows``: None for every position, else a
    (b, g) long tensor of the positions the final layer is computed at
    (exact: attention needs only those query rows, the MLP is
    position-wise; ``anncur_tpu/models/bert.py::_encoder_layer_select_only``)."""
    p = lp["attn"]
    b, s, h = x.shape
    nh, hd = spec.num_heads, spec.head_dim
    x_sel = x if rows is None else torch.gather(x, 1, rows[:, :, None].expand(-1, -1, h))
    g = x_sel.shape[1]
    q = _dense(x_sel, p["q_kernel"], p["q_bias"], dtype).reshape(b, g, nh, hd)
    k = _dense(x, p["k_kernel"], p["k_bias"], dtype).reshape(b, s, nh, hd)
    v = _dense(x, p["v_kernel"], p["v_bias"], dtype).reshape(b, s, nh, hd)
    ctx = attention(q, k, v, key_valid).reshape(b, g, h)
    a = _dense(ctx, p["out_kernel"], p["out_bias"], dtype)
    x0 = _layer_norm(x_sel + a, p["ln_scale"], p["ln_bias"], spec.layer_norm_eps)
    mp = lp["mlp"]
    m = _gelu(_dense(x0, mp["in_kernel"], mp["in_bias"], dtype), spec.gelu_approximate)
    m = _dense(m, mp["out_kernel"], mp["out_bias"], dtype)
    return _layer_norm(x0 + m, mp["ln_scale"], mp["ln_bias"], spec.layer_norm_eps)


@torch.no_grad()
def bert_encode(
    params: nn.Module,  # params_module() of a BertParams tree
    token_ids: torch.Tensor,  # (b, s) int
    segment_ids: torch.Tensor,  # (b, s) int
    attention_mask: torch.Tensor,  # (b, s) bool or {0,1}
    spec: BertSpec,
    compute_dtype: torch.dtype = torch.bfloat16,
    cls_only: bool = False,
    out_positions: Optional[torch.Tensor] = None,  # (b, g) int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sequence_output (b, s, h) f32, pooled_output (b, h) f32).

    ``cls_only``: the final layer runs at CLS only; sequence_output is
    (b, 1, h). ``out_positions``: the final layer runs at these positions
    only; sequence_output is (b, g, h), row j at ``out_positions[:, j]``.
    Both are exact (``anncur_tpu.models.bert.bert_encode``)."""
    b, s = token_ids.shape
    token_ids = token_ids.long()
    emb = params["embeddings"]
    x = emb["word"][token_ids] + emb["position"][:s][None] + emb["token_type"][segment_ids.long()]
    x = _layer_norm(x.to(compute_dtype), emb["ln_scale"], emb["ln_bias"], spec.layer_norm_eps)
    key_valid = attention_mask > 0

    layers = params["layers"]
    last = len(layers) - 1
    for li, lp in enumerate(layers):
        rows = None
        if li == last and cls_only:
            rows = torch.zeros((b, 1), dtype=torch.long, device=x.device)
        elif li == last and out_positions is not None:
            rows = out_positions.long()
        x = _encoder_layer(x, key_valid, lp, spec, compute_dtype, rows)

    seq_out = x.float()
    pooler = params["pooler"]
    pooled = torch.tanh(seq_out[:, 0, :] @ pooler["kernel"] + pooler["bias"])
    return seq_out, pooled
