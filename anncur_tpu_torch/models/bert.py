"""BERT encoder, in PyTorch.

Counterpart of ``anncur_tpu/models/bert.py`` with the same numerics:

- bf16 compute with f32 params cast at each dense layer,
- LayerNorm in f32, cast back to the compute dtype,
- embeddings summed in f32, cast, then normalised,
- gelu tanh under bf16 and erf otherwise (``BertSpec.gelu_approximate``),
- an additive key mask of -1e9 inside attention,
- the final layer computed only at CLS or at ``out_positions``,
- the tanh pooler in f32,
- in training, inverted dropout at the JAX sites (after the embedding
  LayerNorm, on each layer's attention and MLP outputs, and on the
  attention probabilities) and optional remat.

Attention goes through ``ops/attention.py`` (kernel A forward, kernels C
and D backward on the card) whenever no attention dropout applies, which is
JAX's flash condition; with attention dropout in training it is plain
tensor ops, as JAX's ``_attn_core``. On the inference path (bf16, no
autograd graph, no dropout, no tensor parallelism) each layer's bias adds,
GELU, residual adds and LayerNorms go through the three entries of
``ops/encoder_epilogue.py``, which keep the same rounding points; every
other forward runs them as plain tensor ops. The model never asks where
its tensors lie: each entry of ``ops/`` launches its kernel on the card and
computes its plain composition on the CPU. Parameters keep the JAX
pytree layout (``embeddings``, ``layers[i].attn|mlp``, ``pooler``; kernels
``(in, out)``), so a JAX checkpoint maps one to one (``models/convert.py``).

Randomness comes from an explicit ``torch.Generator``: each forward draws
one integer seed per dropout site off it, and each site's mask comes from
a generator seeded with that integer on the activations' device. The
seeds are drawn before any checkpointed region, so remat's recompute
redraws the same masks (``torch.utils.checkpoint`` restores only the
default generators, not a caller's).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from anncur_tpu_torch.ops.attention import attention
from anncur_tpu_torch.ops.encoder_epilogue import bias_add3, bias_gelu, bias_residual_layernorm
from anncur_tpu_torch.parallel.tp import copy_to_tp, reduce_from_tp

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
    holding f32 parameters, same keys as the JAX tree. They do not require
    grad; a trainer turns that on (``Module.requires_grad_``)."""
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


def params_tree(module: nn.Module):
    """Inverse of :func:`params_module`: the JAX-layout tree with f32 numpy
    leaves (copies)."""
    if isinstance(module, nn.ModuleList):
        return [params_tree(m) for m in module]
    if isinstance(module, nn.ParameterDict):
        return {key: p.detach().cpu().numpy().copy() for key, p in module.items()}
    return {key: params_tree(m) for key, m in module.items()}


@torch.no_grad()
def load_params_(module: nn.Module, tree) -> None:
    """Copy a JAX-layout tree (numpy or tensor leaves) into the parameters
    of :func:`params_module`'s module, in place; shapes must match."""
    if isinstance(module, nn.ModuleList):
        if len(module) != len(tree):
            raise ValueError(f"{len(tree)} entries for {len(module)} layers")
        for m, t in zip(module, tree):
            load_params_(m, t)
        return
    if set(module.keys()) != set(tree.keys()):
        raise ValueError(f"tree keys {sorted(tree)} != module keys {sorted(module.keys())}")
    if isinstance(module, nn.ParameterDict):
        for key, p in module.items():
            val = torch.as_tensor(np.asarray(tree[key], np.float32))
            if tuple(val.shape) != tuple(p.shape):
                raise ValueError(f"{key}: shape {tuple(val.shape)} != {tuple(p.shape)}")
            p.copy_(val)
        return
    for key, m in module.items():
        load_params_(m, tree[key])


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


def draw_seeds(generator: torch.Generator, n: int) -> List[int]:
    """``n`` integer seeds off ``generator`` (one draw, on its device)."""
    return torch.randint(0, 2**62, (n,), generator=generator, device=generator.device).tolist()


def dropout(x, seed: Optional[int], rate: float):
    """Inverted dropout (``anncur_tpu/models/bert.py::_dropout``): keep
    with probability 1 - rate and scale by 1 / (1 - rate); identity when
    ``seed`` is None or the rate is 0. The mask comes from a generator
    seeded with ``seed`` on ``x``'s device."""
    if seed is None or not rate:
        return x
    u = torch.rand(x.shape, generator=torch.Generator(device=x.device).manual_seed(seed), device=x.device)
    return torch.where(u < 1.0 - rate, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def attention_dropout_core(q, k, v, key_valid, seed: int, rate: float, dtype):
    """Attention with dropout on the probabilities, as plain tensor ops
    (``anncur_tpu/models/bert.py::_attn_core``): f32 scores and softmax,
    probabilities cast to the compute dtype, dropped, then P V."""
    hd = q.shape[-1]
    scores = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float()) / math.sqrt(hd)
    bias = torch.where(key_valid, 0.0, -1e9).to(torch.float32)
    probs = torch.softmax(scores + bias[:, None, None, :], dim=-1).to(dtype)
    probs = dropout(probs, seed, rate)
    return torch.einsum("bnqk,bknd->bqnd", probs, v.to(dtype))


def _fuses_epilogue(x, lp, dtype, seeds, tp) -> bool:
    """Whether the layer's elementwise work takes ``ops/encoder_epilogue.py``'s
    entries, from what the inputs show: bf16 compute, no autograd graph
    recorded, no dropout seeds and no tensor-parallel group. Training
    (dropout sits between a bias add and its residual, and autograd needs
    the plain ops), f32 and tensor parallelism keep the plain ops."""
    if dtype != torch.bfloat16 or seeds is not None or tp is not None:
        return False
    return not torch.is_grad_enabled() or not (x.requires_grad or any(t.requires_grad for t in lp.parameters()))


def _row_dense(x, kernel, bias, dtype, tp):
    """``_dense`` of a row-parallel product: under tensor parallelism the
    partial products are summed over the ``model`` group before the bias
    is added, once."""
    if tp is None:
        return _dense(x, kernel, bias, dtype)
    return reduce_from_tp(x @ kernel.to(dtype), tp) + bias.to(dtype)


def _encoder_layer(
    x, key_valid, lp, spec: BertSpec, dtype, rows=None,
    seeds: Optional[Sequence[int]] = None, rate: float = 0.0, attn_remat: bool = False,
):
    """One encoder layer. ``rows``: None for every position, else a
    (b, g) long tensor of the positions the final layer is computed at
    (exact: attention needs only those query rows, the MLP is
    position-wise; ``anncur_tpu/models/bert.py::_encoder_layer_select_only``).
    ``seeds``: None (no dropout) or the (attention, hidden 1, hidden 2)
    dropout seeds; ``rate`` is the hidden dropout rate.

    A layer that ``parallel/tp.py::shard_params`` sharded carries its
    ``model`` group as ``lp.tp_group`` and holds this rank's heads and MLP
    columns: q/k/v and the MLP input are column-parallel, the attention
    output and the MLP output row-parallel (Megatron layout)."""
    attn_seed, hid_seed1, hid_seed2 = seeds if seeds is not None else (None, None, None)
    attn_rate = spec.attention_dropout if seeds is not None else 0.0
    tp = getattr(lp, "tp_group", None)
    p = lp["attn"]
    b, s, h = x.shape
    hd = spec.head_dim
    nh = p["q_kernel"].shape[1] // hd  # this rank's heads under tensor parallelism

    def select(t):
        return t if rows is None else torch.gather(t, 1, rows[:, :, None].expand(-1, -1, h))

    x_in = x if tp is None else copy_to_tp(x, tp)
    x_sel = select(x)
    x_in_sel = x_sel if tp is None else select(x_in)
    g = x_sel.shape[1]
    fused = _fuses_epilogue(x, lp, dtype, seeds, tp)
    projections = ((x_in_sel, "q"), (x_in, "k"), (x_in, "v"))
    if fused:
        q, k, v = bias_add3(
            *(t @ p[f"{n}_kernel"].to(dtype) for t, n in projections), p["q_bias"], p["k_bias"], p["v_bias"]
        )
    else:
        q, k, v = (_dense(t, p[f"{n}_kernel"], p[f"{n}_bias"], dtype) for t, n in projections)
    q, k, v = q.reshape(b, g, nh, hd), k.reshape(b, s, nh, hd), v.reshape(b, s, nh, hd)
    if attn_rate:
        # JAX's XLA path (its flash kernel takes no dropout); remat='attn'
        # recomputes this core in backward instead of keeping its (s, s)
        # tensors (on the kernel path there is nothing to gain: kernels C
        # and D recompute P anyway)
        args = (q, k, v, key_valid, attn_seed, attn_rate, dtype)
        if attn_remat:
            ctx = checkpoint(attention_dropout_core, *args, use_reentrant=False)
        else:
            ctx = attention_dropout_core(*args)
    else:
        ctx = attention(q, k, v, key_valid)
    ctx = ctx.reshape(b, g, nh * hd)
    mp = lp["mlp"]
    if fused:
        eps = spec.layer_norm_eps
        approximate = True if spec.gelu_approximate is None else spec.gelu_approximate  # _gelu's bf16 rule
        a = ctx @ p["out_kernel"].to(dtype)
        x0 = bias_residual_layernorm(a, p["out_bias"], x_sel, p["ln_scale"], p["ln_bias"], eps)
        m = bias_gelu(x0 @ mp["in_kernel"].to(dtype), mp["in_bias"], approximate)
        m = m @ mp["out_kernel"].to(dtype)
        return bias_residual_layernorm(m, mp["out_bias"], x0, mp["ln_scale"], mp["ln_bias"], eps)
    a = _row_dense(ctx, p["out_kernel"], p["out_bias"], dtype, tp)
    a = dropout(a, hid_seed1, rate)
    x0 = _layer_norm(x_sel + a, p["ln_scale"], p["ln_bias"], spec.layer_norm_eps)
    x0_in = x0 if tp is None else copy_to_tp(x0, tp)
    m = _gelu(_dense(x0_in, mp["in_kernel"], mp["in_bias"], dtype), spec.gelu_approximate)
    m = _row_dense(m, mp["out_kernel"], mp["out_bias"], dtype, tp)
    m = dropout(m, hid_seed2, rate)
    return _layer_norm(x0 + m, mp["ln_scale"], mp["ln_bias"], spec.layer_norm_eps)


def bert_encode(
    params: nn.Module,  # params_module() of a BertParams tree
    token_ids: torch.Tensor,  # (b, s) int
    segment_ids: torch.Tensor,  # (b, s) int
    attention_mask: torch.Tensor,  # (b, s) bool or {0,1}
    spec: BertSpec,
    compute_dtype: torch.dtype = torch.bfloat16,
    cls_only: bool = False,
    out_positions: Optional[torch.Tensor] = None,  # (b, g) int
    generator: Optional[torch.Generator] = None,
    dropout_on: bool = False,
    remat=False,  # False | True (per layer) | 'attn' (the dropout-attention core)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sequence_output (b, s, h) f32, pooled_output (b, h) f32).

    ``cls_only``: the final layer runs at CLS only; sequence_output is
    (b, 1, h). ``out_positions``: the final layer runs at these positions
    only; sequence_output is (b, g, h), row j at ``out_positions[:, j]``.
    Both are exact (``anncur_tpu.models.bert.bert_encode``).

    Gradients flow as the caller's grad mode says; the inference callers
    run under ``torch.no_grad``. ``dropout_on`` with a ``generator`` turns
    on dropout at the spec's rates (JAX's ``dropout=True`` with a
    ``dropout_rng``). ``remat``: True checkpoints every full layer
    (``use_reentrant=False``), 'attn' only the dropout-attention core."""
    b, s = token_ids.shape
    token_ids = token_ids.long()
    emb = params["embeddings"]
    x = emb["word"][token_ids] + emb["position"][:s][None] + emb["token_type"][segment_ids.long()]
    x = _layer_norm(x.to(compute_dtype), emb["ln_scale"], emb["ln_bias"], spec.layer_norm_eps)
    key_valid = attention_mask > 0

    layers = params["layers"]
    n_layers = len(layers)
    want_dropout = dropout_on and generator is not None
    rate = spec.hidden_dropout if want_dropout else 0.0
    layer_seeds: List[Optional[Tuple[int, int, int]]] = [None] * n_layers
    if want_dropout:
        # every seed of this forward in one draw, before any checkpoint
        seeds = draw_seeds(generator, 1 + 3 * n_layers)
        x = dropout(x, seeds[0], rate)
        if spec.hidden_dropout or spec.attention_dropout:
            layer_seeds = [tuple(seeds[1 + 3 * i: 4 + 3 * i]) for i in range(n_layers)]

    for li, lp in enumerate(layers):
        rows = None
        if li == n_layers - 1 and cls_only:
            rows = torch.zeros((b, 1), dtype=torch.long, device=x.device)
        elif li == n_layers - 1 and out_positions is not None:
            rows = out_positions.long()
        if remat is True and rows is None and torch.is_grad_enabled():
            x = checkpoint(
                _encoder_layer, x, key_valid, lp, spec, compute_dtype, None,
                layer_seeds[li], rate, False, use_reentrant=False,
            )
        else:
            x = _encoder_layer(
                x, key_valid, lp, spec, compute_dtype, rows, layer_seeds[li], rate,
                attn_remat=remat == "attn",
            )

    seq_out = x.float()
    pooler = params["pooler"]
    pooled = torch.tanh(seq_out[:, 0, :] @ pooler["kernel"] + pooler["bias"])
    return seq_out, pooled


def count_params(params: BertParams) -> int:
    """Number of parameter values in a params tree (nested dicts and lists
    of arrays or tensors)."""
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(count_params(v) for v in params)
    return int(np.prod(np.shape(params)))
