"""DeepSeek-V2-Lite as a pointwise cross-encoder, in PyTorch.

No counterpart in the JAX package, which has BERT alone. A decoder LLM
scores a (mention ⧺ entity) pair as RankLLaMA does (arXiv:2310.08319) and
as transformers' ``DeepseekV2ForSequenceClassification`` does: the whole
pair through the causal model, then ``Linear(hidden, 1, bias=False)`` on
the final-norm hidden state at the last non-pad position. The LM head is
left out in favour of that score head.

The architecture is the source's
(https://huggingface.co/deepseek-ai/DeepSeek-V2-Lite/blob/main/config.json
and its ``modeling_deepseek.py``), read from the published config keys
(:meth:`DeepseekV2Spec.from_config`):

- token embeddings, pre-norm decoder layers (RMSNorm, attention, residual;
  RMSNorm, MLP, residual), a final RMSNorm;
- attention: MLA in its expanded prefill form, with no q LoRA: q from one
  product; ``kv_a_proj_with_mqa`` gives a 512-wide latent and a 64-wide
  k_pe shared by every head; the latent's RMSNorm, then ``kv_b_proj`` gives
  each head's k_nope (128) and v (128); YaRN RoPE on the 64 rope dims of q
  and k; causal softmax attention over 192-wide q and k (kernel A, v
  zero-padded to 192);
- the softmax scale is the source's, 192^-0.5 · mscale² with mscale =
  0.1 · ``mscale_all_dim`` · ln(factor) + 1 (≈ 1.5896 times 192^-0.5);
  transformers 4.57's ``DeepseekV2Attention`` leaves that factor out;
- layer 0 a SwiGLU MLP, the others sparse experts (``ops/moe.py``): a
  softmax router in f32, the top 6 of 64, weights not renormalised, each a
  SwiGLU, and the shared experts (one SwiGLU as wide as all of them)
  added; no token is dropped.

RoPE rotates (even, odd) pairs of the rope dims as transformers' complex
form does; the source de-interleaves both q and k first, which permutes
the dims of both alike and leaves every score the same.

Numerics: weights held on the device in the compute dtype (bf16 on the
card; 15.5 B parameters without the LM head, 31 GB: f32 master copies
would not fit beside the work), built there from a ``torch.Generator`` or
handed in as device tensors; activations in the compute dtype; RMSNorm in
f32, rounded, then times its weight (the source's order; one kernel a norm
on the card, ``ops/rms_norm.py``, 82 a forward); RoPE in f32,
rounded once; the router in f32; the score in f32. The final layer runs
its query, attention output and experts at each pair's last valid position
only, which is exact: nothing after it reads the other positions. The
model never asks where its tensors lie: each entry of ``ops/`` it calls
launches its kernel on the card and its plain composition on the CPU.

Pairs keep ``ScoreMatrixBuilder``'s layout (mention ⧺ entity[1:], right-padded with id
0, which is masked as a key); positions run from 0. Spans (``TRACER``):
``mla.attention`` per layer, ``moe.route``, ``moe.experts`` and
``moe.combine`` per expert layer; the device counter ``moe.expert_rows``
((expert layers, experts) int64) adds each forward's rows per expert.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from anncur_tpu_torch.ops.attention import attention
from anncur_tpu_torch.ops.moe import expert_mlp, moe_combine, moe_permute, route, sort_rows, swiglu
from anncur_tpu_torch.ops.rms_norm import rms_norm
from anncur_tpu_torch.utils.device import DeviceLike, resolve_device
from anncur_tpu_torch.utils.tracker import TRACER

EXPERT_ROWS = "moe.expert_rows"
PAD_ID = 0  # the pair padding of indexer/score_matrix.py, masked as a key


@dataclasses.dataclass(frozen=True)
class DeepseekV2Spec:
    """The published widths of DeepSeek-V2-Lite (defaults) or another
    configuration of the same architecture."""

    vocab_size: int = 102400
    hidden_size: int = 2048
    num_layers: int = 27
    num_heads: int = 16
    intermediate_size: int = 10944
    moe_intermediate_size: int = 1408
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    first_k_dense_replace: int = 1
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    rope_factor: float = 40.0
    rope_original_max_position: int = 4096
    rope_beta_fast: float = 32.0
    rope_beta_slow: float = 1.0
    rope_mscale: float = 0.707
    rope_mscale_all_dim: float = 0.707
    routed_scaling_factor: float = 1.0
    max_position_embeddings: int = 163840

    @classmethod
    def from_config(cls, cfg: Dict[str, Any]) -> "DeepseekV2Spec":
        """The spec of a published ``config.json`` (its keys); raises on a
        setting this port does not implement."""
        want = {"q_lora_rank": None, "topk_method": "greedy", "scoring_func": "softmax", "norm_topk_prob": False,
                "n_group": 1, "topk_group": 1, "moe_layer_freq": 1, "attention_bias": False, "hidden_act": "silu"}
        for key, val in want.items():
            if cfg.get(key, val) != val:
                raise ValueError(f"{key}={cfg[key]!r}: this port implements {key}={val!r}")
        rope = cfg["rope_scaling"]
        if rope.get("type", rope.get("rope_type")) != "yarn":
            raise ValueError(f"rope_scaling {rope!r}: this port implements yarn")
        return cls(
            vocab_size=cfg["vocab_size"], hidden_size=cfg["hidden_size"], num_layers=cfg["num_hidden_layers"],
            num_heads=cfg["num_attention_heads"], intermediate_size=cfg["intermediate_size"],
            moe_intermediate_size=cfg["moe_intermediate_size"], n_routed_experts=cfg["n_routed_experts"],
            n_shared_experts=cfg["n_shared_experts"], num_experts_per_tok=cfg["num_experts_per_tok"],
            first_k_dense_replace=cfg["first_k_dense_replace"], kv_lora_rank=cfg["kv_lora_rank"],
            qk_nope_head_dim=cfg["qk_nope_head_dim"], qk_rope_head_dim=cfg["qk_rope_head_dim"],
            v_head_dim=cfg["v_head_dim"], rms_norm_eps=cfg["rms_norm_eps"], rope_theta=cfg["rope_theta"],
            rope_factor=rope["factor"], rope_original_max_position=rope["original_max_position_embeddings"],
            rope_beta_fast=rope["beta_fast"], rope_beta_slow=rope["beta_slow"], rope_mscale=rope["mscale"],
            rope_mscale_all_dim=rope["mscale_all_dim"], routed_scaling_factor=cfg["routed_scaling_factor"],
            max_position_embeddings=cfg["max_position_embeddings"],
        )

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def n_moe_layers(self) -> int:
        return self.num_layers - self.first_k_dense_replace

    @property
    def softmax_scale(self) -> float:
        """192^-0.5 · mscale(factor, mscale_all_dim)² (``modeling_deepseek.py``)."""
        m = yarn_mscale(self.rope_factor, self.rope_mscale_all_dim)
        return self.qk_head_dim ** -0.5 * m * m


def yarn_mscale(factor: float, mscale: float) -> float:
    return 0.1 * mscale * math.log(factor) + 1.0 if factor > 1 else 1.0


def yarn_inv_freq(spec: DeepseekV2Spec) -> torch.Tensor:
    """(rope / 2,) f32 YaRN inverse frequencies (the source's and
    transformers' arithmetic, in f32)."""
    dim, base = spec.qk_rope_head_dim, spec.rope_theta

    def corr(rot):
        return dim * math.log(spec.rope_original_max_position / (rot * 2 * math.pi)) / (2 * math.log(base))

    low = max(math.floor(corr(spec.rope_beta_fast)), 0)
    high = min(math.ceil(corr(spec.rope_beta_slow)), dim - 1)
    pos = base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim)
    extra, inter = 1.0 / pos, 1.0 / (spec.rope_factor * pos)
    ramp = ((torch.arange(dim // 2, dtype=torch.float32) - low) / (high - low if high > low else 0.001)).clamp(0, 1)
    keep = 1.0 - ramp  # the share of each frequency left unscaled
    return inter * (1.0 - keep) + extra * keep


def rope_tables(spec: DeepseekV2Spec, n_pos: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), each (n_pos, rope / 2) f32, times the YaRN attention
    factor mscale(factor, mscale) / mscale(factor, mscale_all_dim)."""
    freqs = torch.outer(torch.arange(n_pos, dtype=torch.float32), yarn_inv_freq(spec))
    att = yarn_mscale(spec.rope_factor, spec.rope_mscale) / yarn_mscale(spec.rope_factor, spec.rope_mscale_all_dim)
    return (freqs.cos() * att).to(device), (freqs.sin() * att).to(device)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """(even, odd) pairs of ``x``'s last dim rotated by (cos, sin), which
    broadcast against x's pairs; in f32, rounded to x's dtype."""
    xf = x.float().unflatten(-1, (-1, 2))
    x0, x1 = xf[..., 0], xf[..., 1]
    return torch.stack((x0 * cos - x1 * sin, x0 * sin + x1 * cos), dim=-1).flatten(-2).to(x.dtype)


def weight_shapes(spec: DeepseekV2Spec) -> Dict[str, Any]:
    """The shape of every weight: ``embed``, ``layers`` (a list of dicts),
    ``final_norm`` and ``score``. Products are (in, out); gate and up are
    one [gate | up] matrix; experts are stacked along a first axis."""
    h, nh = spec.hidden_size, spec.num_heads
    layers: List[Dict[str, Tuple[int, ...]]] = []
    for li in range(spec.num_layers):
        lw = {
            "attn_norm": (h,), "q": (h, nh * spec.qk_head_dim),
            "kv_a": (h, spec.kv_lora_rank + spec.qk_rope_head_dim), "kv_norm": (spec.kv_lora_rank,),
            "kv_b": (spec.kv_lora_rank, nh * (spec.qk_nope_head_dim + spec.v_head_dim)),
            "o": (nh * spec.v_head_dim, h), "mlp_norm": (h,),
        }
        if li < spec.first_k_dense_replace:
            lw.update(gate_up=(h, 2 * spec.intermediate_size), down=(spec.intermediate_size, h))
        else:
            e, w, ws = spec.n_routed_experts, spec.moe_intermediate_size, spec.moe_intermediate_size * spec.n_shared_experts
            lw.update(router=(e, h), experts_gate_up=(e, h, 2 * w), experts_down=(e, w, h),
                      shared_gate_up=(h, 2 * ws), shared_down=(ws, h))
        layers.append(lw)
    return {"embed": (spec.vocab_size, h), "layers": layers, "final_norm": (h,), "score": (h, 1)}


NORMS = ("attn_norm", "kv_norm", "mlp_norm", "final_norm")
# std of the weights drawn where none are handed in: transformers' default
# ``initializer_range`` (the source's config gives none)
INIT_STD = 0.02


def init_weights(spec: DeepseekV2Spec, generator: torch.Generator, device, dtype=torch.bfloat16,
                 std: float = INIT_STD) -> Dict[str, Any]:
    """Random weights drawn on ``device`` from ``generator``: normal(0, std)
    matrices, drawn one at a time in f32 and cast, unit RMSNorm weights."""
    def leaf(name, shape):
        if name in NORMS:
            return torch.ones(shape, dtype=dtype, device=device)
        return torch.randn(shape, generator=generator, device=device).mul_(std).to(dtype)

    shapes = weight_shapes(spec)
    return {
        "embed": leaf("embed", shapes["embed"]),
        "layers": [{k: leaf(k, s) for k, s in lw.items()} for lw in shapes["layers"]],
        "final_norm": leaf("final_norm", shapes["final_norm"]),
        "score": leaf("score", shapes["score"]),
    }


def _check_weights(weights, spec: DeepseekV2Spec, device, dtype) -> None:
    shapes = weight_shapes(spec)
    if len(weights["layers"]) != len(shapes["layers"]):
        raise ValueError(f"{len(weights['layers'])} layers of weights for a spec of {spec.num_layers}")
    pairs = [(n, weights[n], shapes[n]) for n in ("embed", "final_norm", "score")]
    for li, (lw, ls) in enumerate(zip(weights["layers"], shapes["layers"])):
        if set(lw) != set(ls):
            raise ValueError(f"layer {li}: weights {sorted(lw)} vs {sorted(ls)}")
        pairs += [(f"layers[{li}].{n}", lw[n], ls[n]) for n in ls]
    for name, t, shape in pairs:
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype or t.device.type != device.type:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype} on {t.device}, want {shape} {dtype} on {device}")


class DeepseekV2CrossEncoder:
    """The decoder cross-encoder, with ``CrossEncoder.score``'s signature:
    ``ScoreMatrixBuilder`` and the retriever
    (``CurRetriever.build``, ``query_tokens_batch``) take it where they take
    a ``CrossEncoder``. Inference only.

    ``weights``: a tree as :func:`weight_shapes` lays it out, of tensors on
    ``device`` in ``compute_dtype`` (used as they are, not copied); None
    draws them there from a generator seeded with ``seed``
    (:func:`init_weights`, std ``INIT_STD``)."""

    def __init__(self, spec: DeepseekV2Spec = DeepseekV2Spec(), device: DeviceLike = "cuda",
                 weights: Optional[Dict[str, Any]] = None, seed: int = 0,
                 compute_dtype: torch.dtype = torch.bfloat16):
        self.device = resolve_device(device)
        self.spec, self.compute_dtype = spec, compute_dtype
        if weights is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            weights = init_weights(spec, gen, self.device, compute_dtype)
        _check_weights(weights, spec, self.device, compute_dtype)
        self.weights = weights
        self._rope: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}

    @torch.no_grad()
    def score(self, pair_token_ids, first_segment_end: int, train: bool = False,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Scalar f32 score per pair, shape (b,): the score head at each
        pair's last non-pad position. ``first_segment_end`` is taken for the
        signature's sake (a decoder has no segment ids). Traced as a
        ``ce.forward`` span."""
        if train or generator is not None:
            raise ValueError("DeepseekV2CrossEncoder is inference only")
        with TRACER.span("ce.forward"):
            ids = torch.as_tensor(pair_token_ids, device=self.device).long()
            return self._forward(ids)

    def _rope_tables(self, n_pos: int):
        hit = self._rope.get(n_pos)
        if hit is None:
            hit = self._rope[n_pos] = rope_tables(self.spec, n_pos, self.device)
        return hit

    def _forward(self, ids: torch.Tensor) -> torch.Tensor:
        spec, w = self.spec, self.weights
        b, s = ids.shape
        valid = ids != PAD_ID
        last = (torch.arange(s, device=ids.device) * valid).argmax(-1)  # rightmost valid position
        x = w["embed"][ids * valid]
        cos, sin = self._rope_tables(s)
        counter = TRACER.device_counter(EXPERT_ROWS, (spec.n_moe_layers, spec.n_routed_experts), self.device) \
            if spec.n_moe_layers else None
        for li, lw in enumerate(w["layers"]):
            x = self._layer(li, lw, x, valid, last if li == spec.num_layers - 1 else None, cos, sin, counter)
        hidden = rms_norm(x, w["final_norm"], spec.rms_norm_eps)
        return (hidden.float() @ w["score"].float())[:, 0]

    def _layer(self, li, lw, x, valid, at, cos, sin, counter):
        """One decoder layer over (b, s, h); with ``at`` (b,) positions, the
        layer's output at those positions only, (b, h)."""
        spec = self.spec
        xn = rms_norm(x, lw["attn_norm"], spec.rms_norm_eps)
        with TRACER.span("mla.attention"):
            a = self._mla(lw, xn, valid, at, cos, sin)
        resid = x if at is None else x[torch.arange(x.shape[0], device=x.device), at][:, None]
        h1 = resid + a
        hn = rms_norm(h1, lw["mlp_norm"], spec.rms_norm_eps)
        if li < spec.first_k_dense_replace:
            out = h1 + swiglu(hn @ lw["gate_up"]) @ lw["down"]
        else:
            out = self._moe(lw, hn, h1, counter[li - spec.first_k_dense_replace])
        return out if at is None else out[:, 0]

    def _mla(self, lw, xn, valid, at, cos, sin):
        """MLA in its expanded form: (b, g, h), g = s, or 1 at ``at``."""
        spec = self.spec
        b, s, _ = xn.shape
        nh, nope, vd, r = spec.num_heads, spec.qk_nope_head_dim, spec.v_head_dim, spec.kv_lora_rank
        rows = torch.arange(b, device=xn.device)
        src = xn if at is None else xn[rows, at][:, None]
        g = src.shape[1]
        q = (src @ lw["q"]).view(b, g, nh, spec.qk_head_dim)
        ckv = xn @ lw["kv_a"]
        kv = (rms_norm(ckv[..., :r], lw["kv_norm"], spec.rms_norm_eps) @ lw["kv_b"]).view(b, s, nh, nope + vd)
        if at is None:  # (s, 1, rope / 2) against q's (b, s, nh, rope / 2) pairs
            qc, qs = cos[:, None], sin[:, None]
        else:  # (b, 1, 1, rope / 2): each pair's own position
            qc, qs = cos[at][:, None, None], sin[at][:, None, None]
        q[..., nope:] = apply_rope(q[..., nope:], qc, qs)
        k = torch.empty((b, s, nh, spec.qk_head_dim), dtype=xn.dtype, device=xn.device)
        k[..., :nope] = kv[..., :nope]
        k[..., nope:] = apply_rope(ckv[..., r:], cos, sin)[:, :, None, :]
        # the final layer's one query sees exactly the valid keys: with the
        # pad on the right they are the keys at or before its position
        o = attention(q, k, kv[..., nope:], valid, causal=at is None, scale=spec.softmax_scale)
        return o.reshape(b, g, nh * vd) @ lw["o"]

    def _moe(self, lw, hn, h1, counter):
        """The expert layer and the residual add, over every row of ``hn``."""
        spec = self.spec
        shape = h1.shape
        xt = hn.reshape(-1, shape[-1])
        with TRACER.span("moe.route"):
            ids, weights = route(xt, lw["router"], spec.num_experts_per_tok, spec.routed_scaling_factor)
            order = sort_rows(ids, spec.n_routed_experts)
            counter.add_(order.counts)
            xs = moe_permute(xt, order.dest)
        with TRACER.span("moe.experts"):
            y = expert_mlp(xs, lw["experts_gate_up"], lw["experts_down"], order)
            del xs
            shared = swiglu(xt @ lw["shared_gate_up"]) @ lw["shared_down"]
        with TRACER.span("moe.combine"):
            out = moe_combine(y, order.dest, weights, shared, h1.reshape(-1, shape[-1]))
        return out.view(shape)
