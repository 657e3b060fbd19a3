"""The yardstick's arithmetic for DeepSeek-V2-Lite: model FLOPs of a pair
and the bytes of the expert layer's two dispatch passes
(``anncur_tpu_torch/ops/moe.py``: ``moe_permute``, ``moe_combine``)."""

from __future__ import annotations

from typing import Any, Dict, Tuple


def active_weights(cfg: Dict[str, Any]) -> int:
    """Weights a token's products go through: every layer's attention
    projections (q, kv_a, kv_b, o), the dense layers' MLP, each expert
    layer's router, its top k routed experts and its shared experts, and
    the score head; the embedding is a lookup (DeepSeek-V2-Lite: 2.2416 B)."""
    h, nh, n_layers = cfg["hidden_size"], cfg["num_attention_heads"], cfg["num_hidden_layers"]
    nope, rope, vd, r = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"], cfg["kv_lora_rank"]
    attn = h * nh * (nope + rope) + h * (r + rope) + r * nh * (nope + vd) + nh * vd * h
    dense = cfg["first_k_dense_replace"]
    w = cfg["moe_intermediate_size"]
    expert_layer = (h * cfg["n_routed_experts"] + 3 * h * w * cfg["num_experts_per_tok"]
                    + 3 * h * w * cfg["n_shared_experts"])
    return (n_layers * attn + dense * 3 * h * cfg["intermediate_size"] + (n_layers - dense) * expert_layer + h)


def pair_flops(cfg: Dict[str, Any], seq_len: int) -> float:
    """Model FLOPs of one pair's forward at ``seq_len`` tokens: 2 x active
    weights x L, plus causal QKᵀ (qk head dim) and PV (v head dim) over the
    L (L + 1) / 2 visible (query, key) pairs of every head and layer
    (DeepSeek-V2-Lite at 256: 1.1569 TFLOP)."""
    visible = seq_len * (seq_len + 1) / 2
    per_head = 2.0 * visible * (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"] + cfg["v_head_dim"])
    return 2.0 * active_weights(cfg) * seq_len + cfg["num_hidden_layers"] * cfg["num_attention_heads"] * per_head


def permute_cost(tokens: int, k: int, width: int, elem_bytes: int = 2) -> Tuple[float, float]:
    """(bytes, operations) one ``moe_permute`` launch needs: each token's
    row read once, k rows written a token, the (tokens, k) int32 rows; no
    operations."""
    return float(tokens * width * elem_bytes * (1 + k) + 4 * tokens * k), 0.0


def combine_cost(tokens: int, k: int, width: int, elem_bytes: int = 2) -> Tuple[float, float]:
    """(bytes, operations) one ``moe_combine`` launch needs: the k expert
    rows of each token, its shared-expert row and residual read, its row
    written, the (tokens, k) int32 rows and f32 weights; a multiply and an
    add a routed value, two adds a value after."""
    nbytes = tokens * width * elem_bytes * (k + 3) + 8 * tokens * k
    return float(nbytes), float(tokens * width * (2 * k + 2))
