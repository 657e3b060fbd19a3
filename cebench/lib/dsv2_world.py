"""What a run of a DeepSeek-V2-Lite cell makes from its seed: the model's
weights and the token ids.

Weights are drawn on the run's device a part at a time (``embed``, each
``layer<i>``, ``head``), each part from a generator of its own, so the
check can draw any one layer again without the others: every matrix
normal(0, std), drawn in f32 a leaf at a time and rounded to bf16 (the
weights the card holds); RMSNorm weights ones. The port gets the bf16
tensors; the reference gets the same values in f32. The layout is the
port's (``anncur_tpu_torch/models/deepseek_v2.py``): products (in, out),
gate and up one [gate | up] matrix, experts stacked on a first axis.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from cebench.lib import world

NORMS = ("attn_norm", "kv_norm", "mlp_norm", "final_norm")


def layer_shapes(cfg: Dict[str, Any], i: int) -> Dict[str, Tuple[int, ...]]:
    """Layer ``i``'s weights, by name, in drawing order."""
    h, nh = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope, vd, r = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"], cfg["kv_lora_rank"]
    out = {"attn_norm": (h,), "q": (h, nh * (nope + rope)), "kv_a": (h, r + rope), "kv_norm": (r,),
           "kv_b": (r, nh * (nope + vd)), "o": (nh * vd, h), "mlp_norm": (h,)}
    if i < cfg["first_k_dense_replace"]:
        out.update(gate_up=(h, 2 * cfg["intermediate_size"]), down=(cfg["intermediate_size"], h))
    else:
        e, w = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
        ws = w * cfg["n_shared_experts"]
        out.update(router=(e, h), experts_gate_up=(e, h, 2 * w), experts_down=(e, w, h),
                   shared_gate_up=(h, 2 * ws), shared_down=(ws, h))
    return out


def part_shapes(cfg: Dict[str, Any], part: str) -> Dict[str, Tuple[int, ...]]:
    if part == "embed":
        return {"embed": (cfg["vocab_size"], cfg["hidden_size"])}
    if part == "head":
        return {"final_norm": (cfg["hidden_size"],), "score": (cfg["hidden_size"], 1)}
    return layer_shapes(cfg, int(part[len("layer"):]))


def part_weights(cfg: Dict[str, Any], seed: int, part: str, device, dtype=torch.bfloat16) -> Dict[str, torch.Tensor]:
    """One part's weights on ``device``: bf16 values, held in ``dtype``."""
    gen = world.generator(seed, f"dsv2.{part}", device)
    std = cfg["random_weight_std"]
    out = {}
    for name, shape in part_shapes(cfg, part).items():
        if name in NORMS:
            out[name] = torch.ones(shape, dtype=dtype, device=device)
        else:
            out[name] = torch.randn(shape, generator=gen, device=device).mul_(std).to(torch.bfloat16).to(dtype)
    return out


def model_weights(cfg: Dict[str, Any], seed: int, device, dtype=torch.bfloat16) -> Dict[str, Any]:
    """The port's whole tree."""
    head = part_weights(cfg, seed, "head", device, dtype)
    return {"embed": part_weights(cfg, seed, "embed", device, dtype)["embed"],
            "layers": [part_weights(cfg, seed, f"layer{i}", device, dtype) for i in range(cfg["num_hidden_layers"])],
            "final_norm": head["final_norm"], "score": head["score"]}


def reference_parts(cfg: Dict[str, Any], seed: int, device) -> Tuple[torch.Tensor, Callable[[int], Dict], torch.Tensor,
                                                                     torch.Tensor]:
    """(embed, layer(i), final_norm, score) in f32 for the reference: each
    layer drawn again when asked for."""
    head = part_weights(cfg, seed, "head", device, torch.float32)
    return (part_weights(cfg, seed, "embed", device, torch.float32)["embed"],
            lambda i: part_weights(cfg, seed, f"layer{i}", device, torch.float32),
            head["final_norm"], head["score"])


def tokens(gen: torch.Generator, n: int, length: int, dep: Dict[str, Any], entity: bool, device) -> torch.Tensor:
    """(n, length) int32 ids: BOS, then words (1 to BOS - 1), every row full
    length; an entity's last token EOS."""
    out = torch.randint(1, dep["bos_id"], (n, length), generator=gen, device=device, dtype=torch.int32)
    out[:, 0] = dep["bos_id"]
    if entity:
        out[:, -1] = dep["eos_id"]
    return out


def make_items(run) -> torch.Tensor:
    dep = run.cfg["deployment"]
    gen = world.generator(run.seed, "items", run.device)
    return tokens(gen, dep["n_items"], dep["max_label_len"], dep, True, run.device)


def make_mentions(run, n: int, tag: str) -> torch.Tensor:
    dep = run.cfg["deployment"]
    gen = world.generator(run.seed, tag, run.device)
    return tokens(gen, n, dep["max_input_len"], dep, False, run.device)
