"""Plain f32 reference of DeepSeek-V2-Lite as a pointwise cross-encoder.

Straight from the published description: a config (the keys of
https://huggingface.co/deepseek-ai/DeepSeek-V2-Lite/blob/main/config.json)
and the equations of the source's ``modeling_deepseek.py``. Everything is
f32 with TF32 off, one plain op at a time: an explicit causal and padding
mask over the whole sequence at every layer, softmax attention over the
expanded MLA heads, and the experts one by one over the tokens routed to
each. It imports nothing but ``torch``: no kernel, no batching trick, no
fused op of the port (``models/deepseek_v2.py``), which tests hold to it.

Weights are one layer at a time (``layer(i)`` returns layer i's dict), in
the port's layout: products (in, out); ``gate_up`` is [gate | up];
experts stacked on a first axis; ``router`` (experts, hidden).

Departures from the source:

- the LM head is replaced by the score head of transformers'
  ``DeepseekV2ForSequenceClassification``: ``Linear(hidden, 1, bias=False)``
  on the final-norm hidden state at the last non-pad position;
- the softmax scale is the source's ``modeling_deepseek.py`` one,
  qk_head_dim^-0.5 · mscale(factor, mscale_all_dim)²; transformers 4.57's
  ``DeepseekV2Attention`` leaves the mscale² out (its
  ``DeepseekV3Attention`` keeps it);
- RoPE rotates (even, odd) pairs of the rope dims in place (transformers'
  form); the source de-interleaves q and k alike first, which leaves every
  score the same;
- the top-k breaks ties to the lowest expert id (a stable sort);
- padding is id 0, masked as a key.
"""

import torch


def _log(x):
    return torch.tensor(float(x), dtype=torch.float64).log().item()


def yarn_mscale(factor, mscale):
    return 0.1 * mscale * _log(factor) + 1.0 if factor > 1 else 1.0


def softmax_scale(cfg):
    m = yarn_mscale(cfg["rope_scaling"]["factor"], cfg["rope_scaling"]["mscale_all_dim"])
    return (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5 * m * m


def rope_tables(cfg, n_pos, device):
    """(cos, sin), each (n_pos, rope / 2) f32: YaRN frequencies."""
    rs = cfg["rope_scaling"]
    dim, base, factor = cfg["qk_rope_head_dim"], float(cfg["rope_theta"]), float(rs["factor"])

    def corr(rot):
        return dim * _log(rs["original_max_position_embeddings"] / (rot * 2 * torch.pi)) / (2 * _log(base))

    low = max(int(corr(rs["beta_fast"]) // 1), 0)
    high = min(-int((-corr(rs["beta_slow"])) // 1), dim - 1)
    pos_freqs = base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim)
    ramp = ((torch.arange(dim // 2, dtype=torch.float32) - low) / (high - low if high > low else 0.001)).clamp(0, 1)
    inv_freq = (1.0 / (factor * pos_freqs)) * ramp + (1.0 / pos_freqs) * (1.0 - ramp)
    freqs = torch.arange(n_pos, dtype=torch.float32)[:, None] * inv_freq[None, :]
    att = yarn_mscale(factor, rs["mscale"]) / yarn_mscale(factor, rs["mscale_all_dim"])
    return (freqs.cos() * att).to(device), (freqs.sin() * att).to(device)


def rope(x, cos, sin):
    """(even, odd) pairs of the last dim rotated; cos, sin broadcast."""
    x0, x1 = x[..., 0::2], x[..., 1::2]
    out = torch.empty_like(x)
    out[..., 0::2] = x0 * cos - x1 * sin
    out[..., 1::2] = x0 * sin + x1 * cos
    return out


def rms_norm(x, weight, eps):
    return weight * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


def mlp(x, gate_up, down):
    width = gate_up.shape[-1] // 2
    gate, up = x @ gate_up[:, :width], x @ gate_up[:, width:]
    return (torch.nn.functional.silu(gate) * up) @ down


def attention(x, lw, cfg, allowed, cos, sin):
    """MLA over (n, s, h): softmax(q k^T · scale) v per head, ``allowed``
    (n, 1, s, s) the causal and padding mask."""
    n, s, _ = x.shape
    nh, nope, rope_d, vd, r = (cfg["num_attention_heads"], cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                              cfg["v_head_dim"], cfg["kv_lora_rank"])
    q = (x @ lw["q"]).view(n, s, nh, nope + rope_d).transpose(1, 2)  # (n, nh, s, 192)
    ckv = x @ lw["kv_a"]
    latent, k_pe = ckv[..., :r], ckv[..., r:]
    kv = (rms_norm(latent, lw["kv_norm"], cfg["rms_norm_eps"]) @ lw["kv_b"]).view(n, s, nh, nope + vd).transpose(1, 2)
    q = torch.cat([q[..., :nope], rope(q[..., nope:], cos, sin)], dim=-1)
    k_pe = rope(k_pe, cos, sin)[:, None].expand(n, nh, s, rope_d)
    k = torch.cat([kv[..., :nope], k_pe], dim=-1)
    v = kv[..., nope:]
    scores = (q @ k.transpose(-1, -2)) * softmax_scale(cfg)
    probs = torch.softmax(scores.masked_fill(~allowed, -torch.inf), dim=-1)
    return (probs @ v).transpose(1, 2).reshape(n, s, nh * vd) @ lw["o"]


def moe(x, lw, cfg):
    """The expert layer over (T, h): routed experts one by one, plus the
    shared experts."""
    k = cfg["num_experts_per_tok"]
    probs = torch.softmax(x @ lw["router"].T, dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    ids, weights = top.indices[:, :k], top.values[:, :k] * cfg["routed_scaling_factor"]
    out = torch.zeros_like(x)
    for e in range(cfg["n_routed_experts"]):
        tok, slot = (ids == e).nonzero(as_tuple=True)
        if tok.numel():
            y = mlp(x[tok], lw["experts_gate_up"][e], lw["experts_down"][e])
            out.index_add_(0, tok, y * weights[tok, slot][:, None])
    return out + mlp(x, lw["shared_gate_up"], lw["shared_down"])


def forward_scores(cfg, ids, embed, layer, final_norm, score):
    """(n,) f32 scores of the (n, s) token rows ``ids``: ``embed`` (vocab,
    h), ``layer(i)`` layer i's weights, ``final_norm`` (h,), ``score``
    (h, 1); every tensor f32 on one device."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        ids = ids.long()
        n, s = ids.shape
        valid = ids != 0
        pos = torch.arange(s, device=ids.device)
        allowed = (pos[None, :] <= pos[:, None])[None, None] & valid[:, None, None, :]
        cos, sin = rope_tables(cfg, s, ids.device)
        x = embed[ids * valid]
        eps = cfg["rms_norm_eps"]
        for i in range(cfg["num_hidden_layers"]):
            lw = layer(i)
            x = x + attention(rms_norm(x, lw["attn_norm"], eps), lw, cfg, allowed, cos, sin)
            h = rms_norm(x, lw["mlp_norm"], eps)
            if i < cfg["first_k_dense_replace"]:
                x = x + mlp(h, lw["gate_up"], lw["down"])
            else:
                x = x + moe(h.reshape(n * s, -1), lw, cfg).view(n, s, -1)
        last = (pos * valid).argmax(-1)
        hidden = rms_norm(x[torch.arange(n, device=ids.device), last], final_norm, eps)
        return (hidden @ score)[:, 0]
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
