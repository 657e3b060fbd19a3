"""The plain reference: a frozen BERT forward, CUR and exact MIPS top-k in
plain PyTorch, f32 with TF32 off. It imports nothing of the port or of
JAX and reads only what the benchmark made (weights, tokens, R).

The BERT follows the published bert-base description: embeddings summed
and LayerNorm'd, post-LN layers, exact (erf) GELU, softmax attention with
padded keys masked by an additive -1e9, the tanh pooler on [CLS]. The
last layer is computed at [CLS] only, which is exact for a head that reads
[CLS] (the 'default' CE head and ``cls_w_lin`` towers).

``precision`` selects the control: ``"fp8"`` rounds both inputs of every
matrix product (dense layers, QKᵀ, PV, pooler, head) to float8 e4m3 with a
per-tensor scale (amax / 448), the step below bf16 that a later change
could be tempted by; sums stay f32. For MIPS, ``"tf32"`` rounds both
inputs to TF32's 10-bit mantissa, one pass, the step below f32.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

E4M3_MAX = 448.0


@contextlib.contextmanager
def true_f32():
    """f32 matrix products without TF32 inside, whatever was set."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale, back in f32."""
    amax = x.abs().amax().clamp_min(1e-30)
    scale = E4M3_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (f32) rounded to nearest on TF32's 10-bit mantissa."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


class RefBert:
    """One BERT of a weights tree (the port's layout, f32 device tensors)."""

    def __init__(self, tree: Dict[str, Any], cfg: Dict[str, Any], precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"precision={precision!r}")
        self.t, self.precision = tree, precision
        self.nh = cfg["num_attention_heads"]
        self.eps = cfg["layer_norm_eps"]

    def _mm(self, a, b):
        if self.precision == "fp8":
            a, b = fp8(a), fp8(b)
        return a @ b

    def _ln(self, x, scale, bias):
        return torch.nn.functional.layer_norm(x, (x.shape[-1],), scale, bias, self.eps)

    def pooled(self, token_ids: torch.Tensor, segment_ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """(b, h) f32: tanh(W_p h_CLS + b_p) after the last layer."""
        with true_f32():
            return self._pooled(token_ids.long(), segment_ids.long(), mask.bool())

    def _pooled(self, ids, seg, mask):
        b, s = ids.shape
        emb = self.t["embeddings"]
        x = emb["word"][ids] + emb["position"][:s][None] + emb["token_type"][seg]
        x = self._ln(x, emb["ln_scale"], emb["ln_bias"])
        bias = torch.where(mask, 0.0, -1e9).to(torch.float32)[:, None, None, :]
        layers = self.t["layers"]
        for li, lp in enumerate(layers):
            x = self._layer(x, bias, lp, cls_only=li == len(layers) - 1)
        pool = self.t["pooler"]
        return torch.tanh(self._mm(x[:, 0, :], pool["kernel"]) + pool["bias"])

    def _layer(self, x, bias, lp, cls_only):
        b, s, h = x.shape
        hd = h // self.nh
        a = lp["attn"]
        xq = x[:, :1] if cls_only else x
        g = xq.shape[1]
        q = (self._mm(xq, a["q_kernel"]) + a["q_bias"]).view(b, g, self.nh, hd).transpose(1, 2)
        k = (self._mm(x, a["k_kernel"]) + a["k_bias"]).view(b, s, self.nh, hd).transpose(1, 2)
        v = (self._mm(x, a["v_kernel"]) + a["v_bias"]).view(b, s, self.nh, hd).transpose(1, 2)
        probs = torch.softmax(self._mm(q, k.transpose(-1, -2)) / math.sqrt(hd) + bias, dim=-1)
        ctx = self._mm(probs, v).transpose(1, 2).reshape(b, g, h)
        y = self._ln(xq + self._mm(ctx, a["out_kernel"]) + a["out_bias"], a["ln_scale"], a["ln_bias"])
        m = lp["mlp"]
        hmid = torch.nn.functional.gelu(self._mm(y, m["in_kernel"]) + m["in_bias"])
        return self._ln(y + self._mm(hmid, m["out_kernel"]) + m["out_bias"], m["ln_scale"], m["ln_bias"])


def pair_tokens(ment: torch.Tensor, ents: torch.Tensor, pair_len: int) -> torch.Tensor:
    """(n, Lm) mentions and (n, Le) entities, row by row -> (n, pair_len)
    pair tokens: mention ⧺ entity without its [CLS], zero-padded."""
    pairs = torch.cat([ment, ents[:, 1:]], dim=1)
    return torch.nn.functional.pad(pairs, (0, pair_len - pairs.shape[1]))


def ce_scores(tree, cfg, ment: torch.Tensor, ents: torch.Tensor, pair_len: int, precision: str = "f32",
              block: int = 64) -> torch.Tensor:
    """(n,) f32 cross-encoder scores of (mention i, entity i) pairs, ``block``
    pairs a forward: segment 1 from the mention's end, flagged where tokens
    are not [PAD]; the 'default' head on the pooled output."""
    bert = RefBert(tree["bert"], cfg, precision)
    lin = tree["score_linear"]
    lm = ment.shape[1]
    out = []
    for i in range(0, ment.shape[0], block):
        toks = pair_tokens(ment[i:i + block], ents[i:i + block], pair_len).long()
        mask = toks != 0
        pos = torch.arange(toks.shape[1], device=toks.device)[None, :]
        seg = (pos >= lm) & mask
        pooled = bert.pooled(toks * mask, seg, mask)
        with true_f32():
            out.append((bert._mm(pooled, lin["kernel"]) + lin["bias"])[:, 0])
    return torch.cat(out)


def tower_embeds(tower, cfg, toks: torch.Tensor, precision: str = "f32", block: int = 128) -> torch.Tensor:
    """(n, h) f32 ``cls_w_lin`` embeddings of single-segment token rows."""
    bert = RefBert(tower, cfg, precision)
    out = []
    for i in range(0, toks.shape[0], block):
        t = toks[i:i + block].long()
        mask = t != 0
        out.append(bert.pooled(t * mask, torch.zeros_like(t), mask))
    return torch.cat(out)


# the control: the reference one precision below what the configuration
# states (float8 e4m3 for the bf16 model, one TF32 pass for f32 products)
CONTROL_CE, CONTROL_MIPS = "fp8", "tf32"


def pinv_cutoff(mat: np.ndarray) -> np.ndarray:
    """f64 pseudoinverse cutting singular values below max(shape) x f32
    machine epsilon of the largest: scores are f32, so what lies below is
    rounding (the CUR index's stated U = pinv(R[:, anchors]))."""
    mat = np.asarray(mat, np.float64)
    return np.linalg.pinv(mat, rcond=max(mat.shape) * float(np.finfo(np.float32).eps))


def cur_latent(train: np.ndarray, anchors: np.ndarray) -> np.ndarray:
    """(k_i, n) f64 latent item factors U R, U = pinv(R[:, anchors])."""
    train = np.asarray(train, np.float64)
    return pinv_cutoff(train[:, anchors]) @ train


def mips_scores(queries: torch.Tensor, items: torch.Tensor, precision: str = "f32") -> torch.Tensor:
    """(q, n) inner products: f64 for the yardstick, f32 with TF32 off, or
    one TF32 pass (the control)."""
    if precision == "f64":
        return queries.double() @ items.double().T
    with true_f32():
        if precision == "tf32":
            return tf32(queries.float()) @ tf32(items.float()).T
        return queries.float() @ items.float().T


def topk(scores: torch.Tensor, k: int, exclude: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k per row, descending, ties to the smallest id, never an id in
    the row's ``exclude``."""
    scores = scores.clone()
    if exclude is not None:
        scores.scatter_(1, exclude.long(), -torch.inf)
    # a stable sort of the negated scores keeps equal scores in id order
    order = torch.sort(-scores, dim=1, stable=True).indices[:, :k]
    return torch.gather(scores, 1, order), order


def rank_gap(ref_scores: torch.Tensor, chosen: torch.Tensor, k: int, among: Optional[torch.Tensor] = None) -> float:
    """How far a choice of k ids per row falls short of the reference's own
    top k: for each position j, the reference's j-th best score (over
    ``among``'s ids, or every column) less its score of the j-th chosen id
    when the chosen are sorted by the reference; the largest over rows and
    positions, 0 when the choice is the reference's top k."""
    if among is not None:
        pool = torch.gather(ref_scores, 1, among.long())
    else:
        pool = ref_scores
    best = torch.sort(pool, dim=1, descending=True).values[:, :k]
    got = torch.sort(torch.gather(ref_scores, 1, chosen.long()), dim=1, descending=True).values
    return float((best - got).max().clamp_min(0.0))
