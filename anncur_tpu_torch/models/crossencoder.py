"""Cross-encoder: joint (mention ⧺ entity) sequence -> scalar score.

Counterpart of ``anncur_tpu/models/crossencoder.py``. Two heads, parity
with the reference (models/crossencoder.py):

- 'default':  pooled representation -> dropout -> Linear(h, 1),
- 'w_embeds': contextualized embeddings at [unused0/1] (mention,
  averaged) and [unused2] (entity title); score = dot product.

The module holds its parameters in the JAX pytree layout (``bert``,
``score_linear``) as f32 and computes in ``compute_dtype``. ``score``
without ``train`` is the inference path (``torch.no_grad``); with
``train=True`` gradients flow, and dropout applies when a generator is
given (JAX's ``train and rng is not None``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from anncur_tpu_torch.models.bert import (
    BertSpec,
    bert_encode,
    draw_seeds,
    dropout,
    init_bert_params,
    load_params_,
    params_module,
    params_tree,
)
from anncur_tpu_torch.models.pooling import _first_position, pool_sequence
from anncur_tpu_torch.models.special_tokens import (
    ENT_END_ID,
    ENT_START_ID,
    ENT_TITLE_ID,
    NULL_IDX,
)
from anncur_tpu_torch.utils.device import DeviceLike, resolve_device
from anncur_tpu_torch.utils.tracker import TRACER


def to_cross_bert_input(token_ids: torch.Tensor, first_segment_end: int, null_idx: int = NULL_IDX):
    """(token_ids, segment_ids, mask) for a concatenated pair sequence:
    segment 1 starts at ``first_segment_end`` and is flagged only where
    tokens are non-null (reference: models/crossencoder.py:29-48)."""
    mask = token_ids != null_idx
    if first_segment_end > 0:
        pos = torch.arange(token_ids.shape[1], device=token_ids.device)[None, :]
        segment_ids = ((pos >= first_segment_end) & mask).to(token_ids.dtype)
    else:
        segment_ids = torch.zeros_like(token_ids)
    return token_ids * mask.to(token_ids.dtype), segment_ids, mask


def init_crossencoder_params(
    rng: np.random.Generator, spec: BertSpec, cross_enc_type: str = "default"
) -> Dict[str, Any]:
    """Random params in the JAX ``CrossEncoder.init`` layout, from numpy."""
    params: Dict[str, Any] = {"bert": init_bert_params(rng, spec)}
    if cross_enc_type == "default":
        h = spec.hidden_size
        params["score_linear"] = {
            "kernel": rng.standard_normal((h, 1), dtype=np.float32)
            * np.float32(spec.initializer_range),
            "bias": np.zeros((1,), np.float32),
        }
    elif cross_enc_type != "w_embeds":
        raise ValueError(f"cross_enc_type={cross_enc_type!r}")
    return params


class CrossEncoder(nn.Module):
    """Cross-encoder scorer.

    ``params``: a JAX-layout tree with numpy leaves (``models/convert.py``
    builds one from a JAX checkpoint); None draws random weights from
    ``np.random.default_rng(seed)``. The parameters do not require grad
    until a trainer turns them on (``requires_grad_()``). ``remat`` as
    ``anncur_tpu.models.crossencoder.CrossEncoder.remat``: False, True (per
    layer) or 'attn' (the dropout-attention core)."""

    def __init__(
        self,
        spec: BertSpec = BertSpec(),
        cross_enc_type: str = "default",
        pooling_type: str = "cls_w_lin",
        compute_dtype: torch.dtype = torch.bfloat16,
        device: DeviceLike = "cuda",
        params: Optional[Dict[str, Any]] = None,
        seed: int = 0,
        remat=False,
    ):
        super().__init__()
        if cross_enc_type not in ("default", "w_embeds"):
            raise ValueError(f"cross_enc_type={cross_enc_type!r}")
        self.device = resolve_device(device)
        self.spec = spec
        self.cross_enc_type = cross_enc_type
        self.pooling_type = pooling_type
        self.compute_dtype = compute_dtype
        self.remat = remat
        if params is None:
            params = init_crossencoder_params(np.random.default_rng(seed), spec, cross_enc_type)
        self.bert = params_module(params["bert"], self.device)
        if cross_enc_type == "default":
            self.score_linear = params_module(params["score_linear"], self.device)
        self.eval()

    def params_tree(self) -> Dict[str, Any]:
        """The parameters as a JAX-layout tree with f32 numpy leaves."""
        tree: Dict[str, Any] = {"bert": params_tree(self.bert)}
        if self.cross_enc_type == "default":
            tree["score_linear"] = params_tree(self.score_linear)
        return tree

    def load_params_(self, tree: Dict[str, Any]) -> "CrossEncoder":
        """Copy a JAX-layout tree into the parameters, in place."""
        want = {"bert", "score_linear"} if self.cross_enc_type == "default" else {"bert"}
        if set(tree) != want:
            raise ValueError(f"tree keys {sorted(tree)} vs {sorted(want)}")
        load_params_(self.bert, tree["bert"])
        if self.cross_enc_type == "default":
            load_params_(self.score_linear, tree["score_linear"])
        return self

    def _bert(self, token_ids, first_segment_end, cls_only=False, out_positions=None, generator=None):
        token_ids, segment_ids, mask = to_cross_bert_input(token_ids, first_segment_end)
        return bert_encode(
            self.bert, token_ids, segment_ids, mask, self.spec,
            compute_dtype=self.compute_dtype, cls_only=cls_only, out_positions=out_positions,
            generator=generator, dropout_on=generator is not None, remat=self.remat,
        )

    def score(
        self,
        pair_token_ids,
        first_segment_end: int,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Scalar f32 score per pair, shape (b,) (reference: score_candidate
        -> forward, crossencoder.py:450-468). Token ids may be numpy or a
        tensor; they are moved to the module's device.

        ``train=False`` (inference) runs under ``torch.no_grad``. With
        ``train=True`` gradients flow, and a ``generator`` turns on dropout:
        the encoder's, and for the 'default' head a keep-0.9 dropout on the
        pooled embedding (``anncur_tpu/models/crossencoder.py:138-140``).
        Traced as a ``ce.forward`` span."""
        with TRACER.span("ce.forward"):
            if not train:
                with torch.no_grad():
                    return self._score(pair_token_ids, first_segment_end, None)
            return self._score(pair_token_ids, first_segment_end, generator)

    def _score(self, pair_token_ids, first_segment_end, generator):
        pair_token_ids = torch.as_tensor(pair_token_ids, device=self.device)
        if self.cross_enc_type == "default":
            # the final layer runs at CLS only when the head reads CLS (exact)
            cls_only = self.pooling_type in ("cls", "cls_w_lin")
            head_seed = None if generator is None else draw_seeds(generator, 1)[0]
            seq_out, pooled = self._bert(pair_token_ids, first_segment_end, cls_only=cls_only, generator=generator)
            emb = dropout(pool_sequence(seq_out, pooled, self.pooling_type), head_seed, 0.1)
            lin = self.score_linear
            return (emb @ lin["kernel"] + lin["bias"])[:, 0]
        m_emb, e_emb = self._paired(pair_token_ids, first_segment_end, generator)
        return (m_emb * e_emb).sum(-1)

    def _paired(self, pair_token_ids, first_segment_end, generator):
        """w_embeds: (mention, entity) embeddings; the final layer runs only
        at the three tag positions."""
        pos = torch.stack(
            [
                _first_position(pair_token_ids, ENT_START_ID),
                _first_position(pair_token_ids, ENT_END_ID),
                _first_position(pair_token_ids, ENT_TITLE_ID),
            ],
            dim=1,
        )
        seq_out, _ = self._bert(pair_token_ids, first_segment_end, out_positions=pos, generator=generator)
        return (seq_out[:, 0, :] + seq_out[:, 1, :]) / 2.0, seq_out[:, 2, :]

    @torch.no_grad()
    def embed_input(self, token_ids) -> torch.Tensor:
        """Mention-only embedding, (b, h) f32 (reference:
        forward_for_input_embeds, crossencoder.py:127-158): 'w_embeds' is
        the mean of the [unused0]/[unused1] positions, 'default' the
        pooled sequence."""
        token_ids = torch.as_tensor(token_ids, device=self.device)
        if self.cross_enc_type == "w_embeds":
            pos = torch.stack([_first_position(token_ids, ENT_START_ID), _first_position(token_ids, ENT_END_ID)], dim=1)
            seq_out, _ = self._bert(token_ids, 0, out_positions=pos)
            return (seq_out[:, 0, :] + seq_out[:, 1, :]) / 2.0
        return self._pooled(token_ids)

    @torch.no_grad()
    def embed_label(self, token_ids) -> torch.Tensor:
        """Entity-only embedding, (b, h) f32 (reference:
        forward_for_label_embeds, crossencoder.py:161-191): 'w_embeds' is
        the [unused2] position, 'default' the pooled sequence."""
        token_ids = torch.as_tensor(token_ids, device=self.device)
        if self.cross_enc_type == "w_embeds":
            pos = _first_position(token_ids, ENT_TITLE_ID)[:, None]
            seq_out, _ = self._bert(token_ids, 0, out_positions=pos)
            return seq_out[:, 0, :]
        return self._pooled(token_ids)

    def _pooled(self, token_ids):
        cls_only = self.pooling_type in ("cls", "cls_w_lin")
        seq_out, pooled = self._bert(token_ids, 0, cls_only=cls_only)
        return pool_sequence(seq_out, pooled, self.pooling_type)

    @torch.no_grad()
    def embed_paired(self, pair_token_ids, first_segment_end: int):
        """(mention_embed, entity_embed), each (b, h), from one joint forward
        (reference: embed_paired_input_and_labels, crossencoder.py:471-484)."""
        if self.cross_enc_type != "w_embeds":
            raise ValueError("embed_paired requires cross_enc_type='w_embeds'")
        return self._paired(torch.as_tensor(pair_token_ids, device=self.device), first_segment_end, None)
