"""Bi-encoder: separate or shared query/item BERT towers.

Counterpart of ``anncur_tpu/models/biencoder.py`` (reference
BiEncoderModule, models/biencoder.py:149-280). The module holds its
parameters in the JAX pytree layout (``input_bert``/``label_bert`` or
``bert``, and ``linear`` or ``input_linear``/``label_linear``; kernels
``(in, out)``) as f32 and computes in ``compute_dtype``; every tower
forward goes through ``models/bert.py``, so its attention is kernel A on
the card. For the CLS poolings the last layer runs at CLS only, for
``spl_tkns`` at the tag positions only (exact), forward and backward.
``encode_input``/``encode_label`` serve under ``torch.no_grad``;
:meth:`BiEncoder._encode` carries gradients for the trainer, with
dropout when it is given a generator (kernels C and D run the towers'
attention backward on the card).
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
from anncur_tpu_torch.models.special_tokens import ENT_END_ID, ENT_START_ID, ENT_TITLE_ID, NULL_IDX
from anncur_tpu_torch.utils.device import DeviceLike, resolve_device, true_f32

# the param tree's towers and linear heads, by bi_enc_type (one head when
# shared, as the reference's single additional_linear)
TOWERS = {"separate": ("input_bert", "label_bert"), "shared": ("bert",)}
HEADS = {"separate": ("input_linear", "label_linear"), "shared": ("linear",)}


def to_bert_input(token_ids: torch.Tensor, null_idx: int = NULL_IDX):
    """(token_ids, segment_ids, mask) for single-segment input
    (reference: models/biencoder.py:26-39)."""
    mask = token_ids != null_idx
    return token_ids * mask.to(token_ids.dtype), torch.zeros_like(token_ids), mask


def init_biencoder_params(
    rng: np.random.Generator,
    spec: BertSpec,
    bi_enc_type: str = "separate",
    add_linear_layer: bool = False,
    embed_dim: int = 768,
) -> Dict[str, Any]:
    """Random params in the JAX ``BiEncoder.init`` layout, from numpy: one
    BERT per tower, and one projection head when shared (the reference's
    single additional_linear), two when separate."""
    if bi_enc_type not in TOWERS:
        raise ValueError(f"bi_enc_type={bi_enc_type!r}")
    params: Dict[str, Any] = {name: init_bert_params(rng, spec) for name in TOWERS[bi_enc_type]}
    if add_linear_layer:
        std = np.float32(spec.initializer_range)
        for name in HEADS[bi_enc_type]:
            params[name] = {
                "kernel": rng.standard_normal((spec.hidden_size, embed_dim), dtype=np.float32) * std,
                "bias": np.zeros((embed_dim,), np.float32),
            }
    return params


class BiEncoder(nn.Module):
    """Bi-encoder scorer.

    ``bi_enc_type``: 'separate' (two towers) or 'shared' (one);
    ``pooling_type``: cls_w_lin | cls | mean | max | lse | spl_tkns;
    ``add_linear_layer``: a Linear(hidden -> embed_dim) after pooling.
    ``params``: a JAX-layout tree with numpy leaves (``models/convert.py``
    builds one from a JAX checkpoint); None draws random weights from
    ``np.random.default_rng(seed)``. Each tree key is a submodule of that
    name, so ``named_parameters`` gives the JAX paths. The parameters do
    not require grad until a trainer turns them on (``requires_grad_()``).
    ``remat`` as the CrossEncoder's: False, True (per layer) or 'attn'."""

    def __init__(
        self,
        spec: BertSpec = BertSpec(),
        pooling_type: str = "cls_w_lin",
        bi_enc_type: str = "separate",
        embed_dim: int = 768,
        add_linear_layer: bool = False,
        compute_dtype: torch.dtype = torch.bfloat16,
        device: DeviceLike = "cuda",
        params: Optional[Dict[str, Any]] = None,
        seed: int = 0,
        remat=False,
    ):
        super().__init__()
        if bi_enc_type not in TOWERS:
            raise ValueError(f"bi_enc_type={bi_enc_type!r}")
        if not add_linear_layer and embed_dim != spec.hidden_size:
            raise ValueError(
                "embed_dim must equal hidden_size unless add_linear_layer=True "
                f"({embed_dim} != {spec.hidden_size})"
            )
        self.device = resolve_device(device)
        self.spec = spec
        self.pooling_type = pooling_type
        self.bi_enc_type = bi_enc_type
        self.embed_dim = embed_dim
        self.add_linear_layer = add_linear_layer
        self.compute_dtype = compute_dtype
        self.remat = remat
        if params is None:
            params = init_biencoder_params(np.random.default_rng(seed), spec, bi_enc_type, add_linear_layer, embed_dim)
        self._check_keys(params)
        for name in self.tree_keys:
            self.add_module(name, params_module(params[name], self.device))
        self.eval()

    @property
    def tree_keys(self):
        """The param tree's top-level keys: towers, then heads."""
        return TOWERS[self.bi_enc_type] + (HEADS[self.bi_enc_type] if self.add_linear_layer else ())

    def _check_keys(self, tree) -> None:
        if set(tree) != set(self.tree_keys):
            raise ValueError(f"tree keys {sorted(tree)} vs {sorted(self.tree_keys)}")

    def params_tree(self) -> Dict[str, Any]:
        """The parameters as a JAX-layout tree with f32 numpy leaves."""
        return {name: params_tree(getattr(self, name)) for name in self.tree_keys}

    def load_params_(self, tree: Dict[str, Any]) -> "BiEncoder":
        """Copy a JAX-layout tree into the parameters, in place."""
        self._check_keys(tree)
        for name in self.tree_keys:
            load_params_(getattr(self, name), tree[name])
        return self

    def _encode(
        self, token_ids, which: str, train: bool = False, generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        """(b, embed_dim) f32 embeddings by the ``which`` ('input' or
        'label') tower; gradients flow as the caller's grad mode says.
        ``train`` with a ``generator`` turns on dropout: the encoder's, and
        with a linear head a keep-0.9 dropout on the pooled embedding
        before it (``anncur_tpu/models/biencoder.py:158-160``); its seed is
        drawn before the encoder's."""
        token_ids = torch.as_tensor(token_ids, device=self.device)
        if not train:
            generator = None
        token_ids, segment_ids, mask = to_bert_input(token_ids)
        shared = self.bi_enc_type == "shared"
        out_positions = None
        if self.pooling_type == "spl_tkns":
            if which == "input":
                out_positions = torch.stack(
                    [_first_position(token_ids, ENT_START_ID), _first_position(token_ids, ENT_END_ID)], dim=1
                )
            else:
                out_positions = _first_position(token_ids, ENT_TITLE_ID)[:, None]
        tower = getattr(self, "bert" if shared else f"{which}_bert")
        head_seed = draw_seeds(generator, 1)[0] if generator is not None and self.add_linear_layer else None
        seq_out, pooled = bert_encode(
            tower, token_ids, segment_ids, mask, self.spec, compute_dtype=self.compute_dtype,
            cls_only=self.pooling_type in ("cls", "cls_w_lin"), out_positions=out_positions,
            generator=generator, dropout_on=generator is not None, remat=self.remat,
        )
        if self.pooling_type == "spl_tkns":
            # special-token towers (reference: models/biencoder.py:165-173)
            emb = (seq_out[:, 0, :] + seq_out[:, 1, :]) / 2.0 if which == "input" else seq_out[:, 0, :]
        else:
            emb = pool_sequence(seq_out, pooled, self.pooling_type)
        if self.add_linear_layer:
            lin = getattr(self, "linear" if shared else f"{which}_linear")
            emb = dropout(emb, head_seed, 0.1)
            with true_f32():
                emb = emb @ lin["kernel"] + lin["bias"]
        return emb

    @torch.no_grad()
    def encode_input(self, token_ids) -> torch.Tensor:
        """(b, embed_dim) f32 embeddings of queries/mentions on the module's
        device (reference: encode_input, biencoder.py:412-421). Token ids
        may be numpy or a tensor."""
        return self._encode(token_ids, "input")

    @torch.no_grad()
    def encode_label(self, token_ids) -> torch.Tensor:
        """(b, embed_dim) f32 embeddings of items/entities."""
        return self._encode(token_ids, "label")

    @staticmethod
    def score_labels(input_embeds: torch.Tensor, label_embeds: torch.Tensor) -> torch.Tensor:
        """All-pairs inner-product scores (q, n) in true f32 (TF32 off)
        (reference: score_labels, models/biencoder.py:436-463)."""
        with true_f32():
            return input_embeds.float() @ label_embeds.float().T

    @staticmethod
    def score_paired(input_embeds: torch.Tensor, label_embeds: torch.Tensor) -> torch.Tensor:
        """Row-wise scores for aligned (q_i, item_i) pairs."""
        return (input_embeds * label_embeds).sum(-1)
