"""Weights carried across between the two packages, both ways.

The JAX ``CrossEncoder.init`` / ``train/checkpoint.py`` param pytree
(``bert.embeddings.*``, ``bert.layers[i].attn|mlp.*``, ``bert.pooler.*``,
``score_linear.*``) and the JAX ``BiEncoder.init`` one (``input_bert`` and
``label_bert`` or ``bert``, then ``input_linear`` and ``label_linear`` or
``linear``), with numpy leaves, map one to one onto the port's modules:
same keys, same ``(in, out)`` kernel layout.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from anncur_tpu_torch.models.bert import BertSpec
from anncur_tpu_torch.models.biencoder import HEADS, TOWERS, BiEncoder
from anncur_tpu_torch.models.crossencoder import CrossEncoder
from anncur_tpu_torch.utils.device import DeviceLike


def _check_bert(bert: Dict[str, Any], spec: BertSpec, where: str = "bert") -> None:
    h = spec.hidden_size
    want = {
        "embeddings.word": (spec.vocab_size, h),
        "embeddings.position": (spec.max_position_embeddings, h),
        "pooler.kernel": (h, h),
    }
    got = {
        "embeddings.word": np.shape(bert["embeddings"]["word"]),
        "embeddings.position": np.shape(bert["embeddings"]["position"]),
        "pooler.kernel": np.shape(bert["pooler"]["kernel"]),
    }
    if got != want or len(bert["layers"]) != spec.num_layers:
        raise ValueError(
            f"param tree does not match spec at {where}: shapes {got} vs {want}, "
            f"{len(bert['layers'])} layers vs {spec.num_layers}"
        )


def _check_tree(tree: Dict[str, Any], spec: BertSpec, cross_enc_type: str) -> None:
    _check_bert(tree["bert"], spec)
    if (cross_enc_type == "default") != ("score_linear" in tree):
        raise ValueError(f"cross_enc_type={cross_enc_type!r} vs tree keys {sorted(tree)}")


def _check_biencoder_tree(tree: Dict[str, Any], spec: BertSpec, bi_enc_type: str, embed_dim: int) -> None:
    towers, heads = TOWERS.get(bi_enc_type, ()), HEADS.get(bi_enc_type, ())
    keys = set(tree)
    if not towers or not set(towers) <= keys or keys - set(towers) not in (set(), set(heads)):
        raise ValueError(f"bi_enc_type={bi_enc_type!r} vs tree keys {sorted(tree)}")
    for name in towers:
        _check_bert(tree[name], spec, name)
    for name in sorted(keys - set(towers)):
        want = ((spec.hidden_size, embed_dim), (embed_dim,))
        got = (np.shape(tree[name]["kernel"]), np.shape(tree[name]["bias"]))
        if got != want:
            raise ValueError(f"param tree does not match at {name}: shapes {got} vs {want}")


def crossencoder_from_jax_params(
    tree: Dict[str, Any],
    spec: BertSpec,
    cross_enc_type: str = "default",
    device: DeviceLike = "cuda",
    dtype: torch.dtype = torch.bfloat16,
    pooling_type: str = "cls_w_lin",
) -> CrossEncoder:
    """The port's CrossEncoder holding the weights of a JAX param tree
    (numpy leaves; ``np.asarray`` is applied to each), computing in
    ``dtype`` on ``device``."""
    _check_tree(tree, spec, cross_enc_type)
    return CrossEncoder(
        spec=spec,
        cross_enc_type=cross_enc_type,
        pooling_type=pooling_type,
        compute_dtype=dtype,
        device=device,
        params=tree,
    )


def crossencoder_to_jax_params(ce: CrossEncoder) -> Dict[str, Any]:
    """The port's CrossEncoder parameters as a JAX-layout param tree with
    f32 numpy leaves: ``anncur_tpu``'s ``CrossEncoder.score`` takes it as
    ``params`` (after ``jnp.asarray``), and ``train/checkpoint.py`` saves it
    as a checkpoint's ``params``."""
    tree = ce.params_tree()
    _check_tree(tree, ce.spec, ce.cross_enc_type)
    return tree


def biencoder_from_jax_params(
    tree: Dict[str, Any],
    spec: BertSpec,
    pooling_type: str = "cls_w_lin",
    bi_enc_type: str = "separate",
    embed_dim: int = 768,
    device: DeviceLike = "cuda",
    dtype: torch.dtype = torch.bfloat16,
) -> BiEncoder:
    """The port's BiEncoder holding the weights of a JAX ``BiEncoder`` param
    tree (numpy leaves), computing in ``dtype`` on ``device``; the linear
    heads are taken when the tree has them (``add_linear_layer``)."""
    _check_biencoder_tree(tree, spec, bi_enc_type, embed_dim)
    return BiEncoder(
        spec=spec, pooling_type=pooling_type, bi_enc_type=bi_enc_type, embed_dim=embed_dim,
        add_linear_layer=bool(set(tree) - set(TOWERS[bi_enc_type])), compute_dtype=dtype, device=device,
        params=tree,
    )


def biencoder_to_jax_params(be: BiEncoder) -> Dict[str, Any]:
    """The port's BiEncoder parameters as a JAX ``BiEncoder`` param tree
    with f32 numpy leaves (``jnp.asarray`` of it is ``params`` there)."""
    tree = be.params_tree()
    _check_biencoder_tree(tree, be.spec, be.bi_enc_type, be.embed_dim)
    return tree
