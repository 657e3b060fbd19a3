"""Weights carried across between the two packages, both ways.

The JAX ``CrossEncoder.init`` / ``train/checkpoint.py`` param pytree
(``bert.embeddings.*``, ``bert.layers[i].attn|mlp.*``, ``bert.pooler.*``,
``score_linear.*``), with numpy leaves, maps one to one onto the port's
module: same keys, same ``(in, out)`` kernel layout.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from anncur_tpu_torch.models.bert import BertSpec
from anncur_tpu_torch.models.crossencoder import CrossEncoder
from anncur_tpu_torch.utils.device import DeviceLike


def _check_tree(tree: Dict[str, Any], spec: BertSpec, cross_enc_type: str) -> None:
    bert = tree["bert"]
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
            f"param tree does not match spec: shapes {got} vs {want}, "
            f"{len(bert['layers'])} layers vs {spec.num_layers}"
        )
    if (cross_enc_type == "default") != ("score_linear" in tree):
        raise ValueError(f"cross_enc_type={cross_enc_type!r} vs tree keys {sorted(tree)}")


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
