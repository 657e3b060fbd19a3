"""Import HuggingFace BERT checkpoints and reference Lightning ``.ckpt``
files into the port's modules, from local files only.

Counterpart of ``anncur_tpu/models/hf_loader.py``. A ``transformers``
BertModel state dict (torch tensors, or a saved ``pytorch_model.bin``)
maps onto the JAX-layout param tree with f32 numpy leaves, which
``load_params_`` of ``CrossEncoder``/``BiEncoder`` and
``models/convert.py`` take. ``nn.Linear`` stores (out, in) weights; the
tree keeps (in, out) kernels, transposed here once at load time. Nothing
here imports ``transformers``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from anncur_tpu_torch.models.bert import BertParams, BertSpec


def _to_np(t) -> np.ndarray:
    if torch.is_tensor(t):
        t = t.detach().float().cpu().numpy()
    return np.ascontiguousarray(t, dtype=np.float32)


def bert_params_from_state_dict(
    state_dict: Mapping[str, Any],
    spec: BertSpec,
    prefix: str = "",
) -> BertParams:
    """An HF BertModel state dict as the JAX-layout params tree.

    ``prefix``: key prefix to strip (e.g. 'bert.' for BertForX heads, or
    'model.input_encoder.bert_model.' for reference Lightning checkpoints,
    reference models/biencoder.py:386-409)."""
    sd = {k[len(prefix):]: v for k, v in state_dict.items() if k.startswith(prefix)}

    def get(name: str, transpose: bool = False) -> np.ndarray:
        arr = _to_np(sd[name])
        return np.ascontiguousarray(arr.T) if transpose else arr

    params: BertParams = {
        "embeddings": {
            "word": get("embeddings.word_embeddings.weight"),
            "position": get("embeddings.position_embeddings.weight"),
            "token_type": get("embeddings.token_type_embeddings.weight"),
            "ln_scale": get("embeddings.LayerNorm.weight"),
            "ln_bias": get("embeddings.LayerNorm.bias"),
        },
        "layers": [],
        "pooler": {
            "kernel": get("pooler.dense.weight", transpose=True),
            "bias": get("pooler.dense.bias"),
        },
    }
    for li in range(spec.num_layers):
        p = f"encoder.layer.{li}."
        params["layers"].append(
            {
                "attn": {
                    "q_kernel": get(p + "attention.self.query.weight", True),
                    "q_bias": get(p + "attention.self.query.bias"),
                    "k_kernel": get(p + "attention.self.key.weight", True),
                    "k_bias": get(p + "attention.self.key.bias"),
                    "v_kernel": get(p + "attention.self.value.weight", True),
                    "v_bias": get(p + "attention.self.value.bias"),
                    "out_kernel": get(p + "attention.output.dense.weight", True),
                    "out_bias": get(p + "attention.output.dense.bias"),
                    "ln_scale": get(p + "attention.output.LayerNorm.weight"),
                    "ln_bias": get(p + "attention.output.LayerNorm.bias"),
                },
                "mlp": {
                    "in_kernel": get(p + "intermediate.dense.weight", True),
                    "in_bias": get(p + "intermediate.dense.bias"),
                    "out_kernel": get(p + "output.dense.weight", True),
                    "out_bias": get(p + "output.dense.bias"),
                    "ln_scale": get(p + "output.LayerNorm.weight"),
                    "ln_bias": get(p + "output.LayerNorm.bias"),
                },
            }
        )
    return params


def spec_from_hf_config(config) -> BertSpec:
    """BertSpec from a transformers BertConfig or a plain config dict (the
    one place that maps HF field names)."""
    if isinstance(config, dict):
        def get(k, d=None):
            return config.get(k, d)
    else:
        def get(k, d=None):
            return getattr(config, k, d)
    required = ("vocab_size", "hidden_size", "num_hidden_layers", "num_attention_heads", "intermediate_size")
    missing = [k for k in required if get(k) is None]
    if missing:
        raise ValueError(f"HF config is missing required fields: {missing}")
    return BertSpec(
        vocab_size=get("vocab_size"),
        hidden_size=get("hidden_size"),
        num_layers=get("num_hidden_layers"),
        num_heads=get("num_attention_heads"),
        intermediate_size=get("intermediate_size"),
        max_position_embeddings=get("max_position_embeddings", 512),
        type_vocab_size=get("type_vocab_size", 2),
        layer_norm_eps=get("layer_norm_eps", 1e-12),
        initializer_range=get("initializer_range", 0.02),
        # fine-tuning an imported checkpoint honours its own dropout
        hidden_dropout=get("hidden_dropout_prob", 0.1),
        attention_dropout=get("attention_probs_dropout_prob", 0.1),
    )


def _linear_params(sd: Mapping[str, Any], prefix: str) -> Dict[str, np.ndarray]:
    return {
        "kernel": np.ascontiguousarray(_to_np(sd[prefix + "weight"]).T),
        "bias": _to_np(sd[prefix + "bias"]),
    }


def biencoder_params_from_lightning(
    state_dict: Mapping[str, Any],
    spec: BertSpec,
    bi_enc_type: str = "separate",
    add_linear_layer: bool = False,
) -> Dict[str, Any]:
    """A reference BiEncoderWrapper checkpoint's state dict (layout of
    models/biencoder.py:149-214, prefixes :386-409; pass
    ``ckpt['state_dict']``) as the BiEncoder param tree."""
    params: Dict[str, Any] = {}
    if bi_enc_type == "separate":
        params["input_bert"] = bert_params_from_state_dict(state_dict, spec, prefix="model.input_encoder.bert_model.")
        params["label_bert"] = bert_params_from_state_dict(state_dict, spec, prefix="model.label_encoder.bert_model.")
        if add_linear_layer:
            params["input_linear"] = _linear_params(state_dict, "model.input_encoder.additional_linear.")
            params["label_linear"] = _linear_params(state_dict, "model.label_encoder.additional_linear.")
    elif bi_enc_type == "shared":
        params["bert"] = bert_params_from_state_dict(state_dict, spec, prefix="model.encoder.bert_model.")
        if add_linear_layer:
            params["linear"] = _linear_params(state_dict, "model.encoder.additional_linear.")
    else:
        raise ValueError(f"bi_enc_type={bi_enc_type!r}")
    return params


def crossencoder_params_from_lightning(
    state_dict: Mapping[str, Any],
    spec: BertSpec,
    cross_enc_type: str = "default",
) -> Dict[str, Any]:
    """A reference CrossEncoderWrapper checkpoint's state dict
    (models/crossencoder.py:218-242, prefixes :397-420) as the
    CrossEncoder param tree."""
    params: Dict[str, Any] = {
        "bert": bert_params_from_state_dict(state_dict, spec, prefix="model.encoder.bert_model.")
    }
    if cross_enc_type == "default":
        params["score_linear"] = _linear_params(state_dict, "model.encoder.additional_linear.")
    return params


def load_lightning_checkpoint(path: str) -> Mapping[str, Any]:
    """The state dict of a Lightning ``.ckpt`` (or of a bare state-dict
    file). The file is unpickled in full: load only checkpoints you
    trust."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    return ckpt.get("state_dict", ckpt)


def load_bert_from_pretrained_dir(model_dir: str) -> Tuple[BertSpec, BertParams, Optional[str]]:
    """(spec, params, vocab_path) from a local HF-format directory holding
    config.json, pytorch_model.bin (or model.pt / model.torch) and
    vocab.txt."""
    with open(os.path.join(model_dir, "config.json")) as fin:
        cfg = json.load(fin)
    spec = spec_from_hf_config(cfg)
    for name in ("pytorch_model.bin", "model.pt", "model.torch"):
        path = os.path.join(model_dir, name)
        if os.path.exists(path):
            sd = torch.load(path, map_location="cpu", weights_only=True)
            break
    else:
        raise FileNotFoundError(f"no torch checkpoint in {model_dir}")
    prefix = "bert." if any(k.startswith("bert.") for k in sd) else ""
    params = bert_params_from_state_dict(sd, spec, prefix=prefix)
    vocab_path = os.path.join(model_dir, "vocab.txt")
    return spec, params, (vocab_path if os.path.exists(vocab_path) else None)
