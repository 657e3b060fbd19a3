"""Config system: typed dataclass + JSON file + CLI overrides.

A copy of ``anncur_tpu/config.py`` without JAX: the same fields, so the
same JSON files load, the same CLI parser and the same ``result_dir``.

- fields are declared once as a typed ``dataclass`` (not mutated ad-hoc),
- randomness flows through an explicit ``torch.Generator`` seeded from
  ``seed`` (:meth:`Config.prng_key`), not a global framework seed; numpy's
  host-side RNG is seeded only for host-side sampling utilities,
- a ``result_dir`` naming scheme encodes data/model/loss/neg-strategy/seed
  exactly like the reference's (utils/config.py:202-216) so downstream
  aggregation tools can glob results the same way.

``mesh_shape``, ``mesh_axis_names`` and ``num_devices`` are read by the
train CLI: the mesh of ranks it trains over (``cli/train.py``). The
field that names JAX machinery, ``rng_impl``, is kept so the files load;
the port does not read it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import warnings
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import torch


def _json_safe(value: Any) -> bool:
    return isinstance(value, (str, float, int, list, bool, dict)) or value is None


# bool-defaulted fields that additionally accept mode strings on the CLI
_BOOL_MODE_FLAGS = {"use_remat": ("attn",)}


def _bool_flag(modes: tuple = ()):
    """CLI parser factory for bool-defaulted fields. Canonical
    true/false spellings map to bool; fields listed in _BOOL_MODE_FLAGS
    also accept their mode strings (e.g. --use_remat attn). Anything
    else is an argparse error — silently passing unknown strings
    through would make truthy typos ('off', 'atn') flip behavior."""

    def parse(s: str):
        low = s.lower()
        if low in ("1", "true", "yes"):
            return True
        if low in ("0", "false", "no"):
            return False
        if s in modes:
            return s
        allowed = "true/false" + (f" or one of {sorted(modes)}" if modes else "")
        raise argparse.ArgumentTypeError(f"expected {allowed}, got {s!r}")

    return parse


@dataclass
class Config:
    """All knobs for training / indexing / eval runs.

    Field names intentionally mirror the reference (utils/config.py:82-170)
    so its JSON config files load unchanged.
    """

    config_name: Optional[str] = None

    # bookkeeping
    save_code: bool = True
    base_res_dir: str = "results"
    exp_id: str = ""
    res_dir_prefix: str = ""
    misc: str = ""

    seed: int = 1234
    n_procs: int = 20

    max_time: str = "06:23:55:00"
    fast_dev_run: int = 0

    print_interval: int = 10
    eval_interval: float = 800.0

    # data
    data_type: str = "dummy"
    data_dir: str = "None"
    trn_files: Dict[str, Any] = field(default_factory=dict)
    dev_files: Dict[str, Any] = field(default_factory=dict)
    train_domains: List[str] = field(default_factory=lambda: ["dummy"])
    dev_domains: List[str] = field(default_factory=lambda: ["dummy"])
    mention_file_template: str = ""
    entity_file_template: str = ""
    entity_token_file_template: str = ""

    mode: str = "train"
    debug_w_small_data: int = 0

    # model / optimization
    num_devices: int = 0  # JAX package: 0 => use all local devices
    mesh_shape: List[int] = field(default_factory=list)  # e.g. [8] or [4, 2]
    mesh_axis_names: List[str] = field(default_factory=lambda: ["data"])
    type_optimization: str = ""
    learning_rate: float = 1e-5
    weight_decay: float = 0.01
    use_bf16: bool = True  # bf16 compute (reference: fp16 flag)
    # rematerialize in backprop: False | True (full per-layer) | "attn"
    # (selective: recompute only the O(seq^2) attention tensors — see
    # models/bert.py; pass --use_remat attn on the CLI)
    use_remat: bool = False
    # the JAX package's PRNG implementation ("rbg" | "threefry"); kept so
    # the same JSON files load, and selects nothing here: the port's
    # randomness is a torch.Generator (Philox on the card)
    rng_impl: str = "rbg"

    ckpt_path: str = ""
    model_type: str = ""  # bi_enc | cross_enc
    cross_enc_type: str = "default"  # default | w_embeds
    bi_enc_type: str = "separate"  # separate | shared
    bert_model: str = "bert-base-uncased"
    bert_args: Dict[str, Any] = field(default_factory=dict)
    lowercase: bool = True
    shuffle_data: bool = True
    path_to_model: str = ""
    encoder_wrapper_config: str = ""

    num_epochs: int = 4
    warmup_proportion: float = 0.01
    train_batch_size: int = 16
    grad_acc_steps: int = 4
    max_grad_norm: float = 1.0
    loss_type: str = "ce"  # ce | bce | hinge | hinge_sq
    hinge_margin: float = 0.5
    reload_dataloaders_every_n_epochs: int = 0
    ckpt_metric: str = "loss"  # loss | mrr
    num_top_k_ckpts: int = 2

    neg_strategy: str = "dummy"
    num_negs: int = 63
    neg_mine_bienc_model_file: str = ""

    # distillation
    ent_w_score_file_template: str = ""
    train_ent_w_score_file_template: str = ""
    dev_ent_w_score_file_template: str = ""
    distill_n_labels: int = 64

    # encoder shape params
    embed_dim: int = 768
    pooling_type: str = ""
    add_linear_layer: bool = False
    max_input_len: int = 128
    max_label_len: int = 128

    # eval
    eval_batch_size: int = 64

    # ------------------------------------------------------------------ #

    @classmethod
    def from_json(cls, filename: str) -> "Config":
        cfg = cls(config_name=filename)
        with open(filename) as fin:
            params = json.load(fin)
        cfg.update_from_dict(params, warn_extra=True)
        return cfg

    def update_from_dict(self, params: Dict[str, Any], warn_extra: bool = False) -> None:
        names = {f.name for f in dataclasses.fields(self)}
        extra = {k: v for k, v in params.items() if k not in names}
        for k, v in params.items():
            if k in names:
                setattr(self, k, v)
        if extra and warn_extra:
            warnings.warn(f"Ignoring unknown config keys: {sorted(extra)}")

    def to_dict(self) -> Dict[str, Any]:
        return {k: v for k, v in dataclasses.asdict(self).items() if _json_safe(v)}

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=4, sort_keys=True)

    def save_config(self, res_dir: str, filename: str = "config.json") -> str:
        os.makedirs(res_dir, exist_ok=True)
        fname = os.path.join(res_dir, filename)
        with open(fname, "w") as fout:
            fout.write(self.to_json())
        return fname

    # ------------------------------------------------------------------ #

    @staticmethod
    def get_parser_for_args() -> argparse.ArgumentParser:
        """Auto-generate one CLI flag per config field (reference parity:
        utils/config.py:38-62)."""
        parser = argparse.ArgumentParser(description="Config overrides", allow_abbrev=False)
        dummy = Config()
        for f in dataclasses.fields(dummy):
            default = getattr(dummy, f.name)
            if isinstance(default, bool):
                parser.add_argument(
                    f"--{f.name}",
                    type=_bool_flag(_BOOL_MODE_FLAGS.get(f.name, ())),
                    default=None,
                )
            elif isinstance(default, (list, tuple)):
                if len(default):
                    elem_t = type(default[0])
                else:
                    # empty default (e.g. mesh_shape): element type comes
                    # from the List[...] annotation, not the (absent)
                    # first element — plain str broke the int contract
                    ann = str(f.type)
                    elem_t = int if "int" in ann else (float if "float" in ann else str)
                parser.add_argument(f"--{f.name}", nargs="+", type=elem_t, default=None)
            elif isinstance(default, dict):
                parser.add_argument(f"--{f.name}", type=json.loads, default=None)
            else:
                arg_t = type(default) if default is not None else str
                parser.add_argument(f"--{f.name}", type=arg_t, default=None)
        return parser

    def update_config_from_arg_list(self, arg_list: List[str]) -> None:
        args = Config.get_parser_for_args().parse_args(arg_list)
        for f in dataclasses.fields(self):
            val = getattr(args, f.name, None)
            if val is not None:
                setattr(self, f.name, val)

    # ------------------------------------------------------------------ #

    @property
    def result_dir(self) -> str:
        base = f"{self.base_res_dir}/{self.exp_id}" if self.exp_id else self.base_res_dir
        misc = f"_{self.misc}" if self.misc else ""
        return (
            f"{base}/d={self.data_type}/{self.res_dir_prefix}"
            f"m={self.model_type}_l={self.loss_type}_neg={self.neg_strategy}"
            f"_s={self.seed}{misc}"
        )

    @property
    def model_dir(self) -> str:
        return os.path.join(self.result_dir, "model")

    def prng_key(self, device: Any = "cpu") -> torch.Generator:
        """Root generator of this run on ``device``, seeded with ``seed``;
        draw per-purpose seeds off it. ``rng_impl`` does not enter: the
        JAX package's key streams and this generator's differ anyway."""
        return torch.Generator(device=device).manual_seed(self.seed)

    def seed_host_rngs(self) -> None:
        """Seed host-side numpy/python RNGs (sampling anchors, shuffles)."""
        import random as _random

        import numpy as np

        _random.seed(self.seed)
        np.random.seed(_random.randint(0, 2**31 - 1))
