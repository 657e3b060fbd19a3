"""Training entry point.

Counterpart of ``anncur_tpu/cli/train.py`` (parity with reference
models/train.py:22-68):
``python -m anncur_tpu_torch.cli.train --config cfg.json [--any_config_field v] [--device cpu]``
creates the result dir, snapshots config + command line and dispatches
to the port's Trainer for bi- or cross-encoder training over a mesh of
every rank, as the JAX CLI trains on ``default_mesh()``. In a plain
process that is one rank; under ``torchrun --nproc_per_node N -m
anncur_tpu_torch.cli.train ...`` it is N ranks (``parallel/multihost.py::
init_distributed``), laid out by ``mesh_shape`` / ``mesh_axis_names``
(default: 1-D ``data``), with the towers tensor-parallel over a ``model``
axis where there is one; ``num_devices``, when set, must equal the number
of ranks. Rank 0 alone writes the config, the code snapshot, the tracker's
files and the checkpoints. ``--device`` (default ``cuda``) is the one flag
beside the config's fields.

One addition to the JAX CLI: ``bert_args`` may carry the HF config's
``attention_probs_dropout_prob`` (the JAX CLI reads only ``vocab_file``
there, and trains with an attention dropout of 0.1). With an attention
dropout of 0 the attention runs through kernels A, C and D on the card;
with dropout it runs the plain dropout-attention. The hidden dropout
stays at the JAX CLI's 0.1.
"""

from __future__ import annotations

import logging
import os
import shutil
import sys
import time

import numpy as np
import torch

from anncur_tpu_torch.config import Config
from anncur_tpu_torch.data import load_entities, load_mentions, tokenize_entities, tokenize_mentions
from anncur_tpu_torch.indexer.score_matrix import load_score_matrix
from anncur_tpu_torch.models.bert import BertSpec
from anncur_tpu_torch.models.biencoder import BiEncoder
from anncur_tpu_torch.models.crossencoder import CrossEncoder
from anncur_tpu_torch.models.tokenizer import WordPieceTokenizer
from anncur_tpu_torch.parallel.mesh import make_mesh, mesh_session
from anncur_tpu_torch.parallel.multihost import world
from anncur_tpu_torch.train.data import EntLinkDataset, merge_worlds
from anncur_tpu_torch.train.trainer import Trainer
from anncur_tpu_torch.utils import ExperimentTracker
from anncur_tpu_torch.utils.device import DeviceLike, resolve_device

LOGGER = logging.getLogger("anncur_tpu_torch.train")


def save_code_snapshot(result_dir: str) -> None:
    """Snapshot the package source into result_dir/code
    (reference: utils/basic_utils.py:8-16)."""
    src = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    dst = os.path.join(result_dir, "code", "anncur_tpu_torch")
    if os.path.exists(dst):
        shutil.rmtree(dst)
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns("__pycache__", "build"))
    with open(os.path.join(result_dir, "command.txt"), "w") as fout:
        fout.write(" ".join(sys.argv) + "\n")


def load_world_dataset(cfg: Config, files, tokenizer: WordPieceTokenizer) -> EntLinkDataset:
    if isinstance(files, (list, tuple)):
        # reference config format: [ment_file, ent_file, ent_tokens_file]
        files = dict(zip(("ment_file", "ent_file", "ent_tokens_file"), files))
    kb2local, entities = load_entities(files["ent_file"])
    mentions = load_mentions(files["ment_file"], kb2local)
    if cfg.debug_w_small_data:
        mentions = mentions[:100]
    ment_toks = tokenize_mentions(mentions, tokenizer, cfg.max_input_len)
    if files.get("ent_tokens_file") and os.path.exists(files["ent_tokens_file"]):
        ent_toks = np.load(files["ent_tokens_file"]).astype(np.int32)
    else:
        ent_toks = tokenize_entities(entities, tokenizer, cfg.max_label_len)
    return EntLinkDataset(
        mention_tokens=ment_toks,
        entity_tokens=ent_toks,
        gt_labels=np.asarray([m["label_id"] for m in mentions], np.int32),
        mention_texts=[m["mention"] for m in mentions],
        entities=entities,
    )


def load_distill_dataset(cfg: Config, domain: str, score_template: str) -> EntLinkDataset:
    """Dataset from a precomputed teacher score-matrix pickle: mention
    tokens + teacher scores from the pickle, entity tokens from the
    token-file template."""
    data = load_score_matrix(score_template.format(domain))
    ent_toks = np.load(cfg.entity_token_file_template.format(domain)).astype(np.int32)
    scores = np.asarray(data["ment_to_ent_scores"], np.float32)
    return EntLinkDataset(
        mention_tokens=np.asarray(data["mention_tokens_list"], np.int32),
        entity_tokens=ent_toks,
        gt_labels=np.argmax(scores, axis=1).astype(np.int64),
        score_matrix=scores,
    )


def build_model(cfg: Config, vocab_size: int, device: DeviceLike = "cuda"):
    """bert-base towers or CE with the port's seeded random weights
    (``cfg.seed``); the attention dropout from ``bert_args`` where given."""
    args = cfg.bert_args or {}
    spec = BertSpec(vocab_size=vocab_size, attention_dropout=args.get("attention_probs_dropout_prob", 0.1))
    dtype = torch.bfloat16 if cfg.use_bf16 else torch.float32
    if cfg.model_type == "bi_enc":
        return BiEncoder(
            spec=spec,
            pooling_type=cfg.pooling_type or "cls_w_lin",
            bi_enc_type=cfg.bi_enc_type,
            embed_dim=cfg.embed_dim,
            add_linear_layer=cfg.add_linear_layer,
            compute_dtype=dtype,
            device=device,
            seed=cfg.seed,
            remat=cfg.use_remat,
        )
    if cfg.model_type == "cross_enc":
        return CrossEncoder(
            spec=spec,
            cross_enc_type=cfg.cross_enc_type,
            pooling_type=cfg.pooling_type or "cls_w_lin",
            compute_dtype=dtype,
            device=device,
            seed=cfg.seed,
            remat=cfg.use_remat,
        )
    raise ValueError(f"model_type={cfg.model_type!r}")


def _pop_flag(arg_list, flag: str, default=None):
    """The value of ``flag`` taken out of ``arg_list`` (in place)."""
    if flag not in arg_list:
        return default
    i = arg_list.index(flag)
    value = arg_list[i + 1]
    del arg_list[i : i + 2]
    return value


def main(arg_list=None):
    arg_list = list(sys.argv[1:] if arg_list is None else arg_list)
    logging.basicConfig(level=logging.INFO)
    config_file = _pop_flag(arg_list, "--config")
    try:
        device = resolve_device(_pop_flag(arg_list, "--device", "cuda"))
    except RuntimeError as err:
        raise SystemExit(str(err)) from err
    cfg = Config.from_json(config_file) if config_file else Config()
    cfg.update_config_from_arg_list(arg_list)
    with mesh_session(device) as mesh:
        _train(cfg, mesh, device)


def _mesh_of(cfg: Config, mesh, device):
    """The training mesh: ``mesh_shape`` over ``mesh_axis_names``, else the
    1-D mesh over every rank; and the tensor-parallel axis, if any."""
    n_ranks = mesh.size
    if cfg.num_devices > 0 and cfg.num_devices != n_ranks:
        raise ValueError(
            f"num_devices={cfg.num_devices} needs {cfg.num_devices} ranks, have {n_ranks} "
            f"(run under torchrun --nproc_per_node {cfg.num_devices})"
        )
    if cfg.mesh_shape:
        mesh = make_mesh(cfg.mesh_shape, cfg.mesh_axis_names, device)
    tp_axis = "model" if mesh.shape.get("model", 1) > 1 else None
    return mesh, tp_axis


def _train(cfg: Config, mesh, device) -> None:
    mesh, tp_axis = _mesh_of(cfg, mesh, device)
    writer = world()[0] == 0
    cfg.seed_host_rngs()

    os.makedirs(cfg.result_dir, exist_ok=True)
    if writer:
        cfg.save_config(cfg.result_dir, "orig_config.json")
        if cfg.save_code:
            save_code_snapshot(cfg.result_dir)

    vocab_path = cfg.bert_args.get("vocab_file") if cfg.bert_args else None
    if not vocab_path or not os.path.exists(vocab_path):
        raise FileNotFoundError("config.bert_args.vocab_file must point to a WordPiece vocab.txt")
    tokenizer = WordPieceTokenizer.from_vocab_file(vocab_path, do_lower_case=cfg.lowercase)

    if cfg.data_type == "ent_link_ce":
        # distillation datasets from precomputed CE score-matrix pickles
        # (reference: get_ent_link_ce_dataset, utils/data_process.py:706-868)
        train_sets = [
            load_distill_dataset(cfg, d, cfg.train_ent_w_score_file_template or cfg.ent_w_score_file_template)
            for d in cfg.train_domains
        ]
        dev_sets = [
            load_distill_dataset(cfg, d, cfg.dev_ent_w_score_file_template or cfg.ent_w_score_file_template)
            for d in cfg.dev_domains
        ]
    else:
        train_sets = [load_world_dataset(cfg, files, tokenizer) for files in cfg.trn_files.values()]
        dev_sets = [load_world_dataset(cfg, files, tokenizer) for files in cfg.dev_files.values()]
    train_data = merge_worlds(train_sets)
    dev_data = merge_worlds(dev_sets) if dev_sets else None

    steps_per_epoch = max(1, train_data.n_ments // max(1, cfg.train_batch_size))
    model = build_model(cfg, tokenizer.vocab_size, device)
    tracker = ExperimentTracker(cfg.result_dir, config=cfg.to_dict()) if writer else None
    trainer = Trainer(
        cfg, model, mesh=mesh, total_steps=steps_per_epoch * cfg.num_epochs, tp_axis=tp_axis, tracker=tracker
    )

    t0 = time.time()
    trainer.train(train_data, dev_data=dev_data, resume=bool(cfg.ckpt_path))
    if tracker is not None:
        tracker.finish()
    LOGGER.info("training done in %.1fs; results in %s", time.time() - t0, cfg.result_dir)


if __name__ == "__main__":
    main()
