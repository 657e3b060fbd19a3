"""Bi-encoder and cross-encoder training, on one device or over a mesh
of ranks.

Counterpart of ``anncur_tpu/train/trainer.py`` (parity with the
reference's PyTorch-Lightning trainer, models/pairwise_trainer.py:168-266):
gradient accumulation over micro-batches averaged into one optimizer step,
per-micro-batch dropout streams, the bi-encoder's losses (explicit
negatives, in-batch negatives within each micro-batch, distillation from
teacher CE scores) and the cross-encoder's, hard negatives re-mined each
epoch with the current towers (embedded with kernel A, mined with kernel B
on the card), eval-mode dev evaluation with top-k checkpoints, an
end-of-epoch checkpoint, and resume.

Over a mesh (``parallel/mesh.py``; every rank runs the same Trainer in
lockstep on the same global batches): each rank takes its slice of every
micro-batch on the ``data`` axis, starts from rank 0's state, and the
gradients are all-reduced to the global mean before the optimizer, so the
clip norm is the reduced gradient's. The in-batch loss scores each rank's
mentions against the positives of every rank (``train/losses.py``), so
the step equals the one-process step on the global micro-batch, as JAX's
GSPMD step does. With ``tp_axis`` the towers are also tensor-parallel over
that axis (``parallel/tp.py``). Only rank 0 writes checkpoints (full
parameters and moments), then all ranks meet at a barrier; a resume reads
on rank 0 and broadcasts; each epoch's negatives are mined once and
broadcast.

Randomness: the state's ``rng`` is a CPU ``torch.Generator`` seeded from
``Config.seed``. Each step draws one seed per micro-batch off it (JAX
splits the step key and folds in the micro-batch index), and each
micro-batch's loss draws its own seeds for its forwards (the bi-encoder's
input, positive and negative towers; the CE's positive and negative
pairs); the masks themselves come from generators on the device. Over a
mesh every rank draws the same micro-batch seeds and mixes in its ``data``
coordinate (coordinate 0 keeps the seed), so ranks drop different units
and a step with dropout is not bit for bit the one-process step; at
dropout 0 it is the same function.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from anncur_tpu_torch.config import Config
from anncur_tpu_torch.evalx.retrieve_rerank import embed_tokenized
from anncur_tpu_torch.models.bert import draw_seeds
from anncur_tpu_torch.models.biencoder import BiEncoder, init_biencoder_params
from anncur_tpu_torch.models.crossencoder import CrossEncoder, init_crossencoder_params
from anncur_tpu_torch.parallel import tp as tp_mod
from anncur_tpu_torch.parallel.multihost import barrier, broadcast_object, replicate_from_host, world
from anncur_tpu_torch.train import data as data_mod
from anncur_tpu_torch.train.checkpoint import TopKCheckpointManager, adam_moments, flat_paths, load_pytree
from anncur_tpu_torch.train.losses import (
    bienc_loss_in_batch_negs,
    bienc_loss_w_negs,
    crossenc_loss,
    distill_loss,
    mrr_from_scores,
)
from anncur_tpu_torch.train.optimizer import Optimizer, apply_updates, make_optimizer, named_parameters
from anncur_tpu_torch.utils.device import same_device

LOGGER = logging.getLogger(__name__)


@dataclasses.dataclass
class TrainState:
    """``params`` are the model's own parameters (JAX paths -> tensors,
    updated in place); ``opt_state`` the optimizer's dict; ``rng`` a CPU
    generator."""

    params: Dict[str, torch.Tensor]
    opt_state: Dict
    step: int
    rng: torch.Generator


class Trainer:
    """``model_type`` 'bi_enc' (a :class:`BiEncoder`) or 'cross_enc' (a
    :class:`CrossEncoder`) with the reference's loss zoo. ``mesh``: a
    ``parallel/mesh.py::Mesh`` holding the model's device (data parallel
    over its ``data`` axis); ``tp_axis``: a mesh axis to split the towers
    over (tensor parallel); None for pure data parallelism."""

    DISTILL_TRP_STRATEGIES = ("top_ce_w_bienc_hard_negs_trp", "top_ce_w_rand_negs_trp")

    def __init__(
        self,
        config: Config,
        model,  # BiEncoder | CrossEncoder
        mesh=None,
        total_steps: int = 10000,
        tp_axis: Optional[str] = None,
        tracker=None,
    ):
        if not isinstance(model, (BiEncoder, CrossEncoder)):
            raise TypeError(f"Trainer takes a BiEncoder or a CrossEncoder, not {type(model).__name__}")
        if tp_axis is not None and (mesh is None or tp_axis not in mesh.shape):
            raise ValueError(f"tp_axis={tp_axis!r} needs a mesh with that axis")
        if mesh is not None and not same_device(mesh.device, model.device):
            raise ValueError(f"the model lives on {model.device}, the mesh's rank on {mesh.device}")
        self.mesh = mesh
        self.tp_axis = tp_axis
        self._specs = None  # parameter shard dims under tensor parallelism
        self.config = config
        self.model = model
        self.is_bienc = isinstance(model, BiEncoder)
        self.total_steps = total_steps
        self.tracker = tracker
        self._tx: Optional[Optimizer] = None
        self._fse: Optional[int] = None
        self._dev_negs_epoch: Optional[int] = None
        self._dev_negs: Optional[np.ndarray] = None
        self._warned_tail: set = set()
        self._warned_missing_metric = False
        self._trp_embed_cache = None
        self._ckpt = TopKCheckpointManager(
            os.path.join(config.result_dir, "model"),
            k=config.num_top_k_ckpts,
            metric=config.ckpt_metric,
            mode="min" if config.ckpt_metric == "loss" else "max",
        )

    @property
    def device(self) -> torch.device:
        return self.model.device

    @property
    def _n_data(self) -> int:
        return 1 if self.mesh is None else self.mesh.shape.get("data", 1)

    @property
    def _data_group(self):
        """The data-parallel group of a training step (None off a mesh)."""
        if self.mesh is None:
            return None
        return self.mesh.groups.get("data")

    @property
    def _is_writer(self) -> bool:
        """Rank 0 writes the checkpoints."""
        return world()[0] == 0

    # ---------------- state ------------------------------------------- #

    def init_state(self, params=None) -> TrainState:
        """Fresh parameters (``params``, a JAX-layout tree, or random ones
        from ``np.random.default_rng(config.seed)``), a fresh optimizer
        state, step 0 and the seeded generator."""
        cfg = self.config
        if params is None:
            m, rng = self.model, np.random.default_rng(cfg.seed)
            if self.is_bienc:
                params = init_biencoder_params(rng, m.spec, m.bi_enc_type, m.add_linear_layer, m.embed_dim)
            else:
                params = init_crossencoder_params(rng, m.spec, m.cross_enc_type)
        if self._specs is None:
            self.model.load_params_(params)
            if self.mesh is not None:
                # every rank starts from rank 0's values
                with torch.no_grad():
                    own = [p.data for p in self.model.parameters()]
                    for p, val in zip(self.model.parameters(), replicate_from_host(self.mesh, own)):
                        p.copy_(val)
                if self.tp_axis is not None:
                    self._specs = tp_mod.shard_params(self.model, self.mesh, self.tp_axis)
        else:  # sharded by an earlier call: rank 0's full values, this rank's blocks
            full = {n: np.asarray(v, np.float32) for n, v in flat_paths(params).items()}
            tp_mod.load_full_(named_parameters(self.model), replicate_from_host(self.mesh, full), self._specs,
                              self.mesh, self.tp_axis)
        self.model.requires_grad_(True)
        named = named_parameters(self.model)
        self._tx = make_optimizer(
            named,
            learning_rate=cfg.learning_rate,
            weight_decay=cfg.weight_decay,
            total_steps=self.total_steps,
            warmup_proportion=cfg.warmup_proportion,
            max_grad_norm=cfg.max_grad_norm,
            type_optimization=cfg.type_optimization or "all",
        )
        rng = cfg.prng_key("cpu")
        if self.mesh is not None:
            rng = replicate_from_host(self.mesh, rng)
        if self._specs is not None:
            self._tx.tensor_parallel([n for n, d in self._specs.items() if d is not None], self.mesh.groups[self.tp_axis])
        return TrainState(params=named, opt_state=self._tx.init(named), step=0, rng=rng)

    # ---------------- losses ------------------------------------------ #

    def _loss_fn(
        self, batch, generator: Optional[torch.Generator], train: bool = True, group=None
    ) -> Tuple[torch.Tensor, Dict]:
        """Loss of one batch and its metrics. ``train=False`` is the eval
        forward (no grad, no dropout); ``train=True`` with ``generator=None``
        takes gradients without dropout (JAX's eval-mode ``_loss_fn`` under
        ``value_and_grad``). Each forward draws its own dropout stream.
        ``group``: the data-parallel group when ``batch`` is this rank's
        share of a global micro-batch (the in-batch loss gathers the other
        ranks' positives over it)."""
        if self.is_bienc:
            if not train:
                with torch.no_grad():
                    return self._bienc_loss(batch, None, False)
            return self._bienc_loss(batch, generator, True, group)
        r_pos = r_neg = None
        if train and generator is not None:
            r_pos, r_neg = (torch.Generator().manual_seed(s) for s in draw_seeds(generator, 2))
        fse = self._fse or self.config.max_input_len
        pos_scores = self.model.score(batch["pos_pairs"], fse, train=train, generator=r_pos)
        b, n, l = batch["neg_pairs"].shape
        neg_scores = self.model.score(
            batch["neg_pairs"].reshape(b * n, l), fse, train=train, generator=r_neg
        ).reshape(b, n)
        loss = crossenc_loss(pos_scores, neg_scores, self.config.loss_type)
        return loss, {"loss": loss, "mrr": mrr_from_scores(pos_scores, neg_scores)}

    def _bienc_loss(self, batch, generator: Optional[torch.Generator], train: bool, group=None) -> Tuple[torch.Tensor, Dict]:
        """Distillation (``target_scores``), explicit negatives (``negs``,
        with the MRR of the positive among them) or in-batch negatives over
        this batch's (input, pos) rows. The input, positive (or label) and
        negative forwards draw three independent streams."""
        cfg, enc = self.config, self.model
        r_in = r_pos = r_neg = None
        if generator is not None:
            r_in, r_pos, r_neg = (torch.Generator().manual_seed(s) for s in draw_seeds(generator, 3))
        inp = enc._encode(batch["input"], "input", train, r_in)
        if "target_scores" in batch:
            b, n, l = batch["labels"].shape
            lab = enc._encode(batch["labels"].reshape(b * n, l), "label", train, r_pos).reshape(b, n, -1)
            loss = distill_loss((lab * inp[:, None, :]).sum(2), batch["target_scores"])
            return loss, {"loss": loss}
        pos = enc._encode(batch["pos"], "label", train, r_pos)
        if "negs" in batch:
            b, n, l = batch["negs"].shape
            neg = enc._encode(batch["negs"].reshape(b * n, l), "label", train, r_neg).reshape(b, n, -1)
            loss = bienc_loss_w_negs(inp, pos, neg, cfg.loss_type, cfg.hinge_margin)
            mrr = mrr_from_scores((inp * pos).sum(1), (neg * inp[:, None, :]).sum(2))
            return loss, {"loss": loss, "mrr": mrr}
        loss = bienc_loss_in_batch_negs(inp, pos, cfg.loss_type, cfg.hinge_margin, group)
        return loss, {"loss": loss}

    # ---------------- train step -------------------------------------- #

    def train_step(self, state: TrainState, batch: Dict[str, torch.Tensor]) -> Dict:
        """One optimizer step over ``batch`` = :meth:`_shard_batch`'s
        (grad_acc, micro, ...) tensors: gradients of each micro-batch's
        loss, summed and divided by their count, then the optimizer. The
        parameters, optimizer state, step and generator advance in place.
        Over a mesh the gradients and losses are then averaged over the
        ``data`` axis (one all-reduce each), before the optimizer."""
        if self._tx is None:
            raise RuntimeError("call init_state first")
        n_micro = next(iter(batch.values())).shape[0]
        seeds = draw_seeds(state.rng, n_micro)
        coord = 0 if self.mesh is None else self.mesh.coords.get("data", 0)
        group = self._data_group
        params = state.params
        for p in params.values():
            p.grad = None
        micro_losses = []
        for idx in range(n_micro):
            mb = {k: v[idx] for k, v in batch.items()}
            # data coordinate 0 keeps the one-process stream
            seed = (seeds[idx] + coord * 0x9E3779B97F4A7C15) % (1 << 62)
            loss, _ = self._loss_fn(mb, torch.Generator().manual_seed(seed), group=group)
            loss.backward()  # accumulates into .grad as JAX sums the scan
            micro_losses.append(loss.detach())
        # a parameter the head never reads (the pooler under w_embeds) has
        # no grad; JAX's is zeros
        grads = {n: torch.zeros_like(p) if p.grad is None else p.grad / n_micro for n, p in params.items()}
        micro = torch.stack(micro_losses)
        if group is not None:
            grads, micro = self._mean_over_data(grads, micro, group)
        apply_updates(params, self._tx.update(grads, state.opt_state, params))
        for p in params.values():
            p.grad = None
        state.step += 1
        return {"loss": micro.mean(), "micro_losses": micro}

    def _mean_over_data(self, grads: Dict[str, torch.Tensor], micro: torch.Tensor, group):
        """Gradients and micro-batch losses averaged over the data group,
        flattened into one all-reduce."""
        names = list(grads)
        flat = torch.cat([grads[n].reshape(-1) for n in names] + [micro.float()])
        dist.all_reduce(flat, group=group)
        flat /= self._n_data
        out, at = {}, 0
        for n in names:
            out[n] = flat[at: at + grads[n].numel()].view_as(grads[n])
            at += grads[n].numel()
        return out, flat[at:]

    def _shard_batch(self, batch) -> Dict[str, torch.Tensor]:
        """Stack into (grad_acc, micro_b, ...) tensors on the device; a batch
        not divisible by ``grad_acc_steps`` loses its tail, with a warning.
        Over a mesh ``batch`` is the global batch (the same on every rank)
        and each rank keeps its equal, contiguous share of every
        micro-batch; a micro-batch that does not divide by the ``data`` axis
        raises, as JAX's multi-process path does."""
        acc = max(1, self.config.grad_acc_steps)
        out = {}
        for k, v in batch.items():
            if np.ndim(v) == 0:
                continue
            v = np.asarray(v)
            b = v.shape[0]
            micro = b // acc
            if micro == 0:
                acc_eff, micro = 1, b
            else:
                acc_eff = acc
            if acc_eff * micro != b and k not in self._warned_tail:
                self._warned_tail.add(k)
                LOGGER.warning(
                    "batch %r size %d not divisible by grad_acc_steps=%d: "
                    "dropping %d samples per step — pick a divisible "
                    "train_batch_size", k, b, acc_eff, b - acc_eff * micro,
                )
            v = v[: acc_eff * micro].reshape((acc_eff, micro) + v.shape[1:])
            n = self._n_data
            if n > 1:
                if micro % n:
                    raise ValueError(
                        f"multi-process training requires the global micro-batch ({micro}) to be divisible "
                        f"by the mesh data axis ({n}) — pad train_batch_size/grad_acc_steps"
                    )
                c = self.mesh.coords["data"]
                v = v[:, c * (micro // n): (c + 1) * (micro // n)]
            out[k] = torch.as_tensor(v, device=self.device)
        if "first_segment_end" in batch:
            # pair layout is constant per dataset
            self._fse = int(batch["first_segment_end"])
        return out

    # ---------------- eval -------------------------------------------- #

    def evaluate(self, state: TrainState, batches: Iterator[Dict]) -> Dict[str, float]:
        """Eval-mode dev metrics: each batch's mean weighted by its size, so
        a short tail batch counts each example once; ``dev_mrr`` only where
        the batches yield one (explicit negatives)."""
        losses, mrrs, weights = [], [], []
        for batch in batches:
            if "first_segment_end" in batch:
                self._fse = int(batch["first_segment_end"])
            b = {
                k: torch.as_tensor(np.asarray(v), device=self.device)
                for k, v in batch.items()
                if k != "first_segment_end"
            }
            loss, aux = self._loss_fn(b, None, train=False)
            losses.append(float(loss))
            weights.append(next(v.shape[0] for v in b.values() if v.dim() > 0))
            if "mrr" in aux:
                mrrs.append(float(aux["mrr"]))
        w = np.asarray(weights, np.float64)
        res = {"dev_loss": float(np.average(losses, weights=w)) if losses else float("nan")}
        if mrrs:
            res["dev_mrr"] = float(np.average(mrrs, weights=w[: len(mrrs)]))
        return res

    # ---------------- full loop --------------------------------------- #

    def _checkpoint_tree(self, state: TrainState) -> Dict:
        """The checkpoint's tree. Under tensor parallelism every rank calls
        it: the full parameters and moments are gathered from the blocks."""
        params, opt_state = self.model.params_tree(), state.opt_state
        if self._specs is not None:
            full = tp_mod.gather_full(state.params, self._specs, self.mesh, self.tp_axis)
            params = tp_mod.full_tree(params, {n: t.cpu().numpy() for n, t in full.items()})
            opt_state = dict(opt_state, **{
                key: tp_mod.gather_full(opt_state[key], self._specs, self.mesh, self.tp_axis) for key in ("mu", "nu")
            })
        return {
            "params": params,
            "opt_state": opt_state,
            "step": int(state.step),
            # rng continuity: resume picks up the dropout stream mid-sequence
            "rng": state.rng,
        }

    def _save(self, save, state: TrainState, *args) -> None:
        """``save(tree, *args)`` on rank 0 only, then a barrier, so no rank
        reads a half-written checkpoint."""
        tree = self._checkpoint_tree(state)
        if self._is_writer:
            save(tree, *args)
        barrier("checkpoint")

    def _restore(self, state: TrainState, tree: Dict) -> TrainState:
        """Load a checkpoint of either package into ``state``: params, step
        and the Adam count and moments; the generator state where the
        port wrote it (a JAX key leaves the seeded generator as it is)."""
        count, mu, nu = adam_moments(tree["opt_state"])
        if self._specs is not None:
            tp_mod.load_full_(state.params, flat_paths(tree["params"]), self._specs, self.mesh, self.tp_axis)
        else:
            self.model.load_params_(tree["params"])
        state.opt_state["count"] = count
        for key, saved in (("mu", mu), ("nu", nu)):
            full = {n: np.asarray(saved[n]) for n in state.opt_state[key]}
            tp_mod.load_full_(state.opt_state[key], full, self._specs or {}, self.mesh, self.tp_axis)
        state.step = int(tree["step"])
        rng = tree.get("rng")
        if isinstance(rng, np.ndarray) and rng.dtype == np.uint8:
            state.rng.set_state(torch.as_tensor(rng))
        else:
            LOGGER.warning("checkpoint rng is not a torch generator state; keeping the seeded generator")
        return state

    def train(
        self,
        train_data: data_mod.EntLinkDataset,
        dev_data: Optional[data_mod.EntLinkDataset] = None,
        resume: bool = False,
    ) -> TrainState:
        cfg = self.config
        state = self.init_state()
        start_epoch = self._resume(state) if resume else 0

        batch_size = cfg.train_batch_size
        fast_dev = cfg.fast_dev_run
        eval_every = int(cfg.eval_interval) if cfg.eval_interval and cfg.eval_interval > 0 else 0
        steps_since_eval = 0
        for epoch in range(start_epoch, cfg.num_epochs):
            neg_labels = self._epoch_negatives(train_data, state, epoch)
            batches = self._make_batches(train_data, neg_labels, batch_size, epoch)
            t0 = time.time()
            for bi, batch in enumerate(batches):
                if fast_dev and bi >= fast_dev:
                    break
                metrics = self.train_step(state, self._shard_batch(batch))
                steps_since_eval += 1
                if eval_every and dev_data is not None and steps_since_eval >= eval_every:
                    # mid-epoch dev eval + top-k checkpointing (reference:
                    # eval_interval / PL val_check_interval)
                    steps_since_eval = 0
                    self._dev_eval_and_ckpt(state, dev_data, batch_size, epoch)
                if bi % cfg.print_interval == 0:
                    loss_val = float(metrics["loss"])
                    LOGGER.info(
                        "epoch %d step %d loss %.4f (%.2f s/step)",
                        epoch, state.step, loss_val, (time.time() - t0) / (bi + 1),
                    )
                    if self.tracker is not None:
                        self.tracker.log({"train_loss": loss_val, "epoch": epoch}, step=state.step)
            # dev eval + checkpoints (reference: top-k on dev metric +
            # end-of-epoch, pairwise_trainer.py:214-237)
            if dev_data is not None:
                self._dev_eval_and_ckpt(state, dev_data, batch_size, epoch)
            self._save(self._ckpt.save_end_of_epoch, state, epoch, state.step)
        return state

    def _resume(self, state: TrainState) -> int:
        """Restore the latest end-of-epoch checkpoint into ``state``, if
        any: rank 0 reads it and every rank restores it (JAX's
        ``_place_like``). Returns the epoch to start from."""
        last = tree = None
        if self._is_writer:
            last = self._ckpt.latest_eoe()
            tree = None if last is None else load_pytree(last["path"])[0]
        last, tree = broadcast_object((last, tree))
        if last is None:
            return 0
        self._restore(state, tree)
        LOGGER.info("resumed from %s (epoch %d)", last["path"], last["epoch"] + 1)
        return last["epoch"] + 1

    def _dev_eval_and_ckpt(self, state: TrainState, dev_data, batch_size: int, epoch: int) -> None:
        cfg = self.config
        # dev negatives are mined once per epoch, not once per eval
        if self._dev_negs_epoch != epoch:
            self._dev_negs = self._epoch_negatives(dev_data, state, epoch)
            self._dev_negs_epoch = epoch
        dev_metrics = self.evaluate(
            state,
            self._make_batches(dev_data, self._dev_negs, batch_size, epoch, shuffle=False, for_eval=True),
        )
        LOGGER.info("epoch %d dev: %s", epoch, dev_metrics)
        if self.tracker is not None:
            self.tracker.log(dict(dev_metrics, epoch=epoch), step=state.step)
        metric_name = "dev_mrr" if cfg.ckpt_metric == "mrr" else "dev_loss"
        if metric_name not in dev_metrics:
            # ckpt_metric='mrr' with in_batch or distillation, whose eval
            # ranks no candidates: select top-k checkpoints by dev_loss
            if not self._warned_missing_metric:
                LOGGER.warning(
                    "ckpt_metric=%s but eval produced no %s (neg_strategy=%s yields no ranked "
                    "candidates); selecting top-k checkpoints by dev_loss instead",
                    cfg.ckpt_metric, metric_name, cfg.neg_strategy,
                )
                self._warned_missing_metric = True
                self._ckpt.metric, self._ckpt.mode = "loss", "min"
            metric_name = "dev_loss"
        metric_val = dev_metrics[metric_name]
        if np.isfinite(metric_val):
            self._save(self._ckpt.maybe_save, state, metric_val, state.step, epoch)

    def _embed(self, data):
        """(mention, entity) embeddings of ``data`` by the current towers,
        eval mode (kernel A on the card), as numpy."""
        bs = self.config.eval_batch_size
        return (embed_tokenized(self.model, data.mention_tokens, bs, "input"),
                embed_tokenized(self.model, data.entity_tokens, bs, "label"))

    def _epoch_negatives(self, data, state: TrainState, epoch: int) -> Optional[np.ndarray]:
        """This epoch's (n_m, num_negs) negatives, None where the batches
        bring their own (in-batch, distillation). Bi-encoder hard negatives
        are re-mined with the current towers (reference:
        EntLinkData.get_bienc_model, pairwise_trainer.py:133-164). Over a
        mesh rank 0 mines (every rank does, under tensor parallelism, whose
        forwards need them all) and broadcasts its ids."""
        cfg = self.config
        if self.is_bienc and cfg.neg_strategy in ("in_batch", "top_ce_match") + self.DISTILL_TRP_STRATEGIES:
            return None
        if self.mesh is None:
            return self._mine(data, epoch)
        negs = self._mine(data, epoch) if self._is_writer or self._specs is not None else None
        return broadcast_object(negs)

    def _mine(self, data, epoch: int) -> np.ndarray:
        cfg = self.config
        embeds = {}
        if self.is_bienc and cfg.neg_strategy == "bienc_hard_negs":
            embeds = dict(zip(("input_embeds", "label_embeds"), self._embed(data)))
        return data_mod.mine_negatives(
            data, cfg.neg_strategy, cfg.num_negs, seed=epoch, device=self.device, **embeds
        )

    def _make_batches(self, data, neg_labels, batch_size, epoch, shuffle=None, for_eval=False):
        cfg = self.config
        shuffle = cfg.shuffle_data if shuffle is None else shuffle
        # eval sees every example exactly once: no tail drop, no wrap-padding
        tail = {"drop_remainder": False, "pad_remainder": False} if for_eval else {}
        if not self.is_bienc:
            return data_mod.crossenc_batches(data, neg_labels, batch_size, shuffle, epoch, **tail)
        if cfg.neg_strategy == "top_ce_match":
            # distillation from teacher CE scores (reference 'top_ce_match'
            # datasets, data_process.py:706-868)
            return data_mod.distill_batches(data, cfg.distill_n_labels, batch_size, shuffle, epoch, **tail)
        if cfg.neg_strategy in self.DISTILL_TRP_STRATEGIES:
            # triplets; the hard variant mines with the current towers (the
            # model holds them), embedded once per (dataset, epoch) so a
            # step-level dev eval does not re-embed the corpus each time
            embeds = (None, None)
            if cfg.neg_strategy == "top_ce_w_bienc_hard_negs_trp":
                key = (id(data), epoch)
                if self._trp_embed_cache is None or self._trp_embed_cache[0] != key:
                    self._trp_embed_cache = (key, self._embed(data))
                embeds = self._trp_embed_cache[1]
            return data_mod.distill_triplet_batches(
                data, cfg.distill_n_labels, batch_size, shuffle, epoch,
                input_embeds=embeds[0], label_embeds=embeds[1], device=self.device, **tail,
            )
        if neg_labels is None:  # in-batch negatives
            return (
                {"input": b["input"], "pos": b["pos"]}
                for b in data_mod.bienc_batches(
                    data, np.zeros((data.n_ments, 1), np.int64), batch_size, shuffle, epoch, **tail
                )
            )
        return data_mod.bienc_batches(data, neg_labels, batch_size, shuffle, epoch, **tail)
