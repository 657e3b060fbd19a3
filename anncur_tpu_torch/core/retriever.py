"""CUR retriever: the serving API, on one GPU or query-sharded over a
mesh of ranks.

Counterpart of ``anncur_tpu/core/retriever.py``:

offline:  exact CE scores of train queries vs all items
          (ScoreMatrixBuilder) -> CurIndex (latent item embeddings U@R)
fixed-anchor (``query_tokens_batch``): query tokens -> CE-score against
          the k_i anchor items only -> project through the latent factors
          and take the top-k_retvr candidates (kernel B,
          ``ops/mips_kernel.py``) -> exact CE rerank -> top-k results.
          Cost per query = n_anchor_items + top_k_retvr CE calls (the
          reference's cost axis, run_retrieval_eval_wrt_exact_crossenc.py:
          480-481).
adaptive (``query_tokens_adaptive_fused``): the budget is spent in rounds
          that pick each query's own candidates (``core/adaptive_fused.py``,
          kernel B with the scored ids excluded), completing through the
          train matrix (CUR) or factorized item embeddings (AXN,
          ``core/axn.py``), optionally with per-query early stopping. Cost
          per query = the budget.
host adaptive (``query_tokens_adaptive``): the same method with the round
          loop, f64 pinv and picks on the host (``core/adaptive.py``).

query-sharded (``mesh=``): the counterpart of JAX's shard_map over the
          mesh's data axis. Every rank holds the whole corpus and index,
          passes the same global batch, and must call in lockstep; each
          takes its contiguous slice of the padded batch, runs the fixed
          path or the adaptive engine (escalation and shortlist included)
          on its own device, and the results are all-gathered, so every
          rank returns the whole batch. Chunks are sized per shard
          (ceil(q / n_dev) queries), so padding never multiplies CE work.
          The mesh is a serving knob: ``load()`` takes it, ``save()``
          never writes it. Host ADACUR runs the whole batch on each rank.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import pickle
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from anncur_tpu_torch.core.adaptive import adaptive_cur_query, cur_complete_fn
from anncur_tpu_torch.core.adaptive_fused import (
    AxnCompleter,
    CurCompleter,
    _bucket_size,
    _check_method,
    _true_f32,
    adaptive_continue,
    adaptive_rounds,
    split_rounds,
)
from anncur_tpu_torch.core.axn import AxnIndex, fit_item_embeddings, fit_item_embeddings_cached
from anncur_tpu_torch.core.cur import CurIndex, build_cur
from anncur_tpu_torch.data.tokenization import get_context_representation_ids
from anncur_tpu_torch.indexer.score_matrix import ScoreMatrixBuilder, crossenc_rerank_scores, make_pair_scorer
from anncur_tpu_torch.models.crossencoder import CrossEncoder
from anncur_tpu_torch.models.tokenizer import WordPieceTokenizer
from anncur_tpu_torch.ops.mips import topk_stable
from anncur_tpu_torch.ops.mips_kernel import mips_topk_fused
from anncur_tpu_torch.parallel.mesh import all_gather_cat
from anncur_tpu_torch.utils.device import DeviceLike, resolve_device, same_device
from anncur_tpu_torch.utils.tracker import TRACER

LOGGER = logging.getLogger(__name__)


def _sample_ce_rows(start_ns: int, pairs: int, pad_pairs: int) -> None:
    """The tracer's samples of one engine call from ``start_ns`` to now:
    ``ce.pairs``, the rows it handed the CE, and ``ce.pad_pairs``, those of
    them that belong to padding queries."""
    end = time.time_ns()
    TRACER.sample("ce.pairs", pairs, start_ns, end)
    TRACER.sample("ce.pad_pairs", pad_pairs, start_ns, end)


def _largest_divisor_leq(n: int, target: int) -> int:
    """Largest divisor of ``n`` that is <= target (>= 1)."""
    for d in range(min(max(target, 1), n), 0, -1):
        if n % d == 0:
            return d
    return 1


@dataclasses.dataclass
class CurRetriever:
    """Serving-time CUR retriever over one item corpus."""

    encoder: CrossEncoder
    tokenizer: WordPieceTokenizer
    item_tokens: np.ndarray  # (n_items, Le)
    index: CurIndex
    anchor_item_ids: np.ndarray  # (k_i,)
    max_query_len: int = 128
    # each CE forward scores ~target_pairs_per_step pairs whatever the
    # candidate width: queries per step = target // width
    target_pairs_per_step: int = 4096
    pair_pad_multiple: int = 128
    # the item axis is padded to a multiple of this block (token rows and
    # latent rows zero, never selected), as in the JAX package
    item_pad_multiple: int = 1024
    # dynamic corpus (set by .build()): U = pinv(R[:, anchors]) and the
    # anchor-query tokens let add_items extend the index without a rebuild
    train_query_tokens: Optional[np.ndarray] = None
    u: Optional[np.ndarray] = None  # (k_c, k_q)
    # position -> stable external item id (identity until remove_items)
    item_ids: Optional[np.ndarray] = None
    # monotonic id allocator, never derived from max(item_ids)
    next_item_id: Optional[int] = None
    device: DeviceLike = "cuda"
    # optional parallel/mesh.py::Mesh: the query batch is sharded over its
    # mesh_axis (corpus and index replicated); never saved in the state
    mesh: Optional[Any] = None
    mesh_axis: str = "data"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.encoder.device != self.device:
            raise ValueError(f"encoder lives on {self.encoder.device}, retriever on {self.device}")
        if self.mesh is not None and not same_device(self.mesh.device, self.device):
            raise ValueError(f"the mesh's rank lives on {self.mesh.device}, the retriever on {self.device}")
        if self.index.approx_preference != "rows":
            # the query computes anchor_scores @ latent_cols, which is U@R
            # only under 'rows'; a 'cols' index would rank wrongly
            raise ValueError(
                "CurRetriever serves indexes built with approx_preference="
                f"'rows'; got {self.index.approx_preference!r}"
            )
        self._dev_consts = None
        self._train_t = None
        self._host_complete = None  # host ADACUR's completion over the index's own train matrix
        self._axn_cache = {}  # (rank, train shape) -> AxnIndex of the index's own train matrix
        if self.item_ids is None:
            self.item_ids = np.arange(self.item_tokens.shape[0], dtype=np.int64)
        if self.next_item_id is None:
            self.next_item_id = int(self.item_ids.max()) + 1 if len(self.item_ids) else 0

    @property
    def cost_per_query(self) -> int:
        """CE calls per query on the anchor stage."""
        return len(self.anchor_item_ids)

    def _mesh_size(self) -> int:
        return 1 if self.mesh is None else self.mesh.shape[self.mesh_axis]

    def _shard_index(self) -> int:
        """This rank's place on the mesh axis (0 off a mesh)."""
        return 0 if self.mesh is None else self.mesh.coords[self.mesh_axis]

    def _local_rows(self, qtoks: torch.Tensor) -> torch.Tensor:
        """This rank's contiguous slice of a padded batch (all of it off a
        mesh); the batch pads to a multiple of the mesh axis."""
        if self.mesh is None:
            return qtoks
        per = qtoks.shape[0] // self._mesh_size()
        c = self._shard_index()
        return qtoks[c * per: (c + 1) * per]

    def _gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of ``t``, in mesh order (``t`` itself off a mesh)."""
        return t if self.mesh is None else all_gather_cat(t, self.mesh, self.mesh_axis)

    def throughput(self, query_tokens: np.ndarray, top_k: int = 10, top_k_retvr: int = 100, iters: int = 3) -> float:
        """Queries per second of :meth:`query_tokens_batch`, rerank included,
        after one warm call; the device is synchronized before each clock
        read (a bench helper)."""
        self.query_tokens_batch(query_tokens, top_k, top_k_retvr)  # warm-up
        self._sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            self.query_tokens_batch(query_tokens, top_k, top_k_retvr)
        self._sync()
        return iters * np.shape(query_tokens)[0] / (time.perf_counter() - t0)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _stage_batch(self, k: int) -> int:
        return max(1, self.target_pairs_per_step // max(1, k))

    def _padded_n_items(self) -> int:
        n = self.item_tokens.shape[0]
        return n + (-n) % max(1, int(self.item_pad_multiple))

    def _device_consts(self):
        """(item_tokens (n_pad, Le) int32, anchor_ids (k_i,) long,
        latent_items (n_pad, k_c) f32 contiguous) on the device. The latent
        item factors are kept transposed, once, so kernel B reads item rows;
        rows >= the real item count are zero and never selected."""
        if self._dev_consts is None:
            n = self.item_tokens.shape[0]
            n_pad = self._padded_n_items()
            items = torch.zeros((n_pad, self.item_tokens.shape[1]), dtype=torch.int32, device=self.device)
            items[:n] = torch.as_tensor(self.item_tokens, dtype=torch.int32, device=self.device)
            k_c = self.index.latent_cols.shape[0]
            latent = torch.zeros((n_pad, k_c), dtype=torch.float32, device=self.device)
            latent[:n] = self.index.latent_cols.to(self.device, torch.float32).T
            anchors = torch.as_tensor(np.asarray(self.anchor_item_ids, np.int64), device=self.device)
            self._dev_consts = (items, anchors, latent.contiguous())
        return self._dev_consts

    # ---------------- offline build ----------------------------------- #

    @classmethod
    def build(
        cls,
        encoder: CrossEncoder,
        tokenizer: WordPieceTokenizer,
        train_query_tokens: np.ndarray,  # (k_q, Lm) anchor queries
        item_tokens: np.ndarray,  # (n_items, Le)
        n_anchor_items: int,
        builder: ScoreMatrixBuilder,
        seed: int = 0,
        train_scores: Optional[np.ndarray] = None,
        max_query_len: int = 128,
        rcond=None,
        **kw,
    ) -> "CurRetriever":
        """Offline indexing: score the anchor queries against ALL items,
        sample anchor items (the JAX package's numpy draw, so both pick the
        same anchors for one seed), build the CUR latent factors with all
        train rows as anchors. ``rcond``: see ``core/cur.py::build_cur``.
        Extra keyword arguments go to the constructor; ``device`` defaults
        to the encoder's."""
        kw.setdefault("device", encoder.device)
        if train_scores is None:
            train_scores = builder(train_query_tokens, item_tokens)
        n_items = item_tokens.shape[0]
        rng = np.random.default_rng(seed)
        anchors = np.asarray(
            sorted(rng.choice(n_items, size=min(n_anchor_items, n_items), replace=False))
        )
        index, u = build_cur(
            rows=train_scores,
            cols=np.asarray(train_scores)[:, anchors],
            row_idxs=np.arange(train_scores.shape[0]),
            col_idxs=anchors,
            approx_preference="rows",
            validate=False,
            rcond=rcond,
            return_u=True,
            device=encoder.device,
        )
        return cls(
            encoder=encoder,
            tokenizer=tokenizer,
            item_tokens=np.asarray(item_tokens),
            index=index,
            anchor_item_ids=anchors,
            max_query_len=max_query_len,
            train_query_tokens=np.asarray(train_query_tokens),
            u=u.cpu().numpy(),
            **kw,
        )

    # ---------------- dynamic corpus ----------------------------------- #

    def add_items(self, new_item_tokens: np.ndarray, builder: ScoreMatrixBuilder) -> np.ndarray:
        """Add items without rebuilding: each new item costs k_q CE calls
        and one small matvec, its latent column is ``U @ r_new`` (U depends
        only on the anchor intersection, which new items never touch), so
        the result equals a full rebuild with the same anchors. Returns the
        stable external ids of the new items."""
        if self.u is None or self.train_query_tokens is None:
            raise ValueError(
                "add_items requires a retriever created by CurRetriever.build "
                "(it stores U and the anchor-query tokens)"
            )
        new_item_tokens = np.asarray(new_item_tokens, np.int32)
        new_scores = builder(self.train_query_tokens, new_item_tokens)
        # f64 host matmul: U can be ill-conditioned (large entries cancel)
        new_latent = (np.asarray(self.u, np.float64) @ np.asarray(new_scores, np.float64)).astype(np.float32)
        latent_cols = torch.cat(
            [self.index.latent_cols, torch.as_tensor(new_latent, device=self.index.latent_cols.device)], dim=1
        )
        self.index = dataclasses.replace(self.index, latent_cols=latent_cols)
        self.item_tokens = np.concatenate([self.item_tokens, new_item_tokens], axis=0)
        new_ids = np.arange(self.next_item_id, self.next_item_id + new_item_tokens.shape[0], dtype=np.int64)
        self.next_item_id += new_item_tokens.shape[0]
        self.item_ids = np.concatenate([self.item_ids, new_ids])
        self._dev_consts = self._train_t = self._host_complete = None
        self._axn_cache = {}
        return new_ids

    def remove_items(self, ids: np.ndarray) -> int:
        """Remove items by stable external id. Anchor items cannot be
        removed (their tokens feed the anchor stage and their columns define
        U). Remaining items keep their ids; the item axis is compacted, so
        padding stays at its tail. Duplicate ids collapse. Returns the
        number of items removed."""
        ids = np.asarray(ids)
        pos_of = {int(e): p for p, e in enumerate(self.item_ids)}
        missing = [int(i) for i in ids if int(i) not in pos_of]
        if missing:
            raise KeyError(f"unknown item ids: {missing[:5]}")
        positions = np.unique(np.asarray([pos_of[int(i)] for i in ids], dtype=np.int64))
        anchor_set = set(int(a) for a in np.asarray(self.anchor_item_ids))
        hit = [int(p) for p in positions if int(p) in anchor_set]
        if hit:
            raise ValueError(
                f"cannot remove anchor items (positions {hit[:5]}); "
                "rebuild the index with new anchors instead"
            )
        keep = np.setdiff1d(np.arange(self.item_tokens.shape[0]), positions)
        self.item_tokens = self.item_tokens[keep]
        self.item_ids = self.item_ids[keep]
        # anchor positions shift left past removed slots
        old_anchor_pos = np.asarray(self.anchor_item_ids)
        self.anchor_item_ids = old_anchor_pos - np.searchsorted(positions, old_anchor_pos)
        dev = self.index.latent_cols.device
        self.index = dataclasses.replace(
            self.index,
            latent_cols=self.index.latent_cols[:, torch.as_tensor(keep, device=dev)],
            col_idxs=torch.as_tensor(self.anchor_item_ids, dtype=torch.long, device=dev),
        )
        self._dev_consts = self._train_t = self._host_complete = None
        self._axn_cache = {}
        return int(positions.size)

    # ---------------- persistence -------------------------------------- #

    def save(self, path: str) -> None:
        """Persist the serving state in the JAX package's pickle format;
        encoder weights and the tokenizer are saved separately."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "wb") as fout:
            pickle.dump(
                {
                    "latent_rows": self.index.latent_rows.cpu().numpy(),
                    "latent_cols": self.index.latent_cols.cpu().numpy(),
                    "row_idxs": self.index.row_idxs.cpu().numpy().astype(np.int32),
                    "col_idxs": self.index.col_idxs.cpu().numpy().astype(np.int32),
                    "approx_preference": self.index.approx_preference,
                    "anchor_item_ids": np.asarray(self.anchor_item_ids),
                    "item_tokens": np.asarray(self.item_tokens),
                    "item_ids": np.asarray(self.item_ids),
                    "u": None if self.u is None else np.asarray(self.u),
                    "train_query_tokens": None
                    if self.train_query_tokens is None
                    else np.asarray(self.train_query_tokens),
                    "max_query_len": self.max_query_len,
                    "next_item_id": int(self.next_item_id),
                    "format_version": 1,
                },
                fout,
            )

    @classmethod
    def load(
        cls, path: str, encoder: CrossEncoder, tokenizer: WordPieceTokenizer, **kw
    ) -> "CurRetriever":
        """Inverse of save() (also reads the JAX package's files); pass the
        encoder and tokenizer the index was built with. Extra keyword
        arguments override serving knobs."""
        with open(path, "rb") as fin:
            d = pickle.load(fin)
        return cls.from_state_dict(d, encoder, tokenizer, **kw)

    @classmethod
    def from_state_dict(
        cls, d: Dict, encoder: CrossEncoder, tokenizer: WordPieceTokenizer, **kw
    ) -> "CurRetriever":
        """Build from an already unpickled save() dict of either package
        (state files can carry hundreds of MB of item tokens: a caller that
        had to look at the format does not unpickle twice)."""
        dev = encoder.device
        index = CurIndex(
            latent_rows=torch.as_tensor(np.asarray(d["latent_rows"], np.float32), device=dev),
            latent_cols=torch.as_tensor(np.asarray(d["latent_cols"], np.float32), device=dev),
            row_idxs=torch.as_tensor(np.asarray(d["row_idxs"], np.int64), device=dev),
            col_idxs=torch.as_tensor(np.asarray(d["col_idxs"], np.int64), device=dev),
            approx_preference=d["approx_preference"],
        )
        kw.setdefault("device", dev)
        retriever = cls(
            encoder=encoder,
            tokenizer=tokenizer,
            item_tokens=np.asarray(d["item_tokens"]),
            index=index,
            anchor_item_ids=np.asarray(d["anchor_item_ids"]),
            max_query_len=int(d["max_query_len"]),
            train_query_tokens=d["train_query_tokens"],
            u=d["u"],
            item_ids=np.asarray(d["item_ids"]),
            next_item_id=d.get("next_item_id"),
            **kw,
        )
        if "next_item_id" not in d:
            # a legacy state without the allocator: max(item_ids) + 1 reuses
            # the id of a max-id item removed before saving
            LOGGER.warning(
                "state dict has no next_item_id; id allocator re-derived as "
                "max(item_ids)+1, which reuses the id of a removed max-id item"
            )
        return retriever

    # ---------------- online query ------------------------------------ #

    def _anchor_scores(self, qtoks: torch.Tensor, chunk: int) -> torch.Tensor:
        """(q, k_i) f32 exact CE scores of query tokens against the
        anchor items, ``chunk`` queries per CE forward."""
        items, anchor_ids, _ = self._device_consts()
        score_pairs = make_pair_scorer(self.encoder, qtoks.shape[1], items.shape[1], self.pair_pad_multiple)
        anchor_toks = items[anchor_ids][None]  # (1, k_i, Le)
        return torch.cat(
            [score_pairs(blk, anchor_toks.expand(blk.shape[0], -1, -1)) for blk in qtoks.split(chunk)]
        )

    @torch.no_grad()
    def query_tokens_batch(
        self,
        query_tokens: np.ndarray,  # (q, Lm)
        top_k: int = 10,
        top_k_retvr: int = 100,
        rerank: bool = True,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(scores (q, top_k), stable item ids (q, top_k)). Cost per query =
        n_anchor_items + top_k_retvr CE calls (reference online path,
        ..._w_fixed_train_test_splits.py:286-303). Over a mesh each rank
        answers its shard and every rank returns the whole batch.

        Traced: spans ``fixed.pad``, ``fixed.anchor``, ``fixed.retrieve``,
        ``fixed.rerank`` and ``fixed.to_host``; one ``ce.pairs`` /
        ``ce.pad_pairs`` sample per call (this rank's rows)."""
        t_call = time.time_ns()
        query_tokens = np.asarray(query_tokens, np.int32)
        q, lm = query_tokens.shape
        top_k_retvr = min(top_k_retvr, self.index.n_cols)
        top_k = min(top_k, top_k_retvr if rerank else self.index.n_cols)
        k_i = len(self.anchor_item_ids)
        n_dev = self._mesh_size()
        # the chunk is a per-shard block: capped at ceil(q / n_dev), not q
        # (the JAX package measured a 16-query batch on 8 devices padding to
        # 8 x 16 rows, 31.4 -> 4.7 q/s, before capping it)
        chunk = max(1, min(self._stage_batch(max(k_i, top_k_retvr)), -(-q // n_dev)))
        q_pad = q + (-q) % (chunk * n_dev)
        with TRACER.span("fixed.pad"):
            qtoks = torch.zeros((q_pad, lm), dtype=torch.int32, device=self.device)
            qtoks[:q] = torch.as_tensor(query_tokens, device=self.device)
            local = self._local_rows(qtoks)
        s, i = self._query_local(local, chunk, top_k, top_k_retvr, rerank)
        s, i = self._gather_rows(s), self._gather_rows(i)
        with TRACER.span("fixed.to_host"):
            out = s[:q].cpu().numpy(), self.item_ids[i[:q].cpu().numpy()]
        per = local.shape[0]
        n_real = min(max(q - self._shard_index() * per, 0), per)
        width = k_i + (top_k_retvr if rerank else 0)
        _sample_ce_rows(t_call, per * width, (per - n_real) * width)
        return out

    def _query_local(self, qtoks: torch.Tensor, chunk: int, top_k: int, top_k_retvr: int, rerank: bool):
        """The fixed path on this device over ``qtoks`` (a multiple of
        ``chunk`` rows): (scores, item positions) tensors."""
        q_pad, lm = qtoks.shape
        n_items = self.item_tokens.shape[0]
        items, _, latent_items = self._device_consts()
        with TRACER.span("fixed.anchor"):
            anchor_scores = self._anchor_scores(qtoks, chunk)
        # latent projection + top-k in f32 (kernel B on the card); padded
        # item rows sit at the tail and are never selected
        with TRACER.span("fixed.retrieve"):
            if not rerank:
                return mips_topk_fused(anchor_scores, latent_items, top_k, n_items)
            _, cand = mips_topk_fused(anchor_scores, latent_items, top_k_retvr, n_items)

        # rerank stage: bigger query chunks (only top_k_retvr candidates each)
        with TRACER.span("fixed.rerank"):
            score_pairs = make_pair_scorer(self.encoder, lm, items.shape[1], self.pair_pad_multiple)
            r_chunk = _largest_divisor_leq(q_pad, self._stage_batch(top_k_retvr))
            exact = torch.cat(
                [score_pairs(blk, items[c]) for blk, c in zip(qtoks.split(r_chunk), cand.split(r_chunk))]
            )  # (q_pad, top_k_retvr)
            s, order = topk_stable(exact, top_k)
            return s, torch.gather(cand, 1, order)

    def tokenize_query(self, mention: str, context_left: str = "", context_right: str = "") -> List[int]:
        """The query-tokenization contract: lowercasing + quota-balanced
        context representation at max_query_len."""
        return get_context_representation_ids(
            {
                "mention": mention.lower(),
                "context_left": context_left.lower(),
                "context_right": context_right.lower(),
            },
            self.tokenizer,
            self.max_query_len,
        )

    def query(
        self,
        mention: str,
        context_left: str = "",
        context_right: str = "",
        top_k: int = 10,
        top_k_retvr: int = 100,
    ) -> List[Tuple[int, float]]:
        """Single text query -> [(item_id, score)]."""
        ids = self.tokenize_query(mention, context_left, context_right)
        scores, idx = self.query_tokens_batch(
            np.asarray([ids], np.int32), top_k=top_k, top_k_retvr=top_k_retvr
        )
        return list(zip(idx[0].tolist(), scores[0].tolist()))

    # ------------- adaptive query (multi-round, per-query candidates) ---- #

    @torch.no_grad()
    def query_tokens_adaptive(
        self,
        query_tokens: np.ndarray,  # (q, Lm)
        total_budget: int = 200,
        n_rounds: int = 3,
        top_k: int = 10,
        train_scores: Optional[np.ndarray] = None,
        seed: int = 0,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Host ADACUR (``core/adaptive.py``): (scores (q, top_k), stable item
        ids (q, top_k)). Each round's picks are scored as one union batch
        through the retriever's pair scorer (``crossenc_rerank_scores``);
        slots left unfilled (budget < top_k) are id -1, score -inf.
        ``train_scores``: the (n_train, n_items) matrix the index was built
        from; default its exact reconstruction, copied to the host once per
        cache fill."""
        n_items = self.item_tokens.shape[0]
        complete_fn = self._host_completion() if train_scores is None else cur_complete_fn(train_scores)
        query_tokens = np.asarray(query_tokens, np.int32)
        items = self._device_consts()[0]

        def score_items_fn(item_ids):
            cand = np.broadcast_to(np.asarray(item_ids)[None, :], (query_tokens.shape[0], len(item_ids)))
            return crossenc_rerank_scores(
                self.encoder, query_tokens, items, cand,
                batch_ments=self._stage_batch(len(item_ids)), pair_pad_multiple=self.pair_pad_multiple,
            )

        scores, ids, _ = adaptive_cur_query(
            None, score_items_fn, n_items=n_items, total_budget=total_budget,
            n_rounds=n_rounds, top_k=top_k, seed=seed, complete_fn=complete_fn,
        )
        # -1 stays -1 in external-id space (not item_ids[-1])
        return scores, np.where(ids >= 0, self.item_ids[np.clip(ids, 0, None)], -1)

    def _train_matrix(self) -> torch.Tensor:
        """(n_pad, n_train) f32 contiguous on the device: the train matrix
        the index was built from (latent_rows @ latent_cols restores the
        anchor rows exactly), zero-padded on the item axis and held
        transposed, as the latent items are, so kernel B reads item rows.
        Cached; cleared by add_items and remove_items."""
        if self._train_t is None:
            with _true_f32():
                mat = self.index.reconstruct().to(self.device, torch.float32)  # (n_train, n)
            train_t = torch.zeros((self._padded_n_items(), mat.shape[0]), dtype=torch.float32, device=self.device)
            train_t[: mat.shape[1]] = mat.T
            self._train_t = train_t
        return self._train_t

    def _axn_index(self, rank: Optional[int]) -> AxnIndex:
        """The AXN item embeddings of the index's own train matrix, fitted
        once per (rank, shape) and dropped by add_items and remove_items;
        the one copy of the matrix to the host happens at the fit."""
        n_items = self.item_tokens.shape[0]
        shape = (self.index.latent_rows.shape[0], n_items)
        rank = rank or min(shape)
        if (rank, shape) not in self._axn_cache:
            train = self._train_matrix()[:n_items].T
            self._axn_cache[(rank, shape)] = fit_item_embeddings(train, rank, device=self.device)
        return self._axn_cache[(rank, shape)]

    def _host_completion(self):
        """Host ADACUR's CUR completion over the index's own train matrix
        (``core/adaptive.py::cur_complete_fn``), its host copies made once
        and dropped with the train matrix by add_items and remove_items."""
        if self._host_complete is None:
            self._host_complete = cur_complete_fn(self._train_matrix()[: self.item_tokens.shape[0]].T.cpu().numpy())
        return self._host_complete

    def _adaptive_scorer(self, qtoks: torch.Tensor, items: torch.Tensor):
        """ids (q, width) -> (q, width) exact CE scores of each query row of
        ``qtoks`` against its own candidates' tokens ``items[ids]``, in
        query chunks of about target_pairs_per_step pairs."""
        q_pad, lm = qtoks.shape
        score_pairs = make_pair_scorer(self.encoder, lm, items.shape[1], self.pair_pad_multiple)

        def score_fn(ids: torch.Tensor) -> torch.Tensor:
            chunk = _largest_divisor_leq(q_pad, self._stage_batch(ids.shape[1]))
            return torch.cat([score_pairs(m_blk, items[c_blk]) for m_blk, c_blk in zip(qtoks.split(chunk), ids.split(chunk))])

        return score_fn

    @torch.no_grad()
    def query_tokens_adaptive_fused(
        self,
        query_tokens: np.ndarray,  # (q, Lm)
        total_budget: int = 200,
        n_rounds: int = 3,
        top_k: int = 10,
        train_scores=None,  # (n_train, n_items) numpy array or tensor
        seed: int = 0,
        ridge_rel: float = 1e-6,
        method: str = "cur",
        axn_rank: Optional[int] = None,
        axn_lam_rel: float = 1e-2,
        escalate_budget: Optional[int] = None,
        escalate_rounds: int = 3,
        stability_overlap: float = 1.0,
        return_stats: bool = False,
        shortlist: Optional[int] = None,
    ):
        """Adaptive multi-round retrieval: (scores (q, top_k), stable item
        ids (q, top_k)), plus {'avg_budget', 'frac_escalated',
        'stable_frac'} when ``return_stats``. Exactly ``total_budget`` CE
        calls per query, each query scoring its own candidates.

        ``train_scores``: the (n_train, n_items) matrix to complete through
        (default: the index's own train matrix), on the host or the device.
        ``ridge_rel`` plays the fixed path's pinv-rcond role. ``escalate_budget``
        (> total_budget) turns on per-query early stopping: queries whose
        top-k set still changed in the last round resume from their scored
        state and spend the difference over ``escalate_rounds`` rounds; they
        are compacted and padded to a power-of-two bucket, and the padded
        rows count in avg_budget. ``shortlist`` (L) restricts rounds 2+ to
        a batch-shared pool of L items, and is dropped where L cannot hold
        every scored id plus the remaining picks. ``method='axn'`` completes
        through rank-``axn_rank`` item embeddings of the train matrix
        (default: full rank; ``core/axn.py``), fitted once and cached, with
        ridge ``axn_lam_rel``. Per batch the host reads the device once,
        for the early-stop flags. Over a mesh each rank runs its shard's
        rounds (the shortlist pool and the escalation bucket are per
        shard, as JAX's pool is per device) and the stats sum the shards'.
        Traced: one ``ce.pairs`` / ``ce.pad_pairs`` sample per call (this
        rank's rows, the escalation bucket's included)."""
        t_call = time.time_ns()
        _check_method(method)
        query_tokens = np.asarray(query_tokens, np.int32)
        q, lm = query_tokens.shape
        n_items = self.item_tokens.shape[0]
        total_budget = min(total_budget, n_items)
        first, per, n_rounds = split_rounds(total_budget, n_rounds)
        # balanced chunking of each shard's ceil(q / n_dev) rows: round the
        # chunk down to ceil(q_loc / n_chunks) instead of padding up to a
        # multiple of the widest stage's chunk
        n_dev = self._mesh_size()
        q_loc = -(-q // n_dev)
        chunk0 = max(1, min(self._stage_batch(max(first, per)), q_loc))
        n_chunks = -(-q_loc // chunk0)
        q_pad_loc = -(-q_loc // n_chunks) * n_chunks
        qtoks = torch.zeros((q_pad_loc * n_dev, lm), dtype=torch.int32, device=self.device)
        qtoks[:q] = torch.as_tensor(query_tokens, device=self.device)
        if train_scores is not None and train_scores.shape[1] != n_items:
            # candidate ids come from train columns: another item set would
            # make the CE stage score other items' tokens
            raise ValueError(
                f"train_scores has {train_scores.shape[1]} item columns but the corpus has "
                f"{n_items} items; pass a train matrix over the same item set"
            )
        if method == "axn":
            if train_scores is None:
                index = self._axn_index(axn_rank)
            else:  # a caller's matrix: fitted once while unchanged (core/axn.py)
                index = fit_item_embeddings_cached(train_scores, axn_rank or min(train_scores.shape), device=self.device)
            completer = AxnCompleter(index, self._padded_n_items(), axn_lam_rel)
        else:
            if train_scores is not None:
                train = torch.as_tensor(train_scores, dtype=torch.float32, device=self.device)
                train_t = torch.zeros((self._padded_n_items(), train.shape[0]), dtype=torch.float32, device=self.device)
                train_t[:n_items] = train.T
            else:
                train_t = self._train_matrix()
            completer = CurCompleter(train_t, ridge_rel)
        rng = np.random.default_rng(seed)
        anchors0 = torch.as_tensor(np.asarray(sorted(rng.choice(n_items, size=first, replace=False)), np.int64))
        extra = 0 if escalate_budget is None else max(0, min(escalate_budget, n_items) - total_budget)
        if shortlist and (shortlist < first + q_pad_loc * per + per * max(1, n_rounds - 2) or shortlist >= n_items):
            # the pool (per shard) must hold the round-0 anchors, every
            # query's first picks and room for the remaining rounds
            shortlist = None
        # this shard's real rows: the global batch's rows below q
        n_real = min(max(q - self._shard_index() * q_pad_loc, 0), q_pad_loc)
        s, i, counts = self._adaptive_local(
            self._local_rows(qtoks), n_real, completer, anchors0, total_budget, n_rounds, top_k, extra,
            escalate_rounds, stability_overlap, shortlist,
        )
        # this rank's CE rows: its shard's rows over the budget, then the
        # escalation bucket (whose padding repeats a real row) over the rest
        _, n_unstable, bucket = counts
        _sample_ce_rows(t_call, q_pad_loc * total_budget + bucket * extra,
                        (q_pad_loc - n_real) * total_budget + (bucket - n_unstable) * extra)
        s, i = self._gather_rows(s)[:q], self._gather_rows(i)[:q]
        stats = {"avg_budget": float(total_budget), "frac_escalated": 0.0, "stable_frac": 1.0}
        if extra > 0:
            if self.mesh is not None:
                summed = torch.as_tensor(counts, dtype=torch.int64, device=self.device)
                dist.all_reduce(summed, group=self.mesh.groups[self.mesh_axis])
                counts = summed.tolist()
            n_stable, n_unstable, padded = counts
            stats["stable_frac"] = n_stable / q
            if n_unstable:
                # padded escalation rows pay real CE calls, so they count
                stats["avg_budget"] = total_budget + extra * padded / q
                stats["frac_escalated"] = n_unstable / q
        scores_out = s.cpu().numpy()
        ids_out = self.item_ids[i.cpu().numpy()]
        if return_stats:
            return scores_out, ids_out, stats
        return scores_out, ids_out

    def _adaptive_local(
        self, qtoks, n_real, completer, anchors0, total_budget, n_rounds, top_k, extra, escalate_rounds,
        stability_overlap, shortlist,
    ):
        """The adaptive engine on this device over ``qtoks`` (its first
        ``n_real`` rows real): (scores, item positions, counts) where
        counts = [stable real rows, escalated rows, escalation rows with
        their padding] (zeros without escalation)."""
        q_pad = qtoks.shape[0]
        n_items = self.item_tokens.shape[0]
        items = self._device_consts()[0]
        out = adaptive_rounds(
            self._adaptive_scorer(qtoks, items), completer, anchors0, q_pad, total_budget, n_rounds, top_k,
            n_items, with_state=extra > 0, stability_overlap=stability_overlap, shortlist=shortlist,
        )
        s, i = out[0], out[1]
        counts = [0, 0, 0]
        if extra > 0 and n_real:
            _, _, st_ids, st_vals, stable = out
            # only real rows escalate: padded rows would inflate the bucket
            stable_h = stable[:n_real].cpu().numpy()
            unstable = np.flatnonzero(~stable_h)
            counts[0] = int(stable_h.sum())
            if unstable.size:
                b_pad = _bucket_size(int(unstable.size), q_pad)
                sel = torch.as_tensor(
                    np.concatenate([unstable, np.full(b_pad - unstable.size, unstable[0])]), device=self.device
                )
                s2, i2, _, _, _ = adaptive_continue(
                    self._adaptive_scorer(qtoks[sel], items), completer, st_ids[sel], st_vals[sel], extra,
                    escalate_rounds, top_k, n_items,
                )
                rows = sel[: unstable.size]
                s, i = s.clone(), i.clone()
                s[rows], i[rows] = s2[: unstable.size], i2[: unstable.size]
                counts[1:] = [int(unstable.size), b_pad]
        return s, i, counts
