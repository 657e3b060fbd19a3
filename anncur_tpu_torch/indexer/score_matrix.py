"""Offline index build: the (n_ment x n_ent) exact cross-encoder score
matrix, on one GPU or over a mesh of ranks.

Counterpart of ``anncur_tpu/indexer/score_matrix.py``:

- pairs are built on the device (mention ⧺ entity[1:], reference
  semantics utils/data_process.py:949-959), padded to a multiple of
  ``min(pair_pad_multiple, max_position_embeddings)``,
- each CE forward scores ``ment_block`` x ``ent_block`` pairs; entities
  are processed in slabs of at most ``max_pairs_per_program`` pairs per
  mention block, each slab copied to the host once,
- mention blocks checkpoint to disk as ``chunk_<start>.npz`` files that
  the JAX builder reads and writes too (resume: existing chunks are
  loaded, not recomputed), under a ``ChunkDirLock``,
- over a mesh (``ScoreMatrixBuilder(mesh=)``) each rank of the ``data``
  axis scores a contiguous shard of every entity slab (kernel A on its
  card), the shards padded to equal size, and the score blocks are
  all-gathered, so every rank returns the full matrix; rank 0 alone
  writes the chunk files and holds the lock,
- :meth:`ScoreMatrixBuilder.build_multihost` splits the mention rows over
  the processes instead, each writing ``proc<pid>`` chunk files that rank
  0 combines (the JAX layout, so either package's combiner reads them).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import pickle
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from anncur_tpu_torch.models.crossencoder import CrossEncoder
from anncur_tpu_torch.parallel.mesh import all_gather_cat
from anncur_tpu_torch.parallel.multihost import barrier, broadcast_object, process_range, world
from anncur_tpu_torch.utils.device import DeviceLike, resolve_device, same_device

LOGGER = logging.getLogger(__name__)


class ChunkDirLock:
    """Single-writer guard for a chunk directory (copy of the JAX
    package's): a lockfile holding the owner pid, created atomically by
    hard-linking a temp file; a lock whose pid is dead is stale and is
    stolen under a secondary mutex; a live second writer fails loudly."""

    def __init__(self, chunk_dir: str):
        self.path = os.path.join(chunk_dir, ".lock")
        os.makedirs(chunk_dir, exist_ok=True)
        tmp = f"{self.path}.{os.getpid()}.tmp"
        while True:
            with open(tmp, "w") as fout:
                fout.write(str(os.getpid()))
            try:
                os.link(tmp, self.path)
                os.remove(tmp)
                return
            except FileExistsError:
                os.remove(tmp)
            owner = 0
            for _ in range(3):  # tolerate legacy/corrupt lockfiles briefly
                try:
                    with open(self.path) as fin:
                        owner = int(fin.read().strip() or "0")
                except FileNotFoundError:
                    owner = -1  # released between our check and read: retry
                    break
                except (OSError, ValueError):
                    owner = 0
                if owner:
                    break
                time.sleep(0.1)
            if owner == -1:
                continue
            if owner and _pid_alive(owner):
                raise RuntimeError(
                    f"chunk dir {chunk_dir} is being written by live pid {owner}"
                )
            self._steal_stale(owner)

    def _steal_stale(self, owner: int) -> None:
        """Remove a dead owner's lockfile. Stealers serialize on an O_EXCL
        mutex and re-check the owner inside it, so a slower stealer cannot
        delete a faster one's fresh live lock. Returning without removing
        is always safe: the caller loops and re-checks."""
        mutex = self.path + ".steal"
        try:
            fd = os.open(mutex, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            # another stealer is mid-steal or crashed there: age out its mutex
            try:
                if time.time() - os.path.getmtime(mutex) > 60.0:
                    os.remove(mutex)
            except OSError:
                pass
            time.sleep(0.05)
            return
        try:
            os.write(fd, str(os.getpid()).encode())
            os.close(fd)
            try:
                with open(self.path) as fin:
                    cur = int(fin.read().strip() or "0")
            except FileNotFoundError:
                return  # released/stolen already; caller retries the link
            except (OSError, ValueError):
                cur = 0
            if cur != owner or (cur and _pid_alive(cur)):
                return  # changed hands since our check; caller re-checks
            LOGGER.warning("stealing stale chunk-dir lock from pid %s", owner)
            try:
                os.remove(self.path)
            except FileNotFoundError:
                pass
        finally:
            try:
                os.remove(mutex)
            except FileNotFoundError:
                pass

    def release(self) -> None:
        try:
            os.remove(self.path)
        except FileNotFoundError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False
    except PermissionError:
        return True


def build_pairs(ment_block: torch.Tensor, ent_block: torch.Tensor, pair_len: int) -> torch.Tensor:
    """(Bm, Lm) x (Be, Le) -> (Bm*Be, pair_len) pair tokens:
    mention ⧺ entity[1:] (entity CLS dropped), zero-padded to ``pair_len``
    (padding is masked inside the encoder)."""
    bm, lm = ment_block.shape
    be, le = ent_block.shape
    left = ment_block[:, None, :].expand(bm, be, lm)
    right = ent_block[None, :, 1:].expand(bm, be, le - 1)
    pairs = torch.cat([left, right], dim=-1).reshape(bm * be, lm + le - 1)
    if pair_len > lm + le - 1:
        pairs = torch.nn.functional.pad(pairs, (0, pair_len - (lm + le - 1)))
    return pairs


def padded_pair_len(lm: int, le: int, pair_pad_multiple: int, max_positions: int) -> int:
    """lm + le - 1 rounded up to ``min(pair_pad_multiple, max_positions)``:
    clamped to the position table, the same rule as the serving-side
    scorer, so offline and online pairs have one shape."""
    pair_len = lm + le - 1
    return pair_len + (-pair_len) % min(pair_pad_multiple, max_positions)


def make_pair_scorer(ce: CrossEncoder, lm: int, le: int, pair_pad_multiple: int):
    """(c, Lm) query block + (c, width, Le) candidate tokens -> (c, width)
    CE scores: the serving side's one pair scorer (the retriever's anchor,
    rerank and adaptive stages, :func:`crossenc_rerank_scores`). Its
    pair layout (mention ⧺ candidate[1:], padded to :func:`padded_pair_len`)
    is :func:`build_pairs`'s: the train matrix and the online scores must
    come from one pair shape."""
    raw_len = lm + le - 1
    pair_len = padded_pair_len(lm, le, pair_pad_multiple, ce.spec.max_position_embeddings)

    def score_pairs(m_blk: torch.Tensor, cand_toks: torch.Tensor) -> torch.Tensor:
        c, width, _ = cand_toks.shape
        left = m_blk[:, None, :].expand(c, width, lm)
        pairs = torch.cat([left, cand_toks[:, :, 1:]], dim=-1).reshape(c * width, raw_len)
        pairs = torch.nn.functional.pad(pairs, (0, pair_len - raw_len))
        return ce.score(pairs, first_segment_end=lm).reshape(c, width)

    return score_pairs


def tokens_on(device: torch.device, tokens) -> torch.Tensor:
    """int32 token ids (an array or a tensor) on ``device``."""
    if torch.is_tensor(tokens):
        return tokens.to(device=device, dtype=torch.int32)
    return torch.as_tensor(np.asarray(tokens, np.int32), device=device)


@torch.no_grad()
def crossenc_rerank_scores(
    ce: CrossEncoder,
    ment_tokens,  # (n_m, Lm)
    ent_tokens,  # (n_e, Le)
    cand_idx,  # (n_m, k) candidate entity ids per mention
    batch_ments: Optional[int] = None,
    pair_pad_multiple: int = 128,
) -> np.ndarray:
    """Exact CE scores of each mention's candidates, (n_m, k) f32 numpy,
    through :func:`make_pair_scorer` (the retrieve-and-rerank eval's rerank
    and the retriever's host ADACUR rounds). Candidate tokens are gathered
    on the device; ``batch_ments`` mentions per CE forward, by default
    ~4096 pairs."""
    dev = ce.device
    ments, ents = tokens_on(dev, ment_tokens), tokens_on(dev, ent_tokens)
    cidx = torch.as_tensor(np.ascontiguousarray(cand_idx, np.int64), device=dev)
    n_m, lm = ments.shape
    k = cidx.shape[1]
    if batch_ments is None:
        batch_ments = max(1, 4096 // max(1, k))
    bm = max(1, min(batch_ments, n_m))
    score_pairs = make_pair_scorer(ce, lm, ents.shape[1], pair_pad_multiple)
    out = torch.cat([score_pairs(m_blk, ents[c_blk]) for m_blk, c_blk in zip(ments.split(bm), cidx.split(bm))])
    return out.float().cpu().numpy()


@dataclasses.dataclass
class ScoreMatrixBuilder:
    """Exact score matrix on one device, or entity-sharded over the ``axis``
    of ``mesh`` (every rank calls it in lockstep with the same tokens).

    ``ment_block``: mentions per CE forward; ``ent_block``: entities per
    CE forward, so one forward scores ment_block * ent_block pairs."""

    encoder: CrossEncoder
    ment_block: int = 8
    ent_block: int = 64
    pair_pad_multiple: int = 128
    # entity slab per mention block: at most this many pairs between two
    # host copies (progress and chunk granularity)
    max_pairs_per_program: int = 32768
    device: DeviceLike = "cuda"
    mesh: Any = None  # parallel/mesh.py::Mesh; None = this device alone
    axis: str = "data"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.encoder.device != self.device:
            raise ValueError(
                f"encoder lives on {self.encoder.device}, builder on {self.device}"
            )
        if self.mesh is not None and not same_device(self.mesh.device, self.device):
            raise ValueError(f"the mesh's rank lives on {self.mesh.device}, the builder on {self.device}")

    @torch.no_grad()
    def _score_block(self, block: torch.Tensor, ents: torch.Tensor, lm: int, pair_len: int) -> torch.Tensor:
        """(bm, Lm) mention block x (slab, Le) entities -> (bm, slab) f32."""
        be = self.ent_block
        parts = []
        for c in range(0, ents.shape[0], be):
            pairs = build_pairs(block, ents[c : c + be], pair_len)
            parts.append(self.encoder.score(pairs, first_segment_end=lm).reshape(block.shape[0], -1))
        return torch.cat(parts, dim=1)

    def __call__(
        self,
        ment_tokens: np.ndarray,  # (n_m, Lm)
        ent_tokens: np.ndarray,  # (n_e, Le)
        progress_cb: Optional[Callable[[float], None]] = None,
        chunk_dir: Optional[str] = None,
        chunk_rows: int = 512,
    ) -> np.ndarray:
        """The full (n_m, n_e) float32 score matrix on the host (on every
        rank of a mesh).

        With ``chunk_dir``, every ``chunk_rows`` (rounded up to whole
        mention blocks) mention rows are written as ``chunk_<start>.npz``;
        existing chunks are loaded instead of recomputed (over a mesh,
        rank 0 lists them and writes them)."""
        ment_tokens = np.asarray(ment_tokens)
        ent_tokens = np.asarray(ent_tokens)
        n_m, lm = ment_tokens.shape
        n_e, le = ent_tokens.shape
        bm, be = self.ment_block, self.ent_block
        n_dev, coord = 1, 0
        if self.mesh is not None:
            n_dev, coord = self.mesh.shape[self.axis], self.mesh.coords[self.axis]
        writer = world()[0] == 0 if self.mesh is not None else True
        pair_len = padded_pair_len(
            lm, le, self.pair_pad_multiple, self.encoder.spec.max_position_embeddings
        )
        # entity slabs: bounded pairs per slab and rank, capped at the
        # padded corpus; each slab splits into n_dev equal shards
        n_e_base = n_e + (-n_e) % (n_dev * be)
        slab = min(max(1, self.max_pairs_per_program // (bm * be)) * be * n_dev, n_e_base)
        n_e_pad = n_e_base + (-n_e_base) % slab
        shard = slab // n_dev
        ents = torch.zeros((n_e_pad, le), dtype=torch.int32, device=self.device)
        ents[:n_e] = torch.as_tensor(ent_tokens, dtype=torch.int32, device=self.device)

        out = np.zeros((n_m, n_e), np.float32)
        t0 = time.time()
        chunk_start, chunk_buf = 0, []
        lock = ChunkDirLock(chunk_dir) if chunk_dir is not None and writer else None
        existing = set()
        if chunk_dir is not None:
            if writer and os.path.isdir(chunk_dir):
                existing = {f for f in os.listdir(chunk_dir) if f.startswith("chunk_") and f.endswith(".npz")}
            if self.mesh is not None:
                existing = broadcast_object(existing)

        def flush_chunk():
            nonlocal chunk_start, chunk_buf
            if chunk_buf and writer:
                np.savez_compressed(
                    os.path.join(chunk_dir, f"chunk_{chunk_start}.npz"),
                    scores=np.concatenate(chunk_buf, axis=0),
                    row_start=chunk_start,
                )
            chunk_buf = []

        try:
            i = 0
            while i < n_m:
                if chunk_dir is not None:
                    # chunks are keyed by their exact (block-aligned) start row
                    cpath = os.path.join(chunk_dir, f"chunk_{i}.npz")
                    if f"chunk_{i}.npz" in existing:
                        flush_chunk()
                        with np.load(cpath) as data:
                            rows = data["scores"]
                        out[i : i + rows.shape[0]] = rows[:, :n_e]
                        i += rows.shape[0]
                        chunk_start = i
                        continue
                take = min(bm, n_m - i)
                block = torch.zeros((bm, lm), dtype=torch.int32, device=self.device)
                block[:take] = torch.as_tensor(ment_tokens[i : i + take], dtype=torch.int32, device=self.device)
                for c0 in range(0, n_e_pad, slab):
                    s0 = c0 + coord * shard
                    scores = self._score_block(block, ents[s0 : s0 + shard], lm, pair_len)
                    if self.mesh is not None:
                        scores = all_gather_cat(scores, self.mesh, self.axis, dim=1)
                    c1 = min(c0 + slab, n_e)
                    if c1 > c0:
                        out[i : i + take, c0:c1] = scores[:take, : c1 - c0].cpu().numpy()
                chunk_buf.append(out[i : i + take])
                i += take
                if progress_cb is not None:
                    progress_cb(i / n_m)
                if chunk_dir is not None and i - chunk_start >= chunk_rows:
                    flush_chunk()
                    chunk_start = i
            if chunk_dir is not None:
                flush_chunk()
        finally:
            # release even on a crash, or a same-process resume is refused
            if lock is not None:
                lock.release()
        dt = max(time.time() - t0, 1e-9)
        LOGGER.info("score matrix %dx%d built in %.1fs (%.0f pairs/s)", n_m, n_e, dt, n_m * n_e / dt)
        return out

    def build_multihost(
        self,
        ment_tokens: np.ndarray,
        ent_tokens: np.ndarray,
        chunk_dir: str,
        chunk_rows: int = 512,
        progress_cb: Optional[Callable[[float], None]] = None,
    ) -> Optional[np.ndarray]:
        """Cross-process build: each process scores its contiguous mention
        range (:func:`process_range`) with this process-local builder and
        writes chunk files into ``chunk_dir/proc<pid:04d>`` plus a
        ``_done.json``; after a barrier, process 0 combines them
        (``indexer/combine.py``) and returns the full matrix, the others
        None (``anncur_tpu/indexer/score_matrix.py::build_multihost``, the
        form of the reference's SLURM mention-range chunks + combiner). A
        restarted process resumes from its own chunks. ``chunk_dir`` must
        be shared by the processes."""
        from anncur_tpu_torch.indexer.combine import combine_chunks

        if self.mesh is not None and self.mesh.size > 1:
            raise ValueError(
                "build_multihost needs a process-LOCAL mesh (each process "
                f"builds its own mention range); mesh contains {self.mesh.size - 1} "
                "remote devices. Use a global mesh only for training."
            )
        pid, n_proc = world()
        n_m = np.shape(ment_tokens)[0]
        start, end = process_range(n_m, n_proc, pid)
        subdir = os.path.join(chunk_dir, f"proc{pid:04d}")
        LOGGER.info("multihost build: process %d/%d owns mention rows [%d, %d)", pid, n_proc, start, end)
        if end > start:
            self(np.asarray(ment_tokens)[start:end], ent_tokens, chunk_dir=subdir, chunk_rows=chunk_rows,
                 progress_cb=progress_cb)
        else:  # more processes than rows: still meet at the barrier
            os.makedirs(subdir, exist_ok=True)
        with open(os.path.join(subdir, "_done.json"), "w") as fout:
            json.dump({"row_start": start, "row_end": end}, fout)
        barrier("score_matrix_build_done")
        if pid != 0:
            return None
        parts = []
        for p in range(n_proc):
            s, e = process_range(n_m, n_proc, p)
            if e > s:
                parts.append(combine_chunks(os.path.join(chunk_dir, f"proc{p:04d}"), n_ments=e - s))
        out = np.concatenate(parts, axis=0)
        if out.shape != (n_m, np.shape(ent_tokens)[0]):
            raise ValueError(f"combined matrix has shape {out.shape}, not {(n_m, np.shape(ent_tokens)[0])}")
        return out

    @torch.no_grad()
    def paired_embeds(self, ment_tokens: np.ndarray, ent_tokens: np.ndarray):
        """(n_m, n_e, h) f32 mention and entity contextual embeddings from
        the joint forward of a 'w_embeds' CE (reference mode=embeds,
        run_cross_encoder_for_ment_ent_matrix_zeshel.py:126-163). For small
        n_m only: the output is O(n_m * n_e * h). Entities are chunked,
        ``ent_block`` pairs per forward, the last chunk zero-padded."""
        ment_tokens = np.asarray(ment_tokens)
        n_m, lm = ment_tokens.shape
        n_e, le = np.shape(ent_tokens)
        pair_len = padded_pair_len(lm, le, self.pair_pad_multiple, self.encoder.spec.max_position_embeddings)
        be = max(self.ent_block, 1)
        ents = torch.zeros((n_e + (-n_e) % be, le), dtype=torch.int32, device=self.device)
        ents[:n_e] = tokens_on(self.device, ent_tokens)
        m_out, e_out = [], []
        for i in range(n_m):
            ment = tokens_on(self.device, ment_tokens[i : i + 1])
            parts = [
                self.encoder.embed_paired(build_pairs(ment, ents[c : c + be], pair_len), first_segment_end=lm)
                for c in range(0, ents.shape[0], be)
            ]
            m_out.append(torch.cat([m for m, _ in parts])[:n_e].float().cpu().numpy())
            e_out.append(torch.cat([e for _, e in parts])[:n_e].float().cpu().numpy())
        return np.stack(m_out), np.stack(e_out)


# --------------------------------------------------------------------- #
# on-disk format: the JAX package's pickle schema (reference
# run_cross_encoder_for_ment_ent_matrix_zeshel.py:230-240)
# --------------------------------------------------------------------- #


def save_score_matrix(
    path: str,
    ment_to_ent_scores: np.ndarray,
    mention_tokens_list: np.ndarray,
    entity_id_list: np.ndarray,
    entity_tokens_list: Optional[np.ndarray] = None,
    test_data: Any = None,
    arg_dict: Optional[Dict] = None,
) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as fout:
        pickle.dump(
            {
                "ment_to_ent_scores": np.asarray(ment_to_ent_scores),
                "test_data": test_data,
                "mention_tokens_list": np.asarray(mention_tokens_list),
                "entity_id_list": np.asarray(entity_id_list),
                "entity_tokens_list": None if entity_tokens_list is None else np.asarray(entity_tokens_list),
                "arg_dict": arg_dict or {},
            },
            fout,
        )


def load_score_matrix(path: str) -> Dict[str, Any]:
    with open(path, "rb") as fin:
        data = pickle.load(fin)
    # tolerate torch tensors in reference-produced pickles
    for key in ("ment_to_ent_scores", "mention_tokens_list", "entity_id_list", "entity_tokens_list"):
        val = data.get(key)
        if val is not None and hasattr(val, "numpy"):
            data[key] = val.numpy()
    return data
