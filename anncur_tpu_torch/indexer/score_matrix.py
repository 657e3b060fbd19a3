"""Offline index build: the (n_ment x n_ent) exact cross-encoder score
matrix, on one GPU.

Counterpart of ``anncur_tpu/indexer/score_matrix.py`` without the mesh
and the multi-host build:

- pairs are built on the device (mention ⧺ entity[1:], reference
  semantics utils/data_process.py:949-959), padded to a multiple of
  ``min(pair_pad_multiple, max_position_embeddings)``,
- each CE forward scores ``ment_block`` x ``ent_block`` pairs; entities
  are processed in slabs of at most ``max_pairs_per_program`` pairs per
  mention block, each slab copied to the host once,
- mention blocks checkpoint to disk as ``chunk_<start>.npz`` files that
  the JAX builder reads and writes too (resume: existing chunks are
  loaded, not recomputed), under a ``ChunkDirLock``.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import pickle
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from anncur_tpu_torch.models.crossencoder import CrossEncoder
from anncur_tpu_torch.utils.device import DeviceLike, resolve_device

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
    """Exact score matrix on one device.

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

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.encoder.device != self.device:
            raise ValueError(
                f"encoder lives on {self.encoder.device}, builder on {self.device}"
            )

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
        """The full (n_m, n_e) float32 score matrix on the host.

        With ``chunk_dir``, every ``chunk_rows`` (rounded up to whole
        mention blocks) mention rows are written as ``chunk_<start>.npz``;
        existing chunks are loaded instead of recomputed."""
        ment_tokens = np.asarray(ment_tokens)
        ent_tokens = np.asarray(ent_tokens)
        n_m, lm = ment_tokens.shape
        n_e, le = ent_tokens.shape
        bm, be = self.ment_block, self.ent_block
        pair_len = padded_pair_len(
            lm, le, self.pair_pad_multiple, self.encoder.spec.max_position_embeddings
        )
        # entity slabs: bounded pairs per slab, capped at the padded corpus
        n_e_base = n_e + (-n_e) % be
        slab = min(max(1, self.max_pairs_per_program // (bm * be)) * be, n_e_base)
        n_e_pad = n_e_base + (-n_e_base) % slab
        ents = torch.zeros((n_e_pad, le), dtype=torch.int32, device=self.device)
        ents[:n_e] = torch.as_tensor(ent_tokens, dtype=torch.int32, device=self.device)

        out = np.zeros((n_m, n_e), np.float32)
        t0 = time.time()
        chunk_start, chunk_buf = 0, []
        lock = ChunkDirLock(chunk_dir) if chunk_dir is not None else None

        def flush_chunk():
            nonlocal chunk_start, chunk_buf
            if chunk_buf:
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
                    if os.path.exists(cpath):
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
                    scores = self._score_block(block, ents[c0 : c0 + slab], lm, pair_len)
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
