"""What the port's drivers share: the card's name, the synthetic serving
worlds (a seeded CE and CUR retriever over random item tokens, as the JAX
drivers build theirs), percentiles, the result file, and an in-process
``cli/serve.py --http`` server."""

from __future__ import annotations

import json
import os
import subprocess
import threading
import time
import urllib.request
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from anncur_tpu_torch.core.cur import build_cur
from anncur_tpu_torch.core.retriever import CurRetriever
from anncur_tpu_torch.models.bert import BertSpec
from anncur_tpu_torch.models.crossencoder import CrossEncoder
from anncur_tpu_torch.models.tokenizer import WordPieceTokenizer, make_realistic_vocab, make_test_vocab
from anncur_tpu_torch.train.checkpoint import save_pytree

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
RESULTS_DIR = os.path.join(CHECKOUT, "results", "torch")

# bench.py's serving cell (chip_smoke.py phase 4): 10,000 items of 128
# tokens, a seeded rank-16 train matrix of 500 anchor queries, 500 anchor
# items; TINY is its CPU-sized stand-in
BASE_WORLD = dict(n_items=10000, n_train=500, n_anchors=500, rank=16, seq_len=128)
TINY_WORLD = dict(n_items=600, n_train=40, n_anchors=32, rank=8, seq_len=16)


def card(device) -> str:
    """The card as ``nvidia-smi`` names it, with its power limit (a card
    set below 700 W runs slower under load), or the device type off the
    card."""
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()
        return out[device.index or 0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(device)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def make_encoder(tiny: bool, device, seed: int = 0) -> CrossEncoder:
    """bert-base in bf16 (the serving CE), or a tiny f32 one over the test
    vocabulary; random weights from ``seed``. Both keep bert's 512
    positions, which the serving CLI's architecture flags assume."""
    if tiny:
        spec = BertSpec.tiny(vocab_size=len(make_test_vocab()), max_position_embeddings=512)
        return CrossEncoder(spec, compute_dtype=torch.float32, device=device, seed=seed)
    return CrossEncoder(BertSpec(), compute_dtype=torch.bfloat16, device=device, seed=seed)


def world_tokenizer(vocab_size: int) -> WordPieceTokenizer:
    """A tokenizer of ``vocab_size`` entries, so that the serving CLI, which
    sizes its CE by the vocabulary file, loads the world's CE: the test
    vocabulary, or the bert-base-uncased layout (``make_realistic_vocab``,
    4,000 specials and characters, then words)."""
    test = make_test_vocab()
    return WordPieceTokenizer(test if vocab_size == len(test) else make_realistic_vocab(n_words=vocab_size - 4000))


def build_retriever(
    encoder: CrossEncoder, n_items: int, n_train: int, n_anchors: int, rank: int, seq_len: int, seed: int = 0,
) -> Tuple[CurRetriever, np.ndarray, np.random.Generator]:
    """A CUR retriever over ``n_items`` random item token rows and a seeded
    rank-``rank`` train matrix of ``n_train`` anchor queries (their random
    tokens and U kept, so ``add_items`` works). Returns (retriever, the
    train matrix, the generator, for the caller's queries)."""
    rng = np.random.default_rng(seed)
    vocab = encoder.spec.vocab_size
    item_toks = rng.integers(1, vocab, size=(n_items, seq_len)).astype(np.int32)
    train = (rng.standard_normal((n_train, rank)) @ rng.standard_normal((rank, n_items))).astype(np.float32)
    anchors = np.asarray(sorted(rng.choice(n_items, n_anchors, replace=False)))
    index, u = build_cur(
        rows=train, cols=train[:, anchors], row_idxs=np.arange(n_train), col_idxs=anchors,
        approx_preference="rows", validate=False, return_u=True, device=encoder.device,
    )
    train_q = rng.integers(1, vocab, size=(n_train, seq_len)).astype(np.int32)
    retriever = CurRetriever(
        encoder=encoder, tokenizer=world_tokenizer(vocab), item_tokens=item_toks, index=index,
        anchor_item_ids=anchors, max_query_len=seq_len, target_pairs_per_step=4096, train_query_tokens=train_q,
        u=u.cpu().numpy(), device=encoder.device,
    )
    return retriever, train, rng


def percentiles(xs: Sequence[float], ps=(50, 95, 99)) -> Dict[str, float]:
    arr = np.asarray(xs, np.float64)
    out = {f"p{p}": float(np.percentile(arr, p)) for p in ps}
    out["max"] = float(arr.max())
    return out


def write_json(path: str, obj) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as fout:
        json.dump(obj, fout, indent=1)
    print("wrote", path, flush=True)


def served_files(retriever: CurRetriever, root: str) -> Dict[str, str]:
    """The files ``cli/serve.py`` reads for ``retriever``: its state, its
    CE's weights and its tokenizer's vocabulary, written under ``root``."""
    os.makedirs(root, exist_ok=True)
    files = {k: os.path.join(root, name) for k, name in
             (("index", "retr_state.pkl"), ("crossenc_ckpt", "ce.pkl"), ("vocab_file", "vocab.txt"))}
    retriever.save(files["index"])
    save_pytree(files["crossenc_ckpt"], {"params": retriever.encoder.params_tree()})
    retriever.tokenizer.save_vocab(files["vocab_file"])
    return files


def serve_argv(files: Dict[str, str], encoder: CrossEncoder, device) -> List[str]:
    """``cli/serve.py`` flags for the files of :func:`served_files`: the
    CE's widths and compute dtype, the device."""
    spec = encoder.spec
    return ["--index", files["index"], "--vocab_file", files["vocab_file"], "--crossenc_ckpt", files["crossenc_ckpt"],
            "--hidden_size", str(spec.hidden_size), "--num_layers", str(spec.num_layers),
            "--num_heads", str(spec.num_heads), "--intermediate_size", str(spec.intermediate_size),
            "--compute_dtype", "f32" if encoder.compute_dtype == torch.float32 else "bf16",
            "--device", str(torch.device(device))]


class Server:
    """``cli/serve.py``'s ``main(argv + ['--http', '127.0.0.1:0'])`` in a
    thread of this process. ``.server`` is its live server (``cli/serve.py``
    hangs its retriever and device lock on it), ``.base`` its URL."""

    def __init__(self, argv: List[str], timeout_s: float = 300.0):
        from anncur_tpu_torch.cli import serve

        self.error: Optional[BaseException] = None
        serve._serve_http.last_server = None

        def run():
            try:
                serve.main(argv + ["--http", "127.0.0.1:0"])
            except BaseException as e:  # noqa: BLE001 — reported through close() and __init__
                self.error = e

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()
        deadline = time.time() + timeout_s
        while serve._serve_http.last_server is None and self.thread.is_alive() and time.time() < deadline:
            time.sleep(0.05)
        self.server = serve._serve_http.last_server
        if self.server is None:
            raise RuntimeError(f"the HTTP server did not come up: {self.error!r}")
        self.base = "http://127.0.0.1:%d" % self.server.server_address[1]

    def close(self) -> None:
        self.server.shutdown()
        self.thread.join(timeout=60)
        if self.thread.is_alive():
            raise RuntimeError("the HTTP server did not stop")
        if self.error is not None:
            raise RuntimeError(f"the HTTP server raised: {self.error!r}")


def http_call(base: str, path: str, payload=None, timeout: float = 600):
    """(status, JSON body) of one GET (no payload) or POST."""
    req = urllib.request.Request(
        base + path,
        data=None if payload is None else json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
        method="GET" if payload is None else "POST",
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())
