"""Multi-rank dry run of the parallel layer.

    python -m anncur_tpu_torch.parallel.dryrun --nproc N [--device cuda|cpu] [--timeout S]

Spawns N ranks (NCCL on the cards, one rank per card, the default; a dry
run on the CPU over gloo must be asked for with ``--device cpu``, and
without a card the default raises instead of moving to the CPU) and
runs, at ``BertSpec.tiny`` sizes, the steps of the JAX package's
``__graft_entry__.py::dryrun_multichip`` with the port, each held against
the same call without a mesh on the same rank:

(a) a data-parallel bi-encoder step over a 1-D mesh, with explicit and
    with in-batch negatives; (a2) at N >= 4 (even), a (N/2 x 2)
    data x model step with the towers tensor-parallel, against the same
    mesh without tensor parallelism (loss and updated parameters);
(b) the entity-sharded score-matrix build, ``build_multihost``,
    ``mips_topk_sharded`` and ``DenseIndex(mesh=)``;
(c) query-sharded serving: the fixed path, the adaptive engine, its
    early-stop escalation and its shortlist; (c2) ``add_items`` through
    the entity-sharded builder, then a query.

Every rank writes its measurements; the parent prints one JSON line and
exits non-zero if a rank fails, disagrees or outlives ``--timeout``.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5  # updated parameters after one Adam step at lr 1e-5 (tests/test_torch_train.py)
# first moments (0.1 x the clipped gradient), x their max over the tree:
# splitting a micro-batch over ranks sums the gradient in other orders, and
# the embedding leaves are sums of many cancelling terms (splitting one
# micro-batch in two moves them by ~5e-5 of the tree max with no
# collective at all; the in-batch loss, ~8e-4)
GRAD_RTOL = 2e-3
SCORE_ATOL = 1e-4  # CE scores on other batch compositions
GAP = 1e-4  # ids compared where neighbouring scores differ by more
# leaves whose gradient is 0 in exact arithmetic, so Adam follows the sign
# of the rounding noise there: the keys' bias under every softmax, and the
# label tower's last LayerNorm bias (the "cls" label embedding itself, so
# it shifts every score of a row alike)
ZERO_GRAD_LEAVES = ("attn/k_bias", "label_bert/layers/1/mlp/ln_bias")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _same_topk(s, i, s_ref, i_ref, what):
    """Scores within SCORE_ATOL and ids equal wherever the reference's
    neighbours are more than GAP apart; raises otherwise."""
    s, i, s_ref, i_ref = (np.asarray(x) for x in (s, i, s_ref, i_ref))
    if s.shape != s_ref.shape or not np.allclose(s, s_ref, rtol=0, atol=SCORE_ATOL):
        raise AssertionError(f"{what}: scores differ by {np.abs(s - s_ref).max() if s.shape == s_ref.shape else s.shape}")
    gaps = -np.diff(s_ref, axis=1)
    sep = np.ones(s_ref.shape, bool)
    sep[:, :-1] &= gaps > GAP
    sep[:, 1:] &= gaps > GAP
    if not np.array_equal(i[sep], i_ref[sep]):
        raise AssertionError(f"{what}: ids differ")
    return float(np.abs(s - s_ref).max())


def compare_steps(got, want, what, zero_grad_leaves=ZERO_GRAD_LEAVES):
    """The losses, the largest |difference| of the updated parameters but
    at the zero-gradient leaves, and of the first moments over their
    largest value, of two :func:`step` results (the ``BertSpec.tiny``
    towers of :func:`run_checks` by default); raises past the tolerances."""
    (loss, params, mu), (ref_loss, ref_params, ref_mu) = got, want
    p_diff = max(float((params[n] - ref_params[n]).abs().max()) for n in ref_params if not n.endswith(zero_grad_leaves))
    scale = max(float(t.abs().max()) for t in ref_mu.values())
    g_diff = max(float((mu[n] - ref_mu[n]).abs().max()) for n in ref_mu) / scale
    if not (np.isfinite(loss) and abs(loss - ref_loss) <= LOSS_RTOL * abs(ref_loss)
            and p_diff <= PARAM_ATOL and g_diff <= GRAD_RTOL):
        raise AssertionError(f"{what}: loss {loss} vs {ref_loss}, params differ by {p_diff}, moments by {g_diff}")
    return {"loss": loss, "reference_loss": ref_loss, "param_diff": p_diff, "moment_rel_diff": g_diff}


def step(trainer, batch, params):
    """(loss, full parameters, full first moments) of one step from
    ``params`` (JAX layout) over the global ``batch``."""
    from anncur_tpu_torch.parallel import tp as tp_mod

    state = trainer.init_state(params)
    loss = float(trainer.train_step(state, trainer._shard_batch(batch))["loss"])
    params, mu = dict(state.params), dict(state.opt_state["mu"])
    if trainer._specs is not None:
        params, mu = (tp_mod.gather_full(t, trainer._specs, trainer.mesh, trainer.tp_axis) for t in (params, mu))
    return loss, {n: t.detach().clone() for n, t in params.items()}, {n: t.clone() for n, t in mu.items()}


def run_checks(n: int, device, res_dir: str) -> dict:
    """Steps (a) to (c2) on this rank; a dict of what was measured.
    ``res_dir`` is shared by the ranks (chunk files)."""
    import torch
    import torch.distributed as dist

    from anncur_tpu_torch.config import Config
    from anncur_tpu_torch.core.cur import build_cur
    from anncur_tpu_torch.core.retriever import CurRetriever
    from anncur_tpu_torch.data.synthetic import make_tokenized_world
    from anncur_tpu_torch.indexer.score_matrix import ScoreMatrixBuilder
    from anncur_tpu_torch.models.bert import BertSpec
    from anncur_tpu_torch.models.biencoder import BiEncoder, init_biencoder_params
    from anncur_tpu_torch.models.crossencoder import CrossEncoder
    from anncur_tpu_torch.ops.dense_index import DenseIndex
    from anncur_tpu_torch.ops.mips import mips_topk_sharded
    from anncur_tpu_torch.ops.mips_kernel import mips_topk_fused
    from anncur_tpu_torch.ops.pinv import pinv_f64
    from anncur_tpu_torch.parallel.mesh import make_mesh
    from anncur_tpu_torch.train.data import EntLinkDataset, bienc_batches, mine_negatives
    from anncur_tpu_torch.train.trainer import Trainer

    out = {}
    mesh = make_mesh((n,), ("data",), device)
    ment, ent, gt, tok = make_tokenized_world(seed=0, n_ents=48, n_ments=max(16, 4 * n), max_ment_len=16,
                                              max_ent_len=16)
    data = EntLinkDataset(ment, ent, gt)
    spec = BertSpec.tiny(vocab_size=tok.vocab_size, max_position_embeddings=64, hidden_dropout=0.0,
                         attention_dropout=0.0)

    # (a) data-parallel steps, explicit and in-batch negatives
    params = init_biencoder_params(np.random.default_rng(0), spec, "separate", False, spec.hidden_size)
    negs = mine_negatives(data, "random", 2, seed=0)

    def trainer(m, tp_axis=None, **kw):
        cfg = Config(model_type="bi_enc", loss_type="ce", num_negs=2, base_res_dir=os.path.join(res_dir, "a"),
                     learning_rate=1e-5, **kw)
        enc = BiEncoder(spec, pooling_type="cls", embed_dim=spec.hidden_size, compute_dtype=torch.float32,
                        device=device, params=params)
        return Trainer(cfg, enc, mesh=m, total_steps=4, tp_axis=tp_axis)

    for name, batch in (
        ("dp_negs", next(bienc_batches(data, negs, 4 * n, shuffle=False))),
        ("dp_in_batch", {k: v for k, v in next(bienc_batches(data, negs, 4 * n, shuffle=False)).items()
                         if k in ("input", "pos")}),
    ):
        got = step(trainer(mesh, train_batch_size=4 * n, grad_acc_steps=2), batch, params)
        want = step(trainer(None, train_batch_size=4 * n, grad_acc_steps=2), batch, params)
        out[name] = compare_steps(got, want, name)

    # (a2) dp x tp against the same mesh without tensor parallelism
    if n >= 4 and n % 2 == 0:
        mesh2 = make_mesh((n // 2, 2), ("data", "model"), device)
        batch = next(bienc_batches(data, negs, n, shuffle=False))
        got = step(trainer(mesh2, "model", train_batch_size=n, grad_acc_steps=1), batch, params)
        want = step(trainer(mesh2, train_batch_size=n, grad_acc_steps=1), batch, params)
        out["tp"] = dict(compare_steps(got, want, "tp"), mesh=[n // 2, 2])

    # (b) entity-sharded build, build_multihost, sharded MIPS, DenseIndex
    ce_spec = BertSpec.tiny(vocab_size=tok.vocab_size, max_position_embeddings=64, initializer_range=0.3)
    ce = CrossEncoder(ce_spec, compute_dtype=torch.float32, device=device, seed=1)
    blocks = dict(ment_block=2, ent_block=4, pair_pad_multiple=32, device=device)
    builder = ScoreMatrixBuilder(ce, mesh=mesh, **blocks)
    local = ScoreMatrixBuilder(ce, **blocks)
    want = local(ment[:3], ent)
    got = builder(ment[:3], ent, chunk_dir=os.path.join(res_dir, "chunks"), chunk_rows=2)
    err = float(np.abs(got - want).max())
    mh = local.build_multihost(ment[:5], ent, os.path.join(res_dir, "mh"), chunk_rows=2)
    mh_err = 0.0 if mh is None else float(np.abs(mh - local(ment[:5], ent)).max())
    if not (err <= 1e-5 and mh_err <= 1e-5):
        raise AssertionError(f"sharded build differs by {err}, build_multihost by {mh_err}")
    out["build"] = {"max_abs_err": err, "multihost_max_abs_err": mh_err}

    gen = np.random.default_rng(1)
    q = torch.as_tensor(gen.standard_normal((4, 32)), dtype=torch.float32, device=device)
    items = torch.as_tensor(gen.standard_normal((n * 8, 32)), dtype=torch.float32, device=device)
    s, i = mips_topk_sharded(q, items, 5, mesh)
    s_ref, i_ref = mips_topk_fused(q, items, 5)
    index = DenseIndex(items[:-3].cpu().numpy(), mesh=mesh, device=device)
    si, ii = index.search(q.cpu().numpy(), 5)
    s_ref3, i_ref3 = mips_topk_fused(q, items[:-3].contiguous(), 5)
    if not (torch.equal(i, i_ref) and torch.allclose(s, s_ref) and np.array_equal(ii, i_ref3.cpu().numpy())):
        raise AssertionError("sharded MIPS disagrees with the one-device kernel")
    out["mips"] = {"max_abs_err": max(float((s - s_ref).abs().max()), float(np.abs(si - s_ref3.cpu().numpy()).max()))}

    # (c) query-sharded serving against the same retriever without a mesh
    rng = np.random.default_rng(3)
    n_items, n_train, k_i = ent.shape[0], 6, 4
    train = rng.standard_normal((n_train, n_items)).astype(np.float32)
    anchors = np.asarray(sorted(rng.choice(n_items, k_i, replace=False)))

    def retriever(m, n_it=n_items, anc=anchors, **kw):
        index = build_cur(rows=train[:, :n_it], cols=train[:, anc], row_idxs=np.arange(n_train), col_idxs=anc,
                          approx_preference="rows", validate=False, device=device)
        return CurRetriever(encoder=ce, tokenizer=tok, item_tokens=np.asarray(ent[:n_it]), index=index,
                            anchor_item_ids=anc, max_query_len=ment.shape[1], mesh=m, device=device, **kw)

    r, r1 = retriever(mesh), retriever(None)
    qs = np.asarray(ment[: n + 1])  # one more query than ranks: a padded shard
    calls = {
        "fixed": lambda x: x.query_tokens_batch(qs, top_k=3, top_k_retvr=6),
        "adaptive": lambda x: x.query_tokens_adaptive_fused(qs, total_budget=6, n_rounds=2, top_k=3, train_scores=train),
        "escalate": lambda x: x.query_tokens_adaptive_fused(
            qs, total_budget=6, n_rounds=2, top_k=3, train_scores=train, escalate_budget=10, escalate_rounds=2),
    }
    out["serve"] = {k: _same_topk(*call(r), *call(r1), k) for k, call in calls.items()}
    # shortlist pools are per shard (as JAX's per device): equal at n = 1
    sl = r.query_tokens_adaptive_fused(qs, total_budget=6, n_rounds=3, top_k=3, train_scores=train, shortlist=16)
    if sl[0].shape != (n + 1, 3) or not np.isfinite(sl[0]).all():
        raise AssertionError("shortlist serving returned a bad result")
    if n == 1:
        _same_topk(*sl, *r1.query_tokens_adaptive_fused(qs, total_budget=6, n_rounds=3, top_k=3,
                                                        train_scores=train, shortlist=16), "shortlist")

    # (c2) add_items through the entity-sharded builder, then a query
    anchors2 = np.asarray(sorted(rng.choice(n_items - 2, k_i, replace=False)))
    u = np.asarray(pinv_f64(train[:, anchors2]))
    grown = []
    for m, b in ((mesh, builder), (None, local)):
        r2 = retriever(m, n_items - 2, anchors2, train_query_tokens=np.asarray(ment[:n_train]), u=u)
        r2.add_items(np.asarray(ent[n_items - 2:]), b)
        grown.append(r2.query_tokens_batch(qs, top_k=3, top_k_retvr=6))
    out["serve"]["add_items"] = _same_topk(*grown[0], *grown[1], "add_items")
    dist.barrier()
    return out


def worker(args) -> None:
    import torch

    torch.set_num_threads(1)
    from anncur_tpu_torch.parallel.multihost import init_distributed

    device = init_distributed(args.device, timeout_s=args.timeout)
    import torch.distributed as dist

    rank = dist.get_rank()
    t0 = time.perf_counter()
    out = run_checks(dist.get_world_size(), device, os.path.join(args.out, "shared"))
    out["seconds"] = time.perf_counter() - t0
    with open(os.path.join(args.out, f"rank{rank}.json"), "w") as fout:
        json.dump(out, fout)
    dist.destroy_process_group()


def launch(nproc: int, device: str, timeout: float, out_dir: str) -> dict:
    """Run ``nproc`` workers to the end; the summary of their results.
    Raises when a worker fails or outlives ``timeout`` (it is killed)."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    port = _free_port()
    procs = []
    for rank in range(nproc):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(nproc), LOCAL_RANK=str(rank if device == "cuda" else 0),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), OMP_NUM_THREADS="1")
        env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
        cmd = [sys.executable, "-m", "anncur_tpu_torch.parallel.dryrun", "--worker", "--device", device,
               "--timeout", str(timeout), "--out", out_dir]
        procs.append(subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    deadline = time.time() + timeout
    logs, failed = [], []
    try:
        for rank, p in enumerate(procs):
            try:
                log, _ = p.communicate(timeout=max(1.0, deadline - time.time()))
            except subprocess.TimeoutExpired:
                failed.append(f"rank {rank} timed out after {timeout} s")
                break
            logs.append(log)
            if p.returncode != 0:
                failed.append(f"rank {rank} exited {p.returncode}:\n{log[-4000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if failed:
        raise RuntimeError("\n".join(failed))
    ranks = []
    for rank in range(nproc):
        with open(os.path.join(out_dir, f"rank{rank}.json")) as fin:
            ranks.append(json.load(fin))
    return {"nproc": nproc, "device": device, "ranks": ranks}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--nproc", type=int, default=2)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--timeout", type=float, default=300.0, help="seconds for the whole run and for each collective")
    p.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--out", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.worker:
        worker(args)
        return 0
    if args.device == "cuda":
        from anncur_tpu_torch.utils.device import resolve_device

        resolve_device("cuda")  # no card: raises, never a quiet run on the CPU
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out_dir:
        try:
            summary = launch(args.nproc, args.device, args.timeout, out_dir)
        except RuntimeError as err:
            print(f"dryrun failed: {err}", file=sys.stderr, flush=True)
            return 1
    summary["seconds"] = time.perf_counter() - t0
    print(json.dumps({"dryrun": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
