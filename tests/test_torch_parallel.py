"""Port parity, the parallel layer (``anncur_tpu_torch/parallel``) on the
CPU over gloo: process ranges, meshes and TP specs against the JAX
package's; then groups of 2 and 3 ranks, each rank a process
(``tests/torch_parallel_worker.py``), against the one-process port and
the JAX package on the same numpy inputs (``BertSpec.tiny``):

- a data-parallel bi-encoder step with in-batch negatives (the world of
  ``tests/test_multihost.py``, dropout 0): its loss equals the JAX
  single-process step's, the ranks' parameters equal each other and the
  one-process port's, and a resume from rank 0's checkpoint continues the
  same run on every rank;
- a cross-encoder step with explicit negatives against the one-process
  port's;
- the towers tensor-parallel over 2 ranks against the replicated step, and
  a checkpoint of full parameters that JAX's ``load_pytree`` reads;
- the entity-sharded build and ``build_multihost`` against JAX's builder,
  and a spanning mesh refused;
- ``mips_topk_sharded`` over 2 and 3 ranks, with padding and equal scores
  planted across shards, against JAX's ``mips_topk`` (ties to the lowest
  global id);
- ``CurRetriever(mesh=)`` fixed, adaptive, escalating and shortlisted
  against the one-process port and JAX's retriever on a 2-device mesh;
- ``parallel/dryrun.py`` at 2 and 4 ranks (the latter with a 2 x 2 data x
  model step).

All groups start together when the module's fixture runs; every rank has
a process-group timeout and the parent a deadline, so a hung collective
fails the test instead of the run.
"""

import dataclasses
import glob
import json
import os
import pickle
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anncur_tpu.config import Config as JaxConfig
from anncur_tpu.data.synthetic import make_tokenized_world
from anncur_tpu.indexer.combine import combine_chunks as jax_combine_chunks
from anncur_tpu.indexer.score_matrix import ScoreMatrixBuilder as JaxBuilder
from anncur_tpu.models.bert import BertSpec as JaxBertSpec
from anncur_tpu.models.biencoder import BiEncoder as JaxBiEncoder
from anncur_tpu.models.crossencoder import CrossEncoder as JaxCrossEncoder
from anncur_tpu.ops.mips import mips_topk as jax_mips_topk
from anncur_tpu.parallel import make_mesh as jax_make_mesh
from anncur_tpu.parallel import multihost as jax_multihost
from anncur_tpu.parallel.tp import param_pspecs as jax_param_pspecs
from anncur_tpu.train.checkpoint import load_pytree as jax_load_pytree
from anncur_tpu.train.trainer import Trainer as JaxTrainer
from jax.sharding import PartitionSpec as P

from anncur_tpu_torch.config import Config
from anncur_tpu_torch.models.bert import BertSpec
from anncur_tpu_torch.models.convert import biencoder_from_jax_params, crossencoder_from_jax_params
from anncur_tpu_torch.parallel import dryrun, multihost, tp
from anncur_tpu_torch.parallel.dryrun import GRAD_RTOL, LOSS_RTOL, PARAM_ATOL, step
from anncur_tpu_torch.parallel.mesh import make_mesh, mesh_session
from anncur_tpu_torch.train import data as tdata
from anncur_tpu_torch.train.checkpoint import flat_paths
from anncur_tpu_torch.train.trainer import Trainer
from test_torch_retriever import _assert_same_topk, _build_both, world  # noqa: F401  (world: a fixture)

torch.set_num_threads(2)  # xdist runs several test files side by side

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_parallel_worker.py")
TIMEOUT_S = 150  # per group, from the fixture's start; the collectives time out at 120 s
L = 16
MIPS_TOL = 1e-6  # f32 dots of 16 terms in other orders, x the largest |score|


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)


class Group:
    """``n`` worker ranks on one job, started at once; :meth:`results`
    waits for them (killing all past the deadline) and loads each rank's
    results."""

    def __init__(self, tmp, name, n, jobs):
        self.dir, self.n = str(tmp / name), n
        os.makedirs(self.dir)
        job = os.path.join(self.dir, "job.pkl")
        with open(job, "wb") as fout:
            pickle.dump(jobs, fout)
        port = _free_port()
        self.procs = [self._spawn([sys.executable, WORKER, job, self.dir], r, port) for r in range(n)]
        self.deadline = time.time() + TIMEOUT_S
        self._results = None

    def _spawn(self, cmd, rank, port):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(self.n), LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1")
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        return subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def wait(self):
        logs = []
        try:
            for p in self.procs:
                logs.append(p.communicate(timeout=max(1.0, self.deadline - time.time()))[0])
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for p, log in zip(self.procs, logs):
            assert p.returncode == 0, f"rank failed:\n{log[-6000:]}"
        return logs

    def results(self):
        if self._results is None:
            self.wait()
            self._results = []
            for r in range(self.n):
                with open(os.path.join(self.dir, f"result_{r}.pkl"), "rb") as fin:
                    self._results.append(pickle.load(fin))
        return self._results


class Dryrun(Group):
    def __init__(self, tmp, name, n):
        self.dir, self.n = str(tmp / name), n
        cmd = [sys.executable, "-m", "anncur_tpu_torch.parallel.dryrun", "--nproc", str(n), "--device", "cpu", "--timeout", "120"]
        env = dict(os.environ, OMP_NUM_THREADS="1")
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        self.procs = [subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)]
        self.deadline = time.time() + TIMEOUT_S

    def summary(self):
        log = self.wait()[0]
        return json.loads(next(line for line in log.splitlines() if line.startswith('{"dryrun"')))["dryrun"]


# ---------------------------------------------------------------- jobs


def _dp_job():
    """tests/test_multihost.py's DP world at dropout 0: the JAX
    single-process step's loss and the starting parameters."""
    ment, ent, gt, tok = make_tokenized_world(seed=3, n_ents=24, n_ments=32, max_ment_len=L, max_ent_len=L)
    kw = dict(vocab_size=tok.vocab_size, hidden_size=32, num_layers=1, num_heads=2, intermediate_size=64,
              hidden_dropout=0.0, attention_dropout=0.0)
    # lr 1e-5, the dry run's (tests/test_multihost.py takes 5e-4): the
    # first step's loss does not depend on it
    cfg = dict(model_type="bi_enc", loss_type="ce", train_batch_size=16, grad_acc_steps=2, num_negs=3,
               neg_strategy="random", learning_rate=1e-5)
    enc = JaxBiEncoder(spec=JaxBertSpec.tiny(**kw), pooling_type="cls", embed_dim=32, compute_dtype=jnp.float32)
    trainer = JaxTrainer(JaxConfig(base_res_dir="/unused", **cfg), enc, total_steps=4)
    state = trainer.init_state()
    params = _np_tree(state.params)
    batch = {"input": np.asarray(ment[:16], np.int32), "pos": np.asarray(ent[gt[:16]], np.int32)}
    _, metrics = trainer.make_train_step()(state, trainer._shard_batch(batch))
    return dict(spec=kw, pooling="cls", config=cfg, params=params, batch=batch), float(metrics["loss"])


def _ce_job():
    ment, ent, gt, tok = make_tokenized_world(seed=5, n_ents=24, n_ments=16, max_ment_len=L, max_ent_len=L)
    data = tdata.EntLinkDataset(ment, ent, gt)
    kw = dict(vocab_size=tok.vocab_size, max_position_embeddings=64, hidden_dropout=0.0, attention_dropout=0.0,
              initializer_range=0.3)
    params = _np_tree(JaxCrossEncoder(spec=JaxBertSpec.tiny(**kw), cross_enc_type="w_embeds").init(jax.random.PRNGKey(2)))
    negs = tdata.mine_negatives(data, "random", 3, seed=0)
    batch = next(tdata.crossenc_batches(data, negs, 4, shuffle=False))
    cfg = dict(model_type="cross_enc", loss_type="ce", train_batch_size=4, grad_acc_steps=2, num_negs=3,
               cross_enc_type="w_embeds", learning_rate=1e-5)
    return dict(spec=kw, cross_enc_type="w_embeds", config=cfg, params=params, batch=batch)


def _tp_job():
    """tests/test_tp.py's TP world at dropout 0."""
    ment, ent, gt, tok = make_tokenized_world(seed=4, n_ents=16, n_ments=16, max_ment_len=L, max_ent_len=L)
    data = tdata.EntLinkDataset(ment, ent, gt)
    kw = dict(vocab_size=tok.vocab_size, hidden_size=64, num_heads=4, num_layers=1, intermediate_size=128,
              hidden_dropout=0.0, attention_dropout=0.0, max_position_embeddings=64)
    enc = JaxBiEncoder(spec=JaxBertSpec.tiny(**kw), pooling_type="cls", embed_dim=64, compute_dtype=jnp.float32)
    params = _np_tree(enc.init(jax.random.PRNGKey(0)))
    negs = tdata.mine_negatives(data, "random", 2, seed=0)
    batch = next(tdata.bienc_batches(data, negs, 8, shuffle=False))
    cfg = dict(model_type="bi_enc", loss_type="ce", num_negs=2, train_batch_size=8, grad_acc_steps=1,
               learning_rate=1e-5)
    return dict(spec=kw, pooling="cls", config=cfg, params=params, batch=batch)


def _build_job():
    """tests/test_multihost.py's build, and JAX's matrix on its 8 devices."""
    ment, ent, gt, tok = make_tokenized_world(seed=3, n_ents=24, n_ments=32, max_ment_len=L, max_ent_len=L)
    kw = dict(vocab_size=tok.vocab_size, max_position_embeddings=64)
    ce = JaxCrossEncoder(spec=JaxBertSpec.tiny(**kw), compute_dtype=jnp.float32)
    params = ce.init(jax.random.PRNGKey(0))
    want = JaxBuilder(ce, jax_make_mesh((8,), ("data",)), ment_block=4, ent_block=8, pair_pad_multiple=32)(
        params, ment[:10], ent)
    return dict(spec=kw, params=_np_tree(params), ment=np.asarray(ment[:10]), ent=np.asarray(ent)), want


def _mips_cases(n_dev, seed):
    """Items zero-padded to the mesh, the best row planted again in every
    shard (equal scores across shards), a k larger than a shard, and at 3
    ranks a valid count that leaves the last shard with no real row."""
    rng = np.random.default_rng(seed)
    common = rng.standard_normal(16).astype(np.float32)
    q = (common + 0.3 * rng.standard_normal((5, 16))).astype(np.float32)
    n_valid = 13
    items = rng.standard_normal((n_valid, 16)).astype(np.float32)
    shard = -(-n_valid // n_dev)
    best = 4.0 * common  # every query's best item
    twins = [1 + s * shard for s in range(n_dev) if 1 + s * shard < n_valid]
    items[twins] = best
    padded = np.zeros((shard * n_dev, 16), np.float32)
    padded[:n_valid] = items
    cases = [dict(queries=q, items=padded, k=k, n_valid=n_valid) for k in (4, shard + 2)]
    if n_dev == 3:
        cases.append(dict(queries=q, items=padded, k=6, n_valid=2 * shard - 1))
    return cases, twins


def _serve_job(world, tmp):  # noqa: F811
    """The tiny-CE retriever of tests/test_torch_retriever.py, its state
    file, 5 queries (one padded row on the second rank) and the calls."""
    ment, ent, tok, ce_j, params, ce_t, builder_j, builder_t = world
    r_j, r_t = _build_both(world)
    state = str(tmp / "state.pkl")
    r_t.save(state)
    calls = {
        "fixed": ("query_tokens_batch", dict(top_k=5, top_k_retvr=20)),
        "adaptive": ("query_tokens_adaptive_fused", dict(total_budget=12, n_rounds=3, top_k=5, return_stats=True)),
        "escalate": ("query_tokens_adaptive_fused", dict(total_budget=10, n_rounds=2, escalate_budget=18,
                                                         escalate_rounds=2, stability_overlap=1.01, top_k=5,
                                                         return_stats=True)),
        # per shard (3 rows): 3 + 3 x 3 + 3 = 15 <= 20, so the pool is on;
        # over the whole batch of 5 it would be dropped (21 > 20)
        "shortlist": ("query_tokens_adaptive_fused", dict(total_budget=9, n_rounds=3, top_k=5, shortlist=20)),
    }
    kw = dict(vocab_size=tok.vocab_size, max_position_embeddings=64, initializer_range=0.3)
    job = dict(spec=kw, params=_np_tree(params), state=state, vocab=tok.vocab, queries=np.asarray(ment[16:21]),
               calls=calls, new_items=np.asarray(ent[32:40]))
    return job, (r_j, r_t)


def _cli_train_job(tmp):
    """tests/test_torch_cli_train.py's bi-encoder world and config, for the
    train CLI run by every rank."""
    from anncur_tpu.data.synthetic import make_tokenizer, make_world, write_world_files

    root = tmp / "cli_world"
    root.mkdir()
    mentions, entities = make_world(np.random.default_rng(8), n_ents=30, n_ments=16)
    files = write_world_files(str(root), mentions, entities)
    make_tokenizer().save_vocab(str(root / "vocab.txt"))
    cfg = {
        "model_type": "bi_enc", "loss_type": "ce", "pooling_type": "cls", "embed_dim": 64, "num_epochs": 1,
        "train_batch_size": 8, "grad_acc_steps": 1, "max_input_len": L, "max_label_len": L,
        "bert_args": {"vocab_file": str(root / "vocab.txt")}, "fast_dev_run": 2, "save_code": False,
        "use_bf16": False, "print_interval": 1, "neg_strategy": "random", "num_negs": 2, "dev_files": {},
        "trn_files": {"synthville": {"ment_file": files["ment_file"], "ent_file": files["ent_file"]}},
        "base_res_dir": str(tmp / "cli_train"),
    }
    path = str(root / "config.json")
    with open(path, "w") as fout:
        json.dump(cfg, fout)
    return {"config": path}


@pytest.fixture(scope="module")
def runs(tmp_path_factory, world):  # noqa: F811
    """Every group of ranks, started together; the references they are
    held to, computed meanwhile."""
    tmp = tmp_path_factory.mktemp("parallel")
    dp_job, dp_jax_loss = _dp_job()
    build_job, build_want = _build_job()
    serve_job, retrievers = _serve_job(world, tmp)
    ce_job, tp_job = _ce_job(), _tp_job()
    cases2, twins2 = _mips_cases(2, 1)
    cases3, twins3 = _mips_cases(3, 2)
    groups = {
        "two": Group(tmp, "two", 2, [("misc", {}), ("cli_train", _cli_train_job(tmp)), ("dp", dp_job), ("ce", ce_job), ("tp", tp_job),
                                     ("build", build_job), ("mips", {"cases": cases2}), ("serve", serve_job)]),
        "three": Group(tmp, "three", 3, [("misc", {}), ("mips", {"cases": cases3})]),
        "dryrun2": Dryrun(tmp, "dryrun2", 2),
        "dryrun4": Dryrun(tmp, "dryrun4", 4),
    }
    refs = dict(dp_job=dp_job, dp_jax_loss=dp_jax_loss, build_job=build_job, build_want=build_want, ce_job=ce_job,
                tp_job=tp_job, serve_job=serve_job, retrievers=retrievers, mips={2: (cases2, twins2), 3: (cases3, twins3)})
    try:
        yield groups, refs, tmp
    finally:
        for g in groups.values():
            for p in g.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()


# ---------------------------------------------------------------- no ranks


def test_process_range_matches_jax():
    for n in range(0, 23):
        for n_proc in range(1, 7):
            got = [multihost.process_range(n, n_proc, p) for p in range(n_proc)]
            assert got == [jax_multihost.process_range(n, n_proc, p) for p in range(n_proc)]
            assert got[0][0] == 0 and got[-1][1] == n
            assert all(a[1] == b[0] for a, b in zip(got, got[1:]))


def test_make_mesh_raises_as_jax():
    """A shape over more ranks than the world raises with JAX's message
    (JAX counts the 8 CPU devices of the test platform, the port the ranks
    of its 1-rank group); the group is gone after the session."""
    import torch.distributed as dist

    with pytest.raises(ValueError, match=r"mesh shape \(9,\) needs 9 devices, have 8"):
        jax_make_mesh((9,), ("data",))
    with mesh_session("cpu") as mesh:
        assert mesh.shape == {"data": 1} and mesh.coords == {"data": 0} and mesh.device == torch.device("cpu")
        with pytest.raises(ValueError, match=r"mesh shape \(2,\) needs 2 devices, have 1"):
            make_mesh((2,), ("data",))
        with pytest.raises(ValueError, match="differ in length"):
            make_mesh((1,), ("data", "model"))
        m2 = make_mesh((1, 1), ("data", "model"))
        assert m2.axis_names == ("data", "model") and m2.size == 1
    assert not dist.is_initialized()


def test_param_pspecs_match_jax():
    """Every leaf's shard dim equals JAX's PartitionSpec on the same tree
    path (tests/test_tp.py::test_param_pspecs_rules), for both towers."""
    enc = JaxBiEncoder(spec=JaxBertSpec.tiny(), pooling_type="cls", embed_dim=64, compute_dtype=jnp.float32)
    params = enc.init(jax.random.PRNGKey(0))
    want = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(jax_param_pspecs(params), is_leaf=lambda x: isinstance(x, P))[0]:
        name = "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
        dims = [d for d, ax in enumerate(spec) if ax == "model"]
        want[name] = dims[0] if dims else None
    got = tp.param_pspecs(_np_tree(params))
    assert got == want
    assert got["input_bert/layers/0/attn/q_kernel"] == 1 and got["input_bert/layers/0/attn/out_kernel"] == 0
    assert got["input_bert/layers/0/mlp/in_bias"] == 0 and got["input_bert/embeddings/word"] is None
    port = biencoder_from_jax_params(_np_tree(params), BertSpec.tiny(), pooling_type="cls", embed_dim=64,
                                     device="cpu", dtype=torch.float32)
    assert tp.param_pspecs(port) == want


# ---------------------------------------------------------------- 2 and 3 ranks


def test_mesh_helpers_over_ranks(runs):
    """A mesh over fewer ranks than the world is refused; a CPU generator
    carries rank 0's state to every rank; shard_batch splits 7 rows 4 + 3;
    replicate takes rank 0's values."""
    groups = runs[0]
    for g in ("two", "three"):
        res = [r["misc"] for r in groups[g].results()]
        assert all("covers 1 of the" in r["fewer"] for r in res)
        want = torch.rand(4, generator=torch.Generator().manual_seed(7)).numpy()
        for r in res:
            np.testing.assert_array_equal(r["draws"], want)
            np.testing.assert_array_equal(r["replicated"], np.zeros(3))
        rows = np.concatenate([r["shard"] for r in res])
        np.testing.assert_array_equal(rows, np.arange(14).reshape(7, 2))
        assert [len(r["shard"]) for r in res] == [b - a for a, b in (multihost.process_range(7, len(res), p)
                                                                      for p in range(len(res)))]


def test_train_cli_over_ranks(runs):
    """The train CLI in a 2-rank world trains over the ranks' mesh: rank 0
    alone writes the config, the tracker's metrics and the checkpoint (which
    JAX's load_pytree reads); a --num_devices the world lacks is refused on
    every rank; the CLI leaves the launcher's group in place."""
    groups, _, tmp = runs
    res = [r["cli_train"] for r in groups["two"].results()]
    for r in res:
        assert "num_devices=3 needs 3 ranks, have 2" in r["refused"] and r["still_grouped"]
    configs = glob.glob(str(tmp / "cli_train" / "**" / "orig_config.json"), recursive=True)
    assert len(configs) == 1
    res_dir = os.path.dirname(configs[0])
    with open(os.path.join(res_dir, "metrics.jsonl")) as fin:
        losses = [r["train_loss"] for r in map(json.loads, fin) if "train_loss" in r]
    assert len(losses) == 2 and all(np.isfinite(losses))
    (ckpt,) = glob.glob(os.path.join(res_dir, "model", "eoe-*"))
    tree, _ = jax_load_pytree(ckpt)
    assert tree["step"] == 2 and np.shape(tree["params"]["input_bert"]["layers"][0]["attn"]["q_kernel"]) == (64, 64)


def _after_one_process(trainer, job):
    """(loss, params, moments) of the one-process port step on the job."""
    return step(trainer, job["batch"], job["params"])


def _compare(got, want, zero_grad):
    """Rank results (loss, numpy params, numpy moments) vs a reference
    step's, with the dry run's tolerances."""
    loss, params, mu = got
    ref_loss, ref_params, ref_mu = want
    assert loss == pytest.approx(ref_loss, rel=LOSS_RTOL)
    for n, t in ref_params.items():
        if not n.endswith(zero_grad):
            np.testing.assert_allclose(params[n], t.numpy(), rtol=0, atol=PARAM_ATOL, err_msg=n)
    scale = max(float(t.abs().max()) for t in ref_mu.values())
    for n, t in ref_mu.items():
        np.testing.assert_allclose(mu[n], t.numpy(), rtol=0, atol=GRAD_RTOL * scale, err_msg=n)


def test_dp_in_batch_step_matches_jax_and_one_process(runs):
    """The in-batch loss scores each rank's mentions against the positives
    of both ranks, so the 2-rank step is the JAX single-process step on the
    global micro-batch (not two local losses)."""
    groups, refs, _ = runs
    res = [r["dp"] for r in groups["two"].results()]
    job = refs["dp_job"]
    assert res[0]["local_rows"] == res[1]["local_rows"] == 4  # 8-row micro-batches over 2 ranks
    for r in res:
        assert r["loss"] == pytest.approx(refs["dp_jax_loss"], rel=LOSS_RTOL)
    for n in res[0]["after"]["params"]:
        np.testing.assert_array_equal(res[0]["after"]["params"][n], res[1]["after"]["params"][n])
    spec = BertSpec.tiny(**job["spec"])
    enc = biencoder_from_jax_params(job["params"], spec, pooling_type="cls", embed_dim=32, device="cpu",
                                    dtype=torch.float32)
    cfg = Config(base_res_dir=str(runs[2] / "dp_ref"), **job["config"])
    want = _after_one_process(Trainer(cfg, enc, total_steps=4), job)
    _compare((res[0]["loss"], res[0]["after"]["params"], res[0]["after"]["mu"]), want,
             ("attn/k_bias", "label_bert/layers/0/mlp/ln_bias"))
    # resume: rank 0's checkpoint, read by rank 0 and broadcast, continues
    # the run on both ranks
    for r in res:
        assert r["resume_epoch"] == 1
        assert r["resume_loss"] == pytest.approx(r["live_loss"], rel=1e-6)
        assert r["resume_loss"] == pytest.approx(res[0]["resume_loss"], rel=1e-6)


def test_ce_step_with_negatives_matches_one_process(runs):
    groups, refs, tmp = runs
    job = refs["ce_job"]
    res = [r["ce"] for r in groups["two"].results()]
    ce = crossencoder_from_jax_params(job["params"], BertSpec.tiny(**job["spec"]), "w_embeds", device="cpu",
                                      dtype=torch.float32)
    want = _after_one_process(Trainer(Config(base_res_dir=str(tmp / "ce_ref"), **job["config"]), ce, total_steps=4), job)
    for r in res:
        _compare((r["loss"], r["after"]["params"], r["after"]["mu"]), want, ("attn/k_bias",))


def test_tp_step_matches_replicated_and_checkpoints_full(runs):
    """tp=2: q/k/v and the MLP input split by columns, the outputs by rows;
    loss, updated parameters and moments equal the replicated step's; the
    checkpoint holds full parameters that JAX's load_pytree reads."""
    groups, refs, _ = runs
    res = [r["tp"] for r in groups["two"].results()]
    for r in res:
        ref_params = {n: torch.as_tensor(t) for n, t in r["ref_params"].items()}
        ref_mu = {n: torch.as_tensor(t) for n, t in r["ref_mu"].items()}
        _compare((r["loss"], r["params"], r["mu"]), (r["ref_loss"], ref_params, ref_mu), ("attn/k_bias",))
        shapes = r["local_shapes"]
        assert shapes["input_bert.layers.0.attn.q_kernel"] == (64, 32)
        assert shapes["input_bert.layers.0.attn.out_kernel"] == (32, 64)
        assert shapes["input_bert.layers.0.mlp.in_kernel"] == (64, 64)
        assert shapes["input_bert.embeddings.word"][1] == 64
    tree, meta = jax_load_pytree(os.path.join(res[0]["ckpt_dir"], "eoe-0-last.ckpt"))
    flat = flat_paths(tree["params"])
    want_shapes = {n: np.shape(v) for n, v in flat_paths(refs["tp_job"]["params"]).items()}
    assert {n: np.shape(v) for n, v in flat.items()} == want_shapes
    for n, v in flat.items():
        if not n.endswith("attn/k_bias"):
            np.testing.assert_allclose(v, res[0]["ref_params"][n], rtol=0, atol=PARAM_ATOL, err_msg=n)
    assert meta["step"] == 1 and tree["step"] == 1


def test_sharded_build_and_build_multihost_match_jax(runs):
    groups, refs, tmp = runs
    res = [r["build"] for r in groups["two"].results()]
    want = refs["build_want"]
    for r in res:
        np.testing.assert_allclose(r["scores"], want, rtol=1e-4, atol=1e-5)
        np.testing.assert_array_equal(r["resumed"], r["scores"])
        assert r["chunk_files"] == ["chunk_0.npz", "chunk_4.npz", "chunk_8.npz"]
        assert "process-LOCAL mesh" in r["refused"] and "1 remote devices" in r["refused"]
    np.testing.assert_allclose(res[0]["multihost"], want, rtol=1e-4, atol=1e-5)
    assert res[1]["multihost"] is None
    # JAX's combiner reads the port's per-process chunks
    mh = os.path.join(groups["two"].dir, "mh")
    np.testing.assert_allclose(jax_combine_chunks(os.path.join(mh, "proc0001"), n_ments=5), want[5:], rtol=1e-4,
                               atol=1e-5)
    assert json.load(open(os.path.join(mh, "proc0000", "_done.json"))) == {"row_start": 0, "row_end": 5}


@pytest.mark.parametrize("n_dev", [2, 3])
def test_mips_topk_sharded_matches_jax(runs, n_dev):
    """Ids equal JAX's mips_topk on the real items; the planted twins rank
    in global id order (each shard's twin ties the others')."""
    groups, refs, _ = runs
    cases, twins = refs["mips"][n_dev]
    res = groups["two" if n_dev == 2 else "three"].results()
    for c, case in enumerate(cases):
        s_j, i_j = jax_mips_topk(jnp.asarray(case["queries"]), jnp.asarray(case["items"][: case["n_valid"]]), case["k"])
        for r in res:
            s, i = r["mips"][c]
            np.testing.assert_array_equal(i, np.asarray(i_j))
            np.testing.assert_allclose(s, np.asarray(s_j), rtol=0, atol=MIPS_TOL * float(np.abs(s_j).max()))
        live = [t for t in twins if t < case["n_valid"]]
        np.testing.assert_array_equal(res[0]["mips"][c][1][:, : len(live)], np.tile(live, (5, 1)))


def _one_process_shortlist(r_t, queries, kw, n_dev=2):
    """The one-process port on each shard's rows as the mesh pads them
    (ceil(q / n_dev) rows, the last shard padded with zero tokens): the
    shortlist pool is built per shard, as JAX's is per device."""
    q = len(queries)
    per = -(-q // n_dev)
    padded = np.zeros((per * n_dev, queries.shape[1]), queries.dtype)
    padded[:q] = queries
    parts = [r_t.query_tokens_adaptive_fused(padded[c * per:(c + 1) * per], **kw) for c in range(n_dev)]
    return np.concatenate([p[0] for p in parts])[:q], np.concatenate([p[1] for p in parts])[:q]


def test_query_sharded_serving_matches_one_process_and_jax(runs, world):  # noqa: F811
    """Fixed, adaptive, escalating and shortlisted serving over 2 ranks, 5
    queries (the second shard padded): every rank returns the whole batch,
    equal to the one-process port and to JAX's retriever on a 2-device
    mesh; then add_items through an entity-sharded builder."""
    groups, refs, _ = runs
    job, (r_j, r_t) = refs["serve_job"], refs["retrievers"]
    res = [r["serve"] for r in groups["two"].results()]
    queries = job["queries"]
    mesh2 = jax_make_mesh((2,), ("data",), devices=jax.devices()[:2])
    r_j2 = dataclasses.replace(r_j, mesh=mesh2)
    for name, (method, kw) in job["calls"].items():
        want_j = getattr(r_j2, method)(queries, **kw)
        if name == "shortlist":
            want_t = _one_process_shortlist(r_t, queries, kw)
        else:
            want_t = getattr(r_t, method)(queries, **kw)
        for r in res:
            got = r[name]
            _assert_same_topk(got[0], got[1], want_t[0], want_t[1])
            _assert_same_topk(got[0], got[1], want_j[0], want_j[1])
            np.testing.assert_array_equal(got[1], res[0][name][1])
            if kw.get("return_stats"):
                assert got[2]["stable_frac"] == pytest.approx(want_t[2]["stable_frac"])
                assert got[2]["frac_escalated"] == pytest.approx(want_t[2]["frac_escalated"])
                assert got[2]["avg_budget"] >= kw["total_budget"]
    ids = r_t.add_items(job["new_items"], world[7])
    want = r_t.query_tokens_batch(queries, **job["calls"]["fixed"][1])
    for r in res:
        np.testing.assert_array_equal(r["added_ids"], ids)
        _assert_same_topk(r["after_add"][0], r["after_add"][1], want[0], want[1])


def test_dryrun_defaults_to_the_card_and_raises_without_one(monkeypatch):
    """With no ``--device`` the dry run asks for the card; where there is
    none it raises before any rank starts, never running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(dryrun, "launch", lambda *a: pytest.fail("a rank was started"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dryrun.main(["--nproc", "1"])


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun(runs, n):
    """parallel/dryrun.py to its end: every check of every rank held (the
    dp x tp step only at 4 ranks)."""
    summary = runs[0][f"dryrun{n}"].summary()
    assert summary["nproc"] == n and len(summary["ranks"]) == n
    for r in summary["ranks"]:
        assert {"dp_negs", "dp_in_batch", "build", "mips", "serve"} <= set(r)
        assert ("tp" in r) == (n == 4)
        if n == 4:
            assert r["tp"]["mesh"] == [2, 2]
