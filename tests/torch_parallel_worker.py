"""One rank of the multi-rank tests of the port's parallel layer
(``tests/test_torch_parallel.py``): gloo over localhost, one CPU process
per rank, at ``BertSpec.tiny`` sizes.

    python tests/torch_parallel_worker.py JOB.pkl OUT_DIR

with ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT`` set as
``torchrun`` sets them. ``JOB.pkl`` holds the sections to run and their
inputs (numpy only, made by the parent from the JAX package); every rank
runs the same sections in the same order and writes what it measured to
``OUT_DIR/result_<rank>.pkl``. Imports nothing of JAX.
"""

import os
import pickle
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
torch.set_num_threads(1)

import torch.distributed as dist  # noqa: E402

from anncur_tpu_torch.config import Config  # noqa: E402
from anncur_tpu_torch.core.retriever import CurRetriever  # noqa: E402
from anncur_tpu_torch.indexer.score_matrix import ScoreMatrixBuilder  # noqa: E402
from anncur_tpu_torch.models.bert import BertSpec  # noqa: E402
from anncur_tpu_torch.models.convert import biencoder_from_jax_params, crossencoder_from_jax_params  # noqa: E402
from anncur_tpu_torch.models.tokenizer import WordPieceTokenizer  # noqa: E402
from anncur_tpu_torch.ops.mips import mips_topk_sharded  # noqa: E402
from anncur_tpu_torch.parallel.dryrun import step  # noqa: E402
from anncur_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from anncur_tpu_torch.parallel.multihost import barrier, init_distributed, replicate_from_host  # noqa: E402
from anncur_tpu_torch.train.trainer import Trainer  # noqa: E402

CPU = torch.device("cpu")


def _numpy(tensors):
    return {n: t.detach().cpu().numpy().copy() for n, t in tensors.items()}


def bienc(job, params):
    spec = BertSpec.tiny(**job["spec"])
    return biencoder_from_jax_params(params, spec, pooling_type=job["pooling"], embed_dim=spec.hidden_size,
                                     device="cpu", dtype=torch.float32)


def section_dp(job, mesh, out_dir):
    """Data-parallel bi-encoder step (in-batch negatives) from the JAX
    parameters, then the resume leg: rank 0 writes the end-of-epoch
    checkpoint, a second Trainer resumes from it on every rank, and both
    take the next step on the same batch."""
    cfg = Config(base_res_dir=os.path.join(out_dir, "dp"), **job["config"])
    trainer = Trainer(cfg, bienc(job, job["params"]), mesh=mesh, total_steps=4)
    state = trainer.init_state(job["params"])
    batch = trainer._shard_batch(job["batch"])
    loss = float(trainer.train_step(state, batch)["loss"])
    after = {"params": _numpy(state.params), "mu": _numpy(state.opt_state["mu"])}
    trainer._save(trainer._ckpt.save_end_of_epoch, state, 0, state.step)
    live_loss = float(trainer.train_step(state, batch)["loss"])
    resumed = Trainer(cfg, bienc(job, job["params"]), mesh=mesh, total_steps=4)
    state2 = resumed.init_state(job["params"])
    epoch = resumed._resume(state2)
    resume_loss = float(resumed.train_step(state2, resumed._shard_batch(job["batch"]))["loss"])
    return dict(loss=loss, after=after, live_loss=live_loss, resume_loss=resume_loss, resume_epoch=epoch,
                local_rows=int(batch["input"].shape[1]))


def section_ce(job, mesh, out_dir):
    """Cross-encoder step with explicit negatives."""
    spec = BertSpec.tiny(**job["spec"])
    ce = crossencoder_from_jax_params(job["params"], spec, job["cross_enc_type"], device="cpu", dtype=torch.float32)
    trainer = Trainer(Config(base_res_dir=os.path.join(out_dir, "ce"), **job["config"]), ce, mesh=mesh, total_steps=4)
    loss, params, mu = step(trainer, job["batch"], job["params"])
    return dict(loss=loss, after={"params": _numpy(params), "mu": _numpy(mu)})


def section_tp(job, mesh, out_dir):
    """The towers tensor-parallel over a (1, world) data x model mesh,
    against the replicated step on this rank; rank 0 writes the TP
    trainer's checkpoint (the full parameters)."""
    n = dist.get_world_size()
    mesh2 = make_mesh((1, n), ("data", "model"))
    cfg = Config(base_res_dir=os.path.join(out_dir, "tp"), **job["config"])
    tp_trainer = Trainer(cfg, bienc(job, job["params"]), mesh=mesh2, total_steps=10, tp_axis="model")
    got = step(tp_trainer, job["batch"], job["params"])
    ref = step(Trainer(cfg, bienc(job, job["params"]), total_steps=10), job["batch"], job["params"])
    local_shapes = {n_: tuple(p.shape) for n_, p in tp_trainer.model.named_parameters()}
    state = tp_trainer.init_state(job["params"])
    tp_trainer.train_step(state, tp_trainer._shard_batch(job["batch"]))
    tp_trainer._save(tp_trainer._ckpt.save_end_of_epoch, state, 0, state.step)
    return dict(
        loss=got[0], ref_loss=ref[0], params=_numpy(got[1]), ref_params=_numpy(ref[1]), mu=_numpy(got[2]),
        ref_mu=_numpy(ref[2]), local_shapes=local_shapes, ckpt_dir=tp_trainer._ckpt.ckpt_dir,
    )


def section_build(job, mesh, out_dir):
    """Entity-sharded build (with chunk files, then resumed from them),
    build_multihost with a process-local builder, and a spanning mesh
    refused by build_multihost."""
    spec = BertSpec.tiny(**job["spec"])
    ce = crossencoder_from_jax_params(job["params"], spec, device="cpu", dtype=torch.float32)
    blocks = dict(ment_block=4, ent_block=8, pair_pad_multiple=32, device="cpu")
    sharded = ScoreMatrixBuilder(ce, mesh=mesh, **blocks)
    chunks = os.path.join(out_dir, "sharded_chunks")
    scores = sharded(job["ment"], job["ent"], chunk_dir=chunks, chunk_rows=4)
    resumed = sharded(job["ment"], job["ent"], chunk_dir=chunks, chunk_rows=4)
    mh = ScoreMatrixBuilder(ce, **blocks).build_multihost(job["ment"], job["ent"], os.path.join(out_dir, "mh"), chunk_rows=4)
    try:
        sharded.build_multihost(job["ment"], job["ent"], os.path.join(out_dir, "refused"))
        refused = None
    except ValueError as err:
        refused = str(err)
    barrier("build")
    return dict(scores=scores, resumed=resumed, multihost=mh, refused=refused, chunk_files=sorted(os.listdir(chunks)))


def section_mips(job, mesh, out_dir):
    out = []
    for case in job["cases"]:
        s, i = mips_topk_sharded(torch.as_tensor(case["queries"]), torch.as_tensor(case["items"]), case["k"], mesh,
                                 n_valid=case["n_valid"])
        out.append((s.numpy(), i.numpy()))
    return out


def section_serve(job, mesh, out_dir):
    """The retriever of the job's state file, query-sharded over the mesh:
    each call of the job, then add_items through an entity-sharded
    builder and a fixed query."""
    spec = BertSpec.tiny(**job["spec"])
    ce = crossencoder_from_jax_params(job["params"], spec, device="cpu", dtype=torch.float32)
    r = CurRetriever.load(job["state"], ce, WordPieceTokenizer(job["vocab"]), mesh=mesh, device="cpu")
    out = {name: getattr(r, method)(job["queries"], **kw) for name, (method, kw) in job["calls"].items()}
    builder = ScoreMatrixBuilder(ce, mesh=mesh, ment_block=4, ent_block=8, pair_pad_multiple=32, device="cpu")
    out["added_ids"] = r.add_items(job["new_items"], builder)
    out["after_add"] = r.query_tokens_batch(job["queries"], **job["calls"]["fixed"][1])
    return out


def section_misc(job, mesh, out_dir):
    """make_mesh over fewer ranks than the world refused; a CPU generator
    replicated from rank 0; shard sizes of an uneven batch."""
    from anncur_tpu_torch.parallel.mesh import replicate, shard_batch

    try:
        make_mesh((1,), ("data",))
        fewer = None
    except ValueError as err:
        fewer = str(err)
    gen = torch.Generator().manual_seed(7 if dist.get_rank() == 0 else 1234)
    gen = replicate_from_host(mesh, {"rng": gen})["rng"]
    shard = shard_batch({"x": np.arange(7 * 2).reshape(7, 2)}, mesh)["x"]
    rep = replicate({"w": np.full((3,), float(dist.get_rank()))}, mesh)["w"]
    return dict(fewer=fewer, draws=torch.rand(4, generator=gen).numpy(), shard=shard.numpy(), replicated=rep.numpy())


def section_cli_train(job, mesh, out_dir):
    """``cli/train.py`` in a world of ranks, as under ``torchrun``: the job's
    config at ``--num_devices`` = the world (two bi-encoder steps of a tiny
    encoder in place of bert-base), then a ``--num_devices`` the world does
    not have, refused on every rank before any collective."""
    import anncur_tpu_torch.cli.train as ttrain
    from anncur_tpu_torch.models.biencoder import BiEncoder

    def tiny(cfg, vocab_size, device):
        spec = BertSpec.tiny(vocab_size=vocab_size, hidden_size=64, num_layers=1)
        return BiEncoder(spec=spec, pooling_type="cls", embed_dim=64, compute_dtype=torch.float32, device=device)

    ttrain.build_model = tiny
    n = str(dist.get_world_size())
    ttrain.main(["--config", job["config"], "--device", "cpu", "--num_devices", n])
    try:
        ttrain.main(["--config", job["config"], "--device", "cpu", "--num_devices", "3"])
        refused = None
    except ValueError as err:
        refused = str(err)
    barrier("cli_train")
    return dict(refused=refused, still_grouped=dist.is_initialized())


SECTIONS = {"cli_train": section_cli_train, "dp": section_dp, "ce": section_ce, "tp": section_tp, "build": section_build, "mips": section_mips,
            "serve": section_serve, "misc": section_misc}


def main():
    job_path, out_dir = sys.argv[1], sys.argv[2]
    with open(job_path, "rb") as fin:
        jobs = pickle.load(fin)
    init_distributed("cpu", timeout_s=float(os.environ.get("PARALLEL_TEST_TIMEOUT", "120")))
    mesh = make_mesh((dist.get_world_size(),), ("data",))
    out = {}
    for name, job in jobs:
        out[name] = SECTIONS[name](job, mesh, out_dir)
    rank = dist.get_rank()
    with open(os.path.join(out_dir, f"result_{rank}.pkl"), "wb") as fout:
        pickle.dump(out, fout)
    barrier("done")
    dist.destroy_process_group()
    print(f"rank {rank} OK", flush=True)


if __name__ == "__main__":
    main()
