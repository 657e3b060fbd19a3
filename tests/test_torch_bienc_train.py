"""Port parity, bi-encoder training: the Trainer's bi-encoder losses and
gradients (in-batch negatives, explicit negatives, distillation; the
CLS-only and tag-position last layers under gradients), its step
arithmetic, the batch generators, hard-negative mining with the current
towers, the frozen and decay sets, the ckpt_metric fallback, checkpoints
across packages, crash-resume and the dropout streams, held against the
JAX package on the same numpy inputs (CPU, ``BertSpec.tiny``).

The JAX side runs its XLA attention; at dropout 0 both packages compute
the same function, so losses and gradients are compared in f32. With
dropout on the two RNGs differ, so the port is held to determinism by
seed, independent streams and the keep rate instead."""

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anncur_tpu.config import Config as JaxConfig
from anncur_tpu.data.synthetic import make_tokenized_world
from anncur_tpu.models import bert as jbert
from anncur_tpu.models.biencoder import BiEncoder as JaxBiEncoder
from anncur_tpu.train import checkpoint as jckpt
from anncur_tpu.train import data as jdata
from anncur_tpu.train import optimizer as joptim
from anncur_tpu.train.trainer import Trainer as JaxTrainer

from anncur_tpu_torch.config import Config
from anncur_tpu_torch.evalx.retrieve_rerank import embed_tokenized
from anncur_tpu_torch.models import bert as tbert
from anncur_tpu_torch.models.biencoder import BiEncoder
from anncur_tpu_torch.models.convert import biencoder_from_jax_params
from anncur_tpu_torch.train import checkpoint as tckpt
from anncur_tpu_torch.train import data as tdata
from anncur_tpu_torch.train.optimizer import make_optimizer, named_parameters
from anncur_tpu_torch.train.trainer import Trainer

torch.set_num_threads(2)  # xdist runs several test files side by side

L = 16  # mention and entity tokens
EMBED = 48  # the linear heads' width
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4  # x the leaf's max |grad|: f32 sums in other orders through 2 layers
STEP_ATOL = 1e-5  # params after 3 Adam steps at lr 1e-5 (tests/test_torch_train.py)


def zero_grad_leaves(bi_enc_type, pooling):
    """Leaves whose gradient is 0 in exact arithmetic, so both packages
    carry rounding noise there: the keys' bias under every attention
    softmax; the label head's bias, which adds inp . b to every candidate
    of a row (a shift under the row's softmax); and, where the label
    embedding is the last layer's output itself (no tanh pooler), that
    layer's LayerNorm bias, for the same reason."""
    leaves = ("attn/k_bias", "label_linear/bias")
    if bi_enc_type == "separate" and pooling != "cls_w_lin":
        leaves += ("label_bert/layers/1/mlp/ln_bias",)
    return leaves


def _flat(tree):
    return {k: np.asarray(v) for k, v in tckpt.flat_paths(jax.tree_util.tree_map(np.asarray, tree)).items()}


@pytest.fixture(scope="module")
def world():
    ment, ent, gt, tok = make_tokenized_world(seed=5, n_ents=24, n_ments=32, max_ment_len=L, max_ent_len=L)
    teacher = np.random.default_rng(2).standard_normal((32, 24)).astype(np.float32)
    return tdata.EntLinkDataset(ment, ent, gt.astype(np.int64), score_matrix=teacher), tok


def _specs(tok, **kw):
    kw = dict(vocab_size=tok.vocab_size, max_position_embeddings=64, **kw)
    return jbert.BertSpec.tiny(**kw), tbert.BertSpec.tiny(**kw)


def _configs(tmp_path, **kw):
    base = dict(
        base_res_dir=str(tmp_path), model_type="bi_enc", loss_type="ce", num_epochs=1, train_batch_size=8,
        grad_acc_steps=2, num_negs=3, neg_strategy="in_batch", distill_n_labels=4, learning_rate=1e-5,
        print_interval=100, eval_batch_size=8, num_top_k_ckpts=2, type_optimization="all_encoder_layers",
    )
    base.update(kw)
    cfg_j, cfg_t = JaxConfig(), Config()
    cfg_j.update_from_dict(base)
    cfg_t.update_from_dict(base)
    return cfg_j, cfg_t


def _encoders(tok, bi_enc_type="separate", pooling="cls_w_lin", add_linear=True, **spec_kw):
    """(JAX BiEncoder, the port's on the same params, numpy params), f32."""
    spec_j, spec_t = _specs(tok, **spec_kw)
    embed = EMBED if add_linear else spec_t.hidden_size
    enc_j = JaxBiEncoder(spec=spec_j, pooling_type=pooling, bi_enc_type=bi_enc_type, embed_dim=embed,
                         add_linear_layer=add_linear, compute_dtype=jnp.float32)
    params = jax.tree_util.tree_map(np.asarray, enc_j.init(jax.random.PRNGKey(1)))
    enc_t = biencoder_from_jax_params(params, spec_t, pooling, bi_enc_type, embed, device="cpu", dtype=torch.float32)
    return enc_j, enc_t, params


def _batch(data, kind, n=4, n_negs=3):
    """One micro-batch of ``kind``: in_batch {input, pos}, negs {input,
    pos, negs}, distill {input, labels, target_scores}."""
    if kind == "distill":
        return next(tdata.distill_batches(data, 4, n, shuffle=False))
    negs = tdata.mine_negatives(data, "random", n_negs, seed=1)
    b = next(tdata.bienc_batches(data, negs, n, shuffle=False))
    return {k: b[k] for k in ("input", "pos")} if kind == "in_batch" else b


# ---------------------------------------------------------------- losses and gradients


@pytest.mark.parametrize("kind,bi_enc_type,pooling,add_linear", [
    ("in_batch", "separate", "cls_w_lin", True),
    ("negs", "separate", "cls_w_lin", True),
    ("distill", "separate", "cls_w_lin", True),
    ("in_batch", "shared", "cls", True),
    ("negs", "shared", "spl_tkns", False),
    ("distill", "separate", "spl_tkns", True),
])
def test_bienc_loss_and_grads_match_jax(world, tmp_path, kind, bi_enc_type, pooling, add_linear):
    """The Trainer's _loss_fn and every gradient leaf against
    jax.value_and_grad of JAX's _loss_fn in eval mode (dropout 0), f32.
    cls_w_lin and cls run the last layer at CLS only (g=1), spl_tkns at
    the tag positions (g=2 in the input tower, g=1 in the label tower).
    The init is widened (0.3) so the gradients are not a near-cancelling
    sum (tests/test_torch_train.py)."""
    data, tok = world
    enc_j, enc_t, params = _encoders(tok, bi_enc_type, pooling, add_linear, initializer_range=0.3)
    cfg_j, cfg_t = _configs(tmp_path)
    jt, tt = JaxTrainer(cfg_j, enc_j), Trainer(cfg_t, enc_t)
    batch = _batch(data, kind)
    (want_loss, aux_j), want_grads = jax.jit(jax.value_and_grad(
        lambda p, b: jt._loss_fn(p, b, None, train=False), has_aux=True
    ))(jax.tree_util.tree_map(jnp.asarray, params), {k: jnp.asarray(v) for k, v in batch.items()})
    enc_t.requires_grad_(True)
    loss, aux = tt._loss_fn({k: torch.as_tensor(v) for k, v in batch.items()}, None)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=LOSS_RTOL)
    assert set(aux) == set(aux_j)
    if "mrr" in aux:
        np.testing.assert_allclose(float(aux["mrr"]), float(aux_j["mrr"]), rtol=1e-6)
    want = _flat(want_grads)
    got = {n: np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
           for n, p in named_parameters(enc_t).items()}
    assert set(got) == set(want)
    scale = max(np.abs(w).max() for w in want.values())
    for name, w in want.items():
        if name.endswith(zero_grad_leaves(bi_enc_type, pooling)):
            assert np.abs(got[name]).max() <= GRAD_RTOL * scale and np.abs(w).max() <= GRAD_RTOL * scale, name
            continue
        np.testing.assert_allclose(got[name], w, atol=GRAD_RTOL * np.abs(w).max(), rtol=0, err_msg=name)


def test_in_batch_product_is_true_f32(world, tmp_path):
    """The in-batch loss at d=768 with TF32 allowed equals a float64
    reference on the same embeddings (on the CPU the flag changes nothing;
    tests/test_torch_cuda.py holds it on the card, where TF32 would keep
    10 mantissa bits)."""
    from anncur_tpu_torch.train.losses import bienc_loss_in_batch_negs

    rng = np.random.default_rng(0)
    a, b = (rng.standard_normal((6, 768)).astype(np.float32) for _ in range(2))
    s = a.astype(np.float64) @ b.astype(np.float64).T
    want = np.mean(np.log(np.exp(s - s.max(1, keepdims=True)).sum(1)) + s.max(1) - np.diag(s))
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = float(bienc_loss_in_batch_negs(torch.as_tensor(a), torch.as_tensor(b)))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    np.testing.assert_allclose(got, want, rtol=1e-5)


# ---------------------------------------------------------------- step arithmetic


@pytest.mark.parametrize("strategy", ["in_batch", "random", "top_ce_match"])
def test_bienc_trainer_steps_match_jax_step_arithmetic(world, tmp_path, strategy):
    """Three Trainer steps (2 micro-batches of 4; in-batch negatives stay
    within each micro-batch) from the same params, dropout 0 on both sides,
    the frozen embeddings of all_encoder_layers: equal micro-batch losses
    and params (f32, 1e-5 absolute). JAX's step always draws dropout, so
    its side is the step's own arithmetic in eval mode: per micro-batch
    value_and_grad(_loss_fn), averaged, then tx.update. No linear heads:
    both packages drop the head's input at 0.1 in training whatever the
    spec's rates."""
    data, tok = world
    enc_j, enc_t, params = _encoders(tok, add_linear=False, hidden_dropout=0.0, attention_dropout=0.0)
    cfg_j, cfg_t = _configs(tmp_path, neg_strategy=strategy)
    jt, tt = JaxTrainer(cfg_j, enc_j, total_steps=10), Trainer(cfg_t, enc_t, total_steps=10)
    jstate = jt.init_state()
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jopt = jt._tx.init(jp)
    tstate = tt.init_state(params)
    grad_fn = jax.jit(jax.value_and_grad(lambda p, mb: jt._loss_fn(p, mb, None, train=False), has_aux=True))
    negs = tt._epoch_negatives(data, tstate, 0)
    batches = list(tt._make_batches(data, negs, cfg_t.train_batch_size, 0))[:3]
    assert len(batches) == 3 and jstate.step == 0
    for batch in batches:
        sharded = jt._shard_batch(batch)
        n_micro = next(iter(sharded.values())).shape[0]
        assert n_micro == 2
        losses, gsum = [], None
        for i in range(n_micro):
            (loss, _), g = grad_fn(jp, {k: v[i] for k, v in sharded.items()})
            losses.append(float(loss))
            gsum = g if gsum is None else jax.tree_util.tree_map(jnp.add, gsum, g)
        upd, jopt = jt._tx.update(jax.tree_util.tree_map(lambda x: x / n_micro, gsum), jopt, jp)
        jp = jax.tree_util.tree_map(lambda a, u: a + u, jp, upd)
        metrics = tt.train_step(tstate, tt._shard_batch(batch))
        np.testing.assert_allclose(metrics["micro_losses"].numpy(), losses, atol=STEP_ATOL, rtol=0)
    assert tstate.step == 3
    want = _flat(jp)
    for name, p in tstate.params.items():
        np.testing.assert_allclose(p.detach().numpy(), want[name], atol=STEP_ATOL, rtol=0, err_msg=name)
    # the frozen word embeddings did not move, the top layer did
    assert np.array_equal(want["input_bert/embeddings/word"], params["input_bert"]["embeddings"]["word"])
    assert not np.array_equal(want["label_bert/layers/1/mlp/out_kernel"],
                              params["label_bert"]["layers"][1]["mlp"]["out_kernel"])


# ---------------------------------------------------------------- batches, mining, masks


@pytest.mark.parametrize("generator", ["bienc", "distill", "triplet_random", "triplet_hard"])
def test_bienc_batches_match_jax(world, generator):
    """The three generators give arrays equal to JAX's, with the training
    tail (drop or wrap) and the eval tail (every example once)."""
    data, _ = world
    jd = jdata.EntLinkDataset(data.mention_tokens, data.entity_tokens, data.gt_labels, score_matrix=data.score_matrix)
    rng = np.random.default_rng(3)
    # small integers: exact dot products, ties ordered by index on both sides
    emb = (rng.integers(-2, 3, (32, 6)).astype(np.float32), rng.integers(-2, 3, (24, 6)).astype(np.float32))
    for bs, tail in ((5, {}), (7, {"shuffle": False, "drop_remainder": False, "pad_remainder": False}), (40, {})):
        if generator == "bienc":
            negs = tdata.mine_negatives(data, "random", 3, seed=2)
            got = tdata.bienc_batches(data, negs, bs, seed=4, **tail)
            want = jdata.bienc_batches(jd, negs, bs, seed=4, **tail)
        elif generator == "distill":
            got = tdata.distill_batches(data, 5, bs, seed=4, **tail)
            want = jdata.distill_batches(jd, 5, bs, seed=4, **tail)
        else:
            kw = dict(input_embeds=emb[0], label_embeds=emb[1]) if generator == "triplet_hard" else {}
            got = tdata.distill_triplet_batches(data, 3, bs, seed=4, device="cpu", **kw, **tail)
            want = jdata.distill_triplet_batches(jd, 3, bs, seed=4, **kw, **tail)
        got, want = list(got), list(want)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in g:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_bienc_hard_negs_mined_with_current_towers_match_jax(world, tmp_path):
    """_epoch_negatives embeds with the current towers (eval mode) and mines
    through the MIPS: its ids equal JAX's mine_negatives on the same
    embeddings, the embeddings equal JAX's towers' (f32, 1e-4), and no
    gold id is among a mention's negatives."""
    data, tok = world
    enc_j, enc_t, params = _encoders(tok)
    _, cfg_t = _configs(tmp_path, neg_strategy="bienc_hard_negs", num_negs=5)
    tt = Trainer(cfg_t, enc_t)
    got = tt._epoch_negatives(data, tt.init_state(params), 0)
    inp = embed_tokenized(enc_t, data.mention_tokens, cfg_t.eval_batch_size, "input")
    lab = embed_tokenized(enc_t, data.entity_tokens, cfg_t.eval_batch_size, "label")
    jd = jdata.EntLinkDataset(data.mention_tokens, data.entity_tokens, data.gt_labels)
    want = jdata.mine_negatives(jd, "bienc_hard_negs", 5, seed=0, input_embeds=inp, label_embeds=lab)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (32, 5) and not (got == data.gt_labels[:, None]).any()
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    for toks, mine, which in ((data.mention_tokens, inp, "input"), (data.entity_tokens, lab, "label")):
        ref = np.asarray(enc_j._encode(jp, jnp.asarray(toks), which))
        np.testing.assert_allclose(mine, ref, atol=1e-4 * np.abs(ref).max(), rtol=0)


@pytest.mark.parametrize("bi_enc_type,add_linear", [("separate", True), ("separate", False), ("shared", True), ("shared", False)])
@pytest.mark.parametrize("type_optimization", ["all_encoder_layers", "top_layer", "additional_layers"])
def test_frozen_and_decay_sets_match_jax(world, bi_enc_type, add_linear, type_optimization):
    """The optimizer's frozen and decay sets over the two towers (and the
    heads) equal the masks JAX builds from the same patterns on its tree."""
    _, tok = world
    _, enc_t, params = _encoders(tok, bi_enc_type, "cls_w_lin", add_linear)
    named = named_parameters(enc_t)
    opt = make_optimizer(named, type_optimization=type_optimization)
    patterns = joptim.PATTERNS_OPTIMIZER[type_optimization]
    frozen = _flat(joptim._mask_from_predicate(params, lambda p: not any(t in p for t in patterns)))
    decay = _flat(joptim._mask_from_predicate(
        params, lambda p: not any(s in p.rsplit("/", 1)[-1] for s in joptim.NO_DECAY_SUBSTRINGS)))
    assert set(named) == set(frozen)
    assert opt.frozen == {n for n, v in frozen.items() if v}
    assert opt.decay == {n for n, v in decay.items() if v}
    assert opt.frozen and len(opt.frozen) < len(named)


# ---------------------------------------------------------------- eval and checkpoints


def test_evaluate_reports_mrr_only_where_batches_rank(world, tmp_path):
    """dev_mrr comes from explicit negatives only; in-batch and distillation
    evals give dev_loss alone (JAX's evaluate, key for key)."""
    data, tok = world
    enc_j, enc_t, params = _encoders(tok)
    for strategy, keys in (("random", {"dev_loss", "dev_mrr"}), ("in_batch", {"dev_loss"}), ("top_ce_match", {"dev_loss"})):
        cfg_j, cfg_t = _configs(tmp_path / strategy, neg_strategy=strategy)
        jt, tt = JaxTrainer(cfg_j, enc_j), Trainer(cfg_t, enc_t)
        state = tt.init_state(params)
        negs = tt._epoch_negatives(data, state, 0)
        batches = list(tt._make_batches(data, negs, 6, 0, shuffle=False, for_eval=True))
        got = tt.evaluate(state, iter(batches))
        want = jt.evaluate(dataclasses.replace(jt.init_state(), params=jax.tree_util.tree_map(jnp.asarray, params)),
                           iter(batches))
        assert set(got) == set(want) == keys
        for k in keys:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5)


def test_ckpt_metric_mrr_falls_back_to_dev_loss(world, tmp_path, caplog):
    """ckpt_metric='mrr' with in_batch negatives: the dev eval has no MRR,
    so the Trainer warns once and keeps top-k checkpoints by dev_loss."""
    data, tok = world
    _, enc_t, _ = _encoders(tok)
    _, cfg = _configs(tmp_path, ckpt_metric="mrr", num_epochs=2, fast_dev_run=1)
    tr = Trainer(cfg, enc_t, total_steps=10)
    with caplog.at_level(logging.WARNING, logger="anncur_tpu_torch.train.trainer"):
        tr.train(data, dev_data=data)
    assert sum("selecting top-k checkpoints by dev_loss" in r.message for r in caplog.records) == 1
    assert tr._ckpt.metric == "loss" and tr._ckpt.mode == "min" and len(tr._ckpt.entries) == 2
    assert all(e["path"].split("/")[-1].startswith("loss=") for e in tr._ckpt.entries)


def test_bienc_checkpoints_cross_packages(world, tmp_path):
    """A JAX bi-encoder run's end-of-epoch checkpoint (two towers, two
    heads, optax state, step, typed key) resumes in the port: params, step,
    Adam count and moments equal JAX's (the seeded generator stays, a JAX
    key cannot seed it). The port's checkpoint reads in JAX: its params
    embed as the port's towers do, and its moments are keyed by JAX's
    paths."""
    data, tok = world
    enc_j, enc_t, params = _encoders(tok, hidden_dropout=0.0, attention_dropout=0.0)
    cfg_j, cfg_t = _configs(tmp_path / "jax", neg_strategy="random", fast_dev_run=2)
    jstate = JaxTrainer(cfg_j, enc_j, total_steps=10).train(data)
    tt = Trainer(cfg_t, enc_t, total_steps=10)
    tree, _ = tckpt.load_pytree(tt._ckpt.latest_eoe()["path"])
    state = tt._restore(tt.init_state(), tree)
    assert state.step == int(jstate.step) == 2 and state.opt_state["count"] == 2
    want = _flat(jstate.params)
    for name, p in state.params.items():
        np.testing.assert_array_equal(p.detach().numpy(), want[name])
    adam = next(s for s in jax.tree_util.tree_leaves(jstate.opt_state, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(s, "mu"))
    for key in ("mu", "nu"):
        jm = _flat(getattr(adam, key))
        for name, t in state.opt_state[key].items():
            np.testing.assert_array_equal(t.numpy(), jm[name])
    # resume carries on training from there
    cfg_t.num_epochs = 2
    resumed = Trainer(cfg_t, enc_t, total_steps=10).train(data, resume=True)
    assert resumed.step == 4

    # the reverse: the port's checkpoint in JAX
    _, cfg_p = _configs(tmp_path / "port", neg_strategy="random", fast_dev_run=2)
    port_state = Trainer(cfg_p, enc_t, total_steps=10).train(data)
    jtree, _ = jckpt.load_pytree(Trainer(cfg_p, enc_t)._ckpt.latest_eoe()["path"])
    assert jtree["step"] == port_state.step == 2 and jtree["opt_state"]["count"] == 2
    assert set(jtree["opt_state"]["mu"]) == set(_flat(jtree["params"]))
    jp = jax.tree_util.tree_map(jnp.asarray, jtree["params"])
    ref = np.asarray(enc_j.encode_input(jp, jnp.asarray(data.mention_tokens[:6])))
    np.testing.assert_allclose(enc_t.encode_input(data.mention_tokens[:6]).numpy(), ref,
                               atol=1e-4 * np.abs(ref).max(), rtol=0)


def test_bienc_crash_resume_bitwise_with_dropout(world, tmp_path):
    """Train 1 epoch with hard negatives re-mined each epoch, dropout on and
    a dev eval, then resume in a new Trainer for 2 more: the params equal
    an uninterrupted 3-epoch run bit for bit."""
    data, tok = world
    dev = tdata.EntLinkDataset(data.mention_tokens[:8], data.entity_tokens, data.gt_labels[:8])

    def run(sub, epochs, resume=False):
        _, cfg = _configs(tmp_path / sub, num_epochs=epochs, fast_dev_run=2, neg_strategy="bienc_hard_negs")
        enc = BiEncoder(_specs(tok)[1], embed_dim=EMBED, add_linear_layer=True, compute_dtype=torch.float32,
                        device="cpu")
        return Trainer(cfg, enc, total_steps=30).train(data, dev_data=dev, resume=resume)

    run("a", 1)
    resumed = run("a", 3, resume=True)
    mono = run("b", 3)
    assert resumed.step == mono.step == 6
    for name, p in resumed.params.items():
        assert torch.equal(p, mono.params[name]), name


@pytest.mark.parametrize("strategy", ["in_batch", "random", "bienc_hard_negs", "top_ce_match",
                                      "top_ce_w_bienc_hard_negs_trp", "top_ce_w_rand_negs_trp"])
def test_trainer_trains_a_bienc_with_every_strategy(world, tmp_path, strategy):
    """Trainer.train on the CPU with each negative strategy: two epochs of
    two steps with a dev eval, finite dev metrics, the end-of-epoch and
    top-k checkpoints written (dev_mrr where the strategy ranks negatives,
    dev_loss otherwise)."""
    data, tok = world
    _, cfg = _configs(tmp_path, neg_strategy=strategy, num_epochs=2, fast_dev_run=2, ckpt_metric="mrr")
    enc = BiEncoder(_specs(tok)[1], embed_dim=EMBED, add_linear_layer=True, compute_dtype=torch.float32, device="cpu")
    tr = Trainer(cfg, enc, total_steps=10)
    state = tr.train(data, dev_data=data)
    assert state.step == 4 and tr._ckpt.latest_eoe()["epoch"] == 1
    ranks = strategy in ("random", "bienc_hard_negs") or strategy.endswith("_trp")
    assert tr._ckpt.metric == ("mrr" if ranks else "loss") and len(tr._ckpt.entries) == 2
    assert all(np.isfinite(e["value"]) for e in tr._ckpt.entries)


# ---------------------------------------------------------------- dropout streams


def test_bienc_dropout_streams(world, tmp_path, monkeypatch):
    """With dropout on: a loss is determined by its micro-batch seed; the
    input, positive and negative forwards draw three distinct streams; two
    identical micro-batches of a step see other masks; the head's dropout
    keeps 0.9 of the entries; eval mode has no dropout."""
    data, tok = world
    _, cfg = _configs(tmp_path, neg_strategy="random", grad_acc_steps=2)
    enc = BiEncoder(_specs(tok)[1], embed_dim=EMBED, add_linear_layer=True, compute_dtype=torch.float32, device="cpu")
    tr = Trainer(cfg, enc, total_steps=10)
    state = tr.init_state()
    mb = {k: torch.as_tensor(v) for k, v in _batch(data, "negs").items()}

    def loss(seed):
        return float(tr._loss_fn(mb, torch.Generator().manual_seed(seed))[0].detach())

    assert loss(3) == loss(3) != loss(4)
    assert loss(3) != float(tr._loss_fn(mb, None, train=False)[0])
    seeds = []
    encode = BiEncoder._encode
    monkeypatch.setattr(BiEncoder, "_encode", lambda self, toks, which, train=False, generator=None: (
        seeds.append((which, generator.initial_seed())), encode(self, toks, which, train, generator))[1])
    tr._loss_fn(mb, torch.Generator().manual_seed(3))
    assert [w for w, _ in seeds] == ["input", "label", "label"] and len({s for _, s in seeds}) == 3
    monkeypatch.undo()
    batch = {k: torch.stack([v, v]) for k, v in mb.items()}
    ml = tr.train_step(state, batch)["micro_losses"]
    assert ml.shape == (2,) and ml[0] != ml[1]
    x = torch.ones(200_000)
    kept = float((tbert.dropout(x, 11, 0.1) != 0).float().mean())
    assert abs(kept - 0.9) < 0.005 and torch.equal(tbert.dropout(x, 11, 0.1), tbert.dropout(x, 11, 0.1))


def test_bienc_remat_gives_the_same_grads(world):
    """remat=True recomputes each layer with the same dropout masks: the
    towers' grads equal those without remat (f32, 1e-6)."""
    data, tok = world
    grads = []
    for remat in (False, True):
        enc = BiEncoder(_specs(tok)[1], embed_dim=EMBED, add_linear_layer=True, compute_dtype=torch.float32,
                        device="cpu", remat=remat)
        enc.requires_grad_(True)
        inp = enc._encode(data.mention_tokens[:4], "input", True, torch.Generator().manual_seed(1))
        lab = enc._encode(data.entity_tokens[:4], "label", True, torch.Generator().manual_seed(2))
        (inp @ lab.T).logsumexp(1).sum().backward()
        grads.append({n: p.grad.clone() for n, p in named_parameters(enc).items() if p.grad is not None})
    assert grads[0].keys() == grads[1].keys()
    for name, g in grads[0].items():
        torch.testing.assert_close(grads[1][name], g, rtol=1e-6, atol=1e-7, msg=name)
