"""Port parity, training: the attention backward, CE gradients, the
optimizer, losses/negatives/batches, the Trainer step, and the behaviour
the JAX training tests pin (dropout, checkpoints, resume, remat), held
against the JAX package on the same numpy inputs (CPU).

The JAX side runs its XLA attention (``_attn_core``): the stock flash
backward runs only on a TPU, and at dropout 0 it computes the same
values at every row that reaches a loss."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anncur_tpu.config import Config as JaxConfig
from anncur_tpu.data.synthetic import make_tokenized_world
from anncur_tpu.models import bert as jbert
from anncur_tpu.models.crossencoder import CrossEncoder as JaxCrossEncoder
from anncur_tpu.train import checkpoint as jckpt
from anncur_tpu.train import data as jdata
from anncur_tpu.train import losses as jlosses
from anncur_tpu.train import negatives as jnegs
from anncur_tpu.train.optimizer import make_optimizer as jax_make_optimizer
from anncur_tpu.train.trainer import Trainer as JaxTrainer

from anncur_tpu_torch.config import Config
from anncur_tpu_torch.models import bert as tbert
from anncur_tpu_torch.models.convert import crossencoder_from_jax_params, crossencoder_to_jax_params
from anncur_tpu_torch.models.crossencoder import CrossEncoder
from anncur_tpu_torch.ops.attention import (
    attention,
    attention_bwd_dkv,
    attention_bwd_dq,
    attention_bwd_plain,
)
from anncur_tpu_torch.train import checkpoint as tckpt
from anncur_tpu_torch.train import data as tdata
from anncur_tpu_torch.train import losses as tlosses
from anncur_tpu_torch.train import negatives as tnegs
from anncur_tpu_torch.train.optimizer import apply_updates, make_optimizer, named_parameters
from anncur_tpu_torch.train.trainer import Trainer

torch.set_num_threads(2)  # xdist runs several test files side by side

CPU = torch.device("cpu")
LM = LE = 16  # mention / entity tokens -> 31-token pairs


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree):
    """{JAX path: numpy leaf}, paths as the optimizer names them."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out["/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)] = np.asarray(leaf)
    return out


@pytest.fixture(scope="module")
def world():
    ment, ent, gt, tok = make_tokenized_world(seed=3, n_ents=24, n_ments=32, max_ment_len=LM, max_ent_len=LE)
    return tdata.EntLinkDataset(ment, ent, gt), tok


def _specs(tok, **kw):
    kw = dict(vocab_size=tok.vocab_size, max_position_embeddings=64, **kw)
    return jbert.BertSpec.tiny(**kw), tbert.BertSpec.tiny(**kw)


def _pairs(data, n_ments, n_negs, seed):
    """(pos_pairs (b, Lp), neg_pairs (b, n, Lp)) of the first mentions."""
    sub = tdata.EntLinkDataset(data.mention_tokens[:n_ments], data.entity_tokens, data.gt_labels[:n_ments])
    negs = tnegs.get_random_negs(sub.gt_labels, sub.n_ents, n_negs, seed)
    batch = next(tdata.crossenc_batches(sub, negs, n_ments, shuffle=False))
    return batch["pos_pairs"], batch["neg_pairs"]


# ---------------------------------------------------------------- (a) attention backward


@pytest.mark.parametrize("g", ["s", 1])
def test_attention_backward_matches_jax_vjp(g):
    """(a) autograd of the port's attention (its plain version on CPU, and
    the kernel wrappers' CPU path) against jax.vjp of _attn_core, f32, atol
    1e-5 x the leaf's max: the two frameworks sum in other orders."""
    rng = np.random.default_rng(7)
    b, s, nh, hd = 3, 20, 4, 16
    g = s if g == "s" else g
    q = rng.standard_normal((b, g, nh, hd)).astype(np.float32)
    k, v = (rng.standard_normal((b, s, nh, hd)).astype(np.float32) for _ in range(2))
    lengths = np.array([20, 7, 1])
    valid = np.arange(s)[None, :] < lengths[:, None]
    real_rows = np.broadcast_to(np.arange(g)[None, :] < (lengths[:, None] if g == s else g), (b, g))
    # rows past a pair's length never reach a loss: their cotangent is 0
    dout = rng.standard_normal((b, g, nh, hd)).astype(np.float32) * real_rows[:, :, None, None]
    bias = np.where(valid, 0.0, -1e9).astype(np.float32)[:, None, None, :]

    def core(q_, k_, v_):
        return jbert._attn_core(q_, k_, v_, jnp.asarray(bias), None, jnp.float32, 0.0, "bqnk")

    want_out, vjp = jax.vjp(core, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(t) for t in vjp(jnp.asarray(dout))]

    leaves = [torch.tensor(t, requires_grad=True) for t in (q, k, v)]
    out = attention(*leaves, torch.as_tensor(valid))
    got = [t.numpy() for t in torch.autograd.grad(out, leaves, torch.as_tensor(dout))]
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, w, atol=1e-5 * np.abs(w).max(), rtol=0, err_msg=name)
    # zero rows: masked keys get no dK, dV; padded query rows no dQ
    assert not got[1][~valid].any() and not got[2][~valid].any()
    assert not got[0][~real_rows].any()
    # the kernel wrappers take the same plain autograd for CPU tensors, D
    # first: its D = rowsum(dO * O) is JAX's di (flash_attention.py:273)
    args = [torch.as_tensor(t) for t in (q, k, v)] + [torch.as_tensor(valid)]
    dq, delta = attention_bwd_dq(*args, torch.as_tensor(dout), out.detach(), None)
    dk, dv = attention_bwd_dkv(*args, torch.as_tensor(dout), None, delta)
    for a, w in zip((dq, dk, dv), attention_bwd_plain(*args, torch.as_tensor(dout))):
        assert torch.equal(a, w)
    np.testing.assert_array_equal(dq.numpy(), got[0])
    di = np.sum(np.asarray(want_out) * dout, -1).transpose(0, 2, 1)
    assert delta.shape == (b, nh, g) and delta.dtype == torch.float32
    np.testing.assert_allclose(delta.numpy(), di, atol=1e-5 * np.abs(di).max(), rtol=0)
    assert attention.launches == attention_bwd_dkv.launches == attention_bwd_dq.launches == 0


# ---------------------------------------------------------------- (b) CE gradients


# gradients that are exactly 0 in exact arithmetic: softmax over the keys
# (k_bias) and over a mention's candidates (the 'default' head's bias) is
# invariant to a shift, so both packages carry only rounding noise there
ZERO_GRAD_LEAVES = ("attn/k_bias", "score_linear/bias")


def _ce_loss_and_grads(data, tok, cross_enc_type, dtype):
    """(JAX loss, JAX grads, port loss, port grads) of crossenc_loss over
    3 mentions x (1 + 4 candidates), eval mode, params carried across. The
    init is widened (0.3) so the gradients are not a near-cancelling sum:
    at 0.02 the loss sits at ln 5 and the f32 grads of whole leaves are
    ~1e-6, below f32 resolution of the terms they sum."""
    spec_j, spec_t = _specs(tok, initializer_range=0.3)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    params = _numpy_tree(JaxCrossEncoder(spec=spec_j, cross_enc_type=cross_enc_type).init(jax.random.PRNGKey(5)))
    ce_j = JaxCrossEncoder(spec=spec_j, cross_enc_type=cross_enc_type, compute_dtype=jdt)
    pos, neg = _pairs(data, 3, 4, seed=1)

    def loss_j(p):
        ps = ce_j.score(p, jnp.asarray(pos), LM)
        ns = ce_j.score(p, jnp.asarray(neg.reshape(-1, neg.shape[-1])), LM).reshape(neg.shape[:2])
        return jlosses.crossenc_loss(ps, ns)

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_j))(jax.tree_util.tree_map(jnp.asarray, params))
    ce_t = crossencoder_from_jax_params(params, spec_t, cross_enc_type, device="cpu", dtype=tdt)
    ce_t.requires_grad_(True)
    ps = ce_t.score(pos, LM, train=True)
    ns = ce_t.score(neg.reshape(-1, neg.shape[-1]), LM, train=True).reshape(neg.shape[:2])
    loss = tlosses.crossenc_loss(ps, ns)
    loss.backward()
    # a leaf the head never reads (the pooler under w_embeds) gets no grad
    got = {n: np.zeros(p.shape, np.float32) if p.grad is None else p.grad.numpy()
           for n, p in named_parameters(ce_t).items()}
    want = _flat(want_grads)
    assert set(got) == set(want)
    return float(want_loss), want, float(loss.detach()), got


@pytest.mark.parametrize("cross_enc_type", ["default", "w_embeds"])
def test_crossencoder_loss_and_grads_match_jax_f32(world, cross_enc_type):
    """(b) the CE loss and every gradient leaf against jax.value_and_grad of
    crossenc_loss(score(...)) in eval mode, f32: atol 1e-4 x the leaf's
    max (sums in other orders through 2 layers)."""
    data, tok = world
    want_loss, want, loss, got = _ce_loss_and_grads(data, tok, cross_enc_type, "f32")
    np.testing.assert_allclose(loss, want_loss, atol=1e-4 * abs(want_loss), rtol=0)
    scale = max(np.abs(w).max() for w in want.values())
    for name, w in want.items():
        if name.endswith(ZERO_GRAD_LEAVES):
            assert np.abs(got[name]).max() <= 1e-4 * scale and np.abs(w).max() <= 1e-4 * scale, name
            continue
        np.testing.assert_allclose(got[name], w, atol=1e-4 * np.abs(w).max(), rtol=0, err_msg=name)


@pytest.mark.parametrize("cross_enc_type", ["default", "w_embeds"])
def test_crossencoder_loss_and_grads_match_jax_bf16(world, cross_enc_type):
    """(b) in bf16: the loss within 3e-2 of JAX's bf16 loss (relative),
    and each gradient leaf held to JAX's own bf16 error. Measured at these
    shapes, JAX's bf16 gradients lie up to 18% of a leaf's max from its f32
    gradients (every backward product rounds to 8 bits; JAX also rounds
    the attention probabilities, the port's attention does not), so a
    fixed 3e-2 x the leaf's max between the two bf16 runs would test
    rounding noise. Held instead: the port's bf16 gradient is no farther
    from the f32 gradient than twice JAX's bf16 distance from it, plus
    3e-2 x the leaf's max."""
    data, tok = world
    want_loss, want, loss, got = _ce_loss_and_grads(data, tok, cross_enc_type, "bf16")
    _, exact, _, _ = _ce_loss_and_grads(data, tok, cross_enc_type, "f32")
    np.testing.assert_allclose(loss, want_loss, atol=3e-2 * abs(want_loss), rtol=0)
    for name, w32 in exact.items():
        jax_err = np.abs(want[name] - w32).max()
        port_err = np.abs(got[name] - w32).max()
        assert port_err <= 2 * jax_err + 3e-2 * np.abs(w32).max(), (name, port_err, jax_err)


# ---------------------------------------------------------------- (c) optimizer


@pytest.mark.parametrize("type_optimization", ["all", "all_encoder_layers"])
@pytest.mark.parametrize("grad_scale", [10.0, 1e-3], ids=["clipped", "unclipped"])
def test_optimizer_matches_make_optimizer(type_optimization, grad_scale):
    """(c) three steps through warmup into decay, with the freeze and decay
    masks, against optax: params within 1e-6 x the leaf's max."""
    spec = jbert.BertSpec.tiny()
    params = _numpy_tree(JaxCrossEncoder(spec=spec).init(jax.random.PRNGKey(0)))
    kw = dict(learning_rate=1e-2, weight_decay=0.1, total_steps=6, warmup_proportion=0.34,
              max_grad_norm=1.0, type_optimization=type_optimization)
    tx = jax_make_optimizer(params, **kw)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = tx.init(jp)
    ce = CrossEncoder(tbert.BertSpec.tiny(), device="cpu", params=params)
    tp = named_parameters(ce)
    opt = make_optimizer(tp, **kw)
    tstate = opt.init(tp)
    rng = np.random.default_rng(3)
    norms = []
    for _ in range(3):
        grads = jax.tree_util.tree_map(
            lambda x: (rng.standard_normal(x.shape) * grad_scale).astype(np.float32), params
        )
        norms.append(np.sqrt(sum(float((g * g).sum()) for g in jax.tree_util.tree_leaves(grads))))
        upd, jstate = tx.update(jax.tree_util.tree_map(jnp.asarray, grads), jstate, jp)
        jp = jax.tree_util.tree_map(lambda a, u: a + u, jp, upd)
        flat = _flat(grads)
        apply_updates(tp, opt.update({n: torch.as_tensor(flat[n]) for n in tp}, tstate, tp))
    # the clipped case clips, the other does not
    assert (min(norms) > 1.0) == (grad_scale > 1.0)
    want = _flat(jp)
    moved = 0
    for name, p in tp.items():
        w = want[name]
        np.testing.assert_allclose(p.detach().numpy(), w, atol=1e-6 * np.abs(w).max(), rtol=0, err_msg=name)
        moved += not np.array_equal(p.detach().numpy(), _flat(params)[name])
    frozen_word = not np.array_equal(tp["bert/embeddings/word"].detach().numpy(), params["bert"]["embeddings"]["word"])
    assert frozen_word == (type_optimization == "all") and moved > 0


# ---------------------------------------------------------------- (d) losses, negatives, batches


def test_losses_match_jax():
    """(d) every loss of train/losses.py on the same numpy inputs (f32:
    log-softmax and means in other orders, 1e-6)."""
    rng = np.random.default_rng(0)
    pos, neg = rng.standard_normal(5).astype(np.float32), rng.standard_normal((5, 4)).astype(np.float32)
    a, b, c = (rng.standard_normal(sh).astype(np.float32) for sh in ((5, 8), (5, 8), (5, 3, 8)))
    t = lambda x: torch.as_tensor(x)  # noqa: E731
    cases = [
        (jlosses.crossenc_loss(pos, neg, "ce"), tlosses.crossenc_loss(t(pos), t(neg), "ce")),
        (jlosses.crossenc_loss(pos, neg, "bce"), tlosses.crossenc_loss(t(pos), t(neg), "bce")),
        (jlosses.mrr_from_scores(pos, neg), tlosses.mrr_from_scores(t(pos), t(neg))),
        (jlosses.distill_loss(a[:, :4], neg), tlosses.distill_loss(t(a[:, :4]), t(neg))),
    ]
    for lt in ("ce", "hinge", "hinge_sq"):
        cases.append((jlosses.bienc_loss_w_negs(a, b, c, lt), tlosses.bienc_loss_w_negs(t(a), t(b), t(c), lt)))
        cases.append((jlosses.bienc_loss_in_batch_negs(a, b, lt), tlosses.bienc_loss_in_batch_negs(t(a), t(b), lt)))
    for want, got in cases:
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-6)
    with pytest.raises(NotImplementedError):
        tlosses.crossenc_loss(t(pos), t(neg), "hinge")


def test_negatives_match_jax(world):
    """(d) numpy negative miners are copies: equal arrays; the hard miner
    runs the port's MIPS (ties to the lowest index, as lax.top_k)."""
    data, _ = world
    gt = data.gt_labels
    np.testing.assert_array_equal(tnegs.get_random_negs(gt, 24, 5, 3), jnegs.get_random_negs(gt, 24, 5, 3))
    black = [[1, 2], [3], [0, 4, 5]] * 4
    np.testing.assert_array_equal(
        tnegs.get_random_negs_w_blacklist(gt[:12], black, 24, 4, 1),
        jnegs.get_random_negs_w_blacklist(gt[:12], black, 24, 4, 1),
    )
    rng = np.random.default_rng(1)
    # small integers: exact dot products and many exact ties to order
    inp = rng.integers(-2, 3, (12, 6)).astype(np.float32)
    lab = rng.integers(-2, 3, (24, 6)).astype(np.float32)
    np.testing.assert_array_equal(
        tnegs.get_hard_negs_from_embeds(inp, lab, gt[:12], 5, device="cpu"),
        jnegs.get_hard_negs_from_embeds(inp, lab, gt[:12], 5),
    )
    np.testing.assert_array_equal(
        tnegs.get_hard_negs_from_embeds_w_blacklist(inp, lab, black, 5, device="cpu"),
        jnegs.get_hard_negs_from_embeds_w_blacklist(inp, lab, black, 5),
    )
    sm = rng.standard_normal((12, 24)).astype(np.float32)
    for key in ("indices", "scores"):
        np.testing.assert_array_equal(
            tnegs.get_precomputed_ents_w_scores(sm, 6)[key], jnegs.get_precomputed_ents_w_scores(sm, 6)[key]
        )


def test_batches_and_mining_match_jax(world):
    """(d) merge_worlds, mine_negatives (per world) and crossenc_batches
    give equal arrays."""
    data, _ = world
    parts = [(data.mention_tokens[:20], data.entity_tokens[:14], data.gt_labels[:20] % 14),
             (data.mention_tokens[20:], data.entity_tokens[14:, :12], data.gt_labels[20:] % 10)]
    merged_t = tdata.merge_worlds([tdata.EntLinkDataset(*p) for p in parts])
    merged_j = jdata.merge_worlds([jdata.EntLinkDataset(*p) for p in parts])
    for f in ("mention_tokens", "entity_tokens", "gt_labels", "mention_world"):
        np.testing.assert_array_equal(getattr(merged_t, f), getattr(merged_j, f))
    assert merged_t.world_ent_ranges == merged_j.world_ent_ranges
    for strategy in ("random", "dummy"):
        np.testing.assert_array_equal(
            tdata.mine_negatives(merged_t, strategy, 3, seed=2), jdata.mine_negatives(merged_j, strategy, 3, seed=2)
        )
    negs = tdata.mine_negatives(merged_t, "random", 3, seed=2)
    for kw in ({}, {"shuffle": False, "drop_remainder": False, "pad_remainder": False}):
        got = list(tdata.crossenc_batches(merged_t, negs, 7, seed=4, **kw))
        want = list(jdata.crossenc_batches(merged_j, negs, 7, seed=4, **kw))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g.keys() == w.keys() and g["first_segment_end"] == w["first_segment_end"]
            np.testing.assert_array_equal(g["pos_pairs"], w["pos_pairs"])
            np.testing.assert_array_equal(g["neg_pairs"], w["neg_pairs"])
    # tfidf_hard_negs is served now (held to JAX's in test_torch_data.py);
    # it needs the raw texts, as JAX's does
    with pytest.raises(ValueError, match="raw texts"):
        tdata.mine_negatives(data, "tfidf_hard_negs", 3, device="cpu")


# ---------------------------------------------------------------- (e) Trainer steps


def _configs(tmp_path, **kw):
    base = dict(
        base_res_dir=str(tmp_path), model_type="cross_enc", loss_type="ce", num_epochs=1,
        train_batch_size=4, grad_acc_steps=2, num_negs=3, neg_strategy="random",
        learning_rate=5e-4, print_interval=100, eval_batch_size=16, num_top_k_ckpts=2,
    )
    base.update(kw)
    cfg_j, cfg_t = JaxConfig(), Config()
    cfg_j.update_from_dict(base)
    cfg_t.update_from_dict(base)
    return cfg_j, cfg_t


def test_trainer_steps_match_jax_step_arithmetic(world, tmp_path):
    """(e) three Trainer steps with dropout off on both sides (w_embeds
    head, zero rates) from the same params: equal losses and params, f32
    within 1e-5 absolute (Adam's normalised update turns last-bit grad
    differences of near-zero grads into a share of lr: lr is 1e-5 here,
    configs/el_zeshel_cross_enc.json's).
    JAX's step always draws
    dropout, so its side is the step's own arithmetic in eval mode: per
    micro-batch value_and_grad(_loss_fn)(params, mb, None, train=False),
    averaged, then tx.update (trainer.py:203-233)."""
    data, tok = world
    spec_j, spec_t = _specs(tok, hidden_dropout=0.0, attention_dropout=0.0)
    cfg_j, cfg_t = _configs(tmp_path, learning_rate=1e-5)
    jt = JaxTrainer(cfg_j, JaxCrossEncoder(spec=spec_j, cross_enc_type="w_embeds", compute_dtype=jnp.float32),
                    total_steps=10)
    jstate = jt.init_state()
    params = _numpy_tree(jstate.params)
    tt = Trainer(cfg_t, CrossEncoder(spec_t, cross_enc_type="w_embeds", compute_dtype=torch.float32, device="cpu"),
                 total_steps=10)
    tstate = tt.init_state(params)
    negs = tdata.mine_negatives(data, "random", 3, seed=0)
    grad_fn = jax.jit(jax.value_and_grad(lambda p, mb: jt._loss_fn(p, mb, None, train=False), has_aux=True))
    jp, jopt = jstate.params, jstate.opt_state
    for batch in list(tdata.crossenc_batches(data, negs, 4, seed=0))[:3]:
        sharded = jt._shard_batch(batch)
        n_micro = sharded["pos_pairs"].shape[0]
        losses, gsum = [], None
        for i in range(n_micro):
            (loss, _), g = grad_fn(jp, {k: v[i] for k, v in sharded.items()})
            losses.append(float(loss))
            gsum = g if gsum is None else jax.tree_util.tree_map(jnp.add, gsum, g)
        grads = jax.tree_util.tree_map(lambda x: x / n_micro, gsum)
        upd, jopt = jt._tx.update(grads, jopt, jp)
        jp = jax.tree_util.tree_map(lambda a, u: a + u, jp, upd)
        metrics = tt.train_step(tstate, tt._shard_batch(batch))
        np.testing.assert_allclose(metrics["micro_losses"].numpy(), losses, atol=1e-5, rtol=0)
    assert tstate.step == 3
    want = _flat(jp)
    for name, p in tstate.params.items():
        w = want[name]
        np.testing.assert_allclose(p.detach().numpy(), w, atol=1e-5, rtol=0, err_msg=name)


# ---------------------------------------------------------------- behaviour the JAX tests pin


def _tiny_ce(tok, **kw):
    spec = tbert.BertSpec.tiny(vocab_size=tok.vocab_size, hidden_size=32, num_layers=1, num_heads=2,
                               intermediate_size=64, max_position_embeddings=64, **kw)
    return CrossEncoder(spec, compute_dtype=torch.float32, device="cpu")


def test_dropout_active_in_train_absent_in_eval(world):
    """tests/test_encoders.py:359: attention dropout applies with hidden
    dropout 0; eval mode has none and ignores the generator."""
    data, tok = world
    spec = tbert.BertSpec.tiny(vocab_size=tok.vocab_size, hidden_dropout=0.0, attention_dropout=0.5)
    params = tbert.params_module(tbert.init_bert_params(np.random.default_rng(0), spec), CPU)
    toks = torch.as_tensor(data.mention_tokens[:2])
    args = (params, toks, torch.zeros_like(toks), toks != 0, spec)
    kw = dict(compute_dtype=torch.float32)
    out_eval, _ = tbert.bert_encode(*args, **kw)
    out_train, _ = tbert.bert_encode(*args, generator=torch.Generator().manual_seed(1), dropout_on=True, **kw)
    assert not torch.allclose(out_eval, out_train)
    torch.testing.assert_close(tbert.bert_encode(*args, generator=torch.Generator(), **kw)[0], out_eval, rtol=0, atol=0)
    # the CE: train without a generator, and eval, are the same forward
    ce = _tiny_ce(tok)
    pos, _ = _pairs(data, 4, 1, 0)
    ev = ce.score(pos, LM)
    torch.testing.assert_close(ce.score(pos, LM, train=True).detach(), ev, rtol=0, atol=0)
    assert not torch.equal(ce.score(pos, LM, train=True, generator=torch.Generator().manual_seed(0)).detach(), ev)


def test_micro_batches_get_distinct_dropout(world, tmp_path):
    """tests/test_training.py:398: two identical micro-batches of one step
    see different dropout masks, hence different losses."""
    data, tok = world
    _, cfg = _configs(tmp_path, grad_acc_steps=2)
    tr = Trainer(cfg, _tiny_ce(tok), total_steps=10)
    state = tr.init_state()
    pos, neg = _pairs(data, 2, 3, 0)
    batch = {"pos_pairs": torch.as_tensor(np.stack([pos, pos])), "neg_pairs": torch.as_tensor(np.stack([neg, neg]))}
    tr._fse = LM
    ml = tr.train_step(state, batch)["micro_losses"]
    assert ml.shape == (2,) and ml[0] != ml[1]


def test_checkpoint_round_trip_and_params_cross_packages(world, tmp_path):
    """save/load round trip, and checkpoints' params crossing both ways: a
    JAX checkpoint (typed key, optax state) loads into the port without
    JAX, and the port's params score the same in JAX's CrossEncoder."""
    data, tok = world
    spec_j, spec_t = _specs(tok)
    ce_j = JaxCrossEncoder(spec=spec_j, compute_dtype=jnp.float32)
    params = ce_j.init(jax.random.PRNGKey(2))
    tx = jax_make_optimizer(params)
    jckpt.save_pytree(str(tmp_path / "j.ckpt"), {
        "params": params, "opt_state": tx.init(params), "step": 3, "rng": jax.random.key(0, impl="rbg"),
    })
    tree, _ = tckpt.load_pytree(str(tmp_path / "j.ckpt"))
    assert tree["step"] == 3 and isinstance(tree["rng"], tckpt.ForeignLeaf)
    ce_t = CrossEncoder(spec_t, compute_dtype=torch.float32, device="cpu", seed=9).load_params_(tree["params"])
    pos, _ = _pairs(data, 4, 1, 0)
    want = np.asarray(ce_j.score(params, jnp.asarray(pos), LM))
    np.testing.assert_allclose(ce_t.score(pos, LM).numpy(), want, atol=1e-4, rtol=1e-5)

    gen = torch.Generator().manual_seed(5)
    opt = {"count": 2, "mu": {"a": torch.ones(3)}, "nu": {"a": torch.zeros(3)}}
    tckpt.save_pytree(str(tmp_path / "t.ckpt"), {
        "params": crossencoder_to_jax_params(ce_t), "opt_state": opt, "step": 7, "rng": gen,
    })
    back, _ = tckpt.load_pytree(str(tmp_path / "t.ckpt"))
    assert back["step"] == 7 and back["opt_state"]["count"] == 2
    np.testing.assert_array_equal(back["opt_state"]["mu"]["a"], np.ones(3, np.float32))
    assert torch.equal(torch.as_tensor(back["rng"]), gen.get_state())
    jtree, _ = jckpt.load_pytree(str(tmp_path / "t.ckpt"))
    got = np.asarray(ce_j.score(jax.tree_util.tree_map(jnp.asarray, jtree["params"]), jnp.asarray(pos), LM))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)


def test_topk_ckpt_manager(tmp_path):
    mgr = tckpt.TopKCheckpointManager(str(tmp_path), k=2, metric="loss", mode="min")
    assert mgr.maybe_save({"x": np.ones(2)}, 1.0, step=1, epoch=0)
    assert mgr.maybe_save({"x": np.ones(2)}, 0.5, step=2, epoch=0)
    assert mgr.maybe_save({"x": np.ones(2)}, 2.0, step=3, epoch=0) is None
    assert mgr.maybe_save({"x": np.ones(2)}, 0.1, step=4, epoch=0)
    assert [e["step"] for e in mgr.entries] == [4, 2]
    assert sorted(p.name for p in tmp_path.glob("*.ckpt")) == ["loss=0.100000-step=4.ckpt", "loss=0.500000-step=2.ckpt"]
    again = tckpt.TopKCheckpointManager(str(tmp_path), k=2, metric="loss", mode="min")
    assert again.best_path() == mgr.best_path()


def test_crash_resume_bitwise_with_dropout(world, tmp_path):
    """tests/test_training.py:322 and :479: train 1 epoch, resume in a new
    Trainer for 2 more, with dropout on and a dev eval each epoch: the
    params equal an uninterrupted 3-epoch run bit for bit (the checkpoint
    carries params, moments, step and the generator state)."""
    data, tok = world
    dev = tdata.EntLinkDataset(data.mention_tokens[:8], data.entity_tokens, data.gt_labels[:8])
    kw = dict(fast_dev_run=2)

    def run(sub, epochs, resume=False):
        _, cfg = _configs(tmp_path / sub, num_epochs=epochs, **kw)
        return Trainer(cfg, _tiny_ce(tok), total_steps=30).train(data, dev_data=dev, resume=resume)

    run("a", 1)
    resumed = run("a", 3, resume=True)
    mono = run("b", 3)
    assert resumed.step == mono.step == 6
    for name, p in resumed.params.items():
        assert torch.equal(p, mono.params[name]), name
    files = sorted(p.name for p in (tmp_path / "b").rglob("*.ckpt"))
    assert "eoe-2-last.ckpt" in files and any(f.startswith("loss=") for f in files)


def test_evaluate_is_the_weighted_eval_forward(world, tmp_path):
    """dev_loss is the batch-size-weighted mean of the eval-mode losses
    (tail batch included), deterministic."""
    data, tok = world
    _, cfg = _configs(tmp_path)
    tr = Trainer(cfg, _tiny_ce(tok), total_steps=10)
    state = tr.init_state()
    negs = tdata.mine_negatives(data, "random", 3, seed=0)
    batches = list(tr._make_batches(data, negs, 5, 0, shuffle=False, for_eval=True))
    sizes = [b["pos_pairs"].shape[0] for b in batches]
    assert sum(sizes) == data.n_ments and sizes[-1] == 2
    got = tr.evaluate(state, iter(batches))
    assert got == tr.evaluate(state, iter(batches))
    losses = [float(tr._loss_fn({k: torch.as_tensor(v) for k, v in b.items() if k != "first_segment_end"}, None, train=False)[0])
              for b in batches]
    np.testing.assert_allclose(got["dev_loss"], np.average(losses, weights=sizes), rtol=1e-6)


@pytest.mark.parametrize("remat,attn_dropout", [(True, 0.0), (True, 0.1), ("attn", 0.1)])
def test_remat_gives_the_same_grads(world, remat, attn_dropout):
    """remat recomputes with the same dropout masks: grads equal those
    without remat (f32; the recompute repeats the same ops, 1e-6)."""
    data, tok = world
    pos, neg = _pairs(data, 2, 3, 0)
    grads = []
    for r in (False, remat):
        ce = _tiny_ce(tok, attention_dropout=attn_dropout)
        ce.remat = r
        ce.requires_grad_(True)
        ps = ce.score(pos, LM, train=True, generator=torch.Generator().manual_seed(3))
        ns = ce.score(neg.reshape(-1, neg.shape[-1]), LM, train=True, generator=torch.Generator().manual_seed(4))
        tlosses.crossenc_loss(ps, ns.reshape(neg.shape[:2])).backward()
        grads.append({n: p.grad.clone() for n, p in named_parameters(ce).items()})
    for name, g in grads[0].items():
        torch.testing.assert_close(grads[1][name], g, rtol=1e-6, atol=1e-7, msg=name)


def test_trainer_refuses_what_is_not_ported(world, tmp_path):
    """A model that is neither encoder is refused, and so are a tensor-
    parallel axis without a mesh and a mesh whose rank lives on another
    device than the model. Bi-encoder training is ported:
    tests/test_torch_bienc_train.py; training over a mesh:
    tests/test_torch_parallel.py."""
    from anncur_tpu_torch.parallel.mesh import Mesh

    _, tok = world
    _, cfg = _configs(tmp_path)
    with pytest.raises(TypeError, match="BiEncoder or a CrossEncoder"):
        Trainer(cfg, object())
    with pytest.raises(ValueError, match="needs a mesh"):
        Trainer(cfg, _tiny_ce(tok), tp_axis="model")
    elsewhere = Mesh(shape={"data": 1}, ranks=np.zeros(1, np.int64), coords={"data": 0}, groups={},
                     device=torch.device("meta"))
    with pytest.raises(ValueError, match="the model lives on"):
        Trainer(cfg, _tiny_ce(tok), mesh=elsewhere)


def test_config_copy_loads_the_same_files(tmp_path):
    """The port's Config has the JAX Config's fields, CLI and result_dir;
    prng_key is a seeded torch.Generator."""
    jf = {f.name for f in dataclasses.fields(JaxConfig)}
    assert {f.name for f in dataclasses.fields(Config)} == jf
    cfg_j, cfg_t = _configs(tmp_path, seed=11)
    args = ["--use_remat", "attn", "--mesh_shape", "4", "2", "--trn_files", '{"a": 1}', "--rng_impl", "threefry"]
    cfg_j.update_config_from_arg_list(args)
    cfg_t.update_config_from_arg_list(args)
    assert cfg_t.to_json() == cfg_j.to_json() and cfg_t.result_dir == cfg_j.result_dir
    path = tmp_path / "c.json"
    path.write_text(cfg_j.to_json())
    assert Config.from_json(str(path)).to_dict() == JaxConfig.from_json(str(path)).to_dict()
    g = cfg_t.prng_key()
    assert isinstance(g, torch.Generator) and torch.equal(g.get_state(), torch.Generator().manual_seed(11).get_state())
