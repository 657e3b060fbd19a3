"""DeepSeek-V2-Lite as a cross-encoder (``models/deepseek_v2.py``), its
plain reference (``models/deepseek_v2_reference.py``), causal kernel A
(``ops/attention.py``) and the expert layer (``ops/moe.py``).

On the CPU, at a tiny spec (hidden 64, 3 layers with the first dense, 8
experts with top 2 and 1 shared, latent 32, nope 16, rope 8, v 16): the
reference against transformers' ``DeepseekV2ForSequenceClassification``;
the port in f32 against the reference (the same experts at every layer,
scores within f32 rounding); the plain ops against loops; the builder and
the retriever with the new CE. Tests marked ``cuda`` hold the kernels to
the plain versions on the card and skip without one:

    python -m pytest tests/test_torch_deepseek_v2.py -q -m cuda
"""

import numpy as np
import pytest
import torch

from anncur_tpu_torch.models import deepseek_v2 as dsv2
from anncur_tpu_torch.models import deepseek_v2_reference as ref
from anncur_tpu_torch.ops import moe
from anncur_tpu_torch.ops.attention import attention, attention_fwd, attention_plain
from anncur_tpu_torch.utils.tracker import TRACER

TINY = {
    "vocab_size": 300, "hidden_size": 64, "num_hidden_layers": 3, "num_attention_heads": 4,
    "intermediate_size": 96, "moe_intermediate_size": 16, "n_routed_experts": 8, "n_shared_experts": 1,
    "num_experts_per_tok": 2, "first_k_dense_replace": 1, "kv_lora_rank": 32, "qk_nope_head_dim": 16,
    "qk_rope_head_dim": 8, "v_head_dim": 16, "rms_norm_eps": 1e-6, "rope_theta": 10000,
    "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40, "mscale": 0.707, "mscale_all_dim": 0.707,
                     "original_max_position_embeddings": 4096, "type": "yarn"},
    "routed_scaling_factor": 1, "max_position_embeddings": 163840, "q_lora_rank": None, "topk_method": "greedy",
    "scoring_func": "softmax", "norm_topk_prob": False, "n_group": 1, "topk_group": 1, "hidden_act": "silu",
}
LENGTHS = [20, 17, 13, 20, 5, 11]
# f32 against f32 through different orders of the same sums
F32_ATOL = 5e-5


def _spec(cfg=TINY):
    return dsv2.DeepseekV2Spec.from_config(cfg)


def _weights(dtype=torch.float32, device="cpu", seed=1, cfg=TINY, std=0.2):
    return dsv2.init_weights(_spec(cfg), torch.Generator(device=device).manual_seed(seed), device, dtype, std)


def _as_f32(w):
    return {"embed": w["embed"].float(), "final_norm": w["final_norm"].float(), "score": w["score"].float(),
            "layers": [{k: v.float() for k, v in lw.items()} for lw in w["layers"]]}


def _ids(device="cpu", vocab=300, lengths=LENGTHS, s=20, seed=0):
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(1, vocab, (len(lengths), s), generator=g)
    for i, n in enumerate(lengths):
        ids[i, n:] = 0
    return ids.to(device)


def _reference(w, ids, cfg=TINY):
    return ref.forward_scores(cfg, ids, w["embed"], lambda i: w["layers"][i], w["final_norm"], w["score"])


def test_spec_reads_the_published_config_and_refuses_what_it_does_not_implement():
    spec = _spec({**TINY, "num_hidden_layers": 27, "hidden_size": 2048})
    assert (spec.num_layers, spec.qk_head_dim, spec.n_moe_layers) == (27, 24, 26)
    m = 0.1 * 0.707 * np.log(40) + 1
    assert spec.softmax_scale == pytest.approx(24 ** -0.5 * m * m)
    assert dsv2.DeepseekV2Spec().softmax_scale == pytest.approx(192 ** -0.5 * 1.5896, rel=1e-4)
    for key, val in (("q_lora_rank", 1536), ("topk_method", "group_limited_greedy"), ("norm_topk_prob", True),
                     ("scoring_func", "sigmoid")):
        with pytest.raises(ValueError):
            _spec({**TINY, key: val})


def test_yarn_tables_match_the_reference():
    spec = _spec()
    cos, sin = dsv2.rope_tables(spec, 40, "cpu")
    rcos, rsin = ref.rope_tables(TINY, 40, "cpu")
    assert torch.equal(cos, rcos) and torch.equal(sin, rsin)


def test_reference_matches_transformers_sequence_classification():
    """transformers 4.57's ``DeepseekV2Attention`` scales scores by
    qk_head_dim^-0.5 alone; the source's ``modeling_deepseek.py`` (which the
    reference follows) also multiplies by yarn_get_mscale(factor,
    mscale_all_dim)^2. So each layer's ``scaling`` is set to the source's
    value before the comparison; everything else is transformers' own."""
    transformers = pytest.importorskip("transformers")
    cfg = dict(TINY)
    hf_cfg = transformers.DeepseekV2Config(
        **{k: v for k, v in cfg.items() if k != "scoring_func"}, pad_token_id=0, num_labels=1,
        num_key_value_heads=cfg["num_attention_heads"], attn_implementation="eager")
    model = transformers.DeepseekV2ForSequenceClassification(hf_cfg).eval()
    w = _weights()
    sd = {"model.embed_tokens.weight": w["embed"], "model.norm.weight": w["final_norm"], "score.weight": w["score"].T}

    def mlp(prefix, gate_up, down):
        width = gate_up.shape[-1] // 2
        sd.update({prefix + "gate_proj.weight": gate_up[:, :width].T, prefix + "up_proj.weight": gate_up[:, width:].T,
                   prefix + "down_proj.weight": down.T})

    for i, lw in enumerate(w["layers"]):
        p = f"model.layers.{i}."
        sd.update({p + "input_layernorm.weight": lw["attn_norm"], p + "post_attention_layernorm.weight": lw["mlp_norm"],
                   p + "self_attn.q_proj.weight": lw["q"].T, p + "self_attn.kv_a_proj_with_mqa.weight": lw["kv_a"].T,
                   p + "self_attn.kv_a_layernorm.weight": lw["kv_norm"], p + "self_attn.kv_b_proj.weight": lw["kv_b"].T,
                   p + "self_attn.o_proj.weight": lw["o"].T})
        if "gate_up" in lw:
            mlp(p + "mlp.", lw["gate_up"], lw["down"])
        else:
            sd[p + "mlp.gate.weight"] = lw["router"]
            for e in range(cfg["n_routed_experts"]):
                mlp(p + f"mlp.experts.{e}.", lw["experts_gate_up"][e], lw["experts_down"][e])
            mlp(p + "mlp.shared_experts.", lw["shared_gate_up"], lw["shared_down"])
    model.load_state_dict({k: v.contiguous() for k, v in sd.items()}, strict=True)
    for layer in model.model.layers:
        layer.self_attn.scaling = ref.softmax_scale(cfg)
    ids = _ids()
    with torch.no_grad():
        hf = model(input_ids=ids, attention_mask=(ids != 0).long()).logits[:, 0]
    want = _reference(w, ids)
    assert want.std() > 0.3  # pairs score apart
    torch.testing.assert_close(want, hf, atol=F32_ATOL, rtol=0)


def test_port_matches_the_reference_in_f32_expert_for_expert(monkeypatch):
    w = _weights()
    ids = _ids()
    valid = ids != 0
    last = (torch.arange(ids.shape[1]) * valid).argmax(-1)
    got_ids, want_ids = [], []

    def route(x, gate, top_k, scale=1.0):
        out = moe.route(x, gate, top_k, scale)
        got_ids.append(out[0])
        return out

    moe_ref = ref.moe

    def ref_moe(x, lw, cfg):
        probs = torch.softmax(x @ lw["router"].T, dim=-1)
        want_ids.append(torch.sort(probs, dim=-1, descending=True, stable=True).indices[:, :cfg["num_experts_per_tok"]])
        return moe_ref(x, lw, cfg)

    monkeypatch.setattr(dsv2, "route", route)
    monkeypatch.setattr(ref, "moe", ref_moe)
    ce = dsv2.DeepseekV2CrossEncoder(_spec(), "cpu", weights=w, compute_dtype=torch.float32)
    got = ce.score(ids, first_segment_end=8)
    want = _reference(w, ids)
    torch.testing.assert_close(got, want, atol=F32_ATOL, rtol=0)
    assert len(got_ids) == len(want_ids) == 2
    b, s = ids.shape
    torch.testing.assert_close(got_ids[0].view(b, s, -1)[valid], want_ids[0].view(b, s, -1)[valid], atol=0, rtol=0)
    torch.testing.assert_close(got_ids[1], want_ids[1].view(b, s, -1)[torch.arange(b), last], atol=0, rtol=0)


def test_port_in_bf16_stays_near_the_reference():
    w = _weights(torch.bfloat16, std=0.1)
    ids = _ids()
    got = dsv2.DeepseekV2CrossEncoder(_spec(), "cpu", weights=w).score(ids, 8)
    want = _reference(_as_f32(w), ids)
    assert got.dtype == torch.float32
    # bf16 activations through three layers: far below the pairs' spread
    assert float((got - want).abs().max()) < 0.1 * float(want.std())


def test_expert_rows_count_every_token_and_slot():
    TRACER.reset_counter(dsv2.EXPERT_ROWS)
    ids = _ids()
    dsv2.DeepseekV2CrossEncoder(_spec(), "cpu", weights=_weights(), compute_dtype=torch.float32).score(ids, 8)
    rows = TRACER.read_counter(dsv2.EXPERT_ROWS)
    k = TINY["num_experts_per_tok"]
    b, s = ids.shape
    # layer 1 runs every position; the final layer (2) the last one a pair
    assert rows.shape == (2, TINY["n_routed_experts"])
    assert rows.sum(1).tolist() == [b * s * k, b * k]


def test_causal_attention_plain_is_a_masked_einsum():
    g = torch.Generator().manual_seed(3)
    b, s, nh, hd, hv = 3, 37, 2, 24, 16
    q, k = (torch.randn(b, s, nh, hd, generator=g) for _ in range(2))
    v = torch.randn(b, s, nh, hv, generator=g)
    valid = torch.arange(s)[None, :] < torch.tensor([[37], [20], [1]])
    scale = 0.3
    out = attention_plain(q, k, v, valid, causal=True, scale=scale)
    sc = torch.einsum("bqnd,bknd->bnqk", q, k) * scale
    allowed = torch.tril(torch.ones(s, s, dtype=torch.bool))[None, None] & valid[:, None, None, :]
    # a row whose visible keys are all invalid attends them evenly (-1e9 each)
    sc = torch.where(allowed, sc, torch.where(torch.tril(torch.ones(s, s, dtype=torch.bool)), -1e9, -torch.inf))
    want = torch.einsum("bnqk,bknd->bqnd", torch.softmax(sc, -1), v)
    torch.testing.assert_close(out, want, atol=1e-6, rtol=0)
    assert out.shape == (b, s, nh, hv)
    assert torch.equal(attention(q, k, v, valid, causal=True, scale=scale), out)
    with pytest.raises(ValueError):
        attention_plain(q[:, :5], k, v, valid, causal=True)


def _routing(t=50, e=8, k=3, seed=0):
    g = torch.Generator().manual_seed(seed)
    x, gate = torch.randn(t, 16, generator=g), torch.randn(e, 16, generator=g)
    return moe.route(x, gate, k)


def test_route_is_the_softmax_top_k_with_ties_to_the_lowest_id():
    ids, weights = _routing()
    assert ids.shape == weights.shape == (50, 3) and weights.dtype == torch.float32
    assert (weights[:, :-1] >= weights[:, 1:]).all()
    x = torch.zeros(4, 16)  # every logit equal: experts 0, 1, 2
    ids, weights = moe.route(x, torch.randn(8, 16), 3, scale=2.0)
    assert ids.tolist() == [[0, 1, 2]] * 4
    torch.testing.assert_close(weights, torch.full((4, 3), 2.0 / 8))


def test_sort_rows_groups_rows_by_expert_in_token_order():
    ids, _ = _routing()
    order = moe.sort_rows(ids, 8)
    dest = order.dest.long()
    assert sorted(dest.tolist()) == list(range(ids.numel()))
    ends = order.ends.long().tolist()
    starts = [0] + ends[:-1]
    for e in range(8):
        slots = (ids.reshape(-1) == e).nonzero()[:, 0]
        assert dest[slots].tolist() == list(range(starts[e], ends[e]))
        assert int(order.counts[e]) == len(slots)


def test_permute_and_combine_plain_against_loops():
    ids, weights = _routing()
    order = moe.sort_rows(ids, 8)
    g = torch.Generator().manual_seed(5)
    x = torch.randn(50, 16, generator=g).to(torch.bfloat16)
    xs = moe.moe_permute_plain(x, order.dest)
    for t in range(50):
        for i in range(3):
            assert torch.equal(xs[order.dest[t * 3 + i]], x[t])
    y = torch.randn(order.dest.numel(), 16, generator=g).to(torch.bfloat16)
    shared, resid = (torch.randn(50, 16, generator=g).to(torch.bfloat16) for _ in range(2))
    out = moe.moe_combine_plain(y, order.dest, weights, shared, resid)
    for t in range(50):
        acc = torch.zeros(16)
        for i in range(3):
            acc = acc + weights[t, i] * y[order.dest[t * 3 + i]].float()
        assert torch.equal(out[t], resid[t] + (acc.to(torch.bfloat16) + shared[t]))


def test_expert_mlp_plain_runs_each_expert_on_its_rows():
    ids, _ = _routing()
    order = moe.sort_rows(ids, 8)
    g = torch.Generator().manual_seed(6)
    xs = torch.randn(order.dest.numel(), 16, generator=g)
    wgu, wd = torch.randn(8, 16, 10, generator=g), torch.randn(8, 5, 16, generator=g)
    y = moe.expert_mlp(xs, wgu, wd, order)
    flat = ids.reshape(-1)
    for slot in range(flat.numel()):
        e, r = int(flat[slot]), int(order.dest[slot])
        h = xs[r] @ wgu[e]
        torch.testing.assert_close(y[r], (torch.nn.functional.silu(h[:5]) * h[5:]) @ wd[e])


def _world(n_m=5, n_e=30, lm=8, le=8, seed=0):
    rng = np.random.default_rng(seed)
    ments = rng.integers(5, 298, (n_m, lm)).astype(np.int32)
    ents = rng.integers(5, 298, (n_e, le)).astype(np.int32)
    ments[:, 0] = ents[:, 0] = 298
    ents[:, -1] = 299
    return ments, ents


def test_score_matrix_builder_with_the_decoder_ce():
    from anncur_tpu_torch.indexer.score_matrix import ScoreMatrixBuilder, build_pairs, padded_pair_len

    w = _weights()
    ce = dsv2.DeepseekV2CrossEncoder(_spec(), "cpu", weights=w, compute_dtype=torch.float32)
    ments, ents = _world()
    got = ScoreMatrixBuilder(ce, ment_block=2, ent_block=4, max_pairs_per_program=16, device="cpu")(ments, ents)
    pl = padded_pair_len(8, 8, 128, ce.spec.max_position_embeddings)
    want = _reference(w, build_pairs(torch.as_tensor(ments), torch.as_tensor(ents), pl)).view(5, 30).numpy()
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)


def test_cur_retriever_build_and_query_with_the_decoder_ce():
    from anncur_tpu_torch.core.retriever import CurRetriever
    from anncur_tpu_torch.indexer.score_matrix import ScoreMatrixBuilder, build_pairs, padded_pair_len
    from anncur_tpu_torch.models.tokenizer import WordPieceTokenizer, make_test_vocab

    w = _weights()
    ce = dsv2.DeepseekV2CrossEncoder(_spec(), "cpu", weights=w, compute_dtype=torch.float32)
    ments, ents = _world(n_m=12, n_e=24)
    ret = CurRetriever.build(ce, WordPieceTokenizer(make_test_vocab()), ments[:8], ents, n_anchor_items=10,
                             builder=ScoreMatrixBuilder(ce, device="cpu"), seed=0, max_query_len=8, device="cpu")
    pl = padded_pair_len(8, 8, 128, ce.spec.max_position_embeddings)
    full = _reference(w, build_pairs(torch.as_tensor(ments), torch.as_tensor(ents), pl)).view(12, 24).numpy()
    scores, item_ids = ret.query_tokens_batch(ments[8:], top_k=5, top_k_retvr=12)
    assert scores.shape == item_ids.shape == (4, 5)
    np.testing.assert_allclose(scores, np.take_along_axis(full[8:], item_ids, axis=1), atol=F32_ATOL, rtol=0)


# ------------------------------------------------------------------ card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("g_mode", ["g=s", "g=1"])
def test_kernel_a_causal_hd192_against_plain(g_mode):
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(7)
    b, s, nh = 24, 256, 16
    q, k = (torch.randn(b, s, nh, 192, generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
    v = torch.randn(b, s, nh, 128, generator=gen, device=dev).to(torch.bfloat16)
    n_keys = torch.randint(1, s + 1, (b,), generator=gen, device=dev)
    valid = torch.arange(s, device=dev)[None, :] < n_keys[:, None]
    scale = dsv2.DeepseekV2Spec().softmax_scale
    if g_mode == "g=s":
        out = attention(q, k, v, valid, causal=True, scale=scale)
        want = attention_plain(q, k, v, valid, causal=True, scale=scale)
        rows = valid  # rows past a pair's last key: computed, read by nobody
    else:
        last = n_keys - 1
        q1 = q[torch.arange(b, device=dev), last][:, None]
        out = attention(q1, k, v, valid, scale=scale)
        want = attention_plain(q1, k, v, valid, scale=scale)
        rows = torch.ones(b, 1, dtype=torch.bool, device=dev)
    torch.cuda.synchronize()
    assert out.shape == want.shape
    # bf16 P (as kernel A rounds it) against the f32 plain softmax
    torch.testing.assert_close(out[rows].float(), want[rows].float(), atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("hd,hv", [(24, 16), (64, 64), (192, 128)])
def test_kernel_a_causal_takes_hd_192_and_pads_narrower_heads(hd, hv):
    """The causal body is built at hd 192 alone: attention() zero-pads
    narrower q, k and v to it (the tiny spec's 24), and kernel A's entry
    refuses any other width."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(8)
    b, s, nh = 6, 80, 2
    q, k = (torch.randn(b, s, nh, hd, generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
    v = torch.randn(b, s, nh, hv, generator=gen, device=dev).to(torch.bfloat16)
    valid = torch.arange(s, device=dev)[None, :] < torch.randint(1, s + 1, (b, 1), generator=gen, device=dev)
    out = attention(q, k, v, valid, causal=True, scale=0.3)
    want = attention_plain(q, k, v, valid, causal=True, scale=0.3)
    assert out.shape == want.shape
    torch.testing.assert_close(out[valid].float(), want[valid].float(), atol=2e-2, rtol=2e-2)
    if hd == 64:
        with pytest.raises(ValueError, match="hd 192"):
            attention_fwd(q, k, q, valid, causal=True, scale=0.3)


@pytest.mark.cuda
def test_dispatch_kernels_match_plain_bit_for_bit():
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(8)
    t, e, k, h = 4099, 64, 6, 2048
    x = torch.randn(t, h, generator=gen, device=dev).to(torch.bfloat16)
    ids, weights = moe.route(x, torch.randn(e, h, generator=gen, device=dev).to(torch.bfloat16) * 0.05, k)
    order = moe.sort_rows(ids, e)
    assert torch.equal(moe.moe_permute(x, order.dest), moe.moe_permute_plain(x, order.dest))
    y = torch.randn(order.dest.numel(), h, generator=gen, device=dev).to(torch.bfloat16)
    shared, resid = (torch.randn(t, h, generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
    runs = [moe.moe_combine(y, order.dest, weights, shared, resid) for _ in range(3)]
    torch.cuda.synchronize()
    want = moe.moe_combine_plain(y, order.dest, weights, shared, resid)
    assert all(torch.equal(r, want) for r in runs)


@pytest.mark.cuda
def test_grouped_experts_match_the_loop():
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(9)
    t, e, k, h, wd = 3000, 64, 6, 2048, 1408
    x = torch.randn(t, h, generator=gen, device=dev).to(torch.bfloat16)
    ids, _ = moe.route(x, torch.randn(e, h, generator=gen, device=dev) * 0.05, k)
    order = moe.sort_rows(ids, e)
    xs = moe.moe_permute(x, order.dest)
    wgu = (torch.randn(e, h, 2 * wd, generator=gen, device=dev) * 0.02).to(torch.bfloat16)
    wdn = (torch.randn(e, wd, h, generator=gen, device=dev) * 0.02).to(torch.bfloat16)
    got = moe.expert_mlp(xs, wgu, wdn, order)
    want = moe.expert_mlp_plain(xs, wgu, wdn, order)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
def test_bf16_ce_on_the_card_against_the_f32_reference_tiny():
    dev = _card()
    w = _weights(torch.bfloat16, dev, std=0.1)
    ids = _ids(dev)
    got = dsv2.DeepseekV2CrossEncoder(_spec(), dev, weights=w).score(ids, 8)
    want = _reference(_as_f32(w), ids)
    assert float((got - want).abs().max()) < 0.1 * float(want.std())


@pytest.mark.cuda
def test_bf16_ce_on_the_card_one_published_width_layer():
    """One expert layer at the published widths (with a dense layer before
    it, so the causal attention and the experts run at full size), bf16
    against the f32 reference."""
    dev = _card()
    cfg = {**TINY, "vocab_size": 1000, "hidden_size": 2048, "num_attention_heads": 16, "intermediate_size": 10944,
           "moe_intermediate_size": 1408, "n_routed_experts": 64, "n_shared_experts": 2, "num_experts_per_tok": 6,
           "kv_lora_rank": 512, "qk_nope_head_dim": 128, "qk_rope_head_dim": 64, "v_head_dim": 128,
           "num_hidden_layers": 3}
    w = _weights(torch.bfloat16, dev, cfg=cfg, std=0.05)
    ids = _ids(dev, vocab=1000, lengths=[256, 255, 200, 130] * 4, s=256)
    got = dsv2.DeepseekV2CrossEncoder(_spec(cfg), dev, weights=w).score(ids, 128)
    want = _reference(_as_f32(w), ids, cfg)
    assert float((got - want).abs().max()) < 0.1 * float(want.std())
