"""The port's drivers (``anncur_tpu_torch/tools/``) on the CPU at a tiny
size: the serving soak in fixed and adaptive-with-escalation mode with its
contract asserted (as ``tests/test_serving_soak.py`` runs the JAX
driver's), and every other driver through its ``main(argv)`` to its JSON
keys; the matched-recall sweep against JAX's oracle functions, the
early-stop rows against the retriever's own calls, bucketed against padded
builds, one rank against two, the trained-CE matrix's layout against the
committed JAX one and its training and scores against JAX's from one
start. Their numbers are CPU numbers: the card's are
``chip_smoke.py``'s (phases 12 and 14)."""

import json

import numpy as np
import pytest
import torch

from anncur_tpu_torch.tools import (
    _common,
    adaptive_matched_recall,
    bench_early_stop,
    bench_http_serving,
    bench_nitems_scaling,
    bench_serving_latency,
    make_trained_ce_matrix,
    measure_packing,
    military_scale,
    multichip_scaling,
    serving_soak,
)

torch.set_num_threads(2)  # xdist runs several test files side by side


@pytest.mark.parametrize("mode", ["fixed", "adaptive"])
def test_soak_holds_the_serving_contract_under_churn(tmp_path, mode):
    """Stable ids, no errors or hung clients, a bounded tail and memory,
    no kernel rebuilt: asserted inside ``run_soak``."""
    srv = serving_soak.build_server(str(tmp_path), mode=mode, tiny=True, device="cpu")
    try:
        res = serving_soak.run_soak(srv.base, seconds=4.0, n_clients=4, mutate=True, server=srv.server)
    finally:
        srv.close()
    assert res["counts"]["query"] > 0 and res["counts"]["add"] > 0 and res["counts"]["remove"] > 0
    assert set(res["latency_s"]) == {"query", "add", "remove"}
    assert res["kernel_builds"]["loaded"] == [] and "device_mb" not in res  # CPU: no kernel, no card memory
    assert res["rss_growth_frac_after_warm"] is not None


def test_soak_flags_a_query_that_returns_a_removed_id(tmp_path, monkeypatch):
    """The stable-id check bites: a server that keeps answering with an id
    after its /remove completed fails the soak."""
    srv = serving_soak.build_server(str(tmp_path), mode="fixed", tiny=True, device="cpu")
    retriever = srv.server.retriever
    removed = []
    remove = retriever.remove_items

    def remove_but_remember(ids):
        removed.extend(int(i) for i in ids)
        return remove(ids)

    query = retriever.query_tokens_batch

    def query_with_removed(*a, **k):
        scores, ids = query(*a, **k)
        if removed:
            ids = ids.copy()
            ids[:, 0] = removed[-1]
        return scores, ids

    monkeypatch.setattr(retriever, "remove_items", remove_but_remember)
    monkeypatch.setattr(retriever, "query_tokens_batch", query_with_removed)
    try:
        with pytest.raises(AssertionError, match="removed ids"):
            serving_soak.run_soak(srv.base, seconds=2.0, n_clients=2, mutate=True, server=srv.server)
    finally:
        srv.close()


def _json(path):
    with open(path) as fin:
        return json.load(fin)


def test_bench_serving_latency_tiny(tmp_path):
    out = str(tmp_path / "lat.json")
    bench_serving_latency.main(["--tiny", "--device", "cpu", "--reps", "2", "--fixed_batches", "1", "4",
                                "--ada_batches", "1", "4", "--out", out])
    res = _json(out)
    assert res["device"] == "cpu"
    assert set(res["results"]) == {"fixed_b1", "fixed_b4", "adaptive_b1", "adaptive_b4", "add_then_query"}
    for row in ("fixed_b4", "adaptive_b4"):
        assert {"p50_ms", "p95_ms", "qps", "first_s", "reps", "times_ms"} <= set(res["results"][row])
        assert res["results"][row]["p95_ms"] >= res["results"][row]["p50_ms"] > 0
    assert res["results"]["add_then_query"]["n_added"] == 16


def test_bench_http_serving_tiny(tmp_path):
    out = str(tmp_path / "http.json")
    bench_http_serving.main(["--tiny", "--device", "cpu", "--clients", "4", "--per_client", "2",
                             "--seq_baseline", "2", "--out", out])
    res = _json(out)
    assert res["device"] == "cpu" and res["config"]["clients"] == 4
    assert res["sequential_1_client"]["queries"] == 2 and res["concurrent"]["queries"] == 8
    for key in ("qps", "latency_p50_ms", "latency_p95_ms", "device_dispatches", "queries_per_dispatch"):
        assert res["concurrent"][key] > 0


def test_military_scale_quick(tmp_path):
    out = str(tmp_path / "mil.json")
    military_scale.main(["--quick", "--device", "cpu", "--out", out])
    res = _json(out)
    assert set(res["stages"]) == set(military_scale.STAGES)
    stages = res["stages"]
    assert stages["mips"]["shape"] == {"q": 256, "n": 4096, "d": 64, "k": 16}
    assert stages["offline_build"]["n_ents"] == 2048 and stages["offline_build"]["pairs_per_s"] > 0
    assert stages["serving"]["fixed"]["q_per_s"] > 0 and stages["serving"]["adaptive"]["q_per_s"] > 0
    assert list(stages["serving_batch"]["runs"]) == ["20"]
    assert 0.0 <= stages["adaptive_oracle"]["fixed_recall_cost600"] <= 1.0


def test_bench_nitems_scaling_cpu(tmp_path):
    out = str(tmp_path / "ni.json")
    bench_nitems_scaling.main(["--cpu", "--n_items", "600", "1100", "--batches", "1", "8", "--reps", "1",
                               "--budget", "60", "--rounds", "3", "--shortlist_also", "300", "--out", out])
    res = _json(out)
    assert res["device"] == "cpu" and set(res["scales"]) == {"600", "1100"}
    assert set(res["scales"]["1100"]) == {"padded_items", "fixed_b8", "adaptive_b1", "adaptive_b8", "adaptive_b8_r1",
                                          "adaptive_b1_sl300", "adaptive_b8_sl300"}
    assert res["scales"]["1100"]["padded_items"] == 2048


def test_an_add_scores_one_ce_pair_per_anchor_query_and_item(tmp_path):
    """/add pays k_q CE pairs per new item: its builder's blocks fit the
    anchor queries and the items, so no padded item is scored (the
    builder's default 8 x 64 blocks scored 512 pairs for one item here)."""
    srv = serving_soak.build_server(str(tmp_path), mode="fixed", tiny=True, device="cpu")
    encoder = srv.server.retriever.encoder
    k_q = len(srv.server.retriever.train_query_tokens)
    pairs, score = [], encoder.score

    def counted(toks, *a, **k):
        pairs.append(toks.shape[0])
        return score(toks, *a, **k)

    encoder.score = counted
    try:
        for n_new in (1, 3):
            pairs.clear()
            code, out = _common.http_call(
                srv.base, "/add", {"items": [{"title": f"new {i}", "description": "gamma"} for i in range(n_new)]})
            assert code == 200 and len(out["ids"]) == n_new
            assert sum(pairs) == k_q * n_new, (pairs, k_q)
    finally:
        del encoder.score
        srv.close()


# --------------------------------------------------------- adaptive_matched_recall


@pytest.fixture(scope="module")
def amr_tiny(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("amr") / "amr.json")
    return out, adaptive_matched_recall.main(["--tiny", "--device", "cpu", "--out", out])


def test_adaptive_matched_recall_tiny_equals_jax_oracles(amr_tiny):
    """The tiny sweep's rank60 and trained_ce scenarios against JAX's own
    oracle functions on the same matrices: the same matched budgets, and
    the fixed-anchor, budget-sweep and early-stop recalls within 1e-6
    (f32 means of the same hit counts)."""
    from anncur_tpu.core import adaptive_fused as jax_af

    _, res = amr_tiny
    grid = adaptive_matched_recall.TINY
    assert set(res["scenarios"]) == {"rank60", "trained_ce", "trained_ce_hard"}
    for name in ("rank60", "trained_ce"):
        if name == "rank60":
            full, train = adaptive_matched_recall.make_matrix(7, grid["n_q"], grid["n_train"], grid["n_items"], 60, 0.05)
        else:
            full, train, _ = adaptive_matched_recall.load_trained_ce(
                f"{adaptive_matched_recall.BENCH_DIR}/trained_ce_matrix_quick.npz")
        scen = res["scenarios"][name]
        for key, method, n_rounds in (("cur_r3", "cur", 3), ("axn_r5", "axn", 5)):
            want = jax_af.matched_recall_budget(
                full, train, *grid["fixed"], top_k=10, n_rounds=n_rounds, seeds=grid["seeds"],
                budgets=grid["budgets"], method=method,
                axn_rank=adaptive_matched_recall.axn_rank_of(train) if method == "axn" else None)
            got = scen[key]
            assert got["matched_budget"] == want["matched_budget"], (name, key)
            assert abs(got["fixed_recall"] - want["fixed_recall"]) <= 1e-6
            for b, r in want["adaptive_sweep"].items():
                assert abs(got["adaptive_sweep"][b] - r) <= 1e-6, (name, key, b)
        base, base_rounds, ceiling, esc_rounds = grid["es_configs"][0]
        rec, avg, frac = jax_af.adaptive_recall_oracle_early_stop(
            full, train, base, base_rounds, ceiling, esc_rounds, top_k=10, seed=0)
        got = scen["early_stop"]["configs"][f"b{base}r{base_rounds}_e{ceiling}r{esc_rounds}"]
        assert got["avg_budget"] == avg and got["frac_escalated"] == frac
        # the ceiling's 120 scored ids exceed rank60's 80 train rows: the
        # ridge solve is then underdetermined and rounding picks between
        # near-equal completions (one query's set differs, JAX's and the
        # port's alike), so there the recall is held within one hit of 160;
        # below the train rank the two engines agree exactly (next block)
        tol = 1.0 / (grid["n_q"] * 10) if ceiling > train.shape[0] else 1e-6
        assert abs(got["recall"] - rec) <= tol + 1e-7, (name, got["recall"], rec)
    full, train = adaptive_matched_recall.make_matrix(7, grid["n_q"], grid["n_train"], grid["n_items"], 60, 0.05)
    want = jax_af.adaptive_recall_oracle_early_stop(full, train, 30, 3, 60, 3, top_k=10, seed=0)
    got = adaptive_matched_recall.adaptive_recall_oracle_early_stop(full, train, 30, 3, 60, 3, top_k=10, seed=0,
                                                                    device="cpu")
    assert abs(got[0] - want[0]) <= 1e-6 and got[1:] == tuple(want[1:])
    # the headline policy: JAX's compute_headline on the port's sweep
    import copy
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "jax_amr", f"{adaptive_matched_recall.BENCH_DIR}/../tools/adaptive_matched_recall.py")
    jax_amr = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_amr)
    want = copy.deepcopy(res)
    jax_amr.compute_headline(want)
    assert {k: v for k, v in res.items() if k.startswith("headline")} == {
        k: v for k, v in want.items() if k.startswith("headline")}
    assert res["headline_matched_budget"] is not None


def test_early_stop_sweep_runs_on_the_card_unless_told_otherwise(monkeypatch):
    """``early_stop_sweep`` with no device resolves ``"cuda"`` as every
    other entry does: without a card it raises, as ``resolve_device`` does,
    and does not run on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    grid = adaptive_matched_recall.TINY
    full, train = adaptive_matched_recall.make_matrix(7, grid["n_q"], grid["n_train"], grid["n_items"], 60, 0.05)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        adaptive_matched_recall.early_stop_sweep(full, train, *grid["fixed"], grid["seeds"], grid["es_configs"])


def test_adaptive_matched_recall_es_only_skips_unswept_scenarios_and_honours_budgets(amr_tiny, tmp_path, capsys):
    """``--es_only`` over an artifact that lacks a scenario skips it with a
    warning (JAX's tool raises KeyError there), keeps the swept ones'
    budget sweeps, and re-sweeps them at ``--budgets`` when given."""
    src, _ = amr_tiny
    with open(src) as fin:
        prior = json.load(fin)
    del prior["scenarios"]["trained_ce_hard"]
    out = str(tmp_path / "amr.json")
    with open(out, "w") as fout:
        json.dump(prior, fout)
    threads = torch.get_num_threads()
    res = adaptive_matched_recall.main(["--tiny", "--device", "cpu", "--es_only", "--out", out])
    assert "trained_ce_hard" not in res["scenarios"] and res["skipped_scenarios"] == ["trained_ce_hard"]
    assert "--es_only skips it" in capsys.readouterr().err
    assert res["scenarios"]["rank60"]["cur_r3"] == prior["scenarios"]["rank60"]["cur_r3"]
    res = adaptive_matched_recall.main(["--tiny", "--device", "cpu", "--es_only", "--budgets", "60", "30",
                                        "--out", out])
    assert torch.get_num_threads() == threads  # the sweep's one thread is the sweep's alone
    assert res["budgets"] == [30, 60]
    for scen in ("rank60", "trained_ce"):
        assert set(map(int, res["scenarios"][scen]["cur_r8"]["adaptive_sweep"])) == {30, 60}
        assert "early_stop" in res["scenarios"][scen]


# ---------------------------------------------------------------- bench_early_stop


def test_bench_early_stop_rows_equal_the_retrievers_direct_calls(tmp_path):
    """Each end-to-end row's budget and escalated share are the retriever's
    own stats on the same world and queries; one bucket row at q = 8; each
    scenario's derived q/s is q over phase 1's time plus its bucket's."""
    out = str(tmp_path / "es.json")
    res = bench_early_stop.main(["--cpu", "--q", "8", "--reps", "1", "--out", out])
    assert _json(out)["e2e"].keys() == {"stable_all", "natural", "escalate_all"}
    assert "none" in res["compile_per_bucket"] and "compile_plus_first_s" not in json.dumps(res)
    _, es = bench_early_stop.headline_config()
    world = dict(_common.TINY_WORLD, n_items=1000)
    retriever, train, rng = _common.build_retriever(_common.make_encoder(True, "cpu"), **world)
    qt = rng.integers(1, retriever.encoder.spec.vocab_size, size=(8, world["seq_len"])).astype("int32")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for name, overlap in bench_early_stop.REGIMES:
            _, _, stats = retriever.query_tokens_adaptive_fused(
                qt, **bench_early_stop.e2e_kwargs(es, torch.as_tensor(train), overlap))
            row = res["e2e"][name]
            assert (row["avg_budget"], row["frac_escalated"]) == (stats["avg_budget"], stats["frac_escalated"]), name
    finally:
        torch.set_num_threads(threads)
    assert res["e2e"]["stable_all"]["frac_escalated"] == 0.0 and res["e2e"]["escalate_all"]["frac_escalated"] == 1.0
    assert list(res["phase2_buckets"]) == ["8"]
    t1 = res["e2e"]["stable_all"]["med_s"]
    for row in res["per_scenario"].values():
        t = t1 + (res["phase2_buckets"][str(row["bucket_at_q"])]["med_s"] if row["bucket_at_q"] else 0.0)
        assert row["derived_qps"] == pytest.approx(8 / t)


# ---------------------------------------------------------------- measure_packing


def test_measure_packing_bucketed_scores_equal_padded(tmp_path):
    """Dropping entity padding changes no score: the bucketed build equals
    the padded one exactly on the CPU (f32, the same kernels), in every
    regime; the padding ratios are the regimes' own."""
    res = measure_packing.main(["--quick", "--out", str(tmp_path / "pack.json")])
    assert set(res["regimes"]) == set(measure_packing.REGIMES)
    for name, row in res["regimes"].items():
        assert row["max_abs_err"] == 0.0, name
        assert sum(row["bucket_sizes"].values()) == res["shape"]["n_ents"]
        assert row["padded_pairs_per_s"] > 0 and row["bucketed_pairs_per_s"] > 0
    ratios = [res["regimes"][r]["padding_ratio"] for r in ("full", "mixed", "short")]
    assert ratios[0] == 0.0 < ratios[1] < ratios[2]


# -------------------------------------------------------------- multichip_scaling


def test_multichip_scaling_one_and_two_gloo_ranks_give_equal_answers(tmp_path):
    """The quick world's fixed and adaptive answers on a 1-rank and a 2-rank
    gloo mesh (one process per rank) are the same; each row has its
    rates, and the overheads are against one rank."""
    res = multichip_scaling.main(["--quick", "--device", "cpu", "--nproc", "1", "2", "--timeout", "300",
                                  "--out", str(tmp_path / "mcs.json")])
    one, two = res["answers"]["1"], res["answers"]["2"]
    assert one["fixed_ids"] == two["fixed_ids"] and one["adaptive_ids"] == two["adaptive_ids"]
    assert max(abs(a - b) for ra, rb in zip(one["fixed_scores"], two["fixed_scores"]) for a, b in zip(ra, rb)) <= 1e-5
    assert res["rows"]["2"]["backend"] == "gloo" and res["rows"]["2"]["n_ranks"] == 2
    assert res["fixed_overhead_vs_1rank"]["1"] == 0.0 and res["rows"]["1"]["adaptive_q_per_s_total"] > 0


# --------------------------------------------------------- make_trained_ce_matrix


def test_make_trained_ce_matrix_quick_against_the_committed_jax_matrix(tmp_path):
    """The quick rare-word world (the committed ``trained_ce_matrix_quick.npz``
    is JAX's) through the port's trainer and builder: the same layout and
    shapes, a finite training loss near JAX's, and the spectrum and gold
    ranks within the band of two barely trained CEs. The packages draw
    other random numbers, so entries are not compared. Bands: the final
    loss within 0.1 of JAX's (both sit near ln 5 = 1.61 after 30 steps),
    s2/s1 within 0.25 and gold-in-top-64 within 0.25 (16 eval rows: one
    row is 0.0625). An untrained CE passes these bands as well; the
    training itself is held to JAX's by the next test."""
    out = str(tmp_path / "tce.npz")
    meta = make_trained_ce_matrix.main(["--quick", "--world", "rare", "--device", "cpu", "--out", out])
    got, want = np.load(out), np.load(f"{adaptive_matched_recall.BENCH_DIR}/trained_ce_matrix_quick.npz")
    assert got["scores"].dtype == np.float16 and got["scores"].shape == want["scores"].shape
    assert (int(got["n_train"]), int(got["n_q"])) == (int(want["n_train"]), int(want["n_q"]))
    jax_meta = json.loads(str(want["meta"]))
    assert json.loads(str(got["meta"])) == meta and meta["train_steps"] == jax_meta["train_steps"]
    assert abs(meta["final_loss"] - jax_meta["final_loss"]) <= 0.1
    assert abs(meta["s2_over_s1"] - jax_meta["s2_over_s1"]) <= 0.25
    assert abs(meta["gold_in_top64_frac"] - jax_meta["gold_in_top64_frac"]) <= 0.25
    # the matched-recall sweep reads it as it reads JAX's
    full, train, _ = adaptive_matched_recall.load_trained_ce(out)
    assert full.shape == (16, 400) and train.shape == (60, 400)


@pytest.fixture()
def keep_all_head_masks(monkeypatch):
    """The 'default' CE head drops its input at 0.1 in training in both
    packages, from generators that draw other numbers. Here every mask
    keeps every unit (inverted dropout's 1/0.9 scale kept), so the two
    trainers see one deterministic function; the spec's own rates are 0."""
    import jax
    import jax.numpy as jnp

    import anncur_tpu_torch.models.crossencoder as tce

    monkeypatch.setattr(jax.random, "bernoulli", lambda key, p, shape: jnp.ones(shape, bool))
    monkeypatch.setattr(tce, "dropout", lambda x, seed, rate: x if seed is None else x / (1.0 - rate))
    # one thread: with two, the CPU's reductions change order from run to
    # run, and the port's own trajectory does not repeat once it parts
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_trained_from(params, spec, cfg_kw, total_steps):
    """JAX's Trainer and CrossEncoder (f32, 'default' head) whose initial
    params are ``params`` (a numpy tree in the shared layout)."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from anncur_tpu.config import Config as JaxConfig
    from anncur_tpu.models.bert import BertSpec as JaxBertSpec
    from anncur_tpu.models.crossencoder import CrossEncoder as JaxCrossEncoder
    from anncur_tpu.train.trainer import Trainer as JaxTrainer

    ce = JaxCrossEncoder(spec=JaxBertSpec(**dataclasses.asdict(spec)), cross_enc_type="default",
                         compute_dtype=jnp.float32)
    object.__setattr__(ce, "init", lambda key: jax.tree_util.tree_map(jnp.asarray, params))
    cfg = JaxConfig()
    cfg.update_from_dict(cfg_kw)
    return ce, JaxTrainer(cfg, ce, total_steps=total_steps)


def flat_jax(tree):
    """{path as the port names its parameters: numpy leaf}."""
    import jax

    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def assert_params_close(got, want, start, atol):
    """Every leaf of the port's trained params within ``atol`` of JAX's,
    and JAX's moved from ``start`` by more than ten times ``atol``
    somewhere (a trainer that takes no step fails)."""
    moved = max(float(np.abs(want[n] - start[n]).max()) for n in want)
    assert moved > 10 * atol, moved
    assert set(got) == set(want)
    for name, p in got.items():
        np.testing.assert_allclose(p.detach().cpu().numpy(), want[name], rtol=0, atol=atol, err_msg=name)


def test_make_trained_ce_matrix_trains_as_jax_from_the_same_start(tmp_path, keep_all_head_masks):
    """The quick recipe's training and scoring held to JAX's from one start:
    the quick shared-title world (the default), its config, spec and
    negatives (half of them one-word siblings of the gold), the port's
    seeded initial params given to JAX's CrossEncoder too, the head's masks
    keeping every unit and the spec's dropout rates at 0 (the only random
    draws). 30 steps of the port's ``train_ce`` against JAX's own jitted
    train step over JAX's batches of the same negatives (the JAX tool's
    loop), then the 76 x 400 matrix each package's builder scores with its
    own trained CE. Tolerances, as measured at one thread: the first 15
    losses within 1e-5 (they sit within 4e-7); from step 16, as the loss
    starts to fall, the two f32 trajectories part by about 3x a step until
    they settle, so all 30 losses are held within 3e-3 (largest 9.0e-4),
    every parameter within 2e-3 (largest 4.3e-4, against 4.9e-2 moved),
    the centred matrices within 5% of the score std (1.1%; the score bias
    has a zero gradient in exact arithmetic and drifts by rounding alone),
    s2/s1 within 2e-3 (1.8e-4) and the same 97%-energy rank and
    gold-in-top-64. A trainer that takes no step, or a wrong one, fails
    each of these by an order of magnitude or more."""
    from anncur_tpu.indexer.score_matrix import ScoreMatrixBuilder as JaxBuilder
    from anncur_tpu.train import data as jdata

    from anncur_tpu_torch.config import Config
    from anncur_tpu_torch.indexer.score_matrix import ScoreMatrixBuilder
    from anncur_tpu_torch.models.crossencoder import CrossEncoder, init_crossencoder_params
    from anncur_tpu_torch.train.data import EntLinkDataset

    n_train, n_q, steps = 60, 16, 30
    ment, ent, gt, tok, hard_negs = make_trained_ce_matrix.make_shared_world(
        np.random.default_rng(0), 400, n_train + n_q + 200, n_rare=120)
    train_slice = slice(n_train + n_q, len(gt))
    data = EntLinkDataset(ment[train_slice], ent, gt[train_slice])
    spec = make_trained_ce_matrix.ce_spec(tok.vocab_size, True, hidden_dropout=0.0, attention_dropout=0.0)
    cfg_kw = dict(make_trained_ce_matrix.train_kwargs(True), base_res_dir=str(tmp_path))
    cfg = Config(**cfg_kw)
    negs = make_trained_ce_matrix.train_negatives(data, gt, train_slice, hard_negs, cfg.num_negs, "cpu")
    ce = CrossEncoder(spec, "default", compute_dtype=torch.float32, device="cpu")
    state, losses = make_trained_ce_matrix.train_ce(ce, cfg, data, negs, steps)

    start = init_crossencoder_params(np.random.default_rng(cfg.seed), spec, "default")
    jce, jt = jax_trained_from(start, spec, cfg_kw, steps)
    jstate, step, jlosses = jt.init_state(), jt.make_train_step(), []
    jdata_ = jdata.EntLinkDataset(data.mention_tokens, data.entity_tokens, data.gt_labels)
    while int(jstate.step) < steps:
        for batch in jdata.crossenc_batches(jdata_, negs, cfg.train_batch_size, shuffle=False):
            jstate, metrics = step(jstate, jt._shard_batch(batch))
            jlosses.append(float(metrics["loss"]))
            if int(jstate.step) >= steps:
                break
    assert state.step == steps and len(losses) == len(jlosses) == steps
    np.testing.assert_allclose(losses[:15], jlosses[:15], rtol=0, atol=1e-5)
    np.testing.assert_allclose(losses, jlosses, rtol=0, atol=3e-3)
    assert_params_close(state.params, flat_jax(jstate.params), flat_jax(start), atol=2e-3)

    rows = ment[: n_train + n_q]
    got = ScoreMatrixBuilder(ce, ment_block=8, ent_block=8, pair_pad_multiple=32, device="cpu")(rows, ent)
    want = np.asarray(JaxBuilder(jce, ment_block=8, ent_block=8, pair_pad_multiple=32)(jstate.params, rows, ent))
    # centred: the score bias (and with it the mean) drifts by rounding
    np.testing.assert_allclose(got - got.mean(), want - want.mean(), rtol=0, atol=0.05 * want.std())
    gold = gt[n_train:n_train + n_q]
    s_got, s_want = make_trained_ce_matrix.spectrum(got, n_train, n_q, gold), make_trained_ce_matrix.spectrum(
        want, n_train, n_q, gold)
    assert abs(s_got[0] - s_want[0]) <= 2e-3 and s_got[1:] == s_want[1:], (s_got, s_want)
