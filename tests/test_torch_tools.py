"""The port's drivers (``anncur_tpu_torch/tools/``) on the CPU at a tiny
size: the serving soak in fixed and adaptive-with-escalation mode with its
contract asserted (as ``tests/test_serving_soak.py`` runs the JAX
driver's), and every other driver through its ``main(argv)`` to its JSON
keys. Their numbers are CPU numbers: the card's are ``chip_smoke.py``'s
(phase 12)."""

import json

import pytest
import torch

from anncur_tpu_torch.tools import (
    _common,
    bench_http_serving,
    bench_nitems_scaling,
    bench_serving_latency,
    military_scale,
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
