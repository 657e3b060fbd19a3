"""The port's examples (``anncur_tpu_torch/examples/``) on the CPU: the
quickstart end to end, its CE stage and index against JAX's from one
start, and the yugioh-scale eval's sweep and oracle point
on a cut matrix against JAX's ``run_transductive_eval`` and
``run_approx_eval_w_seed`` on the same matrix (the full 3,374 x 10,031
matrix runs on the card, ``chip_smoke.py`` phase 14). Tolerances as
``tests/test_torch_evalx.py``'s (``PARITY.md``)."""

import importlib
import json

import numpy as np
import pytest
import torch

from anncur_tpu_torch.examples import quickstart, yugioh_scale_eval
from test_torch_evalx import RECALL_ATOL, assert_res_close
from test_torch_tools import assert_params_close, flat_jax, jax_trained_from, keep_all_head_masks  # noqa: F401

jtrans = importlib.import_module("anncur_tpu.evalx.transductive")

torch.set_num_threads(2)  # xdist runs several test files side by side


def test_quickstart_completes_with_recall_of_jax_quickstart():
    """Every stage on the CPU: 6 bi-encoder steps (2 epochs of 3 batches,
    as JAX's config gives), 120 CE steps, the 16-anchor index, 16 unseen
    queries at top-5 of 24 and a text query. JAX's quickstart reaches
    recall 1.000 against the exact CE ranking on the CPU; the port is held
    to at least 0.95 (one missed item of the 80 would be 0.9875). The
    stages themselves are held to JAX's on the same inputs by the next
    test."""
    res = quickstart.main(["--device", "cpu"])
    assert res["bienc_steps"] == 6 and res["ce_steps"] == 120
    assert res["departs_from_reference"] == quickstart.DEPARTURE
    assert res["recall"] >= 0.95, res["recall"]
    assert res["cost_per_query"] == 16 + 24
    assert len(res["text_query"]) == 3 and all(0 <= i < 64 for i, _ in res["text_query"])


def test_quickstart_ce_stage_and_index_equal_jax_from_the_same_start(tmp_path, monkeypatch, keep_all_head_masks):
    """Stage 3 held to JAX's quickstart from one start: the quickstart's
    world, spec (hidden dropout 0 as well here) and CE config, the port's
    seeded initial params given to JAX's CrossEncoder too, the head's masks
    keeping every unit (the only random draws). The port's
    ``train_cross_encoder`` against JAX's ``Trainer.train`` (40 epochs of
    3 batches, random negatives drawn each epoch). The first two epochs'
    losses agree within 1e-5 (they sit within 2e-7); from step 8, as the
    loss falls fast, the two f32 trajectories part and never meet again,
    so later steps are held by the mean loss of the last 10 epochs: within
    0.15 of JAX's (measured 0.690 vs 0.620) and learned (below ln 5 - 0.5;
    a CE that takes no step stays at ln 5). Then stages 4-6 on the port's
    trained weights in both packages: the same anchors, exact top-5,
    retrieved ids and recall."""
    import jax
    import jax.numpy as jnp

    from anncur_tpu.core.retriever import CurRetriever as JaxRetriever
    from anncur_tpu.indexer.score_matrix import ScoreMatrixBuilder as JaxBuilder
    from anncur_tpu.train import data as jdata
    from anncur_tpu.train.trainer import Trainer as JaxTrainer

    from anncur_tpu_torch.config import Config
    from anncur_tpu_torch.core.metrics import topk_overlap_frac
    from anncur_tpu_torch.data.synthetic import make_tokenized_world
    from anncur_tpu_torch.models.crossencoder import init_crossencoder_params
    from anncur_tpu_torch.train.data import EntLinkDataset
    from anncur_tpu_torch.train.trainer import Trainer

    ment, ent, gt, tok = make_tokenized_world(seed=0, n_ents=64, n_ments=48, max_ment_len=32, max_ent_len=32)
    data = EntLinkDataset(ment, ent, gt)
    spec = quickstart.make_spec(tok.vocab_size, hidden_dropout=0.0)
    losses, jlosses = [], []
    train_step = Trainer.train_step
    monkeypatch.setattr(Trainer, "train_step", lambda self, st, b: losses.append(
        float((m := train_step(self, st, b))["loss"])) or m)
    ce, steps = quickstart.train_cross_encoder(spec, data, str(tmp_path / "t"), "cpu")

    cfg_kw = dict(quickstart.CE_CONFIG, base_res_dir=str(tmp_path / "j"))
    start = init_crossencoder_params(np.random.default_rng(Config(**cfg_kw).seed), spec, "default")
    jce, jt = jax_trained_from(start, spec, cfg_kw, quickstart.CE_STEPS)
    make_step = JaxTrainer.make_train_step

    def recording_step(self):
        step = make_step(self)

        def run(state, batch):
            state, metrics = step(state, batch)
            jlosses.append(float(metrics["loss"]))
            return state, metrics
        return run

    monkeypatch.setattr(JaxTrainer, "make_train_step", recording_step)
    jstate = jt.train(jdata.EntLinkDataset(ment, ent, gt), dev_data=None)
    assert steps == quickstart.CE_STEPS and len(losses) == len(jlosses) == steps
    np.testing.assert_allclose(losses[:6], jlosses[:6], rtol=0, atol=1e-5)
    late, jlate = np.mean(losses[-30:]), np.mean(jlosses[-30:])
    assert abs(late - jlate) <= 0.15 and max(late, jlate) < np.log(5) - 0.5, (late, jlate)

    # stages 4-6 on the port's trained weights, in both packages
    retriever, idx, exact_top, recall = quickstart.index_and_query(ce, tok, ment, ent, "cpu")
    params = jax.tree_util.tree_map(jnp.asarray, ce.params_tree())
    builder = JaxBuilder(jce, ment_block=8, ent_block=8, pair_pad_multiple=64)
    r_j = JaxRetriever.build(jce, params, tok, train_query_tokens=ment[:32], item_tokens=ent, n_anchor_items=16,
                             builder=builder, max_query_len=32)
    _, idx_j = r_j.query_tokens_batch(ment[32:], top_k=5, top_k_retvr=24)
    exact_j = np.asarray(builder(params, ment[32:], ent))
    exact_top_j = np.argsort(-exact_j, axis=1, kind="stable")[:, :5]
    np.testing.assert_array_equal(retriever.anchor_item_ids, np.asarray(r_j.anchor_item_ids))
    np.testing.assert_array_equal(exact_top, exact_top_j)
    np.testing.assert_array_equal(idx, np.asarray(idx_j))
    assert recall == float(topk_overlap_frac(np.asarray(idx_j), exact_top_j).mean())


def test_yugioh_scale_eval_equals_jax_on_a_cut_matrix(tmp_path):
    """The example's matrix recipe at 300 x 900, rank 20: its CUR grid
    (top-k 10, k_retvr 500, one seed) key for key against JAX's harness on
    the same matrix, the oracle point against JAX's evaluator, and the
    summary file; the heat map is drawn or reported as not drawn."""
    mat = yugioh_scale_eval.make_matrix(300, 900, 20, seed=0)
    rng = np.random.default_rng(0)
    want_mat = (rng.standard_normal((300, 20)) @ rng.standard_normal((20, 900))).astype(np.float32)
    want_mat += 0.05 * rng.standard_normal(want_mat.shape).astype(np.float32)
    np.testing.assert_array_equal(mat, want_mat)  # JAX's example draws it so
    grid = (20, 50)
    got, _ = yugioh_scale_eval.sweep(mat, str(tmp_path / "t"), grid, device="cpu")
    want = jtrans.run_transductive_eval(
        mat, str(tmp_path / "j"), methods=("cur",), n_seeds=1, n_ment_anchors_vals=list(grid),
        n_ent_anchors_vals=list(grid), top_k_vals=[10], top_k_retvr_vals=[500])
    assert_res_close(got, want, recall_atol=RECALL_ATOL)
    for method in ("cur_oracle", "cur"):
        g = yugioh_scale_eval.run_approx_eval_w_seed(method, mat, 50, 50, 10, 500, seed=0, device="cpu")
        w = jtrans.run_approx_eval_w_seed(method, mat, 50, 50, 10, 500, seed=0)
        assert abs(g["all"][yugioh_scale_eval.RECALL] - w["all"][yugioh_scale_eval.RECALL]) <= RECALL_ATOL
    path = yugioh_scale_eval.heat_map(got, str(tmp_path / "t"))
    assert path is None or path.endswith(".pdf")


def test_yugioh_scale_eval_main_writes_its_summary(tmp_path, monkeypatch):
    """``main`` end to end on a cut matrix (the module's sizes patched):
    the grid's points, the oracle point, the summary file."""
    monkeypatch.setattr(yugioh_scale_eval, "N_MENTS", 200)
    monkeypatch.setattr(yugioh_scale_eval, "N_ENTS", 600)
    monkeypatch.setattr(yugioh_scale_eval, "RANK", 10)
    out = tmp_path / "y"
    res = yugioh_scale_eval.main([str(out), "--device", "cpu", "--grid", "20", "40", "--oracle_point", "40", "40"])
    assert res["n_points"] == 4 and set(res["points"]) == {
        f"anc_n_m={m}~anc_n_e={e}" for m in (20, 40) for e in (20, 40)}
    assert res["oracle_point"]["cur_oracle_recall"] >= res["oracle_point"]["cur_recall"] - RECALL_ATOL
    with open(out / "yugioh_scale_eval.json") as fin:
        assert json.load(fin)["grid"] == [20, 40]
    assert (out / "retrieval_wrt_exact_crossenc.json").exists()


@pytest.mark.parametrize("name", ["quickstart", "yugioh_scale_eval"])
def test_examples_import_no_jax_and_no_plotting(name):
    """The examples import neither JAX nor matplotlib at import time (the
    card's host has no matplotlib; the heat map imports it when drawn)."""
    import subprocess
    import sys

    code = (f"import sys; import anncur_tpu_torch.examples.{name}; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'anncur_tpu', 'matplotlib')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
