"""Port parity, the paper's CUR eval harnesses and the indexer leftovers:
``evalx/core.py`` (retrieve-and-rerank, split overlap, the grid
evaluator), the transductive and inductive evals (result dicts and files
key for key), ``CurIndex``'s remaining methods and
``build_cur_from_matrix``, ``indexer/splits.py``, ``combine.py`` and
``ent2ent.py`` files crossing the two packages, ``rank_probe`` and the
copied ``aggregate`` pivots, held against the JAX package on the same
numpy inputs (CPU).

Tolerances (``PARITY.md``): recall metrics equal on matrices whose
rankings are well separated, within 0.005 where ties or rounding may
reorder an item; relative Frobenius errors within 2e-3."""

import importlib
import json
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anncur_tpu.core import cur as jcur
from anncur_tpu.data.synthetic import make_tokenized_world
from anncur_tpu.evalx import aggregate as jagg
from anncur_tpu.evalx import rank_probe as jrank
from anncur_tpu.indexer import combine as jcombine
from anncur_tpu.indexer import ent2ent as je2e
from anncur_tpu.indexer import score_matrix as jsm
from anncur_tpu.indexer import splits as jsplits
from anncur_tpu.models.bert import BertSpec as JaxBertSpec
from anncur_tpu.models.crossencoder import CrossEncoder as JaxCrossEncoder
from conftest import make_low_rank

from anncur_tpu_torch.core import cur as tcur
from anncur_tpu_torch.evalx import aggregate as tagg
from anncur_tpu_torch.evalx import core as tcore
from anncur_tpu_torch.evalx import inductive as tind
from anncur_tpu_torch.evalx import rank_probe as trank
from anncur_tpu_torch.evalx import transductive as ttrans
from anncur_tpu_torch.indexer import combine as tcombine
from anncur_tpu_torch.indexer import ent2ent as te2e
from anncur_tpu_torch.indexer import score_matrix as tsm
from anncur_tpu_torch.indexer import splits as tsplits
from anncur_tpu_torch.models.bert import BertSpec
from anncur_tpu_torch.models.convert import crossencoder_from_jax_params

# the modules (anncur_tpu.evalx re-exports functions of these names)
jcore = importlib.import_module("anncur_tpu.evalx.core")
jtrans = importlib.import_module("anncur_tpu.evalx.transductive")
jind = importlib.import_module("anncur_tpu.evalx.inductive")
torch.set_num_threads(2)  # xdist runs several test files side by side

CPU = "cpu"
RECALL_ATOL = 0.005  # PARITY.md: one reordered item in 200 rankings
FROB_ATOL = 2e-3  # relative Frobenius error


def _low_rank(seed, n=60, m=240, rank=8, noise=0.0):
    return make_low_rank(np.random.default_rng(seed), n, m, rank, noise)


def assert_res_close(got, want, recall_atol=0.0, path=""):
    """Nested result dicts equal key for key: overlap metrics within
    ``recall_atol`` (0: equal), Frobenius errors within FROB_ATOL of the
    relative error (the absolute one scaled by its base), the rest equal."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, sorted(set(got) ^ set(want)))
        for key in want:
            assert_res_close(got[key], want[key], recall_atol, f"{path}/{key}")
        if "approx_error_relative" in want and want["approx_error_relative"] > 0:
            base = want["approx_error"] / want["approx_error_relative"]
            assert abs(got["approx_error"] - want["approx_error"]) <= FROB_ATOL * base, path
        return
    if path.endswith("approx_error"):
        return  # held against its base above
    if path.endswith("approx_error_relative"):
        assert abs(got - want) <= FROB_ATOL, (path, got, want)
    elif "exact_vs_reranked" in path:
        # counts (common, diff, total) are k x the fraction
        k = re.search(r"top_k=(\d+)", path)
        scale = 1 if "frac" in path or not k else int(k.group(1))
        assert abs(got - want) <= recall_atol * scale, (path, got, want)
    else:
        assert got == want, (path, got, want)


# ---------------------------------------------------------------- evalx/core.py


def _reference_rerank(exact, approx_idx, k):
    """The reference's per-mention rerank: exact scores masked to the
    retrieved items (-1e14 elsewhere), then a stable top-k over all items."""
    masked = np.full_like(exact, -1e14)
    np.put_along_axis(masked, approx_idx, np.take_along_axis(exact, approx_idx, 1), 1)
    return np.argsort(-masked, axis=1, kind="stable")[:, :k]


def test_retrieve_rerank_matches_jax_and_the_reference():
    """Every array of retrieve_rerank equals JAX's on distinct scores (ids
    exactly; scores are gathers of the same inputs). On tied scores (small
    integers) the exact and approx top-k still equal JAX's, and the rerank
    is the reference's masked top-k: a tie among retrieved items goes to the
    lowest item id, where JAX's goes to the item retrieved first."""
    rng = np.random.default_rng(0)
    for ties in (False, True):
        draw = (lambda: rng.integers(-3, 4, (12, 90))) if ties else (lambda: rng.standard_normal((12, 90)))
        exact, approx = draw().astype(np.float32), draw().astype(np.float32)
        want = jcore.retrieve_rerank(jnp.asarray(exact), jnp.asarray(approx), 7, 20)
        got = tcore.retrieve_rerank(torch.as_tensor(exact), torch.as_tensor(approx), 7, 20)
        assert set(got) == set(want)
        for key in want:
            if ties and key.startswith("reranked"):
                continue
            np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
        np.testing.assert_array_equal(got["reranked_indices"].numpy(),
                                      _reference_rerank(exact, got["approx_indices"].numpy(), 7))
        np.testing.assert_array_equal(got["reranked_scores"].numpy(), np.asarray(want["reranked_scores"]))


def test_eval_split_overlap_and_all_topk_match_jax():
    """Per-split overlaps and Frobenius errors, and the all-top-k evaluator,
    key for key; one host read serves the split eval."""
    exact = _low_rank(1)
    approx = exact + 0.3 * np.random.default_rng(2).standard_normal(exact.shape).astype(np.float32)
    splits = {"anchor": np.arange(0, 60, 3), "non_anchor": np.setdiff1d(np.arange(60), np.arange(0, 60, 3)),
              "all": np.arange(60)}
    for k, kr in ((1, 10), (10, 50), (20, 240)):
        want = jcore.eval_split_overlap(exact, approx, k, kr, splits)
        got = tcore.eval_split_overlap(exact, approx, k, kr, splits, device=CPU)
        assert_res_close(got, want)
    want = jcore.eval_approx_for_all_topk(exact, approx, [1, 5, 10, 100], 50, with_error=True)
    got = tcore.eval_approx_for_all_topk(exact, approx, [1, 5, 10, 100], 50, with_error=True, device=CPU)
    assert set(got) == set(want) == {1, 5, 10}
    for k in want:
        assert_res_close(got[k], want[k])


@pytest.mark.parametrize("ties", [False, True])
def test_eval_approx_grid_equals_the_per_point_evaluator(ties):
    """The grid identity: the host grid (stable argsorts) equals the device
    per-point evaluator (topk_stable, reranked ties to the lowest item id)
    at every (k, kr), ties included, and equals JAX's grid."""
    exact = _low_rank(3, n=30, m=120)
    approx = exact + np.random.default_rng(4).standard_normal(exact.shape).astype(np.float32)
    if ties:  # f16 rounding of small integers' multiples: many exact ties
        exact, approx = (np.round(x).astype(np.float16).astype(np.float32) for x in (exact, approx))
    ks, krs = [1, 5, 10], [5, 10, 37, 120]
    grid = tcore.eval_approx_grid(exact, approx, ks, krs)
    assert_res_close(grid, {int(k): v for k, v in jcore.eval_approx_grid(exact, approx, ks, krs).items()})
    for kr in krs:
        per_point = tcore.eval_approx_for_all_topk(exact, approx, ks, kr, device=CPU)
        assert set(grid[kr]) == set(per_point)
        for k in per_point:
            # the same hit counts; the per-point fraction is an f32 mean
            assert grid[kr][k].keys() == per_point[k].keys()
            for key, val in per_point[k].items():
                assert abs(grid[kr][k][key] - val) <= 1e-6 * max(1.0, abs(val)), (k, kr, key)


# ---------------------------------------------------------------- CurIndex leftovers


def test_cur_index_leftovers_match_jax():
    """get_rows / get_cols / get / get_complete_col / topk_in_col and
    build_cur_from_matrix (plain and oracle, both preferences) against JAX,
    true f32 even with TF32 allowed."""
    mat = _low_rank(5, n=40, m=70, rank=6)
    rows, cols = np.arange(0, 40, 4), np.arange(0, 70, 5)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        for pref in ("rows", "cols"):
            for oracle in (False, True):
                want = jcur.build_cur_from_matrix(mat, rows, cols, approx_preference=pref, oracle=oracle)
                got = tcur.build_cur_from_matrix(mat, rows, cols, approx_preference=pref, oracle=oracle, device=CPU)
                assert got.approx_preference == pref and got.latent_rows.device.type == "cpu"
                tol = dict(atol=1e-4 * np.abs(mat).max(), rtol=0)
                ri, ci = np.array([3, 0, 17]), np.array([9, 2, 44, 69])
                for g, w in ((got.reconstruct(), want.reconstruct()), (got.get_rows(ri), want.get_rows(ri)),
                             (got.get_cols(ci), want.get_cols(ci)), (got.get(ri, ci), want.get(ri, ci))):
                    np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol)
                if pref == "cols":
                    sparse = mat[rows][:, [5, 6, 7]]
                    np.testing.assert_allclose(got.get_complete_col(sparse).numpy(),
                                               np.asarray(want.get_complete_col(jnp.asarray(sparse))), **tol)
                    vals, ids = got.topk_in_col(sparse, 4)
                    wv, wi = want.topk_in_col(jnp.asarray(sparse), 4)
                    np.testing.assert_array_equal(ids.numpy(), np.asarray(wi))
                    np.testing.assert_allclose(vals.numpy(), np.asarray(wv), **tol)
                    with pytest.raises(ValueError, match="get_complete_row"):
                        got.get_complete_row(sparse.T)
                else:
                    with pytest.raises(ValueError, match="get_complete_col"):
                        got.get_complete_col(mat[rows][:, :3])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


# ---------------------------------------------------------------- the transductive and inductive evals


@pytest.fixture(scope="module")
def e2e_data():
    """Entity-to-anchor-entity scores of the 240 entities against 24
    anchors, from the matrix's own column space (so the fixed-anchor
    methods recover structure)."""
    exact = _low_rank(7)
    rng = np.random.default_rng(8)
    anchors = np.sort(rng.choice(240, 24, replace=False))
    basis = np.linalg.svd(exact.astype(np.float64), full_matrices=False)[2][:8]  # (8, 240) row space
    scores = (basis.T @ basis[:, anchors]).astype(np.float32)  # (240, 24)
    return exact, {24: {"scores": scores, "anchor_ents": anchors}}


def test_run_transductive_eval_matches_jax(e2e_data, tmp_path):
    """Every method of the sweep, res files key for key; the low-rank
    matrix makes CUR's rankings well separated, so recalls agree exactly
    except where an anchor budget is below the rank (0.005)."""
    exact, e2e = e2e_data
    bienc = exact + np.random.default_rng(9).standard_normal(exact.shape).astype(np.float32)
    kw = dict(methods=("cur", "cur_oracle", "bienc", "fixed_anc_ent", "fixed_anc_ent_cur_24"), n_seeds=2,
              n_ment_anchors_vals=[10, 30], n_ent_anchors_vals=[6, 12, 24, 500], top_k_vals=[1, 5],
              top_k_retvr_vals=[5, 20, 60], bienc_scores=bienc, ent_to_ent_data=e2e, misc="t")
    want = jtrans.run_transductive_eval(exact, str(tmp_path / "j"), **kw)
    got = ttrans.run_transductive_eval(exact, str(tmp_path / "t"), device=CPU, **kw)
    assert_res_close(got, want, recall_atol=RECALL_ATOL)
    with open(tmp_path / "t" / "retrieval_wrt_exact_crossenc.json") as fin:
        assert json.load(fin) == got
    assert set(got) == {"cur", "cur_oracle", "bienc", "fixed_anc_ent", "fixed_anc_ent_cur_24", "other_args"}
    # above the rank (12, 24 anchors) CUR is exact: recall 1 and equal
    full = got["cur"]["top_k=5"]["k_retvr=20"]["anc_n_m=30~anc_n_e=24"]["all"]
    assert full["exact_vs_reranked_approx_retvr~common_frac_mean"] == 1.0
    assert full == want["cur"]["top_k=5"]["k_retvr=20"]["anc_n_m=30~anc_n_e=24"]["all"] or \
        abs(full["approx_error_relative"] - want["cur"]["top_k=5"]["k_retvr=20"]["anc_n_m=30~anc_n_e=24"]["all"]["approx_error_relative"]) <= FROB_ATOL
    assert [ttrans.sample_anchors(np.random.default_rng(s), 240, 12).tolist() for s in range(3)] == \
        [jtrans.sample_anchors(np.random.default_rng(s), 240, 12).tolist() for s in range(3)]


@pytest.mark.parametrize("method", ["cur", "bienc", "fixed_anc_ent", "fixed_anc_ent_cur", "adaptive_cur"])
def test_run_inductive_eval_matches_jax(e2e_data, tmp_path, method):
    """res.json at the same path with the same keys and values (recall
    within 0.005: the grid and the adaptive rounds rank approximations
    that differ by rounding), and JAX's aggregate reads the port's file."""
    exact, e2e = e2e_data
    train, test = exact[:40], exact[40:]
    bienc = test + np.random.default_rng(9).standard_normal(test.shape).astype(np.float32)
    kw = dict(method=method, seed=1, top_k_vals=[1, 5, 10], n_ent_anchors_vals=[6, 12, 24],
              top_k_retvr_vals=None if method == "cur" else [5, 20, 50], bienc_scores=bienc,
              ent_to_ent_data=e2e[24], misc="_x")
    want = jind.run_inductive_eval(test, train, str(tmp_path / "j"), **kw)
    got = tind.run_inductive_eval(test, train, str(tmp_path / "t"), device=CPU, **kw)
    assert_res_close(got, want, recall_atol=RECALL_ATOL)
    path = tmp_path / "t" / f"method={method}_s=1_x" / "res.json"
    with open(path) as fin:
        assert json.load(fin) == got
    if method != "adaptive_cur":
        rows = jagg.recall_vs_cost_table(got, method, 5)
        assert rows == tagg.recall_vs_cost_table(got, method, 5) and len(rows) > 0


def test_aggregate_pivots_equal_jax(e2e_data, tmp_path):
    """The copied aggregate module: compile_rqs and combine_result_files on
    the port's inductive results give JAX's pivots and flat files."""
    exact, e2e = e2e_data
    per_method = {}
    for method in ("cur", "bienc"):
        per_method[method] = tind.run_inductive_eval(
            exact[40:], exact[:40], str(tmp_path / "res"), method=method, top_k_vals=[1, 5],
            n_ent_anchors_vals=[6, 12], bienc_scores=exact[40:] + 1.0, device=CPU)
    jout = jagg.compile_rqs(per_method, 40, str(tmp_path / "j"))
    tout = tagg.compile_rqs(per_method, 40, str(tmp_path / "t"))
    assert sorted(jout) == sorted(tout)
    for rq in jout:
        with open(tmp_path / "j" / "RQs" / rq / "processed_res.json") as a, \
                open(tmp_path / "t" / "RQs" / rq / "processed_res.json") as b:
            assert json.load(a) == json.load(b)
    glob = str(tmp_path / "res" / "*" / "res.json")
    assert jagg.combine_result_files(glob, str(tmp_path / "j.json")) == \
        tagg.combine_result_files(glob, str(tmp_path / "t.json"))


# ---------------------------------------------------------------- indexer files


def test_splits_and_combine_files_cross_packages(tmp_path):
    """split_score_matrix and every combiner: files of one package read by
    the other, equal to its own."""
    rng = np.random.default_rng(0)
    scores = rng.standard_normal((30, 12)).astype(np.float32)
    toks = rng.integers(0, 50, (30, 8)).astype(np.int32)
    ids = np.arange(12)
    kw = dict(nm_train_vals=(5, 10, 40), n_splits=2, dev_frac=0.3, seed=3)
    got = tsplits.split_score_matrix(scores, toks, ids, str(tmp_path / "t"), **kw)
    want = jsplits.split_score_matrix(scores, toks, ids, str(tmp_path / "j"), **kw)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for name in g:
            a, b = jsm.load_score_matrix(g[name]), tsm.load_score_matrix(w[name])
            for key in ("ment_to_ent_scores", "mention_tokens_list", "entity_id_list"):
                np.testing.assert_array_equal(a[key], b[key])
            assert a["arg_dict"] == b["arg_dict"]
    # chunks written by the JAX package, combined by the port, and back
    cdir = tmp_path / "chunks"
    cdir.mkdir()
    for start in (0, 10, 20):
        np.savez_compressed(cdir / f"chunk_{start}.npz", scores=scores[start:start + 10], row_start=start)
    np.testing.assert_array_equal(tcombine.combine_chunks(str(cdir), 30), jcombine.combine_chunks(str(cdir), 30))
    parts = [g["test"] for g in got[:2]]
    tcombine.combine_pickles(parts, str(tmp_path / "tc.pkl"))
    jcombine.combine_pickles(parts, str(tmp_path / "jc.pkl"))
    a, b = jsm.load_score_matrix(str(tmp_path / "tc.pkl")), tsm.load_score_matrix(str(tmp_path / "jc.pkl"))
    np.testing.assert_array_equal(a["ment_to_ent_scores"], b["ment_to_ent_scores"])
    dirs = []
    for i in range(2):
        d = tmp_path / f"rr{i}"
        d.mkdir()
        for name in ("bienc_topk_preds.txt", "crossenc_topk_preds_w_bienc_retrvr.txt"):
            (d / name).write_text(json.dumps({"indices": [[i, 1], [2, 3]], "scores": [[0.5, 0.25], [1.0, 0.0]]}))
        (d / "gt_labels.txt").write_text(json.dumps([i, 2]))
        dirs.append(str(d))
    tcombine.combine_rr_chunk_dirs(dirs, str(tmp_path / "rt"))
    jcombine.combine_rr_chunk_dirs(dirs, str(tmp_path / "rj"))
    for name in ("bienc_topk_preds.txt", "crossenc_topk_preds_w_bienc_retrvr.txt", "gt_labels.txt"):
        assert (tmp_path / "rt" / name).read_text() == (tmp_path / "rj" / name).read_text()
    with pytest.raises(FileExistsError):
        tcombine.combine_topk_preds([os.path.join(dirs[0], "bienc_topk_preds.txt")],
                                    str(tmp_path / "rt" / "bienc_topk_preds.txt"))


def test_ent2ent_matches_jax_and_pickles_cross(tmp_path):
    """k-means++ anchors equal JAX's (duplicates and the empty case too);
    build_ent_to_ent_scores through the port's ScoreMatrixBuilder equals
    JAX's builder on the same CE (f32, 1e-4); the pickles cross."""
    rng = np.random.default_rng(1)
    emb = rng.standard_normal((50, 8)).astype(np.float32)
    dup = np.repeat(emb[:3], 5, axis=0)
    for e, n in ((emb, 7), (emb, 0), (dup, 6), (emb, 80)):
        np.testing.assert_array_equal(te2e.kmeanspp_anchor_ids(e, n, seed=2), je2e.kmeanspp_anchor_ids(e, n, seed=2))
    _, ent, _, tok = make_tokenized_world(seed=4, n_ents=21, n_ments=4, max_ment_len=16, max_ent_len=16)
    spec = dict(vocab_size=tok.vocab_size, max_position_embeddings=64)
    ce_j = JaxCrossEncoder(spec=JaxBertSpec.tiny(**spec), compute_dtype=jnp.float32)
    import jax

    params = ce_j.init(jax.random.PRNGKey(0))
    ce_t = crossencoder_from_jax_params(jax.tree_util.tree_map(np.asarray, params), BertSpec.tiny(**spec),
                                        device=CPU, dtype=torch.float32)
    anchors = te2e.kmeanspp_anchor_ids(rng.standard_normal((21, 4)), 5)
    want = je2e.build_ent_to_ent_scores(jsm.ScoreMatrixBuilder(ce_j, ment_block=4, ent_block=8, pair_pad_multiple=32),
                                        params, ent, anchors)
    got = te2e.build_ent_to_ent_scores(tsm.ScoreMatrixBuilder(ce_t, ment_block=4, ent_block=8, pair_pad_multiple=32,
                                                              device=CPU), ent, anchors)
    assert got.shape == (21, 5)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)
    te2e.save_ent_to_ent_pickle(str(tmp_path / "t.pkl"), got, anchors)
    je2e.save_ent_to_ent_pickle(str(tmp_path / "j.pkl"), want, anchors)
    for path, ref in ((tmp_path / "t.pkl", got), (tmp_path / "j.pkl", want)):
        for load in (te2e.load_ent_to_ent_pickle, je2e.load_ent_to_ent_pickle):
            scores, anc = load(str(path))
            np.testing.assert_array_equal(scores, ref)
            np.testing.assert_array_equal(anc, anchors)


def test_rank_probe_matches_jax():
    mat = _low_rank(11, n=40, m=50, rank=5, noise=1e-3)
    assert trank.matrix_rank_report(mat) == jrank.matrix_rank_report(mat)
    rng = np.random.default_rng(0)
    a, b = rng.standard_normal((9, 32)).astype(np.float32), rng.standard_normal((13, 32)).astype(np.float32)
    got = trank.bienc_score_matrix(a, b, device=CPU)
    np.testing.assert_allclose(got, jrank.bienc_score_matrix(a, b), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, a.astype(np.float64) @ b.astype(np.float64).T, rtol=1e-5, atol=1e-5)


def test_eval_package_needs_no_plotting_and_copies_match():
    """Importing the eval harnesses pulls in neither matplotlib nor JAX;
    the copied modules' code equals the JAX package's below the docstring."""
    code = ("import sys; import anncur_tpu_torch.evalx, anncur_tpu_torch.evalx.transductive, "
            "anncur_tpu_torch.evalx.inductive, anncur_tpu_torch.evalx.aggregate, anncur_tpu_torch.evalx.rank_probe, "
            "anncur_tpu_torch.indexer.ent2ent, anncur_tpu_torch.train.trainer; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('matplotlib', 'jax', 'anncur_tpu')]; "
            "assert not bad, bad")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=root, timeout=120)
    for name in ("aggregate", "plots", "paper_style"):
        with open(os.path.join(root, "anncur_tpu", "evalx", f"{name}.py")) as a, \
                open(os.path.join(root, "anncur_tpu_torch", "evalx", f"{name}.py")) as b:
            body = [s.split('"""', 2)[2] for s in (a.read(), b.read())]
        assert body[0] == body[1], name
