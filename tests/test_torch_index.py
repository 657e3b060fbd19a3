"""Port parity, offline index: pair layout, the exact score matrix (with
chunk-dir resume), the CUR build, and files that cross between the two
packages in both directions (CPU)."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anncur_tpu.core import cur as jcur
from anncur_tpu.data.synthetic import make_tokenized_world
from anncur_tpu.indexer import score_matrix as jsm
from anncur_tpu.models.bert import BertSpec as JaxBertSpec
from anncur_tpu.models.crossencoder import CrossEncoder as JaxCrossEncoder
from conftest import make_low_rank

from anncur_tpu_torch.core import cur as tcur
from anncur_tpu_torch.indexer import score_matrix as tsm
from anncur_tpu_torch.models.bert import BertSpec
from anncur_tpu_torch.models.convert import crossencoder_from_jax_params

torch.set_num_threads(2)  # xdist runs several test files side by side

# f32 CE on both sides: sums in other orders, nothing else
SCORE_ATOL, SCORE_RTOL = 1e-4, 1e-5


def test_build_pairs_identical(rng):
    ment = rng.integers(1, 50, size=(3, 7)).astype(np.int32)
    ent = rng.integers(1, 50, size=(4, 5)).astype(np.int32)
    for pair_len in (11, 16):
        want = np.asarray(jsm.build_pairs(jnp.asarray(ment), jnp.asarray(ent), pair_len))
        got = tsm.build_pairs(torch.as_tensor(ment), torch.as_tensor(ent), pair_len).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def ce_world():
    ment, ent, _, tok = make_tokenized_world(seed=4, n_ents=21, n_ments=10, max_ment_len=16, max_ent_len=16)
    kw = dict(vocab_size=tok.vocab_size, max_position_embeddings=64)
    ce_j = JaxCrossEncoder(spec=JaxBertSpec.tiny(**kw), compute_dtype=jnp.float32)
    params = ce_j.init(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, params)
    ce_t = crossencoder_from_jax_params(tree, BertSpec.tiny(**kw), device="cpu", dtype=torch.float32)
    builder_j = jsm.ScoreMatrixBuilder(ce_j, ment_block=4, ent_block=8, pair_pad_multiple=32)
    want = builder_j(params, ment, ent)
    return ment, ent, ce_j, params, ce_t, builder_j, want


def test_score_matrix_matches_jax(ce_world):
    ment, ent, _, _, ce_t, _, want = ce_world
    # 3 pair forwards per slab: the slab and the ragged last block are exercised
    builder_t = tsm.ScoreMatrixBuilder(
        ce_t, ment_block=4, ent_block=8, pair_pad_multiple=32, max_pairs_per_program=96, device="cpu"
    )
    got = builder_t(ment, ent)
    assert got.shape == (10, 21) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=SCORE_ATOL, rtol=SCORE_RTOL)


def test_chunk_dir_resume_across_packages(ce_world, tmp_path):
    ment, ent, _, params, ce_t, builder_j, want = ce_world
    builder_t = tsm.ScoreMatrixBuilder(ce_t, ment_block=4, ent_block=8, pair_pad_multiple=32, device="cpu")
    cdir = str(tmp_path / "chunks")
    first = builder_t(ment, ent, chunk_dir=cdir, chunk_rows=4)
    names = sorted(f for f in os.listdir(cdir) if f.startswith("chunk_"))
    assert names == ["chunk_0.npz", "chunk_4.npz", "chunk_8.npz"]
    assert not os.path.exists(os.path.join(cdir, ".lock"))
    # resume: a chunk file holding marker rows is loaded, not recomputed
    np.savez_compressed(os.path.join(cdir, "chunk_4.npz"), scores=np.full((4, 21), 7.0, np.float32), row_start=4)
    resumed = builder_t(ment, ent, chunk_dir=cdir, chunk_rows=4)
    np.testing.assert_array_equal(resumed[4:8], 7.0)
    np.testing.assert_array_equal(resumed[:4], first[:4])
    # the JAX builder resumes from the port's chunks, and the port from the
    # JAX builder's: one chunk missing each time, recomputed
    os.remove(os.path.join(cdir, "chunk_8.npz"))
    os.remove(os.path.join(cdir, "chunk_4.npz"))
    by_jax = builder_j(params, ment, ent, chunk_dir=cdir, chunk_rows=4)
    np.testing.assert_allclose(by_jax, want, atol=SCORE_ATOL, rtol=SCORE_RTOL)
    os.remove(os.path.join(cdir, "chunk_0.npz"))
    by_port = builder_t(ment, ent, chunk_dir=cdir, chunk_rows=4)
    np.testing.assert_allclose(by_port, want, atol=SCORE_ATOL, rtol=SCORE_RTOL)


def test_chunk_dir_lock_refuses_live_writer(tmp_path):
    cdir = str(tmp_path / "c")
    with tsm.ChunkDirLock(cdir):
        with pytest.raises(RuntimeError, match="live pid"):
            tsm.ChunkDirLock(cdir)
    # a stale lock (dead pid) is stolen
    with open(os.path.join(cdir, ".lock"), "w") as fout:
        fout.write("999999999")
    tsm.ChunkDirLock(cdir).release()


def test_score_matrix_files_cross_packages(tmp_path, rng):
    scores = rng.standard_normal((3, 5)).astype(np.float32)
    toks = rng.integers(0, 9, size=(3, 4)).astype(np.int32)
    ids = np.arange(5)
    tsm.save_score_matrix(str(tmp_path / "t.pkl"), scores, toks, ids, arg_dict={"a": 1})
    back = jsm.load_score_matrix(str(tmp_path / "t.pkl"))
    np.testing.assert_array_equal(back["ment_to_ent_scores"], scores)
    assert back["arg_dict"] == {"a": 1} and back["entity_tokens_list"] is None
    jsm.save_score_matrix(str(tmp_path / "j.pkl"), scores, toks, ids, entity_tokens_list=toks)
    back = tsm.load_score_matrix(str(tmp_path / "j.pkl"))
    np.testing.assert_array_equal(back["mention_tokens_list"], toks)
    np.testing.assert_array_equal(back["entity_tokens_list"], toks)


# ---------------------------------------------------------------- CUR


def _jax_cur(mat, rows_i, cols_i, **kw):
    return jcur.build_cur(
        rows=mat[rows_i], cols=mat[:, cols_i], row_idxs=rows_i, col_idxs=cols_i, **kw
    )


def _port_cur(mat, rows_i, cols_i, **kw):
    return tcur.build_cur(
        rows=mat[rows_i], cols=mat[:, cols_i], row_idxs=rows_i, col_idxs=cols_i, device="cpu", **kw
    )


@pytest.mark.parametrize(
    "kw",
    [
        {},
        {"approx_preference": "cols"},
        {"rcond": "noise"},
        {"rcond": "auto", "pinv_impl": "f32"},
        {"oracle": True},
    ],
    ids=["rows", "cols", "noise", "auto-f32", "oracle"],
)
def test_build_cur_matches_jax(rng, kw):
    mat = make_low_rank(rng, 48, 64, 6, noise=1e-3 if kw.get("rcond") else 0.0)
    rows_i = np.sort(rng.choice(48, 12, replace=False))
    cols_i = np.sort(rng.choice(64, 10, replace=False))
    kw = dict(kw)
    if kw.pop("oracle", False):
        kw["full_matrix"] = mat
    idx_j, u_j = _jax_cur(mat, rows_i, cols_i, return_u=True, **kw)
    idx_t, u_t = _port_cur(mat, rows_i, cols_i, return_u=True, **kw)
    assert idx_t.approx_preference == idx_j.approx_preference
    # f64 host pinvs agree to the last bit; f32 SVDs to f32 noise
    u_tol = 1e-6 if kw.get("pinv_impl") != "f32" else 1e-4
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), rtol=u_tol, atol=u_tol * np.abs(np.asarray(u_j)).max())
    for a, b in ((idx_t.latent_rows, idx_j.latent_rows), (idx_t.latent_cols, idx_j.latent_cols)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-4 * np.abs(b).max())
    np.testing.assert_array_equal(idx_t.row_idxs.numpy(), rows_i)
    np.testing.assert_array_equal(idx_t.col_idxs.numpy(), cols_i)
    if "rcond" not in kw:
        # rank(anchor intersection) == rank(A): CUR is exact
        np.testing.assert_allclose(idx_t.reconstruct().numpy(), mat, atol=1e-3 * np.abs(mat).max())


def test_build_cur_intersection_check_raises_in_both(rng):
    mat = make_low_rank(rng, 16, 20, 3)
    rows_i, cols_i = np.arange(4), np.arange(5)
    cols = mat[:, cols_i].copy()
    cols[0, 0] += 1.0
    for build in (jcur.build_cur, functools.partial(tcur.build_cur, device="cpu")):
        with pytest.raises(ValueError, match="intersection"):
            build(rows=mat[rows_i], cols=cols, row_idxs=rows_i, col_idxs=cols_i)


def test_cur_index_files_cross_packages(rng, tmp_path):
    mat = make_low_rank(rng, 20, 30, 4)
    rows_i, cols_i = np.arange(0, 20, 3), np.arange(0, 30, 4)
    idx_t = _port_cur(mat, rows_i, cols_i)
    tcur.save_cur_index(str(tmp_path / "t.pkl"), idx_t)
    back_j = jcur.load_cur_index(str(tmp_path / "t.pkl"))
    np.testing.assert_array_equal(np.asarray(back_j.latent_cols), idx_t.latent_cols.numpy())
    np.testing.assert_array_equal(np.asarray(back_j.col_idxs), cols_i)
    idx_j = _jax_cur(mat, rows_i, cols_i, approx_preference="cols")
    jcur.save_cur_index(str(tmp_path / "j.pkl"), idx_j)
    back_t = tcur.load_cur_index(str(tmp_path / "j.pkl"), device="cpu")
    assert back_t.approx_preference == "cols"
    np.testing.assert_array_equal(back_t.latent_rows.numpy(), np.asarray(idx_j.latent_rows))
    np.testing.assert_array_equal(back_t.row_idxs.numpy(), rows_i)


def test_cur_entry_points_without_cpu_raise_when_cuda_absent(monkeypatch, rng, tmp_path):
    """build_cur on numpy inputs and load_cur_index default to the card:
    without CUDA they raise unless the caller passes device='cpu'."""
    mat = make_low_rank(rng, 12, 16, 3)
    rows_i, cols_i = np.arange(0, 12, 2), np.arange(0, 16, 3)
    tcur.save_cur_index(str(tmp_path / "i.pkl"), _port_cur(mat, rows_i, cols_i))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcur.build_cur(rows=mat[rows_i], cols=mat[:, cols_i], row_idxs=rows_i, col_idxs=cols_i)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcur.load_cur_index(str(tmp_path / "i.pkl"))
    assert tcur.load_cur_index(str(tmp_path / "i.pkl"), device="cpu").latent_rows.device.type == "cpu"
