"""Port parity, dense MIPS: ``pad_items``, int8 quantisation and the int8
MIPS (kernel B's int8 entry's plain version, the CPU path of its
wrapper), ``DenseIndex`` f32 and quantised, and the JAX-named
``fused_mips_topk`` / ``mips_topk_streaming``, against the JAX package on
the CPU with the same numpy inputs. Kernel B's int8 entry itself is held
to its plain version on the card (``tests/test_torch_cuda.py``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anncur_tpu.ops import dense_index as jdense
from anncur_tpu.ops import mips as jmips
from anncur_tpu.ops import mips_pallas as jpallas
from anncur_tpu.ops import quantized as jquant

from anncur_tpu_torch.ops import dense_index as tdense
from anncur_tpu_torch.ops import mips_kernel as tkernel
from anncur_tpu_torch.ops import quantized as tquant
from anncur_tpu_torch.ops.mips import pad_items

torch.set_num_threads(2)  # xdist runs several test files side by side


def test_pad_items_matches_jax():
    items = np.arange(21, dtype=np.float32).reshape(7, 3)
    for multiple in (1, 4, 7, 8):
        got, n_t = pad_items(torch.as_tensor(items), multiple)
        want, n_j = jmips.pad_items(jnp.asarray(items), multiple)
        assert n_t == n_j == 7
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_quantize_items_bit_equal_to_jax():
    """Scales and int8 values identical bit for bit, with a zero row (scale
    1), exact .5 ties after the division (round half to even) and rows
    whose extreme values hit +-127."""
    rng = np.random.default_rng(0)
    items = rng.standard_normal((300, 48)).astype(np.float32) * rng.uniform(0.01, 30, (300, 1)).astype(np.float32)
    items[3] = 0.0
    items[4, :6] = [127.0, 0.5, 1.5, 2.5, -0.5, -126.5]  # scale 1: .5 ties
    items[4, 6:] = 0.0
    got = tquant.quantize_items(torch.as_tensor(items))
    want = jquant.quantize_items(jnp.asarray(items))
    assert got.values.dtype == torch.int8 and got.scales.shape == (300, 1)
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    np.testing.assert_array_equal(got.scales.numpy().view(np.uint32), np.asarray(want.scales).view(np.uint32))
    assert got.values[4, :6].tolist() == [127, 0, 2, 2, 0, -126]
    assert float(got.scales[3, 0]) == 1.0 and got.shape == (300, 48)


def _exact_int8_case(rng, q, n, d):
    """Small-integer queries and values with power-of-two scales: every
    product, sum and scaling is exact in f32, so scores tie exactly."""
    queries = rng.integers(-3, 4, size=(q, d)).astype(np.float32)
    values = rng.integers(-4, 5, size=(n, d)).astype(np.int8)
    scales = (2.0 ** rng.integers(-3, 3, size=(n, 1))).astype(np.float32)
    return queries, values, scales


@pytest.mark.parametrize("q,n,d,k", [(5, 300, 16, 10), (3, 1000, 33, 64), (4, 64, 8, 64)])
def test_mips_topk_int8_matches_jax_exactly_on_exact_inputs(q, n, d, k):
    rng = np.random.default_rng(q * n + k)
    queries, values, scales = _exact_int8_case(rng, q, n, d)
    items_t = tquant.QuantizedItems(torch.as_tensor(values), torch.as_tensor(scales))
    s_t, i_t = tquant.mips_topk_int8(torch.as_tensor(queries), items_t, k)
    s_j, i_j = jquant.mips_topk_int8(
        jnp.asarray(queries), jquant.QuantizedItems(jnp.asarray(values), jnp.asarray(scales)), k, chunk=128
    )
    assert i_t.dtype == torch.int64
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))


def test_mips_topk_int8_matches_jax_on_normal_inputs():
    """Random f32 queries over quantised random items: scores within 1e-5 of
    max|score| (f32 sums in other orders), ids equal where neighbours differ
    by more than that; exclusions and n_valid as the f32 plain version."""
    rng = np.random.default_rng(1)
    queries = rng.standard_normal((8, 64)).astype(np.float32)
    items = rng.standard_normal((2000, 64)).astype(np.float32)
    qi_t = tquant.quantize_items(torch.as_tensor(items))
    s_t, i_t = tquant.mips_topk_int8(torch.as_tensor(queries), qi_t, 20)
    s_j, i_j = jquant.mips_topk_int8(jnp.asarray(queries), jquant.quantize_items(jnp.asarray(items)), 20, chunk=512)
    s_j, i_j = np.asarray(s_j), np.asarray(i_j)
    scale = np.abs(s_j).max()
    np.testing.assert_allclose(s_t.numpy(), s_j, rtol=0, atol=1e-5 * scale)
    gaps = -np.diff(s_j, axis=1)
    sep = np.ones(s_j.shape, bool)
    sep[:, :-1] &= gaps > 1e-5 * scale
    sep[:, 1:] &= gaps > 1e-5 * scale
    assert sep.mean() > 0.9
    np.testing.assert_array_equal(i_t.numpy()[sep], i_j[sep])
    # the plain version with an exclusion list and padding
    exclude = i_t[:, :5]
    s_x, i_x = tquant.mips_topk_int8(torch.as_tensor(queries), qi_t, 10, n_valid=1900, exclude=exclude)
    assert int(i_x.max()) < 1900 and not (i_x[:, :, None] == exclude[:, None, :]).any()
    # the wrapper takes kernel B's plain version on the CPU
    before = tkernel.mips_topk_int8_fused.launches
    assert torch.equal(tkernel.mips_topk_int8_fused(torch.as_tensor(queries), qi_t, 20)[1], i_t)
    assert tkernel.mips_topk_int8_fused.launches == before


@pytest.mark.parametrize("quantize", [False, True])
def test_dense_index_search_and_add_match_jax(quantize):
    """DenseIndex.search before and after add, f32 and quantised, against
    JAX's: k clamped to n, ids equal where the scores stand apart, scores
    within 1e-5 of the scale; a dominating added item is found."""
    rng = np.random.default_rng(2 + quantize)
    base = rng.standard_normal((300, 32)).astype(np.float32)
    queries = rng.standard_normal((6, 32)).astype(np.float32)
    idx_t = tdense.DenseIndex(base, quantize=quantize, device="cpu")
    idx_j = jdense.DenseIndex(base, quantize=quantize)
    for step in range(2):
        s_t, i_t = idx_t.search(queries, 15)
        s_j, i_j = (np.asarray(x) for x in idx_j.search(queries, 15))
        assert s_t.shape == (6, 15) and i_t.dtype == np.int64
        scale = np.abs(s_j).max()
        np.testing.assert_allclose(s_t, s_j, rtol=0, atol=1e-5 * scale)
        gaps = -np.diff(s_j, axis=1)
        sep = np.ones(s_j.shape, bool)
        sep[:, :-1] &= gaps > 1e-5 * scale
        sep[:, 1:] &= gaps > 1e-5 * scale
        np.testing.assert_array_equal(i_t[sep], i_j[sep])
        if step == 0:
            strong = np.ones((1, 32), np.float32) * 10.0
            idx_t.add(strong)
            idx_j.add(strong)
    assert idx_t.n == 301 and (idx_t.quantized is not None) == quantize
    assert (idx_t.search(np.ones((3, 32), np.float32), 1)[1] == 300).all()
    assert idx_t.search(queries, 10_000)[0].shape == (6, 301)  # k = min(k, n)


def test_dense_index_quantized_overlaps_f32_and_mesh_raises():
    from anncur_tpu_torch.core.metrics import topk_overlap_frac

    rng = np.random.default_rng(4)
    items = rng.standard_normal((500, 32)).astype(np.float32)
    q = rng.standard_normal((4, 32)).astype(np.float32)
    _, i_f = tdense.DenseIndex(items, device="cpu").search(q, 10)
    _, i_q = tdense.DenseIndex(items, quantize=True, device="cpu").search(q, 10)
    assert float(topk_overlap_frac(i_q, i_f).mean()) > 0.9
    from anncur_tpu_torch.parallel.mesh import Mesh, mesh_session

    elsewhere = Mesh(shape={"data": 1}, ranks=np.zeros(1, np.int64), coords={"data": 0}, groups={},
                     device=torch.device("meta"))
    with pytest.raises(ValueError, match="the mesh's rank lives on"):
        tdense.DenseIndex(items, mesh=elsewhere, device="cpu")
    with mesh_session("cpu") as mesh:  # the sharded search over one rank
        s_m, i_m = tdense.DenseIndex(items, mesh=mesh, device="cpu").search(q, 10)
    s_f, _ = tdense.DenseIndex(items, device="cpu").search(q, 10)
    np.testing.assert_array_equal(i_m, i_f)
    np.testing.assert_array_equal(s_m, s_f)
    assert tdense.build_flat_or_ivff_index(items, device="cpu").n == 500


def test_fused_and_streaming_mips_match_jax():
    """The JAX-named entries on kernel B (its plain version here) against
    JAX's dispatch and streaming scan, on small-integer inputs with ties:
    scores and ids exactly equal."""
    rng = np.random.default_rng(5)
    queries = rng.integers(-2, 3, size=(7, 24)).astype(np.float32)
    items = rng.integers(-2, 3, size=(900, 24)).astype(np.float32)
    for k in (1, 33):
        want_f = jpallas.fused_mips_topk(jnp.asarray(queries), jnp.asarray(items), k)
        want_s = jpallas.mips_topk_streaming(jnp.asarray(queries), jnp.asarray(items), k, chunk=256)
        got_f = tkernel.fused_mips_topk(torch.as_tensor(queries), torch.as_tensor(items), k)
        got_s = tkernel.mips_topk_streaming(torch.as_tensor(queries), torch.as_tensor(items), k, chunk=256)
        for got, want in ((got_f, want_f), (got_s, want_s)):
            np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
            np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
