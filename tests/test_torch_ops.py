"""Port parity, ops: the plain MIPS top-k (kernel B's plain version and
the CPU path of its wrapper) against the JAX package's ``mips_topk`` and
both Pallas MIPS kernels in interpret mode, with padding and ties; the
pseudoinverse and its cutoffs; the kernel build's source hash (CPU); and
where every kernel entry runs (``cuda_build.on_cpu``)."""

import shutil
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anncur_tpu.ops import mips as jmips
import anncur_tpu.ops.pinv  # noqa: F401  (the package re-exports a function named pinv)
from anncur_tpu.ops.mips_pallas import mips_topk_pallas, mips_topk_pallas_maxmask

import anncur_tpu_torch.ops.pinv  # noqa: F401  (the package re-exports a function named pinv, as JAX's)
from anncur_tpu_torch.ops.mips import masked_topk, mips_topk, topk_stable
from anncur_tpu_torch.ops.mips_kernel import mips_topk_fused

jpinv = sys.modules["anncur_tpu.ops.pinv"]
tpinv = sys.modules["anncur_tpu_torch.ops.pinv"]
torch.set_num_threads(2)  # xdist runs several test files side by side


def _tied_inputs(rng, q, n, d):
    """Small integer entries: products are exact in f32 and many tie."""
    queries = rng.integers(-2, 3, size=(q, d)).astype(np.float32)
    items = rng.integers(-2, 3, size=(n, d)).astype(np.float32)
    items[37] = items[251 % n]  # duplicated rows too
    return queries, items


@pytest.mark.parametrize("n,k", [(300, 7), (512, 16), (130, 64)])
def test_mips_topk_matches_jax_and_pallas_kernels(rng, n, k):
    queries, items = _tied_inputs(rng, 6, n, 32)
    s_t, i_t = mips_topk(torch.as_tensor(queries), torch.as_tensor(items), k)
    # lax.top_k and the port's stable sort both break ties to the lowest
    # index, so ids must be identical, not just tied sets
    s_j, i_j = jmips.mips_topk(jnp.asarray(queries), jnp.asarray(items), k)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    s_p, i_p = mips_topk_pallas(jnp.asarray(queries), jnp.asarray(items), k, tile=128, interpret=True)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_p))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_p))
    s_m, i_m = mips_topk_pallas_maxmask(
        jnp.asarray(queries), jnp.asarray(items), k, tile=128, q_tile=4, interpret=True
    )
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_m))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_m))
    # the kernel wrapper takes the plain version for CPU tensors
    s_f, i_f = mips_topk_fused(torch.as_tensor(queries), torch.as_tensor(items), k)
    assert torch.equal(i_f, i_t) and torch.equal(s_f, s_t)
    assert mips_topk_fused.launches == 0


def test_mips_topk_n_valid_matches_masked_jax(rng):
    """Columns >= n_valid (the retriever's item padding) are never selected:
    the same ids as the JAX retriever's where(valid, approx, -inf) + top_k."""
    queries, items = _tied_inputs(rng, 5, 300, 16)
    n_valid = 211
    valid = np.arange(300) < n_valid
    full = jnp.dot(jnp.asarray(queries), jnp.asarray(items).T, precision="highest")
    s_j, i_j = jmips.masked_topk(full, 20, jnp.asarray(valid))
    s_t, i_t = mips_topk(torch.as_tensor(queries), torch.as_tensor(items), 20, n_valid=n_valid)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    assert int(i_t.max()) < n_valid
    s_m, i_m = masked_topk(torch.as_tensor(np.array(full)), 20, torch.as_tensor(valid))
    assert torch.equal(i_m, i_t)
    with pytest.raises(ValueError):
        mips_topk(torch.as_tensor(queries), torch.as_tensor(items), 20, n_valid=10)


def test_topk_stable_ties_to_lowest_index():
    scores = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0], [0.0, 0.0, 0.0, 0.0, 0.0]])
    vals, idx = topk_stable(scores, 4)
    assert idx.tolist() == [[1, 2, 4, 3], [0, 1, 2, 3]]
    assert vals.tolist() == [[3.0, 3.0, 3.0, 2.0], [0.0, 0.0, 0.0, 0.0]]


@pytest.mark.parametrize("shape,rank", [((12, 9), 9), ((20, 16), 5), ((16, 16), 16)])
def test_pinv_and_cutoffs_match_jax(rng, shape, rank):
    mat = (rng.standard_normal((shape[0], rank)) @ rng.standard_normal((rank, shape[1]))).astype(np.float32)
    mat += 1e-4 * rng.standard_normal(shape).astype(np.float32)
    np.testing.assert_array_equal(tpinv.pinv_f64(mat), jpinv.pinv_f64(mat))
    assert tpinv.noise_rcond(mat) == jpinv.noise_rcond(mat)
    assert tpinv.auto_rcond(mat) == jpinv.auto_rcond(mat)
    # f32 SVDs from two LAPACK drivers agree to f32 noise scaled by the
    # largest kept 1/sigma: compare where the cutoff keeps only signal (the
    # default cutoff keeps the 1e-4 noise directions of a low-rank matrix)
    for rcond in (None, 1e-3) if rank == min(shape) else (1e-3,):
        want = np.asarray(jpinv.pinv(jnp.asarray(mat), rcond))
        got = tpinv.pinv(torch.as_tensor(mat), rcond).numpy()
        np.testing.assert_allclose(got, want, atol=1e-4 * max(1.0, np.abs(want).max()), rtol=0)
    zero = np.zeros((4, 3), np.float32)
    assert tpinv.noise_rcond(zero) == jpinv.noise_rcond(zero) == 0.0


def test_library_path_covers_local_headers(tmp_path, monkeypatch):
    """An edited header that a kernel includes names another library, so it
    is rebuilt; a header it does not include does not. No nvcc needed."""
    from anncur_tpu_torch.ops import cuda_build

    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC_DIR, csrc)
    monkeypatch.setattr(cuda_build, "CSRC_DIR", str(csrc))
    before = cuda_build.library_path("attention")
    assert cuda_build.library_path("attention") == before
    (csrc / "unused.cuh").write_text("// included by no kernel\n")
    assert cuda_build.library_path("attention") == before
    header = csrc / "mma_sm90.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert cuda_build.library_path("attention") != before


# ----------------------------------------------- where an entry runs


def _entry_case(name):
    """(module, the entry's plain versions by module attribute, its CPU
    arguments, a function of them giving the plain result)."""
    from anncur_tpu_torch.ops import attention as at
    from anncur_tpu_torch.ops import encoder_epilogue as ee
    from anncur_tpu_torch.ops import mips_kernel as mk
    from anncur_tpu_torch.ops import moe
    from anncur_tpu_torch.ops import rms_norm as rn
    from anncur_tpu_torch.ops.quantized import quantize_items

    gen = torch.Generator().manual_seed(9)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen).to(dtype)

    bf16 = torch.bfloat16
    q, k, v, dout = randn(2, 5, 2, 16), randn(2, 5, 2, 16), randn(2, 5, 2, 16), randn(2, 5, 2, 16)
    valid = torch.tensor([[True] * 5, [True] * 3 + [False] * 2])
    out, lse, delta = at.attention_plain(q, k, v, valid), randn(2, 2, 5), randn(2, 2, 5)
    queries, items = randn(3, 8), randn(20, 8)
    order = moe.sort_rows(torch.tensor([[0, 2], [1, 2], [3, 0], [2, 1], [0, 3], [1, 0]]), 4)
    x, y, vec = randn(6, 16, dtype=bf16), randn(12, 16, dtype=bf16), randn(16)
    return {
        "attention": (at, ["attention_plain"], (q, k, v, valid), at.attention_plain),
        "attention_bwd_dq": (at, ["attention_bwd_plain", "attention_delta_plain"], (q, k, v, valid, dout, out, lse),
                             lambda *a: (at.attention_bwd_plain(*a[:5])[0], at.attention_delta_plain(a[4], a[5]))),
        "attention_bwd_dkv": (at, ["attention_bwd_plain"], (q, k, v, valid, dout, lse, delta),
                              lambda *a: at.attention_bwd_plain(*a[:5])[1:]),
        "mips_topk_fused": (mk, ["mips_topk"], (queries, items, 4), mips_topk),
        "mips_topk_int8_fused": (mk, ["mips_topk_int8_plain"], (queries, quantize_items(items), 4),
                                 mk.mips_topk_int8_plain),
        "moe_permute": (moe, ["moe_permute_plain"], (x, order.dest), moe.moe_permute_plain),
        "moe_combine": (moe, ["moe_combine_plain"], (y, order.dest, randn(6, 2), x, randn(6, 16, dtype=bf16)),
                        moe.moe_combine_plain),
        "expert_mlp": (moe, ["expert_mlp_plain"], (y, randn(4, 16, 10, dtype=bf16), randn(4, 5, 16, dtype=bf16), order),
                       moe.expert_mlp_plain),
        "bias_residual_layernorm": (ee, ["bias_residual_layernorm_plain"], (x, vec, x.flip(0), 1 + vec, -vec, 1e-12),
                                    ee.bias_residual_layernorm_plain),
        "bias_gelu": (ee, ["bias_gelu_plain"], (x, vec, True), ee.bias_gelu_plain),
        "bias_add3": (ee, ["bias_add3_plain"], (x, y, x.flip(0), vec, -vec, 2 * vec), ee.bias_add3_plain),
        "rms_norm": (rn, ["rms_norm_plain"], (x, 1 + randn(16, dtype=bf16), 1e-6), rn.rms_norm_plain),
    }[name]


def _tensors(result):
    return [t for r in result for t in _tensors(r)] if isinstance(result, (tuple, list)) else [result]


@pytest.mark.parametrize("name", [
    "attention", "attention_bwd_dq", "attention_bwd_dkv", "mips_topk_fused", "mips_topk_int8_fused", "moe_permute",
    "moe_combine", "expert_mlp", "bias_residual_layernorm", "bias_gelu", "bias_add3", "rms_norm",
])
def test_each_entry_runs_its_plain_version_on_the_cpu_and_its_kernel_elsewhere(monkeypatch, name):
    """The one rule, ``cuda_build.on_cpu``, at every public kernel entry:
    CPU tensors give the plain version bit for bit and load no library;
    with the rule made to report the card, the entry reaches its kernel's
    own checks, which raise on the CPU tensors, and never its plain
    version."""
    from anncur_tpu_torch.ops import cuda_build

    module, plains, args, plain = _entry_case(name)

    def copies():  # bias_add3 works in place
        return [a.clone() if isinstance(a, torch.Tensor) else a for a in args]

    def refuse(what):
        def call(*a, **kw):
            raise AssertionError(f"{name} reached {what}")
        return call

    want = plain(*copies())
    monkeypatch.setattr(cuda_build, "load", refuse("a kernel library"))
    got = getattr(module, name)(*copies())
    assert all(torch.equal(g, w) for g, w in zip(_tensors(got), _tensors(want), strict=True))
    assert not cuda_build._LOADED
    monkeypatch.setattr(cuda_build, "on_cpu", lambda *tensors: False)
    for attr in plains:
        monkeypatch.setattr(module, attr, refuse(attr))
    with pytest.raises(ValueError, match="CUDA"):
        getattr(module, name)(*copies())
