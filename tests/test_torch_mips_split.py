"""Kernel B's tensor-core score arithmetic, emulated on the CPU.

For f32 items with 16-byte rows and more than 32 queries a chunk, the score
stage of ``csrc/mips_topk.cu`` runs on the tensor cores in three TF32
passes: each operand x splits into big = tf32(x) and small = tf32(x - big)
(round to nearest, ties away from zero), each 32-deep stage of the depth
sums small_q big_i + big_q small_i + big_q big_i into an f32 accumulator,
and the stage's sum is added to the score in f32, starting from +0.0. This
test-local emulation does that arithmetic in torch (the split by integer bit
arithmetic, each stage's three products in f64 rounded once to f32, then the
f32 running sum) and holds it against an f64 product at the widths kernel B
meets: f32-accurate, as the reference's ``precision="highest"`` is on the
TPU, where one TF32 pass is not. Nothing in the package uses the emulation;
the card tests (``tests/test_torch_cuda.py``) hold the kernel itself.
"""

import numpy as np
import pytest
import torch

from anncur_tpu_torch.ops.mips import mips_topk, topk_stable

torch.set_num_threads(2)  # xdist runs several test files side by side

STAGE = 32  # depth of a stage (csrc/mips_topk.cu, tc::kBK)
EXCLUDED_BITS = 0xFFFFFFFF  # the select's mark over excluded ids
ACCURACY_RATIO = 4.0  # the three-pass error against the plain f32 matmul's


def tf32_rna(x):
    """f32 -> f32 with the low 13 mantissa bits cleared, rounded to nearest
    with ties away from zero (``cvt.rna.tf32.f32``): add half of the 13-bit
    step to the magnitude's bits, then clear them (the sign bit is apart)."""
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = (u + 0x1000) & 0xFFFFE000
    u = torch.where(u >= 2**31, u - 2**32, u)
    return u.to(torch.int32).view(torch.float32)


def split(x):
    """(big, small): big = tf32(x), small = tf32(x - big)."""
    big = tf32_rna(x)
    return big, tf32_rna(x - big)


def score_store(scores):
    """The score kernel's store: the mark's bits become 0xFFFFFFFE."""
    u = scores.contiguous().view(torch.int32).clone()
    u[u == torch.tensor(EXCLUDED_BITS, dtype=torch.int64).to(torch.int32)] -= 1
    return u.view(torch.float32)


def three_pass_scores(queries, items, passes=3):
    """The tensor-core route's scores (``passes=1``: one TF32 pass, big
    times big, for contrast)."""
    qb, qs = split(queries)
    ib, isl = split(items)
    acc = torch.zeros(queries.shape[0], items.shape[0], dtype=torch.float32)  # +0.0
    for k0 in range(0, queries.shape[1], STAGE):
        sl = slice(k0, k0 + STAGE)
        terms = ((qs, ib), (qb, isl), (qb, ib)) if passes == 3 else ((qb, ib),)
        part = sum(a[:, sl].double() @ b[:, sl].double().T for a, b in terms)
        acc = acc + part.float()
    return score_store(acc)


def rel_err(got, exact):
    return float((got.double() - exact).abs().max() / exact.abs().max())


@pytest.mark.parametrize("seed", [0, 1])
def test_split_parts_are_tf32_and_sum_to_x(seed):
    """Both parts have their low 13 bits clear, and big + small is within
    2^-22 |x| of x (what the dropped small x small term costs), over values
    spread across many binades, signed zeros and the rounding ties."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(4096) * np.exp2(rng.integers(-60, 60, 4096))).astype(np.float32)
    ties = (np.float32(1.0) + np.float32(2.0**-11) * np.arange(1, 9, 2, dtype=np.float32)).astype(np.float32)
    x = torch.as_tensor(np.concatenate([x, [0.0, -0.0], ties, -ties]).astype(np.float32))
    big, small = split(x)
    for part in (big, small):
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert bool(((big.double() + small.double() - x.double()).abs() <= 2.0**-22 * x.double().abs()).all())
    # ties round away from zero: 1 + 2^-11 (half a tf32 step) becomes 1 + 2^-10
    assert float(tf32_rna(torch.tensor([1.0 + 2.0**-11]))) == 1.0 + 2.0**-10
    assert float(tf32_rna(torch.tensor([-1.0 - 2.0**-11]))) == -1.0 - 2.0**-10
    assert torch.equal(torch.signbit(big[-len(ties) * 2 - 2 :][:2]), torch.tensor([False, True]))


@pytest.mark.parametrize("q,n,d", [(64, 1024, 500), (64, 1024, 768), (16, 256, 16620)])
def test_three_pass_scores_are_f32_accurate(q, n, d):
    """At the widths kernel B meets (the serving rows' 500, the bi-encoder's
    768, the TF-IDF mine's 16,620) on seeded normal inputs: the three passes'
    max error against the f64 product is at most 4x the plain f32 matmul's;
    one TF32 pass is far outside it (the rule the three passes keep)."""
    rng = np.random.default_rng(d)
    queries = torch.as_tensor(rng.standard_normal((q, d)).astype(np.float32))
    items = torch.as_tensor(rng.standard_normal((n, d)).astype(np.float32))
    exact = queries.double() @ items.double().T
    plain = rel_err(queries @ items.T, exact)
    three = rel_err(three_pass_scores(queries, items), exact)
    one = rel_err(three_pass_scores(queries, items, passes=1), exact)
    assert three <= ACCURACY_RATIO * plain, (three, plain)
    assert one > 10 * ACCURACY_RATIO * plain, (one, plain)


@pytest.mark.parametrize("d", [8, 500, 12347])
def test_small_integer_inputs_are_exact(d):
    """Integers in [-2, 2] are tf32 (small = 0) and every partial sum is an
    integer below 2^24: the three passes give the exact product, as the card
    tests' exact-equality checks of kernel B assume."""
    rng = np.random.default_rng(d)
    queries = torch.as_tensor(rng.integers(-2, 3, (40, d)).astype(np.float32))
    items = torch.as_tensor(rng.integers(-2, 3, (300, d)).astype(np.float32))
    assert bool((split(items)[1] == 0).all())
    got = three_pass_scores(queries, items)
    assert torch.equal(got, (queries.double() @ items.double().T).float())
    s_p, i_p = mips_topk(queries, items, 17)
    s_k, i_k = topk_stable(got, 17)
    assert torch.equal(s_k, s_p) and torch.equal(i_k, i_p)


def test_epilogue_bits_and_the_order_of_the_kernels_own_scores():
    """The store turns only the mark's bits 0xFFFFFFFF into 0xFFFFFFFE;
    the three passes never give -0.0 (the sum starts at +0.0 and adds in
    f32), so on the signed-zero test's inputs (products that round to
    -0.0, +0.0 and +-1) the zeros tie and go by id, as ``topk_stable``
    orders the kernel's own scores."""
    marks = torch.tensor([EXCLUDED_BITS, EXCLUDED_BITS - 1, 0x7FC00000, 0x80000000], dtype=torch.int64)
    stored = score_store(marks.to(torch.int32).view(torch.float32))
    assert (stored.view(torch.int32).to(torch.int64) & 0xFFFFFFFF).tolist() == [
        EXCLUDED_BITS - 1, EXCLUDED_BITS - 1, 0x7FC00000, 0x80000000]
    col = torch.tensor([0.0, -0.0, 1.0, -0.0, 0.0, -1.0, -0.0, 0.0])
    per_term = torch.where(col > 0, -3.125e28, torch.where(col < 0, 3.125e28,
                           torch.where(torch.signbit(col), 1e-30, -1e-30)))
    items = per_term[:, None].expand(8, 32).contiguous()
    queries = torch.full((64, 32), -1e-30)
    scores = three_pass_scores(queries, items)
    assert not bool(torch.signbit(scores[scores == 0]).any())
    assert scores[0].tolist() == [0.0, 0.0, 1.0, 0.0, 0.0, -1.0, 0.0, 0.0]
    ids = topk_stable(scores, 8)[1]
    assert bool((ids == torch.tensor([2, 0, 1, 3, 4, 6, 7, 5])).all())
