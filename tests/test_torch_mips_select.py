"""Kernel B's select arithmetic, emulated on the CPU in its own order.

``csrc/mips_topk.cu`` cannot run here, so this test-local emulation does
what its select stage does to one score row, in numpy: the order-preserving
32-bit key map (+0.0 above -0.0, as lax.top_k), the exclusion mark (key
0), the cluster's slices, four 8-bit
digit rounds of per-block histograms summed over the cluster, the
compaction of the survivors in id order through block and warp prefix
counts over each warp's candidates (the keys whose top byte reaches the
first digit, or its whole chunk where they overflow a list of 256), then the rank placement (k <= 1024) or the bitonic network over
global memory (k > 1024). It is held against the port's ``topk_stable`` /
``mips_topk`` and JAX's ``lax.top_k`` / ``anncur_tpu.ops.mips`` at equality
of ids. Nothing in the package uses the emulation.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from anncur_tpu.ops import mips as jmips

from anncur_tpu_torch.ops.mips import mips_topk, topk_stable

torch.set_num_threads(2)  # xdist runs several test files side by side

# the kernel's constants (csrc/mips_topk.cu)
SEL_WARPS = 8
MAX_CLUSTER = 8
SLICE_TARGET = 2048
CLUSTER_SORT_MAX = 1024
CAND_CAP = 256
SORT_CHUNK = 8192


EXCLUDED_BITS = 0xFFFFFFFF  # the select's mark over excluded ids: key 0


def order_key(scores):
    """f32 -> uint32 in lax.top_k's order (+0.0 above -0.0)."""
    u = np.asarray(scores, np.float32).view(np.uint32)
    return np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)


def score_store(scores):
    """The score kernel's store: the mark's bits become 0xFFFFFFFE."""
    u = np.asarray(scores, np.float32).view(np.uint32).copy()
    u[u == EXCLUDED_BITS] = EXCLUDED_BITS - 1
    return u.view(np.float32)


def mark_excluded(row, exclude):
    """The select's first step: the mark over the row's excluded ids that
    lie in [0, len(row))."""
    u = np.asarray(row, np.float32).view(np.uint32).copy()
    ex = np.asarray(exclude, np.int64)
    u[ex[(ex >= 0) & (ex < len(row))]] = EXCLUDED_BITS
    return u.view(np.float32)


def pack(keys, ids):
    """64-bit words whose descending order is (key desc, id asc)."""
    return (keys.astype(np.uint64) << np.uint64(32)) | (~ids.astype(np.uint64) & np.uint64(0xFFFFFFFF))


def unpack_id(words):
    return (~words & np.uint64(0xFFFFFFFF)).astype(np.int64)


def cluster_plan(n_valid):
    """(blocks per row, keys per block), as make_plan."""
    blocks = 1
    while blocks < MAX_CLUSTER and -(-n_valid // blocks) > SLICE_TARGET:
        blocks *= 2
    return blocks, -(-n_valid // blocks)


def warp_chunks(blk):
    """(start, keys) of each warp's contiguous, 32-aligned chunk of a slice."""
    per_warp = -(-(-(-len(blk) // SEL_WARPS)) // 32) * 32
    return [(w * per_warp, blk[w * per_warp:(w + 1) * per_warp]) for w in range(SEL_WARPS)]


def candidates(seg, d0):
    """A warp's candidate mask: the keys whose top byte is >= d0, or the
    whole chunk where they would overflow its list of CAND_CAP."""
    pick = (seg >> np.uint32(24)) >= d0
    return pick if pick.sum() <= CAND_CAP else np.ones_like(pick)


def radix_select(keys, k, blocks, slice_):
    """(T, c, d0): the k-th largest key, the number of keys above it, and
    the first digit. Round 0 counts every key; rounds 1-3 each warp's
    candidates, of which those matching the prefix."""
    prefix = pmask = d0 = 0
    k_rem = k
    for rnd in range(4):
        shift = 24 - 8 * rnd
        hist = np.zeros(256, np.int64)
        for b in range(blocks):  # each block's histogram; the cluster sums them
            blk = keys[b * slice_:(b + 1) * slice_]
            for _, seg in warp_chunks(blk):
                if rnd:
                    seg = seg[candidates(seg, d0)]
                in_play = seg[(seg & np.uint32(pmask)) == np.uint32(prefix)]
                hist += np.bincount((in_play >> np.uint32(shift)) & np.uint32(0xFF), minlength=256)
        above = np.cumsum(hist[::-1])[::-1] - hist  # keys in the bins above each bin
        (digit,) = np.flatnonzero((above < k_rem) & (k_rem <= above + hist))  # exactly one
        d0 = d0 if rnd else int(digit)
        prefix |= int(digit) << shift
        pmask |= 0xFF << shift
        k_rem -= int(above[digit])
    return prefix, k - k_rem, d0


def compact(keys, T, c, k, d0, blocks, slice_):
    """The k survivor words at the kernel's positions: keys > T at [0, c),
    the first k - c keys == T at [c, k), through each block's and each
    warp's exclusive prefix counts over the warp's candidates, in id order."""
    out = np.zeros(k, np.uint64)
    written = np.zeros(k, bool)
    gt_before = eq_before = 0  # over the lower blocks of the cluster
    for b in range(blocks):
        lo = b * slice_
        blk = keys[lo:lo + slice_]
        o_gt, o_eq = gt_before, eq_before
        for start, seg in warp_chunks(blk):
            ids = lo + start + np.arange(len(seg))
            pick = candidates(seg, d0)
            seg, ids = seg[pick], ids[pick]
            gt, eq = seg > T, seg == T
            pos = o_gt + np.cumsum(gt) - 1
            rank = o_eq + np.cumsum(eq) - 1
            take = eq & (rank < k - c)
            for sel, at in ((gt, pos[gt]), (take, c + rank[take])):
                assert not written[at].any()
                out[at] = pack(seg[sel], ids[sel])
                written[at] = True
            o_gt += int(gt.sum())
            o_eq += int(eq.sum())
        gt_before += int((blk > T).sum())
        eq_before += int((blk == T).sum())
    assert written.all()
    return out


def bitonic_desc(words, chunk=SORT_CHUNK):
    """The global sort, as mips_topk_fused drives it, on words padded with
    zeros to a power of two: mips_sort_chunk_kernel runs every merge size up
    to ``chunk`` and, for each larger size, the strides below ``chunk``, each
    chunk alone at its offset; mips_sort_step_kernel runs the larger strides
    over the whole row."""
    kp = 1 << max(0, int(len(words) - 1).bit_length())
    a = np.zeros(kp, np.uint64)
    a[:len(words)] = words
    chunk = min(kp, chunk)

    def stage(v, base, size, stride):
        i = np.arange(len(v))
        lo = i[(i & stride) == 0]
        hi = lo + stride
        desc = ((base + lo) & size) == 0
        x, y = v[lo], v[hi]
        swap = (x != y) & ((x < y) == desc)
        v[lo[swap]], v[hi[swap]] = y[swap], x[swap]

    def chunk_pass(size):
        for base in range(0, kp, chunk):
            v = a[base:base + chunk]  # a view: the chunk in shared memory
            for sz in [size] if size else [1 << e for e in range(1, chunk.bit_length())]:
                stride = min(sz, chunk) // 2
                while stride > 0:
                    stage(v, base, sz, stride)
                    stride //= 2

    chunk_pass(0)
    size = 2 * chunk
    while size <= kp:
        stride = size // 2
        while stride >= chunk:
            stage(a, 0, size, stride)
            stride //= 2
        chunk_pass(size)
        size *= 2
    return a[:len(words)]


def emulate_select(row, k, chunk=SORT_CHUNK, exclude=()):
    """(scores, ids) of one row's k best, as the select stage makes them,
    after marking the ``exclude`` ids."""
    keys = order_key(mark_excluded(row, exclude))
    blocks, slice_ = cluster_plan(len(row))
    T, c, d0 = radix_select(keys, k, blocks, slice_)
    words = compact(keys, T, c, k, d0, blocks, slice_)
    if k <= CLUSTER_SORT_MAX:
        place = np.array([(words > w).sum() for w in words])  # every block places its share
        ordered = np.empty_like(words)
        ordered[place] = words
    else:
        ordered = bitonic_desc(words, chunk)
    ids = unpack_id(ordered)
    return row[ids], ids


def emulate(scores, k, n_valid=None, exclude=None):
    n_valid = scores.shape[1] if n_valid is None else n_valid
    scores = score_store(scores)
    rows = [emulate_select(r[:n_valid], k, exclude=() if exclude is None else exclude[i]) for i, r in enumerate(scores)]
    return np.stack([s for s, _ in rows]), np.stack([i for _, i in rows])


def _int_inputs(seed, q, n, d):
    rng = np.random.default_rng(seed)
    queries = rng.integers(-2, 3, size=(q, d)).astype(np.float32)
    items = rng.integers(-2, 3, size=(n, d)).astype(np.float32)
    return queries, items


@pytest.mark.parametrize(
    "q,n,d,n_valid,k",
    [
        (4, 300, 16, 300, 1),  # one block, k = 1
        (3, 5000, 8, 4500, 300),  # 4 blocks, k > 256
        (2, 20000, 6, 17000, 100),  # 8 blocks of 2125 keys; padding never seen
        (2, 2100, 4, 2100, 2100),  # k = n_valid: the global sort
        (2, 9000, 3, 9000, 1500),  # k > 1024, heavy ties (d = 3)
        (5, 777, 32, 700, 256),
    ],
)
def test_select_matches_topk_on_small_integer_ties(q, n, d, n_valid, k):
    queries, items = _int_inputs(n + k, q, n, d)
    scores = queries @ items.T  # small integers: exact in f32, many ties
    s_e, i_e = emulate(scores, k, n_valid)
    s_t, i_t = mips_topk(torch.as_tensor(queries), torch.as_tensor(items), k, n_valid)
    np.testing.assert_array_equal(i_e, i_t.numpy())
    np.testing.assert_array_equal(s_e, s_t.numpy())
    valid = jnp.asarray(np.arange(n) < n_valid)
    full = jnp.dot(jnp.asarray(queries), jnp.asarray(items).T, precision="highest")
    s_j, i_j = jmips.masked_topk(full, k, valid)
    np.testing.assert_array_equal(i_e, np.asarray(i_j))
    np.testing.assert_array_equal(s_e, np.asarray(s_j))
    if n_valid == n:
        _, i_m = jmips.mips_topk(jnp.asarray(queries), jnp.asarray(items), k)
        np.testing.assert_array_equal(i_e, np.asarray(i_m))


@pytest.mark.parametrize("n,k", [(1000, 1), (2500, 100), (2500, 2500), (40000, 1200)])
def test_select_all_equal_rows_take_the_smallest_ids(n, k):
    scores = np.full((2, n), 3.5, np.float32)
    scores[1] = -7.0
    s_e, i_e = emulate(scores, k)
    np.testing.assert_array_equal(i_e, np.broadcast_to(np.arange(k), (2, k)))
    _, i_t = topk_stable(torch.as_tensor(scores), k)
    _, i_j = lax.top_k(jnp.asarray(scores), k)
    np.testing.assert_array_equal(i_e, i_t.numpy())
    np.testing.assert_array_equal(i_e, np.asarray(i_j))


@pytest.mark.parametrize("k", [1, 7, 300, 1100])
def test_select_random_f32_matches_lax_top_k(k):
    rng = np.random.default_rng(k)
    scores = (rng.standard_normal((3, 6000)) * 10.0 ** rng.integers(-3, 4, size=(3, 6000))).astype(np.float32)
    scores[:, ::97] = np.inf
    scores[:, 5::89] = -np.inf
    scores[:, 3::101] = 1e-42  # subnormal
    s_e, i_e = emulate(scores, k)
    s_j, i_j = lax.top_k(jnp.asarray(scores), k)
    np.testing.assert_array_equal(i_e, np.asarray(i_j))
    np.testing.assert_array_equal(s_e, np.asarray(s_j))
    _, i_t = topk_stable(torch.as_tensor(scores), k)
    np.testing.assert_array_equal(i_e, i_t.numpy())


def test_signed_zeros_rank_as_topk_stable_orders_them():
    """+0.0 ranks above -0.0, then ties go to the smaller id: the select's
    key map, ``topk_stable`` and ``lax.top_k`` give one order. (The score
    stage makes -0.0 only when every product rounds to -0.0: its fmaf chain
    starts at +0.0, and +0.0 + -0.0 is +0.0.)"""
    row = np.array([0.0, -0.0, 1.0, -0.0, 0.0, -1.0, -0.0, 0.0], np.float32)
    assert order_key(row)[0] == order_key(row)[1] + 1
    s_e, i_e = emulate_select(row, 8)
    _, i_t = topk_stable(torch.as_tensor(row), 8)
    _, i_j = lax.top_k(jnp.asarray(row), 8)
    want = [2, 0, 4, 7, 1, 3, 6, 5]
    assert i_e.tolist() == i_t.tolist() == np.asarray(i_j).tolist() == want
    np.testing.assert_array_equal(np.signbit(s_e), np.signbit(row[i_e]))  # scores keep their bits
    # a sum of products that are all -0.0, accumulated from +0.0, is +0.0
    acc = np.float32(0.0)
    for p in np.float32([-1.0, -2.0]) * np.float32(0.0):
        acc = np.float32(acc + p)
    assert not np.signbit(acc)


@pytest.mark.parametrize("fill", [0.0, -np.inf, -1e30, "nan_mark"])
def test_exclusion_mark_ranks_below_every_score(fill):
    """Excluded ids get key 0; every stored score's key is at least 1 (the
    score store turns the mark's own bits into 0xFFFFFFFE), so excluded ids
    come after every real score, -inf included, and are never among the k
    <= n_valid - S selected: equal to the plain ``mips_topk(exclude=)``."""
    rng = np.random.default_rng(7)
    scores = rng.integers(-3, 4, size=(3, 3000)).astype(np.float32)
    if fill == "nan_mark":  # a real score with the mark's bits
        scores.view(np.uint32)[:, ::7] = EXCLUDED_BITS
    else:
        scores[:, ::2] = fill
    exclude = np.stack([rng.choice(3000, size=40, replace=False) for _ in range(3)])
    exclude[:, 0] = exclude[:, 1]  # a duplicate
    exclude[:, 2] = -1
    keys = order_key(score_store(scores))
    assert keys.min() >= 1
    for k in (5, 3000 - 40):
        _, i_e = emulate(scores, k, exclude=exclude)
        for r in range(3):
            # the stable top-k of the row with its excluded ids taken out
            keep = np.setdiff1d(np.arange(3000), exclude[r])
            want = keep[topk_stable(torch.as_tensor(scores[r, keep]), k)[1].numpy()]
            np.testing.assert_array_equal(i_e[r], want)


def test_order_key_is_monotone():
    rng = np.random.default_rng(0)
    x = np.sort(np.concatenate([
        rng.standard_normal(500).astype(np.float32) * 1e30,
        rng.standard_normal(500).astype(np.float32) * 1e-40,
        np.float32([-np.inf, np.inf, 0.0, 1e-45, -1e-45, np.finfo(np.float32).max]),
    ]))
    keys = order_key(x)
    assert (np.diff(keys.astype(np.int64)) >= 0).all()
    assert ((np.diff(keys.astype(np.int64)) > 0) == (np.diff(x) > 0)).all()


def test_compaction_keeps_id_order_and_the_first_equal_keys():
    rng = np.random.default_rng(3)
    row = rng.integers(0, 6, size=9000).astype(np.float32)
    keys = order_key(row)
    blocks, slice_ = cluster_plan(len(row))
    assert blocks == 8
    k = 2000
    T, c, d0 = radix_select(keys, k, blocks, slice_)
    assert (keys > T).sum() == c < k <= (keys >= T).sum()
    assert (keys >> np.uint32(24) >= d0).sum() < len(keys)  # the candidates are fewer
    words = compact(keys, T, c, k, d0, blocks, slice_)
    ids = unpack_id(words)
    assert (np.diff(ids[:c]) > 0).all() and (np.diff(ids[c:]) > 0).all()
    np.testing.assert_array_equal(ids[c:], np.flatnonzero(keys == T)[:k - c])


@pytest.mark.parametrize("chunk", [2, 64, SORT_CHUNK])
def test_bitonic_network_is_one_sort_for_any_chunk(chunk):
    rng = np.random.default_rng(chunk)
    words = pack(rng.integers(0, 50, size=3000).astype(np.uint32), rng.permutation(3000))
    np.testing.assert_array_equal(bitonic_desc(words, chunk), np.sort(words)[::-1])
