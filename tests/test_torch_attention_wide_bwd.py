"""Kernels C and D's wide route (head dims above 256), emulated on the CPU
in its own order.

``csrc/attention_bwd.cu`` cannot run here, so this test-local emulation does
what its wide bodies do, in torch. Where a block's stored tiles fit in
shared memory (:func:`takes_hopper_body`, the rule of ``launch_wide``), the
Hopper bodies compute S and dP once per (query tile, key tile): kernel C
walks, per 64-key tile, its query tiles over the head dim in chunks (64
bf16 or 32 f32 columns), stores P^T and dS^T of every query row, then
writes dK and dV by slices of columns (128 bf16, 64 f32), summing over the
query tiles; kernel D walks, per 64-row query tile, the key tiles that hold
a valid key (every tile in a pair with none), stores dS of every key, then
writes dQ by slices (128 bf16, 64 f32). A key tile without a valid key, in
a pair with one, gets zero dK, dV (C) and is not visited (D). bf16: the
chunks' products summed in f32, P and dS rounded to bf16 before the
output products. f32: every product in three TF32 passes (each operand x
split into big and small parts; the A operand's big part rounded to nearest,
the B operand's the f32 with its low 13 bits dropped, as the tensor cores
read a raw f32; small = tf32(x - big)), each stage (a chunk of the head dim,
a tile of 64 reduced rows) summed apart, the stages added in f32. Past the
limit the slice bodies run: one 64-column output slice a block, the scores
recomputed for each (f32 in plain f32 arithmetic).

The emulation is held against the port's plain autograd and ``jax.vjp`` of
the JAX package's ``_attn_core`` at hd 272 and 384, at g and s of 1, 17
and 100 and one past the limit; the three-pass split against an f64
product at depths 768 and 255. Nothing in the package uses it; the card
tests (``tests/test_torch_cuda.py``) hold the kernels themselves.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anncur_tpu.models import bert as jbert

from anncur_tpu_torch.ops.attention import attention_bwd_plain, attention_plain

torch.set_num_threads(2)  # xdist runs several test files side by side

TILE = 64
MASK = -1e9
BF16_RTOL = 2e-2  # x the plain gradient's max: chip_smoke.py's GRAD_RTOL (bf16 P, dS, outputs)
F32_RTOL = 1e-5  # x the plain gradient's max: three TF32 passes and f32 sums in other orders
ACCURACY_RATIO = 4.0  # the three-pass error against the plain f32 matmul's

# the wide Hopper bodies' shared memory (csrc/attention_bwd.cu, namespace
# wide): a ring of two slots (three where they fit), one stored tile per
# query tile (C) or key tile (D), three barriers for each of up to three
# slots, (D) 12 bytes of mask word and index per key tile, 1024 bytes to
# align, within the 232,448 a block may take
TILE_BYTES = 8192
SMEM_MAX = 232448
LAYOUT = {  # (slot, stored tile of C, of D) in tiles of 8 KB
    "bf16": (4, 2, 1),
    "f32": (6, 4, 2),
}
CHUNK = {"bf16": 64, "f32": 32}  # head-dim columns of a chunk
SLICE = {("bf16", "C"): 128, ("bf16", "D"): 128, ("f32", "C"): 64, ("f32", "D"): 64}


def takes_hopper_body(kind, kernel, g, s):
    """Whether ``launch_wide`` runs the Hopper body of kernel ``kernel``
    ("C" or "D") at g query rows and s keys (strides TMA takes)."""
    slot, store_c, store_d = LAYOUT[kind]
    n_kt = -(-s // TILE)
    n = -(-g // TILE) if kernel == "C" else n_kt
    store = store_c if kernel == "C" else store_d
    extra = 0 if kernel == "C" else 12 * n_kt
    return 2 * slot * TILE_BYTES + n * store * TILE_BYTES + 72 + extra + 1024 <= SMEM_MAX


def _bf(t):
    return t.to(torch.bfloat16).float()


def _bits(x):
    return x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def _from_bits(u):
    u = torch.where(u >= 2**31, u - 2**32, u)
    return u.to(torch.int32).view(torch.float32)


def tf32_rna(x):
    """f32 -> f32 with the low 13 mantissa bits cleared, rounded to nearest
    with ties away from zero (``cvt.rna.tf32.f32``)."""
    return _from_bits((_bits(x) + 0x1000) & 0xFFFFE000)


def tf32_trunc(x):
    """What the tensor cores read of a raw f32 operand: its low 13 bits dropped."""
    return _from_bits(_bits(x) & 0xFFFFE000)


def split_a(x):
    """An A operand's parts, split in registers: big = tf32(x), small = tf32(x - big)."""
    big = tf32_rna(x)
    return big, tf32_rna(x - big)


def split_b(x):
    """A B operand's parts: the raw f32 as its big part (read truncated),
    small = tf32(x - trunc(x)) (``tf32_small``)."""
    big = tf32_trunc(x)
    return big, tf32_rna(x - big)


def three_pass(a, b, stage, passes=3):
    """a @ b (..., m, k) x (..., k, n) as the f32 bodies compute it: per
    stage of ``stage`` along k, small_a big_b + big_a small_b + big_a big_b
    in f64 rounded once to f32, the stages added in f32 from +0.0
    (``passes=1``: big_a big_b alone, for contrast)."""
    ab, as_ = split_a(a)
    bb, bs = split_b(b)
    acc = torch.zeros(*a.shape[:-1], b.shape[-1], dtype=torch.float32)
    for k0 in range(0, a.shape[-1], stage):
        sl = slice(k0, k0 + stage)
        terms = ((as_, bb), (ab, bs), (ab, bb)) if passes == 3 else ((ab, bb),)
        part = sum(x[..., sl].double() @ y[..., sl, :].double() for x, y in terms)
        acc = acc + part.float()
    return acc


def _product(a, b, kind, stage, hopper):
    """One of the kernels' products: bf16 operands (exact in f32) summed in
    f32; f32 in three TF32 passes on the Hopper body, plain f32 on the
    slice body."""
    if kind == "f32" and hopper:
        return three_pass(a, b, stage)
    return a @ b


def _rows(x, n):
    """(b, n_rows, nh, hd) -> (b, nh, n padded to whole tiles, hd) f32, zero past the rows."""
    b, r, nh, hd = x.shape
    out = torch.zeros(b, nh, -(-n // TILE) * TILE, hd)
    out[:, :, :r] = x.float().transpose(1, 2)
    return out


def _key_bias(key_valid):
    """(b, sp) 0 at valid keys, -1e9 at masked, -inf past s; (b, sp) validity."""
    b, s = key_valid.shape
    sp = -(-s // TILE) * TILE
    bias = torch.full((b, sp), -math.inf)
    bias[:, :s] = torch.where(key_valid, 0.0, MASK)
    valid = torch.zeros(b, sp, dtype=torch.bool)
    valid[:, :s] = key_valid
    return bias, valid


def _shift(key_valid):
    return torch.where(key_valid.any(dim=1), 0.0, MASK)[:, None, None, None]


def _scores(a, b, hd, kind, hopper):
    """a b^T over the head dim in chunks, summed as phase 1 sums them."""
    cols = CHUNK[kind] if hopper else 64
    acc = 0
    for c0 in range(0, hd, cols):
        acc = acc + _product(a[..., c0:c0 + cols], b[..., c0:c0 + cols].transpose(-1, -2), kind, cols, hopper)
    return acc


def emulate_wide_c(q, k, v, key_valid, dout, lse, delta, kind, hopper=None, skip=True):
    """(dK, dV) of the wide kernel C in q's dtype, and the zero blocks (a
    key tile without a valid key, in a pair with one, when ``skip``).
    ``hopper`` None takes the route ``launch_wide`` takes."""
    b, g, nh, hd = q.shape
    s = k.shape[1]
    if hopper is None:
        hopper = takes_hopper_body(kind, "C", g, s)
    scale = 1.0 / math.sqrt(hd)
    qf, dof, kf, vf = _rows(q, g), _rows(dout, g), _rows(k, s), _rows(v, s)
    gp = qf.shape[2]
    lse_p = torch.full((b, nh, gp), math.inf)  # rows >= g: P = 0
    lse_p[..., :g] = lse
    delta_p = torch.zeros(b, nh, gp)
    delta_p[..., :g] = delta
    bias, valid = _key_bias(key_valid)
    pair_any = key_valid.any(dim=1)
    shift = _shift(key_valid)
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    zero_blocks = 0
    slice_w = SLICE[(kind, "C")] if hopper else 64
    for k0 in range(0, kf.shape[2], TILE):
        keys = slice(k0, k0 + TILE)
        run = valid[:, keys].any(dim=1) | ~pair_any | (not skip)
        zero_blocks += int((~run).sum()) * nh

        def stored():
            # phase 1: P^T and dS^T of every query row, tile by tile
            ps, dss = [], []
            for i0 in range(0, gp, TILE):
                rows = slice(i0, i0 + TILE)
                st = _scores(kf[:, :, keys], qf[:, :, rows], hd, kind, hopper)
                dpt = _scores(vf[:, :, keys], dof[:, :, rows], hd, kind, hopper)
                x = st * scale + bias[:, None, keys, None]
                p = torch.exp(x - shift - lse_p[:, :, None, rows])
                ds = p * (dpt - delta_p[:, :, None, rows])
                ps.append(_bf(p) if kind == "bf16" else p)
                dss.append(_bf(ds) if kind == "bf16" else ds)
            return ps, dss

        ps, dss = stored()
        for c0 in range(0, hd, slice_w):
            cols = slice(c0, c0 + slice_w)
            if not hopper:  # the slice body recomputes its scores
                ps, dss = stored()
            acc_k = acc_v = 0
            for t, i0 in enumerate(range(0, gp, TILE)):
                rows = slice(i0, i0 + TILE)
                acc_v = acc_v + _product(ps[t], dof[:, :, rows, cols], kind, TILE, hopper)
                acc_k = acc_k + _product(dss[t], qf[:, :, rows, cols], kind, TILE, hopper)
            sel = run[:, None, None, None]
            dk[:, :, keys, cols] = torch.where(sel, acc_k * scale, 0.0)
            dv[:, :, keys, cols] = torch.where(sel, acc_v, 0.0)
    out = (t[:, :, :s].transpose(1, 2).to(q.dtype) for t in (dk, dv))
    return (*out, zero_blocks)


def emulate_wide_d(q, k, v, key_valid, dout, lse, delta, kind, hopper=None, skip=True):
    """(dQ, key tiles skipped) of the wide kernel D in q's dtype (``skip`` as
    :func:`emulate_wide_c`)."""
    b, g, nh, hd = q.shape
    s = k.shape[1]
    if hopper is None:
        hopper = takes_hopper_body(kind, "D", g, s)
    scale = 1.0 / math.sqrt(hd)
    qf, dof, kf, vf = _rows(q, g), _rows(dout, g), _rows(k, s), _rows(v, s)
    gp = qf.shape[2]
    lse_p = torch.full((b, nh, gp), math.inf)
    lse_p[..., :g] = lse
    delta_p = torch.zeros(b, nh, gp)
    delta_p[..., :g] = delta
    bias, valid = _key_bias(key_valid)
    pair_any = key_valid.any(dim=1)
    shift = _shift(key_valid)
    tiles = range(0, kf.shape[2], TILE)
    # the key tiles each pair runs (the slice body skips them too)
    runs = [valid[:, k0:k0 + TILE].any(dim=1) | ~pair_any | (not skip) for k0 in tiles]
    skipped = sum(int((~r).sum()) for r in runs)

    def stored():
        # phase 1: dS of every key, tile by tile
        out = []
        for k0 in tiles:
            keys = slice(k0, k0 + TILE)
            sc = _scores(qf, kf[:, :, keys], hd, kind, hopper)
            dp = _scores(dof, vf[:, :, keys], hd, kind, hopper)
            x = sc * scale + bias[:, None, None, keys]
            ds = torch.exp(x - shift - lse_p[..., None]) * (dp - delta_p[..., None])
            out.append(_bf(ds) if kind == "bf16" else ds)
        return out

    dss = stored()
    dq = torch.zeros_like(qf)
    slice_w = SLICE[(kind, "D")] if hopper else 64
    for c0 in range(0, hd, slice_w):
        cols = slice(c0, c0 + slice_w)
        if not hopper:
            dss = stored()
        acc = torch.zeros_like(dq[..., cols])
        for ds, k0, run in zip(dss, tiles, runs):
            part = _product(ds, kf[:, :, k0:k0 + TILE, cols], kind, TILE, hopper)
            acc = torch.where(run[:, None, None, None], acc + part, acc)
        dq[..., cols] = acc
    return (dq[:, :, :g] * scale).transpose(1, 2).to(q.dtype), skipped


def forward_lse(q, k, key_valid):
    """(b, nh, g) f32 row log-sum-exp as kernel A writes it: without the
    -1e9 in a pair with no valid key."""
    hd = q.shape[-1]
    x = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float()) / math.sqrt(hd)
    x = x + torch.where(key_valid, 0.0, MASK)[:, None, None, :]
    return torch.logsumexp(x - _shift(key_valid), dim=-1)


def _inputs(hd, g, s, kind, seed=0, nh=2):
    """Pairs of s keys: prefix lengths at and around the 64-key tile
    boundaries, a pair with no valid key, one with holes inside tiles and a
    whole masked tile between valid ones, one whose tile 0 is all masked
    (the masks that fit in s); q and dO the first g rows."""
    rng = np.random.default_rng(seed + hd + g + s)
    rows = [np.arange(s) < n for n in (1, 63, 64, 65, s) if n <= s]
    rows.append(np.zeros(s, dtype=bool))  # no valid key
    if s > 140:
        holes = np.zeros(s, dtype=bool)
        holes[0:5] = holes[20:30] = holes[130:140] = True
        holes[200::3] = True  # keys 64-127 masked: a tile that is skipped
        rows.append(holes)
        late = np.zeros(s, dtype=bool)
        late[100:150] = True  # tile 0 all masked
        rows.append(late)
    valid = np.stack(rows)
    b = valid.shape[0]
    q, k, v = (rng.standard_normal((b, s, nh, hd)).astype(np.float32) for _ in range(3))
    dout = rng.standard_normal((b, g, nh, hd)).astype(np.float32)
    dtype = torch.bfloat16 if kind == "bf16" else torch.float32
    cast = lambda a: torch.as_tensor(a).to(dtype)  # noqa: E731
    return cast(q[:, :g]), cast(k), cast(v), torch.as_tensor(valid), cast(dout)


def _backward(q, k, v, valid, dout, kind, hopper=None):
    """(dQ, dK, dV) of the emulated wide kernels D then C, their skip
    counts, from the forward's output and lse as AttentionFunction feeds
    them; D = rowsum(dO * O) summed in f32."""
    lse = forward_lse(q, k, valid)
    out = attention_plain(q, k, v, valid)
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2)
    dq, skipped = emulate_wide_d(q, k, v, valid, dout, lse, delta, kind, hopper)
    dk, dv, zero_blocks = emulate_wide_c(q, k, v, valid, dout, lse, delta, kind, hopper)
    return (dq, dk, dv), zero_blocks, skipped


def _max_rel_err(got, want, floor=0.0):
    """Max |got - want| over max |want|, or over ``floor`` where want is 0
    everywhere (dQ and dK at s = 1: one key, P = 1, dS = 0 exactly)."""
    scale = float(want.float().abs().max())
    return float((got.float() - want.float()).abs().max()) / (scale if scale > 0 else floor)


def _jax_vjp(q, k, v, valid, dout, kind):
    bias = jnp.asarray(np.where(valid.numpy(), 0.0, MASK).astype(np.float32)[:, None, None, :])
    jdt = jnp.bfloat16 if kind == "bf16" else jnp.float32

    def core(q_, k_, v_):
        return jbert._attn_core(q_, k_, v_, bias, None, jdt, 0.0, "bqnk")

    jq, jk, jv, jdo = (jnp.asarray(t.float().numpy(), dtype=jdt) for t in (q, k, v, dout))
    _, vjp = jax.vjp(core, jq, jk, jv)
    return [torch.tensor(np.asarray(t.astype(jnp.float32))) for t in vjp(jdo)]


def test_the_limits_of_the_hopper_bodies():
    """``launch_wide``'s rule, as documented there: the Hopper bodies take
    bf16 g <= 640 (C) and s <= 1280 (D), f32 g <= 256 and s <= 512."""
    for kind, c_max, d_max in (("bf16", 640, 1280), ("f32", 256, 512)):
        assert takes_hopper_body(kind, "C", c_max, c_max) and not takes_hopper_body(kind, "C", c_max + 1, c_max + 1)
        assert takes_hopper_body(kind, "D", 1, d_max) and not takes_hopper_body(kind, "D", 1, d_max + 1)


@pytest.mark.parametrize("kind", ["bf16", "f32"])
@pytest.mark.parametrize("hd,g,s", [(272, 255, 255), (384, 255, 255), (272, 1, 255), (272, 17, 255),
                                    (384, 100, 100), (272, 1, 1), (272, 17, 17), (384, 1, 100)])
def test_emulated_wide_backward_matches_plain_autograd(kind, hd, g, s):
    """At every row and key, the pair with no valid key included: bf16
    within 2e-2 x the plain gradient's max, f32 within 1e-5; masked keys of
    pairs with a valid key get exactly zero dK and dV."""
    q, k, v, valid, dout = _inputs(hd, g, s, kind)
    got, zero_blocks, skipped = _backward(q, k, v, valid, dout, kind)
    if s == 255:
        assert zero_blocks > 0 and skipped > 0
    want = attention_bwd_plain(q, k, v, valid, dout)
    tol = BF16_RTOL if kind == "bf16" else F32_RTOL
    floor = max(float(w.float().abs().max()) for w in want)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == q.dtype and a.shape == w.shape, name
        assert _max_rel_err(a, w, floor) <= tol, (name, _max_rel_err(a, w, floor))
    masked = ~valid & valid.any(dim=1, keepdim=True)
    assert not got[1][masked].any() and not got[2][masked].any()


@pytest.mark.parametrize("kind", ["bf16", "f32"])
@pytest.mark.parametrize("hd,g", [(272, 255), (384, 100), (272, 17)])
def test_emulated_wide_backward_matches_jax_attn_core(kind, hd, g):
    """Against ``jax.vjp`` of JAX's ``_attn_core`` in the same dtype: bf16
    within 2e-2 x JAX's gradient's max (JAX rounds dP to bf16 where the
    kernels keep it f32), f32 within 1e-5."""
    q, k, v, valid, dout = _inputs(hd, g, 255, kind, seed=1)
    got, _, _ = _backward(q, k, v, valid, dout, kind)
    want = _jax_vjp(q, k, v, valid, dout, kind)
    tol = BF16_RTOL if kind == "bf16" else F32_RTOL
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert _max_rel_err(a, w) <= tol, (name, _max_rel_err(a, w))


@pytest.mark.parametrize("kind,g,s", [("bf16", 641, 641), ("bf16", 17, 1281), ("f32", 257, 257), ("f32", 1, 513)])
def test_past_the_shared_memory_limit_the_slice_bodies_agree(kind, g, s):
    """One tile past the limit the slice bodies run (kernel C past g, D past
    s), recomputing the scores per 64-column slice; they agree with the
    plain autograd and with the Hopper bodies' order on the same inputs."""
    q, k, v, valid, dout = _inputs(272, g, s, kind, seed=2, nh=1)
    c_hopper, d_hopper = takes_hopper_body(kind, "C", g, s), takes_hopper_body(kind, "D", g, s)
    assert not (c_hopper and d_hopper)
    assert not takes_hopper_body(kind, "C" if g > 256 else "D", g, s)
    got, _, _ = _backward(q, k, v, valid, dout, kind)
    want = attention_bwd_plain(q, k, v, valid, dout)
    other, _, _ = _backward(q, k, v, valid, dout, kind, hopper=True)
    tol = BF16_RTOL if kind == "bf16" else F32_RTOL
    for name, a, w, o in zip(("dq", "dk", "dv"), got, want, other):
        assert _max_rel_err(a, w) <= tol, (name, _max_rel_err(a, w))
        assert _max_rel_err(o, a) <= tol, (name, _max_rel_err(o, a))


@pytest.mark.parametrize("kind", ["bf16", "f32"])
def test_skipped_key_tiles_change_no_bit(kind):
    """A 64-key tile without a valid key, in a pair with one, has P =
    exp(-1e9 + ...) = 0 in f32 at every key: kernel C's zero block and
    kernel D's skipped tile give the bits of running them."""
    q, k, v, valid, dout = _inputs(272, 255, 255, kind, seed=3)
    lse = forward_lse(q, k, valid)
    delta = (dout.float() * attention_plain(q, k, v, valid).float()).sum(-1).transpose(1, 2)
    dk, dv, zero_blocks = emulate_wide_c(q, k, v, valid, dout, lse, delta, kind)
    dk_all, dv_all, none = emulate_wide_c(q, k, v, valid, dout, lse, delta, kind, skip=False)
    assert zero_blocks > 0 and none == 0
    assert torch.equal(dk, dk_all) and torch.equal(dv, dv_all)
    dq, skipped = emulate_wide_d(q, k, v, valid, dout, lse, delta, kind)
    dq_all, none = emulate_wide_d(q, k, v, valid, dout, lse, delta, kind, skip=False)
    assert skipped > 0 and none == 0
    assert torch.equal(dq, dq_all)


@pytest.mark.parametrize("depth", [768, 255])
def test_three_pass_transposed_products_are_f32_accurate(depth):
    """The f32 body's products over the three TF32 passes, on seeded normal
    f32 operands: phase 1's S^T = K Q^T over a head dim of 768 (stages of
    32) and phase 2's transposed products dV = P^T dO, dK = dS^T Q, dQ = dS
    K over 255 reduced rows (stages of 64, the B operand transposed and
    split by the kernel): the max error against the f64 product is at most
    4x the plain f32 matmul's; one TF32 pass is far outside it."""
    rng = np.random.default_rng(depth)
    stage = 32 if depth == 768 else TILE
    for _ in range(3):  # the three transposed products (phase 1's, at 768, three times over)
        a = torch.as_tensor(rng.standard_normal((64, depth)).astype(np.float32))
        bt = torch.as_tensor(rng.standard_normal((depth, 256)).astype(np.float32))
        exact = a.double() @ bt.double()
        plain = float(((a @ bt).double() - exact).abs().max() / exact.abs().max())
        three = float((three_pass(a, bt, stage).double() - exact).abs().max() / exact.abs().max())
        one = float((three_pass(a, bt, stage, passes=1).double() - exact).abs().max() / exact.abs().max())
        assert three <= ACCURACY_RATIO * plain, (three, plain)
        assert one > 10 * ACCURACY_RATIO * plain, (one, plain)


def test_split_parts_of_the_raw_b_operand():
    """The B operand's big part is the raw f32 read with its low 13 bits
    dropped, its small part tf32(x - big): big + small is within 2^-22 |x|
    of x, both parts tf32, and a value already tf32 has small part 0."""
    rng = np.random.default_rng(5)
    x = torch.as_tensor((rng.standard_normal(4096) * np.exp2(rng.integers(-40, 40, 4096))).astype(np.float32))
    big, small = split_b(x)
    for part in (big, small):
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert bool(((big.double() + small.double() - x.double()).abs() <= 2.0**-22 * x.double().abs()).all())
    exact = tf32_rna(x)
    assert not split_b(exact)[1].any()
