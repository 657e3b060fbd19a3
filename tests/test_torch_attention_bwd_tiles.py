"""Kernels C and D's bf16 arithmetic, emulated on the CPU in their own order.

``csrc/attention_bwd.cu`` cannot run here, so this test-local emulation
does what its bf16 bodies do, in torch: kernel D, launched first, sums D =
rowsum(dO * O) per row in f32 from bf16 O and dO (four lanes a row, as
:func:`emulate_delta` orders it) and writes it for kernel C; kernel C owns
64-key tiles and walks the query rows in tiles (64 rows, or 16 when g <=
16), padding rows past g with zero Q and dO, lse = +inf and D = 0 so that
they add nothing; kernel D walks 64-key tiles and skips those without a
valid key when the pair has one (the mma.sync body always runs tile 0, the
Hopper body at hd = 64, g > 16 skips it too). Both recompute P = exp(S *
scale + bias - shift - lse) in f32, round P and dS to bf16 before the dV,
dK and dQ products and sum in f32. ``shift`` is -1e9 in a pair with no
valid key, whose lse kernel A writes without the -1e9
(``csrc/attention.cu``). The emulation is held against the port's plain
autograd and ``jax.vjp`` of the JAX package's ``_attn_core`` in bf16, its
D against the plain reduction and JAX's ``di``, and with skipping against
without. Nothing in the package uses the emulation.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anncur_tpu.models import bert as jbert

from anncur_tpu_torch.ops.attention import attention_bwd_plain, attention_delta_plain, attention_plain

torch.set_num_threads(2)  # xdist runs several test files side by side

TILE = 64
MASK = -1e9
PLAIN_RTOL = 2e-2  # x the plain gradient's max: chip_smoke.py's GRAD_RTOL (bf16 P, dS, outputs)
# x JAX's gradient's max: the same bound. JAX's bf16 vjp rounds at other
# places (the probabilities' cotangent dP, an einsum with a bf16 result,
# before the softmax backward), each a bf16 rounding; the distance is
# ~5e-3 at these inputs, as the port's plain autograd's from JAX's
JAX_RTOL = 2e-2
# D = rowsum(dO * O) vs the plain reduction and JAX's di, x max|D|: f32 sums
# of exact bf16 products in other orders
DELTA_RTOL = 1e-6


def _bf(t):
    return t.to(torch.bfloat16).float()


def _shift(key_valid, shifted=True):
    """(b,) -1e9 for a pair with no valid key, else 0 (all 0 if not ``shifted``)."""
    return torch.where(key_valid.any(dim=1) | (not shifted), 0.0, MASK)


def forward_lse(q, k, key_valid, shifted=True):
    """(b, nh, g) f32 row log-sum-exp of the scaled, biased scores, as
    kernel A writes it: without the -1e9 in a pair with no valid key
    (``shifted``), or with it, where -1e9 + log(l) rounds to -1e9."""
    hd = q.shape[-1]
    x = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float()) / math.sqrt(hd)
    x = x + torch.where(key_valid, 0.0, MASK)[:, None, None, :]
    return torch.logsumexp(x - _shift(key_valid, shifted)[:, None, None, None], dim=-1)


def emulate_delta(dout, out):
    """(b, nh, g) f32 D = rowsum(dO * O) as kernel D sums it: each row's
    16-byte units (8 values) dealt to the four lanes of a quad, lane p
    taking units p, p + 4, ..., each lane adding its products (exact in
    f32: bf16 times bf16) in order, then (p0 + p1) + (p2 + p3)."""
    prod = (dout.float() * out.float()).transpose(1, 2)  # (b, nh, g, hd)
    parts = []
    for p in range(4):
        acc = torch.zeros(prod.shape[:-1])
        for u in range(p, prod.shape[-1] // 8, 4):
            for e in range(8):
                acc = acc + prod[..., 8 * u + e]
        parts.append(acc)
    return (parts[0] + parts[1]) + (parts[2] + parts[3])


def _pad_keys(k, v, key_valid):
    """K, V as (b, nh, sp, hd) f32 with sp a multiple of TILE (keys >= s
    zero) and the key bias (b, sp): 0, -1e9 at masked keys, -inf past s."""
    b, s, nh, hd = k.shape
    sp = -(-s // TILE) * TILE
    kf, vf = (torch.zeros(b, nh, sp, hd) for _ in range(2))
    kf[:, :, :s], vf[:, :, :s] = k.float().transpose(1, 2), v.float().transpose(1, 2)
    bias = torch.full((b, sp), -math.inf)
    bias[:, :s] = torch.where(key_valid, 0.0, MASK)
    valid = torch.zeros(b, sp, dtype=torch.bool)
    valid[:, :s] = key_valid
    return kf, vf, bias, valid


def emulate_kernel_c(q, k, v, key_valid, dout, lse, delta, skip=True, shifted=True):
    """(dK, dV, zero blocks) as kernel C's bf16 body computes them: dK, dV
    (b, s, nh, hd) bf16; a 64-key block without a valid key, in a pair that
    has one, writes zeros when ``skip``. ``shifted`` False takes P = exp(x -
    lse) in every pair, with ``lse`` keeping the -1e9 of a pair with no
    valid key (:func:`forward_lse`)."""
    b, g, nh, hd = q.shape
    s = k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    qt = 16 if g <= 16 else TILE
    gp = -(-g // qt) * qt
    qf, dof = (torch.zeros(b, nh, gp, hd) for _ in range(2))
    qf[:, :, :g], dof[:, :, :g] = q.float().transpose(1, 2), dout.float().transpose(1, 2)
    lse_p = torch.full((b, nh, gp), math.inf)  # rows >= g: P = 0
    lse_p[..., :g] = lse
    delta_p = torch.zeros(b, nh, gp)
    delta_p[..., :g] = delta
    kf, vf, bias, valid = _pad_keys(k, v, key_valid)
    pair_any = key_valid.any(dim=1)
    shift = _shift(key_valid, shifted)[:, None, None, None]
    dk, dv = torch.zeros_like(kf), torch.zeros_like(vf)
    zero_blocks = 0
    for k0 in range(0, kf.shape[2], TILE):
        keys = slice(k0, k0 + TILE)
        run = valid[:, keys].any(dim=1) | ~pair_any | (not skip)
        zero_blocks += int((~run).sum()) * nh
        acc_k, acc_v = torch.zeros(b, nh, TILE, hd), torch.zeros(b, nh, TILE, hd)
        for i0 in range(0, gp, qt):
            rows = slice(i0, i0 + qt)
            st = kf[:, :, keys] @ qf[:, :, rows].transpose(-1, -2)  # (b, nh, keys, rows)
            dpt = vf[:, :, keys] @ dof[:, :, rows].transpose(-1, -2)
            x = st * scale + bias[:, None, keys, None]
            p = torch.exp(x - shift - lse_p[:, :, None, rows])
            ds = p * (dpt - delta_p[:, :, None, rows])
            acc_v += _bf(p) @ dof[:, :, rows]
            acc_k += _bf(ds) @ qf[:, :, rows]
        sel = run[:, None, None, None]
        dk[:, :, keys] = torch.where(sel, acc_k * scale, 0.0)
        dv[:, :, keys] = torch.where(sel, acc_v, 0.0)
    out = (t[:, :, :s].transpose(1, 2).to(torch.bfloat16) for t in (dk, dv))
    return (*out, zero_blocks)


def emulate_kernel_d(q, k, v, key_valid, dout, lse, delta, skip=True, first_tile_runs=True, shifted=True):
    """(dQ, tiles skipped) as kernel D's bf16 body computes them: dQ (b, g,
    nh, hd) bf16; a 64-key tile without a valid key, in a pair that has
    one, is skipped when ``skip``, tile 0 only if not ``first_tile_runs``;
    ``shifted`` as :func:`emulate_kernel_c`."""
    hd = q.shape[-1]
    scale = 1.0 / math.sqrt(hd)
    qf, dof = q.float().transpose(1, 2), dout.float().transpose(1, 2)  # (b, nh, g, hd)
    kf, vf, bias, valid = _pad_keys(k, v, key_valid)
    pair_any = key_valid.any(dim=1)
    shift = _shift(key_valid, shifted)[:, None, None, None]
    dq = torch.zeros_like(qf)
    skipped = 0
    for k0 in range(0, kf.shape[2], TILE):
        keys = slice(k0, k0 + TILE)
        always = not skip or (k0 == 0 and first_tile_runs)
        run = valid[:, keys].any(dim=1) | ~pair_any | always
        skipped += int((~run).sum())
        sc = qf @ kf[:, :, keys].transpose(-1, -2)  # (b, nh, g, keys)
        dp = dof @ vf[:, :, keys].transpose(-1, -2)
        x = sc * scale + bias[:, None, None, keys]
        p = torch.exp(x - shift - lse[..., None])
        ds = p * (dp - delta[..., None])
        dq = torch.where(run[:, None, None, None], dq + _bf(ds) @ kf[:, :, keys], dq)
    return (dq * scale).transpose(1, 2).to(torch.bfloat16), skipped


def _inputs(hd, g=255, seed=0):
    """bf16 pairs of s=255 keys, the mask cases of
    tests/test_torch_attention_tiles.py::_inputs: prefix lengths 1, 63, 64,
    65, 255; a pair with no valid key; one with holes inside tiles and a
    whole masked tile between valid ones; one whose tile 0 is all masked.
    q is the first g rows; dO random at every row."""
    rng = np.random.default_rng(seed)
    s, nh = 255, 2
    lengths = [1, 63, 64, 65, s]
    valid = np.zeros((len(lengths) + 3, s), dtype=bool)
    for r, n in enumerate(lengths):
        valid[r, :n] = True
    # row len(lengths): no valid key
    holes = valid[len(lengths) + 1]
    holes[0:5] = holes[20:30] = holes[130:140] = True
    holes[200::3] = True  # keys 64-127 stay masked: a tile that is skipped
    valid[len(lengths) + 2, 100:150] = True  # tile 0 all masked
    b = valid.shape[0]
    q, k, v = (rng.standard_normal((b, s, nh, hd)).astype(np.float32) for _ in range(3))
    dout = rng.standard_normal((b, g, nh, hd)).astype(np.float32)
    to_bf16 = lambda a: torch.as_tensor(a).to(torch.bfloat16)  # noqa: E731
    return to_bf16(q[:, :g]), to_bf16(k), to_bf16(v), torch.as_tensor(valid), to_bf16(dout)


def _backward(q, k, v, valid, dout, skip=True, shifted=True):
    """(dQ, dK, dV) of the emulated kernels D then C, and their skip
    counts, from the bf16 forward output and lse as AttentionFunction
    feeds them; D = rowsum(dO * O) as kernel D sums it. At hd = 64, g > 16
    kernel D's Hopper body skips a masked tile 0 as well."""
    lse = forward_lse(q, k, valid, shifted)
    out = attention_plain(q, k, v, valid)
    delta = emulate_delta(dout, out)
    hopper = q.shape[-1] == 64 and q.shape[1] > 16
    dq, skipped = emulate_kernel_d(q, k, v, valid, dout, lse, delta, skip=skip, first_tile_runs=not hopper,
                                   shifted=shifted)
    dk, dv, zero_blocks = emulate_kernel_c(q, k, v, valid, dout, lse, delta, skip=skip, shifted=shifted)
    return (dq, dk, dv), zero_blocks, skipped


def _max_rel_err(got, want):
    return float((got.float() - want.float()).abs().max() / want.float().abs().max())


@pytest.mark.parametrize("hd,g", [(16, 255), (64, 255), (64, 1), (64, 3), (64, 17), (64, 64), (64, 100), (32, 100)])
def test_emulated_backward_matches_plain_autograd(hd, g):
    q, k, v, valid, dout = _inputs(hd, g)
    got, zero_blocks, skipped = _backward(q, k, v, valid, dout)
    want = attention_bwd_plain(q, k, v, valid, dout)
    assert zero_blocks > 0 and skipped > 0
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16 and a.shape == w.shape, name
        # every row and key: the pair with no valid key included
        assert _max_rel_err(a, w) <= PLAIN_RTOL, (name, _max_rel_err(a, w))
    masked = ~valid & valid.any(dim=1, keepdim=True)  # masked keys of pairs with a valid key
    assert not got[1][masked].any() and not got[2][masked].any()


@pytest.mark.parametrize("hd", [16, 64])
def test_emulated_backward_matches_jax_attn_core_bf16(hd):
    q, k, v, valid, dout = _inputs(hd, seed=1)
    got, _, _ = _backward(q, k, v, valid, dout)
    bias = jnp.asarray(np.where(valid.numpy(), 0.0, MASK).astype(np.float32)[:, None, None, :])

    def core(q_, k_, v_):
        return jbert._attn_core(q_, k_, v_, bias, None, jnp.bfloat16, 0.0, "bqnk")

    jq, jk, jv, jdo = (jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16) for t in (q, k, v, dout))
    _, vjp = jax.vjp(core, jq, jk, jv)
    want = [torch.tensor(np.asarray(t.astype(jnp.float32))) for t in vjp(jdo)]
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert _max_rel_err(a, w) <= JAX_RTOL, (name, _max_rel_err(a, w))


@pytest.mark.parametrize("hd,g", [(64, 100), (64, 3)])
def test_emulated_backward_matches_jax_attn_core_bf16_at_tile_edges(hd, g):
    """As above at a g that is no multiple of 64 (the Hopper bodies' last
    query tile is part padding) and at a g <= 16 (the mma.sync bodies)."""
    q, k, v, valid, dout = _inputs(hd, g, seed=4)
    got, _, _ = _backward(q, k, v, valid, dout)
    bias = jnp.asarray(np.where(valid.numpy(), 0.0, MASK).astype(np.float32)[:, None, None, :])

    def core(q_, k_, v_):
        return jbert._attn_core(q_, k_, v_, bias, None, jnp.bfloat16, 0.0, "bqnk")

    jq, jk, jv, jdo = (jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16) for t in (q, k, v, dout))
    _, vjp = jax.vjp(core, jq, jk, jv)
    want = [torch.tensor(np.asarray(t.astype(jnp.float32))) for t in vjp(jdo)]
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert _max_rel_err(a, w) <= JAX_RTOL, (name, _max_rel_err(a, w))


@pytest.mark.parametrize("hd,g", [(64, 255), (64, 1), (16, 100), (128, 37)])
def test_emulated_delta_matches_plain_reduction_and_jax_di(hd, g):
    """Kernel D's D = rowsum(dO * O) from bf16 O and dO, summed per row in
    f32 over four lanes: within 1e-6 x max|D| of the plain reduction
    (:func:`attention_delta_plain`, the ``(dO.float() * O.float()).sum(-1)``
    the backward computed before) and of JAX's ``di`` (``jnp.sum(
    o.astype(f32) * do.astype(f32), -1)``, flash_attention.py:273), at
    every row, the pair with no valid key included."""
    q, k, v, valid, dout = _inputs(hd, g, seed=5)
    out = attention_plain(q, k, v, valid)
    got = emulate_delta(dout, out)
    plain = attention_delta_plain(dout, out)
    jo, jdo = (jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16) for t in (out, dout))
    di = torch.tensor(np.asarray(jnp.sum(jo.astype(jnp.float32) * jdo.astype(jnp.float32), -1))).transpose(1, 2)
    assert got.shape == plain.shape == (q.shape[0], q.shape[2], g) and got.dtype == torch.float32
    scale = float(plain.abs().max())
    for want in (plain, di):
        assert float((got - want).abs().max()) <= DELTA_RTOL * scale


def test_skipping_is_exact():
    """A 64-key tile without a valid key, in a pair with one, has P =
    exp(-1e9 + ...) = 0 in f32 at every key: kernel C's zero block and
    kernel D's skipped tile (tile 0 run or not) change no bit."""
    q, k, v, valid, dout = _inputs(32, seed=2)
    lse = forward_lse(q, k, valid)
    delta = (dout.float() * attention_plain(q, k, v, valid).float()).sum(-1).transpose(1, 2)
    dk_all, dv_all, none = emulate_kernel_c(q, k, v, valid, dout, lse, delta, skip=False)
    assert none == 0
    dk, dv, zero_blocks = emulate_kernel_c(q, k, v, valid, dout, lse, delta)
    assert zero_blocks > 0
    assert torch.equal(dk, dk_all) and torch.equal(dv, dv_all)
    dq_all, none = emulate_kernel_d(q, k, v, valid, dout, lse, delta, skip=False)
    assert none == 0
    for first_tile_runs in (True, False):
        dq, skipped = emulate_kernel_d(q, k, v, valid, dout, lse, delta, first_tile_runs=first_tile_runs)
        assert skipped > 0
        assert torch.equal(dq, dq_all)


def test_pair_without_valid_key_needs_the_shifted_lse():
    """Every score of a pair with no valid key is -1e9 in f32, so P is
    uniform, 1/s. Its lse with the -1e9 kept rounds to -1e9, and P =
    exp(x - lse) would come out as 1: s times the plain gradient. Kernel
    A's lse without the -1e9 keeps log(s)."""
    q, k, v, valid, dout = _inputs(16, seed=3)
    none = ~valid.any(dim=1)
    assert int(none.sum()) == 1
    want = attention_bwd_plain(q, k, v, valid, dout)
    unshifted = forward_lse(q, k, valid, shifted=False)
    assert torch.equal(unshifted[none], torch.full_like(unshifted[none], MASK))
    shifted = forward_lse(q, k, valid)
    assert torch.allclose(shifted[none], torch.full_like(shifted[none], math.log(255)))
    good, _, _ = _backward(q, k, v, valid, dout)
    bad, _, _ = _backward(q, k, v, valid, dout, shifted=False)
    for a, b, w in zip(good, bad, want):
        scale = float(w[none].float().abs().max())
        assert float((a[none].float() - w[none].float()).abs().max()) <= PLAIN_RTOL * scale
        assert float((b[none].float() - w[none].float()).abs().max()) > 10 * scale
        # the other pairs do not depend on it
        assert torch.equal(a[~none], b[~none])
