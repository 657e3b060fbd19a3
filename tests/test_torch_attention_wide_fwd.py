"""Kernel A's wide route (head dims above 256), emulated on the CPU in its
own order.

``csrc/attention.cu`` cannot run here, so this test-local emulation does
what its wide bodies do, in torch. Where a block's stored tiles fit in
shared memory (:func:`takes_hopper_body`, the rule of ``launch_wide``), the
Hopper body computes S once per (query tile, key tile): per 64-row query
tile it walks the key tiles that hold a valid key (every tile in a pair
with none), each over the head dim in chunks (64 bf16 or 32 f32 columns);
S * scale + bias in f32, the running max m and sum l moved on, P = exp(S -
m) with m the max after the tile, stored (rounded to bf16 in bf16) beside
each row's rescale factor exp(m before - m after). Then O = sum over the
running tiles of P V, O rescaled before each tile's product, and O / l;
the lse is (m - shift) + log l. Output columns are independent, so the
emulation takes all of them at once where the kernel walks them in slices
(128 bf16, 64 f32). bf16: products of bf16 values summed in f32. f32: every
product in three TF32 passes (``three_pass`` of the backward's emulation:
the A operand's big part rounded to nearest, the B operand's the f32 with
its low 13 bits dropped), each stage (a chunk of the head dim, a tile of 64
keys) summed apart and added in f32. Past the limit the slice bodies run:
every key tile, the same online softmax, plain f32 products.

The emulation is held against the port's plain attention and JAX's
``_attn_core`` at hd 272 and 384, at g and s of 1, 17, 100 and 255 with a
pair that has no valid key, the lse against a logsumexp; skipped key tiles
against running them bit for bit; the three-pass P V product against an
f64 product at depths 255 and 768. Nothing in the package uses it; the card
tests (``tests/test_torch_cuda.py``) hold the kernel itself.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_attention_wide_bwd import (
    MASK,
    SMEM_MAX,
    TILE,
    TILE_BYTES,
    _bf,
    _inputs,
    _key_bias,
    _rows,
    _scores,
    _shift,
    forward_lse,
    three_pass,
)

from anncur_tpu.models import bert as jbert

from anncur_tpu_torch.ops.attention import attention_plain

torch.set_num_threads(2)  # xdist runs several test files side by side

BF16_ATOL = 2e-2  # chip_smoke.py's ATTN_ATOL: P and the output rounded to bf16
F32_ATOL = 1e-5  # three TF32 passes and f32 sums in other orders, on outputs of size ~1
LSE_RTOL = 1e-5
ACCURACY_RATIO = 4.0  # the three-pass error against the plain f32 matmul's

# kernel A's wide Hopper body's shared memory (csrc/attention.cu, namespace
# wide; csrc/wide_sm90.cuh): a ring of two slots (three where they fit),
# one stored P tile and 64 f32 rescale factors per key tile, three barriers
# for each of up to three slots, 12 bytes of mask word and index per key
# tile, 1024 bytes to align, within the 232,448 a block may take
LAYOUT_A = {"bf16": (2, 1), "f32": (6, 2)}  # (slot, stored P tile) in tiles of 8 KB


def takes_hopper_body(kind, s):
    """Whether ``launch_wide`` runs kernel A's Hopper body at s keys (strides TMA takes)."""
    slot, store = LAYOUT_A[kind]
    n_kt = -(-s // TILE)
    per_tile = store * TILE_BYTES + 4 * TILE + 12  # P, its rows' rescale factors, mask word and index
    return 2 * slot * TILE_BYTES + n_kt * per_tile + 72 + 1024 <= SMEM_MAX


def emulate_wide_a(q, k, v, key_valid, kind, hopper=None, skip=True):
    """(O in q's dtype, lse (b, nh, g) f32, key tiles skipped) of kernel A's
    wide route; ``hopper`` None takes the route ``launch_wide`` takes;
    ``skip`` False runs the Hopper body over every key tile."""
    b, g, nh, hd = q.shape
    s = k.shape[1]
    if hopper is None:
        hopper = takes_hopper_body(kind, s)
    scale = 1.0 / math.sqrt(hd)
    qf, kf, vf = _rows(q, g), _rows(k, s), _rows(v, s)
    gp = qf.shape[2]
    bias, valid = _key_bias(key_valid)
    pair_any = key_valid.any(dim=1)
    tiles = range(0, kf.shape[2], TILE)
    # the running key tiles of each pair (the slice bodies run every tile)
    runs = [valid[:, k0:k0 + TILE].any(dim=1) | ~pair_any | (not (skip and hopper)) for k0 in tiles]
    skipped = sum(int((~r).sum()) for r in runs)
    m = torch.full((b, nh, gp), -math.inf)
    l = torch.zeros(b, nh, gp)
    o = torch.zeros(b, nh, gp, hd)
    for k0, run in zip(tiles, runs):
        keys = slice(k0, k0 + TILE)
        # phase 1: S over the head dim in chunks, then the online softmax
        x = _scores(qf, kf[:, :, keys], hd, kind, hopper) * scale + bias[:, None, None, keys]
        m_new = torch.maximum(m, x.amax(dim=-1))
        alpha = torch.exp(m - m_new)  # 0 on a pair's first running tile
        p = torch.exp(x - m_new[..., None])
        # phase 2: O rescaled, then this tile's P V (a stage of its own)
        p_st = _bf(p) if kind == "bf16" else p
        part = three_pass(p_st, vf[:, :, keys], TILE) if kind == "f32" and hopper else p_st @ vf[:, :, keys]
        sel = run[:, None, None]
        o = torch.where(sel[..., None], o * alpha[..., None] + part, o)
        l = torch.where(sel, l * alpha + p.sum(dim=-1), l)
        m = torch.where(sel, m_new, m)
    out = (o[:, :, :g] / l[:, :, :g, None]).transpose(1, 2).to(q.dtype)
    lse = (m[:, :, :g] - _shift(key_valid)[..., 0]) + torch.log(l[:, :, :g])
    return out, lse, skipped


def _jax_forward(q, k, v, valid, kind):
    """JAX's ``_attn_core`` at q's dtype, and the lse of its f32 scores
    (without the -1e9 in a pair with no valid key)."""
    bias = np.where(valid.numpy(), 0.0, MASK).astype(np.float32)[:, None, None, :]
    jdt = jnp.bfloat16 if kind == "bf16" else jnp.float32
    jq, jk, jv = (jnp.asarray(t.float().numpy(), dtype=jdt) for t in (q, k, v))
    out = jbert._attn_core(jq, jk, jv, jnp.asarray(bias), None, jdt, 0.0, "bqnk")
    scores = jnp.einsum("bqnd,bknd->bnqk", jq, jk, preferred_element_type=jnp.float32) / math.sqrt(q.shape[-1])
    shift = np.where(valid.numpy().any(axis=1), 0.0, MASK).astype(np.float32)[:, None, None, None]
    lse = jax.nn.logsumexp(scores + jnp.asarray(bias) - shift, axis=-1)
    return (torch.tensor(np.asarray(t.astype(jnp.float32))) for t in (out, lse))


def _assert_close(out, lse, want_out, want_lse, kind):
    tol = BF16_ATOL if kind == "bf16" else F32_ATOL
    err = float((out.float() - want_out.float()).abs().max())
    assert err <= tol, err
    rel = float(((lse - want_lse).abs() / want_lse.abs().clamp(min=1.0)).max())
    assert rel <= LSE_RTOL, rel


def test_the_limit_of_the_hopper_body():
    """``launch_wide``'s rule, as documented there: kernel A's Hopper body
    takes bf16 s <= 1472 and f32 s <= 448."""
    for kind, s_max in (("bf16", 1472), ("f32", 448)):
        assert takes_hopper_body(kind, s_max) and not takes_hopper_body(kind, s_max + 1)


@pytest.mark.parametrize("kind", ["bf16", "f32"])
@pytest.mark.parametrize("hd,g,s", [(272, 255, 255), (384, 255, 255), (272, 1, 255), (384, 17, 255),
                                    (272, 100, 100), (384, 1, 100), (272, 17, 17), (384, 1, 1)])
def test_emulated_wide_forward_matches_plain(kind, hd, g, s):
    """At every row, the pair with no valid key included: O within bf16
    2e-2 / f32 1e-5 of the plain attention, the lse within 1e-5 relative of
    a logsumexp taken without the no-valid-key shift."""
    q, k, v, valid, _ = _inputs(hd, g, s, kind)
    assert not valid.all(dim=1).all() and (~valid.any(dim=1)).any()
    out, lse, skipped = emulate_wide_a(q, k, v, valid, kind)
    if s == 255:
        assert skipped > 0
    assert out.dtype == q.dtype and out.shape == q.shape
    _assert_close(out, lse, attention_plain(q, k, v, valid), forward_lse(q, k, valid), kind)


@pytest.mark.parametrize("kind", ["bf16", "f32"])
@pytest.mark.parametrize("hd,g,s", [(272, 255, 255), (384, 100, 255), (272, 17, 100), (384, 255, 17)])
def test_emulated_wide_forward_matches_jax_attn_core(kind, hd, g, s):
    """Against JAX's ``_attn_core`` in the same dtype (bf16: JAX rounds the
    normalised probabilities and its output to bf16, the kernel P before
    the division), and the lse against JAX's logsumexp of its f32 scores."""
    q, k, v, valid, _ = _inputs(hd, g, s, kind, seed=1)
    out, lse, _ = emulate_wide_a(q, k, v, valid, kind)
    want_out, want_lse = _jax_forward(q, k, v, valid, kind)
    _assert_close(out, lse, want_out, want_lse, kind)


@pytest.mark.parametrize("kind,s", [("bf16", 1473), ("f32", 449)])
def test_past_the_shared_memory_limit_the_slice_bodies_agree(kind, s):
    """One key past the limit the slice bodies run, over every key tile;
    they agree with the plain attention and with the Hopper body's order
    on the same inputs."""
    q, k, v, valid, _ = _inputs(272, 17, s, kind, seed=2, nh=1)
    assert not takes_hopper_body(kind, s)
    out, lse, skipped = emulate_wide_a(q, k, v, valid, kind)
    assert skipped == 0
    _assert_close(out, lse, attention_plain(q, k, v, valid), forward_lse(q, k, valid), kind)
    other, other_lse, _ = emulate_wide_a(q, k, v, valid, kind, hopper=True)
    _assert_close(other, other_lse, out, lse, kind)


@pytest.mark.parametrize("kind", ["bf16", "f32"])
def test_skipped_key_tiles_change_no_bit(kind):
    """A 64-key tile without a valid key, in a pair with one, adds exp(-1e9
    - m) = 0 in f32 at every key and rescales by exp(0) = 1 (before the
    pair's first valid tile, its sums are wiped by the next tile's factor
    exp(-1e9 - m) = 0): skipping it gives the bits of running it."""
    q, k, v, valid, _ = _inputs(272, 255, 255, kind, seed=3)
    out, lse, skipped = emulate_wide_a(q, k, v, valid, kind)
    out_all, lse_all, none = emulate_wide_a(q, k, v, valid, kind, skip=False)
    assert skipped > 0 and none == 0
    assert torch.equal(out, out_all) and torch.equal(lse, lse_all)


@pytest.mark.parametrize("depth", [255, 768])
def test_three_pass_pv_product_is_f32_accurate(depth):
    """O = P V as the f32 body computes it, on probabilities of seeded
    normal scores (each row's max taken off) and normal V, over depth keys
    in stages of 64: within 4x the plain f32 matmul's error against the f64
    product; one TF32 pass is far outside it."""
    rng = np.random.default_rng(depth)
    for _ in range(3):
        x = rng.standard_normal((64, depth)) * 3.0
        p = torch.as_tensor(np.exp(x - x.max(axis=1, keepdims=True)).astype(np.float32))
        v = torch.as_tensor(rng.standard_normal((depth, 64)).astype(np.float32))
        exact = p.double() @ v.double()
        plain = float(((p @ v).double() - exact).abs().max() / exact.abs().max())
        three = float((three_pass(p, v, TILE).double() - exact).abs().max() / exact.abs().max())
        one = float((three_pass(p, v, TILE, passes=1).double() - exact).abs().max() / exact.abs().max())
        assert three <= ACCURACY_RATIO * plain, (three, plain)
        assert one > 10 * ACCURACY_RATIO * plain, (one, plain)

