"""Kernel A's bf16 arithmetic, emulated on the CPU in its own order.

``csrc/attention.cu`` cannot run here, so this test-local emulation does
what its bf16 body does, in torch: 64-key tiles, an online max, an f32
row sum of the f32 probabilities, P rounded to bf16 before P·V, and
64-key tiles with no valid key skipped when the pair has one (tile 0
always runs). It is held against the port's plain attention and the JAX
package's ``_attn_core`` in bf16, and with skipping against without.
Nothing in the package uses the emulation.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anncur_tpu.models import bert as jbert

from anncur_tpu_torch.ops.attention import attention_plain

torch.set_num_threads(2)  # xdist runs several test files side by side

KEY_TILE = 64
PLAIN_ATOL = 2e-2  # bf16 output and bf16 P: chip_smoke.py's ATTN_ATOL
JAX_ATOL = 3e-2  # JAX also rounds its normalised probabilities and its output to bf16


def emulate_kernel_a(q, k, v, key_valid, skip=True, first_tile_runs=True):
    """(out, lse, tiles skipped) as kernel A's bf16 body computes them: out
    (b, g, nh, hd) bf16, lse (b, nh, g) f32, without the -1e9 that every
    score of a pair with no valid key carries. ``skip`` leaves a pair's state
    untouched on a tile without a valid key, when the pair has a valid
    key; the kernel runs tile 0 all the same (``first_tile_runs``)."""
    b, g, nh, hd = q.shape
    s = k.shape[1]
    scale = 1.0 / math.sqrt(hd)
    qf = q.float().transpose(1, 2)  # (b, nh, g, hd)
    kf, vf = (t.float().transpose(1, 2) for t in (k, v))  # (b, nh, s, hd)
    bias = torch.where(key_valid, 0.0, -1e9).to(torch.float32)
    any_valid = key_valid.any(dim=1)
    m = torch.full((b, nh, g), -math.inf)
    l = torch.zeros(b, nh, g)
    acc = torch.zeros(b, nh, g, hd)
    skipped = 0
    for t0 in range(0, s, KEY_TILE):
        keys = slice(t0, min(t0 + KEY_TILE, s))
        always = not skip or (t0 == 0 and first_tile_runs)
        run = key_valid[:, keys].any(dim=1) | ~any_valid | always
        skipped += int((~run).sum())
        x = qf @ kf[:, :, keys].transpose(-1, -2) * scale + bias[:, None, None, keys]
        m_new = torch.maximum(m, x.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(x - m_new[..., None])
        l_new = l * alpha + p.sum(dim=-1)
        acc_new = acc * alpha[..., None] + p.to(torch.bfloat16).float() @ vf[:, :, keys]
        sel = run[:, None, None]
        m, l = torch.where(sel, m_new, m), torch.where(sel, l_new, l)
        acc = torch.where(sel[..., None], acc_new, acc)
    out = (acc * (1.0 / l)[..., None]).to(torch.bfloat16).transpose(1, 2)
    shift = torch.where(any_valid, 0.0, -1e9)[:, None, None]
    return out, (m - shift) + torch.log(l), skipped


def _inputs(hd, seed=0):
    """Pairs of s=255 keys: prefix lengths at tile boundaries, a pair with
    no valid key, one whose mask has holes inside tiles and a whole masked
    tile between valid ones, and one whose first tile is all masked."""
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
    valid[len(lengths) + 2, 100:150] = True  # tile 0 runs all masked, then is wiped
    b = valid.shape[0]
    q, k, v = (rng.standard_normal((b, s, nh, hd)).astype(np.float32) for _ in range(3))
    to_bf16 = lambda a: torch.as_tensor(a).to(torch.bfloat16)  # noqa: E731
    return to_bf16(q), to_bf16(k), to_bf16(v), torch.as_tensor(valid)


@pytest.mark.parametrize("hd", [16, 64])
def test_emulated_kernel_a_matches_plain_attention(hd):
    q, k, v, valid = _inputs(hd)
    got, lse, skipped = emulate_kernel_a(q, k, v, valid)
    want = attention_plain(q, k, v, valid)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    assert skipped > 0
    # every row, padded query rows and the no-valid-key pair included
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), atol=PLAIN_ATOL, rtol=0)
    scores = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float()) / math.sqrt(hd)
    scores = scores + torch.where(valid, 0.0, -1e9)[:, None, None, :]
    shift = torch.where(valid.any(dim=1), 0.0, -1e9)[:, None, None, None]
    want_lse = torch.logsumexp(scores - shift, dim=-1)
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hd", [16, 64])
def test_emulated_kernel_a_matches_jax_attn_core_bf16(hd):
    q, k, v, valid = _inputs(hd, seed=1)
    got, _, _ = emulate_kernel_a(q, k, v, valid)
    bias = np.where(valid.numpy(), 0.0, -1e9).astype(np.float32)[:, None, None, :]
    jq, jk, jv = (jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16) for t in (q, k, v))
    want = jbert._attn_core(jq, jk, jv, jnp.asarray(bias), None, jnp.bfloat16, 0.0, "bqnk")
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want.astype(jnp.float32)), atol=JAX_ATOL, rtol=0
    )


def test_skipping_masked_tiles_is_exact():
    """A skipped tile would add p = exp(-1e9 - m) = 0 and rescale by
    exp(0) = 1, and an all-masked tile 0 is wiped by the next tile's
    rescale exp(-1e9 - m) = 0: skipping changes no bit of a pair that has a
    valid key."""
    q, k, v, valid = _inputs(32, seed=2)
    out_all, lse_all, none = emulate_kernel_a(q, k, v, valid, skip=False)
    assert none == 0
    has_key = valid.any(dim=1)
    assert not bool(has_key.all())
    for first_tile_runs in (True, False):
        out, lse, skipped = emulate_kernel_a(q, k, v, valid, first_tile_runs=first_tile_runs)
        assert skipped > 0
        assert torch.equal(out[has_key], out_all[has_key])
        assert torch.equal(lse[has_key], lse_all[has_key])
        # the pair with no valid key runs every tile either way
        assert torch.equal(out[~has_key], out_all[~has_key])
