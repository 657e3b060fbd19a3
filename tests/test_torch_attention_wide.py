"""Head dims above 256: the wrapper arithmetic of ``ops/attention.py``
around kernels A, C and D on the CPU.

Above 256 the kernels' wide route takes any multiple of 16 and
:func:`attention` zero-pads other widths (300 -> 304) with the softmax
scale kept at 1/sqrt(real hd), slicing the output and the gradients back.
On CPU tensors the wrappers take the plain versions, so the padded path is
driven here through :class:`AttentionFunction` with the three kernel
entries replaced by plain emulations that honour the ``scale`` they are
given (and record the shapes they see); the card tests
(``tests/test_torch_cuda.py``) run the kernels themselves. The plain
attention and its autograd are also held against ``jax.vjp`` of JAX's
``_attn_core`` at hd 384. f32 throughout; tolerances 1e-5 (x the leaf's
max for gradients): the frameworks sum in other orders."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anncur_tpu.models import bert as jbert
from anncur_tpu_torch.ops import attention as attn_mod
from anncur_tpu_torch.ops.attention import AttentionFunction, _pad_head_dim, attention, attention_plain

torch.set_num_threads(2)  # xdist runs several test files side by side


def _case(hd, b=2, g=9, s=13, nh=2, seed=0):
    rng = np.random.default_rng(seed + hd)
    q = rng.standard_normal((b, g, nh, hd)).astype(np.float32)
    k, v = (rng.standard_normal((b, s, nh, hd)).astype(np.float32) for _ in range(2))
    valid = np.arange(s)[None, :] < np.array([s, 5])[:, None]
    dout = rng.standard_normal((b, g, nh, hd)).astype(np.float32)
    return q, k, v, valid, dout


@pytest.mark.parametrize("hd,padded", [(300, 304), (264, 272), (384, 384), (8, 16), (257, 272), (768, 768)])
def test_pad_head_dim_to_the_next_multiple_of_16(hd, padded):
    q = torch.randn(1, 2, 1, hd)
    out = _pad_head_dim(q, q, q)
    assert all(t.shape[-1] == padded for t in out)
    assert all(torch.equal(t[..., :hd], q) and not t[..., hd:].any() for t in out)
    if padded == hd:
        assert out[0] is q  # nothing copied at a multiple of 16


@pytest.mark.parametrize("hd,hv,padded", [(24, 16, 192), (192, 128, 192), (64, 64, 192), (200, 200, 208)])
def test_pad_head_dim_of_causal_heads_and_narrower_v(hd, hv, padded):
    """The same rule for ``attention(causal=True)``: q and k no wider than
    192 go to the causal body's 192, wider ones to the next multiple of 16;
    v, narrower or not, to q's padded width."""
    q, v = torch.randn(1, 2, 1, hd), torch.randn(1, 2, 1, hv)
    out = _pad_head_dim(q, q, v, causal=True)
    assert all(t.shape[-1] == padded for t in out)
    assert torch.equal(out[0][..., :hd], q) and not out[0][..., hd:].any()
    assert torch.equal(out[2][..., :hv], v) and not out[2][..., hv:].any()


def _scaled_plain(q, k, v, key_valid, scale):
    """The plain attention with an explicit scale, and its row lse."""
    scores = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float()) * scale
    scores = scores + torch.where(key_valid, 0.0, -1e9)[:, None, None, :]
    return torch.einsum("bnqk,bknd->bqnd", torch.softmax(scores, -1), v.float()).to(q.dtype), torch.logsumexp(scores, -1)


@pytest.mark.parametrize("hd", [300, 264, 384])
def test_attention_function_pads_keeps_the_real_scale_and_slices(monkeypatch, hd):
    """:class:`AttentionFunction` at a head dim above 256: the kernels see
    q, k, v and dO padded to the next multiple of 16 (zero columns) and
    the scale 1/sqrt(hd) of the real width; the output and dQ, dK, dV come
    back at hd and equal the plain attention's at hd."""
    seen = []

    def fwd(q, k, v, key_valid, with_lse=False, scale=None):
        seen.append(("A", q.shape[-1], scale))
        return _scaled_plain(q, k, v, key_valid, scale)

    def grads(q, k, v, key_valid, dout, scale):
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
            return torch.autograd.grad(_scaled_plain(*leaves, key_valid, scale)[0], leaves, dout)

    def dkv(q, k, v, key_valid, dout, lse, delta, scale=None):
        seen.append(("C", q.shape[-1], scale, dout.shape[-1], bool(dout[..., hd:].any())))
        return grads(q, k, v, key_valid, dout, scale)[1:]

    def dq(q, k, v, key_valid, dout, out, lse, scale=None):
        seen.append(("D", q.shape[-1], scale, dout.shape[-1], bool(dout[..., hd:].any()), out.shape[-1]))
        delta = (dout * out).sum(-1).transpose(1, 2)
        return grads(q, k, v, key_valid, dout, scale)[0], delta

    monkeypatch.setattr(attn_mod, "attention_fwd", fwd)
    monkeypatch.setattr(attn_mod, "attention_bwd_dkv", dkv)
    monkeypatch.setattr(attn_mod, "attention_bwd_dq", dq)
    q, k, v, valid, dout = (torch.as_tensor(t) for t in _case(hd))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = AttentionFunction.apply(*leaves, valid)
    got = torch.autograd.grad(out, leaves, dout)

    padded = hd + (-hd % 16)
    scale = 1.0 / math.sqrt(hd)
    # kernel D first (it writes the D = rowsum(dO * O) that C reads)
    assert seen == [("A", padded, scale), ("D", padded, scale, padded, False, padded), ("C", padded, scale, padded, False)]
    want_leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    want_out = attention_plain(*want_leaves, valid)
    want = torch.autograd.grad(want_out, want_leaves, dout)
    assert out.shape == q.shape
    torch.testing.assert_close(out, want_out, atol=1e-5, rtol=0)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == w.shape, name
        torch.testing.assert_close(a, w, atol=1e-5 * float(w.abs().max()), rtol=0, msg=name)


def test_attention_plain_and_autograd_match_jax_attn_core_at_hd_384():
    """The plain version (what every CPU call takes, and what the card
    kernels are held to) at hd 384 against JAX's ``_attn_core``: the
    forward within 1e-5 and the vjp within 1e-5 x each leaf's max, masked
    keys getting zero dK, dV."""
    q, k, v, valid, dout = _case(384, seed=1)
    bias = np.where(valid, 0.0, -1e9).astype(np.float32)[:, None, None, :]

    def core(q_, k_, v_):
        return jbert._attn_core(q_, k_, v_, jnp.asarray(bias), None, jnp.float32, 0.0, "bqnk")

    want_out, vjp = jax.vjp(core, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(t) for t in vjp(jnp.asarray(dout))]
    leaves = [torch.tensor(t, requires_grad=True) for t in (q, k, v)]
    out = attention(*leaves, torch.as_tensor(valid))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), atol=1e-5, rtol=0)
    got = [t.numpy() for t in torch.autograd.grad(out, leaves, torch.as_tensor(dout))]
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, w, atol=1e-5 * np.abs(w).max(), rtol=0, err_msg=name)
    assert not got[1][~valid].any() and not got[2][~valid].any()
