"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: every test skips without a CUDA card (the CPU tests hold
the plain versions against the JAX package). Run on a GPU host with

    python -m pytest tests/test_torch_cuda.py -q
"""

import pytest
import torch

from anncur_tpu_torch.ops.attention import (
    attention,
    attention_bwd_dkv,
    attention_bwd_dq,
    attention_bwd_plain,
    attention_delta_plain,
    attention_fwd,
    attention_plain,
)
from anncur_tpu_torch.ops import encoder_epilogue as ee
from anncur_tpu_torch.ops.mips import mips_topk
from anncur_tpu_torch.ops.mips_kernel import mips_topk_fused, mips_topk_int8_fused
from anncur_tpu_torch.ops.quantized import QuantizedItems, mips_topk_int8_plain, quantize_items

pytestmark = pytest.mark.cuda


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _attn_case(dev, b, g, s, nh, hd, dtype, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    # q/k/v as slices of one wider projection: strided, like a fused QKV
    qkv = torch.randn(b, s, 3, nh, hd, generator=gen, device=dev).to(dtype)
    q, k, v = qkv[:, :g, 0], qkv[:, :, 1], qkv[:, :, 2]
    lengths = torch.randint(1, s + 1, (b,), generator=gen, device=dev)
    valid = torch.arange(s, device=dev)[None, :] < lengths[:, None]
    return q, k, v, valid, lengths


@pytest.mark.parametrize(
    "b,g,s,nh,hd,dtype,atol",
    [
        (4, 256, 256, 12, 64, torch.bfloat16, 2e-2),  # bf16 output rounding
        (4, 3, 256, 12, 64, torch.bfloat16, 2e-2),
        (3, 37, 37, 4, 16, torch.float32, 1e-5),  # f32: summation order only
        (2, 1, 100, 2, 32, torch.float32, 1e-5),
        (2, 130, 130, 2, 128, torch.float32, 1e-5),
    ],
)
def test_attention_kernel_matches_plain(dev, b, g, s, nh, hd, dtype, atol):
    q, k, v, valid, lengths = _attn_case(dev, b, g, s, nh, hd, dtype, seed=b * s + hd)
    before = attention.launches
    got = attention(q, k, v, valid).float()
    want = attention_plain(q, k, v, valid).float()
    torch.cuda.synchronize()
    assert attention.launches == before + 1
    rows = (torch.arange(g, device=dev)[None, :] < lengths[:, None]) if g == s else torch.ones(b, g, dtype=torch.bool, device=dev)
    err = (got - want).abs().amax(dim=(2, 3))[rows].max().item()
    assert err <= atol, err


def _edge_case(dev, g, hd, seed, s=255, nh=3, dtype=torch.bfloat16):
    """Pairs (bf16 unless ``dtype``) of a ragged s=255 keys: prefix lengths
    at the 64-key tile boundaries, a pair with no valid key, a mask with
    holes inside tiles and a whole masked tile between valid keys, and a
    pair whose first tile is all masked."""
    q, k, v, _, _ = _attn_case(dev, 8, g, s, nh, hd, dtype, seed)
    valid = torch.zeros(8, s, dtype=torch.bool, device=dev)
    for r, n in enumerate((1, 63, 64, 65, s)):
        valid[r, :n] = True
    # row 5: no valid key
    valid[6, 0:5] = valid[6, 20:30] = valid[6, 130:140] = True
    valid[6, 200::3] = True
    valid[7, 100:150] = True
    return q, k, v, valid


@pytest.mark.parametrize(
    "g,hd", [(1, 64), (3, 64), (16, 64), (17, 64), (255, 64), (255, 16), (255, 32), (255, 128)]
)
def test_attention_bf16_tensor_core_path_at_tile_edges(dev, g, hd):
    """Kernel A's bf16 body (one-warp tiles for g <= 16, four-warp tiles
    above) against the plain attention at 2e-2 (bf16 output, bf16 P), at
    every row: padded query rows and the no-valid-key pair included."""
    q, k, v, valid = _edge_case(dev, g, hd, seed=g * 1000 + hd)
    got = attention(q, k, v, valid).float()
    want = attention_plain(q, k, v, valid).float()
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    assert err <= 2e-2, err


def test_attention_bf16_lse_at_ragged_s(dev):
    """The row log-sum-exp of the bf16 body at s=255 within 1e-5 relative
    (f32 sums in another order), without the -1e9 that every score of the
    pair with no valid key carries; out is the same bits without it."""
    q, k, v, valid = _edge_case(dev, 255, 64, seed=7)
    out, lse = attention_fwd(q, k, v, valid, with_lse=True)
    scores = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float()) / 8.0
    scores = scores + torch.where(valid, 0.0, -1e9)[:, None, None, :]
    shift = torch.where(valid.any(dim=1), 0.0, -1e9)[:, None, None, None]
    want = torch.logsumexp(scores - shift, dim=-1)
    torch.cuda.synchronize()
    assert torch.allclose(lse, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(out, attention_fwd(q, k, v, valid)[0])


def test_attention_backward_kernels_through_bf16_forward_at_ragged_s(dev):
    """Kernels C and D read the bf16 body's lse: the autograd through
    kernels A, C and D against the plain autograd at b=4, g=s=255."""
    s = 255
    q, k, v, valid, lengths = _attn_case(dev, 4, s, s, 12, 64, torch.bfloat16, seed=255)
    rows = _real_rows(s, s, lengths)
    gen = torch.Generator(device=dev).manual_seed(5)
    dout = torch.randn(q.shape, generator=gen, device=dev).to(torch.bfloat16) * rows[:, :, None, None]
    want = attention_bwd_plain(q, k, v, valid, dout)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    got = torch.autograd.grad(attention(*leaves, valid), leaves, dout)
    torch.cuda.synchronize()
    for name, a, b, sel in (("dq", got[0], want[0], rows), ("dk", got[1], want[1], valid), ("dv", got[2], want[2], valid)):
        err = (a.float() - b.float()).abs().amax(dim=(2, 3))[sel].max().item()
        scale = b.float().abs().max().item()
        assert err <= 2e-2 * scale, (name, err, scale)
    assert not got[1][~valid].any() and not got[2][~valid].any()


def _run_bwd(q, k, v, valid, dout, out, lse):
    """Kernel D then kernel C, as the autograd runs them: (dK, dV, dQ, delta)."""
    dq, delta = attention_bwd_dq(q, k, v, valid, dout, out, lse)
    return (*attention_bwd_dkv(q, k, v, valid, dout, lse, delta), dq, delta)


@pytest.mark.parametrize(
    "b,g,hd",
    [(8, 1, 64), (8, 3, 64), (8, 16, 64), (8, 17, 64), (8, 255, 64), (8, 255, 16), (8, 255, 32),
     (8, 255, 128), (1, 255, 64), (1, 1, 64), (8, 64, 64), (8, 65, 64), (8, 100, 64), (63, 255, 64),
     (8, 128, 64)],
)
def test_attention_backward_bf16_tensor_core_path_at_tile_edges(dev, b, g, hd):
    """Kernels C and D's bf16 bodies (the Hopper bodies at hd = 64, g > 16;
    mma.sync with 16-row query tiles for g <= 16, 64-row above) against the
    plain autograd at 2e-2 x the plain gradient's max, at every row and
    key: b = 8 with the ``_edge_case`` masks (the pair with no valid key
    included), b = 1 and 63 with every key valid, as the train step's
    pairs. Masked keys of pairs with a valid key get exactly zero dK and
    dV; kernel D's delta is the plain rowsum(dO * O) within 1e-6 x its max;
    two launches give the same bits (no atomics)."""
    if b != 8:
        q, k, v, valid, _ = _attn_case(dev, b, g, 255, 12, hd, torch.bfloat16, seed=g + hd)
        valid = torch.ones_like(valid)
    else:
        q, k, v, valid = _edge_case(dev, g, hd, seed=g * 100 + hd)
    gen = torch.Generator(device=dev).manual_seed(g * 10 + hd)
    dout = torch.randn(q.shape, generator=gen, device=dev).to(torch.bfloat16)
    want = attention_bwd_plain(q, k, v, valid, dout)
    out, lse = attention_fwd(q, k, v, valid, with_lse=True)
    runs = [_run_bwd(q, k, v, valid, dout, out, lse) for _ in range(2)]
    torch.cuda.synchronize()
    dk, dv, dq, delta = runs[0]
    want_delta = attention_delta_plain(dout, out)
    assert (delta - want_delta).abs().max().item() <= 1e-6 * want_delta.abs().max().item()
    for name, a, w in (("dq", dq, want[0]), ("dk", dk, want[1]), ("dv", dv, want[2])):
        assert a.dtype == torch.bfloat16 and a.shape == w.shape, name
        err = (a.float() - w.float()).abs().max().item()
        scale = w.float().abs().max().item()
        assert err <= 2e-2 * scale, (name, err, scale)
    masked = ~valid & valid.any(dim=1, keepdim=True)
    assert not dk[masked].any() and not dv[masked].any()
    assert all(torch.equal(x, y) for x, y in zip(*runs))


def _check_fwd_bwd(q, k, v, valid, lengths, dtype, tol, grad_tol=None):
    """Kernel A, then C and D through the autograd, against the plain
    attention and its autograd at the real rows and valid keys: forward
    within ``tol`` abs, gradients within ``grad_tol`` (``tol`` where not
    given) x the plain gradient's max."""
    grad_tol = tol if grad_tol is None else grad_tol
    g, s = q.shape[1], k.shape[1]
    rows = _real_rows(g, s, lengths)
    gen = torch.Generator(device=q.device).manual_seed(g + s)
    dout = torch.randn(q.shape, generator=gen, device=q.device).to(dtype) * rows[:, :, None, None]
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    out = attention(*leaves, valid)
    got = torch.autograd.grad(out, leaves, dout)
    want_out = attention_plain(q, k, v, valid)
    want = attention_bwd_plain(q, k, v, valid, dout)
    torch.cuda.synchronize()
    err = (out.float() - want_out.float()).abs().amax(dim=(2, 3))[rows].max().item()
    assert err <= tol, ("out", err)
    for name, a, b, sel in (("dq", got[0], want[0], rows), ("dk", got[1], want[1], valid), ("dv", got[2], want[2], valid)):
        assert a.dtype == dtype and a.shape == b.shape, name
        err = (a.float() - b.float()).abs().amax(dim=(2, 3))[sel].max().item()
        scale = b.float().abs().max().item()
        assert err <= grad_tol * scale, (name, err, scale)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hd", list(range(16, 257, 16)))
def test_attention_kernels_take_every_head_dim(dev, hd, dtype):
    """Kernels A, C and D at every head dim that is a multiple of 16 up to
    256, in bf16 and f32, against the plain versions at chip_smoke.py's
    tolerance (2e-2: bf16 outputs, bf16 P and dS), with a ragged s of 130
    keys (three 64-key tiles), a full layer and a 1-row slice."""
    for g in (130, 1):
        q, k, v, valid, lengths = _attn_case(dev, 3, g, 130, 2, hd, dtype, seed=hd + g)
        _check_fwd_bwd(q, k, v, valid, lengths, dtype, 2e-2)


@pytest.mark.parametrize(
    "b,s,nh,hd,dtype",
    [
        (4, 512, 12, 64, torch.float32),  # past the old f32 limit of s <= 450 at hd=64
        (2, 512, 4, 128, torch.float32),
        (4, 256, 8, 48, torch.bfloat16),
        (4, 256, 8, 96, torch.bfloat16),
        (4, 256, 4, 256, torch.bfloat16),
    ],
)
def test_attention_kernels_at_long_s_and_wide_heads(dev, b, s, nh, hd, dtype):
    """The shapes JAX's default attention takes and the port's kernels
    refused before: f32 at s = 512 (bert-base's max_position_embeddings;
    the f32 body now streams K and V in tiles) and bf16 at hd 48, 96 and
    256. Tolerance 2e-2 abs forward and 2e-2 x max for the gradients, as
    chip_smoke.py states; no launch falls back to the plain version."""
    q, k, v, valid, lengths = _attn_case(dev, b, s, s, nh, hd, dtype, seed=s + hd)
    before = (attention.launches, attention_bwd_dkv.launches, attention_bwd_dq.launches)
    _check_fwd_bwd(q, k, v, valid, lengths, dtype, 2e-2)
    assert (attention.launches, attention_bwd_dkv.launches, attention_bwd_dq.launches) == tuple(n + 1 for n in before)


# the wide backward's gradients vs the plain autograd, x the plain
# gradient's max (chip_smoke.py's GRAD_RTOL and GRAD_F32_RTOL): bf16 outputs
# and bf16 P and dS; f32 in three TF32 passes (or FFMA), sums in another order
WIDE_GRAD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hd", [272, 384, 512, 768])
def test_attention_kernels_take_wide_head_dims(dev, hd, dtype):
    """The wide route of kernels A, C and D (head dims above 256) against
    the plain versions, with a ragged s of 130 keys, a full layer and a
    1-row slice: the forward within 2e-2, the gradients within
    ``WIDE_GRAD_TOL`` x the plain gradient's max; one launch of each
    kernel, none of the plain version."""
    for g in (130, 1):
        q, k, v, valid, lengths = _attn_case(dev, 3, g, 130, 2, hd, dtype, seed=hd + g)
        before = (attention.launches, attention_bwd_dkv.launches, attention_bwd_dq.launches)
        _check_fwd_bwd(q, k, v, valid, lengths, dtype, 2e-2, WIDE_GRAD_TOL[dtype])
        assert (attention.launches, attention_bwd_dkv.launches, attention_bwd_dq.launches) == tuple(n + 1 for n in before)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("g,hd", [(255, 384), (1, 512), (17, 272), (1, 272), (255, 768)])
def test_attention_wide_route_at_edge_masks(dev, g, hd, dtype):
    """The wide route on ``_edge_case``'s masks, at every row and key (the
    pair with no valid key included): the forward within 2e-2, the lse
    without the no-valid-key shift within 1e-5 relative, dQ, dK, dV within
    ``WIDE_GRAD_TOL`` x the plain gradient's max, masked keys of pairs with
    a valid key exactly zero, and two launches the same bits."""
    q, k, v, valid = _edge_case(dev, g, hd, seed=g + hd, dtype=dtype)
    out, lse = attention_fwd(q, k, v, valid, with_lse=True)
    assert (out.float() - attention_plain(q, k, v, valid).float()).abs().max().item() <= 2e-2
    scores = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float()) / hd ** 0.5
    scores = scores + torch.where(valid, 0.0, -1e9)[:, None, None, :]
    shift = torch.where(valid.any(dim=1), 0.0, -1e9)[:, None, None, None]
    assert torch.allclose(lse, torch.logsumexp(scores - shift, dim=-1), rtol=1e-5, atol=1e-5)
    gen = torch.Generator(device=dev).manual_seed(g * 10 + hd)
    dout = torch.randn(q.shape, generator=gen, device=dev).to(dtype)
    want = attention_bwd_plain(q, k, v, valid, dout)
    runs = [_run_bwd(q, k, v, valid, dout, out, lse) for _ in range(2)]
    torch.cuda.synchronize()
    dk, dv, dq, delta = runs[0]
    want_delta = attention_delta_plain(dout, out)
    assert (delta - want_delta).abs().max().item() <= 1e-6 * want_delta.abs().max().item()
    for name, a, w in (("dq", dq, want[0]), ("dk", dk, want[1]), ("dv", dv, want[2])):
        assert a.dtype == dtype and a.shape == w.shape, name
        err = (a.float() - w.float()).abs().max().item()
        assert err <= WIDE_GRAD_TOL[dtype] * w.float().abs().max().item(), (name, err)
    masked = ~valid & valid.any(dim=1, keepdim=True)
    assert not dk[masked].any() and not dv[masked].any()
    assert all(torch.equal(x, y) for x, y in zip(*runs))


@pytest.mark.parametrize(
    "dtype,g,s",
    [(torch.bfloat16, 641, 641), (torch.bfloat16, 640, 1281), (torch.float32, 257, 257), (torch.float32, 100, 513)],
)
def test_attention_wide_backward_past_the_staging_limit(dev, dtype, g, s):
    """Kernels C and D at hd 272 one tile past the g (C) or s (D) whose
    stored P^T and dS^T (C) or dS (D) fit in a block's shared memory (bf16
    640 and 1280, f32 256 and 512): that kernel takes the slice body, the
    other its Hopper body. On ``_edge_case``'s masks, the pair with no valid
    key and masked key tiles included: dQ, dK, dV within ``WIDE_GRAD_TOL``
    x the plain gradient's max, masked keys exactly zero, D within 1e-6 x
    its max, two launches the same bits."""
    q, k, v, valid = _edge_case(dev, g, 272, seed=g + s, s=s, dtype=dtype)
    out, lse = attention_fwd(q, k, v, valid, with_lse=True)
    gen = torch.Generator(device=dev).manual_seed(g * 10 + s)
    dout = torch.randn(q.shape, generator=gen, device=dev).to(dtype)
    want = attention_bwd_plain(q, k, v, valid, dout)
    runs = [_run_bwd(q, k, v, valid, dout, out, lse) for _ in range(2)]
    torch.cuda.synchronize()
    dk, dv, dq, delta = runs[0]
    want_delta = attention_delta_plain(dout, out)
    assert (delta - want_delta).abs().max().item() <= 1e-6 * want_delta.abs().max().item()
    for name, a, w in (("dq", dq, want[0]), ("dk", dk, want[1]), ("dv", dv, want[2])):
        err = (a.float() - w.float()).abs().max().item()
        assert err <= WIDE_GRAD_TOL[dtype] * w.float().abs().max().item(), (name, err)
    masked = ~valid & valid.any(dim=1, keepdim=True)
    assert not dk[masked].any() and not dv[masked].any()
    assert all(torch.equal(x, y) for x, y in zip(*runs))


@pytest.mark.parametrize(
    "dtype,g,s,body",
    [(torch.bfloat16, 17, 1472, "attention_fwd_wide_wgmma_kernel"), (torch.bfloat16, 17, 1473, "attention_fwd_bf16_wide_kernel"),
     (torch.float32, 100, 448, "attention_fwd_wide_wgmma_kernel"), (torch.float32, 100, 449, "attention_fwd_f32_wide_kernel")],
)
def test_attention_wide_forward_past_the_staging_limit(dev, dtype, g, s, body):
    """Kernel A at hd 272 at the s whose stored P fit in a block's shared
    memory (bf16 1472, f32 448), on its Hopper body, and one key past it, on
    the slice body; the profiler names the body. On ``_edge_case``'s masks,
    the pair with no valid key and masked key tiles included, at every row:
    the output within 2e-2 (bf16) or 1e-4 (f32) of the plain attention, the
    lse within 1e-5 relative of the plain logsumexp (without the -1e9 of
    the pair with no valid key), two launches the same bits."""
    q, k, v, valid = _edge_case(dev, g, 272, seed=g + s, s=s, dtype=dtype)
    names = _profiled_kernels(lambda: attention_fwd(q, k, v, valid))
    assert any(body in n for n in names), names
    runs = [attention_fwd(q, k, v, valid, with_lse=True) for _ in range(2)]
    want = attention_plain(q, k, v, valid).float()
    scores = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float()) / 272 ** 0.5
    scores = scores + torch.where(valid, 0.0, -1e9)[:, None, None, :]
    shift = torch.where(valid.any(dim=1), 0.0, -1e9)[:, None, None, None]
    want_lse = torch.logsumexp(scores - shift, dim=-1)
    torch.cuda.synchronize()
    out, lse = runs[0]
    err = (out.float() - want).abs().max().item()
    assert err <= (2e-2 if dtype == torch.bfloat16 else 1e-4), err
    assert torch.allclose(lse, want_lse, rtol=1e-5, atol=1e-5)
    assert all(torch.equal(x, y) for x, y in zip(*runs))


def test_attention_kernel_rejects_what_it_cannot_take(dev):
    q, k, v, valid, _ = _attn_case(dev, 2, 8, 8, 2, 16, torch.float32, seed=0)
    with pytest.raises(ValueError, match="head dim"):  # the kernel itself: multiples of 16 only
        attention_fwd(q[..., :8], k[..., :8], v[..., :8], valid)
    # above 256 is no longer refused: attention() pads 264 to 272 for the wide route
    big = torch.randn(2, 8, 2, 264, device=dev)
    before = attention.launches
    got = attention(big, big, big, valid)
    assert attention.launches == before + 1
    assert (got - attention_plain(big, big, big, valid)).abs().max().item() <= 1e-4
    with pytest.raises(ValueError, match="bf16 or f32"):
        attention(q.half(), k.half(), v.half(), valid)
    with pytest.raises(ValueError, match="one CUDA device"):
        attention(q, k, v, valid.cpu())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hd", [8, 24, 72, 200, 300])
def test_attention_pads_head_dims_that_are_not_multiples_of_16(dev, hd, dtype):
    """attention() zero-pads q, k, v to the next multiple of 16 with the
    softmax scale of the real head dim, and slices the output and dQ, dK,
    dV back: forward and backward against the plain versions at the
    tolerance of test_attention_kernels_take_every_head_dim, through one
    launch of each kernel."""
    for g in (130, 1):
        q, k, v, valid, lengths = _attn_case(dev, 3, g, 130, 2, hd, dtype, seed=hd + g)
        before = (attention.launches, attention_bwd_dkv.launches, attention_bwd_dq.launches)
        _check_fwd_bwd(q, k, v, valid, lengths, dtype, 2e-2)
        assert (attention.launches, attention_bwd_dkv.launches, attention_bwd_dq.launches) == tuple(n + 1 for n in before)
        with torch.no_grad():
            out = attention(q, k, v, valid)
        want = attention_plain(q, k, v, valid)
        rows = _real_rows(g, 130, lengths)
        assert out.shape == q.shape
        assert (out.float() - want.float()).abs().amax(dim=(2, 3))[rows].max().item() <= 2e-2


def _real_rows(g, s, lengths):
    """(b, g) rows that reach a loss: rows < length of a full layer, all of
    a 1- or 3-row slice."""
    b = lengths.shape[0]
    if g == s:
        return torch.arange(g, device=lengths.device)[None, :] < lengths[:, None]
    return torch.ones(b, g, dtype=torch.bool, device=lengths.device)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("g", [256, 1, 3])
def test_attention_lse_matches_plain_logsumexp(dev, g, dtype):
    q, k, v, valid, lengths = _attn_case(dev, 4, g, 256, 12, 64, dtype, seed=g)
    out, lse = attention_fwd(q, k, v, valid, with_lse=True)
    scores = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float()) / 8.0
    scores = scores + torch.where(valid, 0.0, -1e9)[:, None, None, :]
    want = torch.logsumexp(scores, dim=-1)
    torch.cuda.synchronize()
    # f32 sums of exponentials in another order: relative 1e-5 of |lse|
    rows = _real_rows(g, 256, lengths)[:, None, :].expand_as(want)
    assert torch.allclose(lse[rows], want[rows], rtol=1e-5, atol=1e-5)
    assert torch.equal(out, attention_fwd(q, k, v, valid)[0])


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2), (torch.float32, 1e-4)])
@pytest.mark.parametrize("g", [256, 1, 3])
def test_attention_backward_kernels_match_plain_autograd(dev, g, dtype, tol):
    """Kernels C and D against the autograd of the plain attention, at
    real query rows; masked keys get exactly zero dK, dV. Tolerance x the
    plain gradient's max: bf16 outputs round to 8 bits (2e-2); f32 sums
    in another order (1e-4)."""
    s = 256
    q, k, v, valid, lengths = _attn_case(dev, 4, g, s, 12, 64, dtype, seed=100 + g)
    rows = _real_rows(g, s, lengths)
    gen = torch.Generator(device=dev).manual_seed(g)
    # padded query rows never reach a loss: their dO is 0, as in the CE
    dout = torch.randn(q.shape, generator=gen, device=dev).to(dtype) * rows[:, :, None, None]
    want = attention_bwd_plain(q, k, v, valid, dout)

    before = (attention.launches, attention_bwd_dkv.launches, attention_bwd_dq.launches)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    out = attention(*leaves, valid)
    dout_before = dout.clone()
    got = torch.autograd.grad(out, leaves, dout)
    torch.cuda.synchronize()
    after = (attention.launches, attention_bwd_dkv.launches, attention_bwd_dq.launches)
    assert after == tuple(n + 1 for n in before)
    assert torch.equal(dout, dout_before)  # the backward leaves its cotangent as it was
    for name, a, b, sel in (
        ("dq", got[0], want[0], rows),
        ("dk", got[1], want[1], valid),
        ("dv", got[2], want[2], valid),
    ):
        assert a.dtype == dtype and a.shape == b.shape, name
        err = (a.float() - b.float()).abs().amax(dim=(2, 3))[sel].max().item()
        scale = b.float().abs().max().item()
        assert err <= tol * scale, (name, err, scale)
    assert not got[1][~valid].any() and not got[2][~valid].any()


def test_attention_backward_kernels_reject_what_they_cannot_take(dev):
    """Kernel D (dout, out, lse) and kernel C (dout, lse, delta) refuse a
    dO or O of another dtype, with hd strided, or with a broadcast axis
    (stride 0), a missing lse, a delta of another dtype and a head dim off
    the 16 grid. A dO transposed over (g, nh) is taken: the kernels read
    its strides."""
    q, k, v, valid, _ = _attn_case(dev, 2, 8, 8, 2, 16, torch.float32, seed=0)
    out, lse = attention_fwd(q, k, v, valid, with_lse=True)
    dout = torch.ones_like(out)
    _, delta = attention_bwd_dq(q, k, v, valid, dout, out, lse)
    strided_hd = torch.ones(out.shape + (2,), device=dev)[..., 0]
    broadcast = torch.ones(1, *out.shape[1:], device=dev).expand(out.shape)
    entries = (
        (lambda do, o, ls, d: attention_bwd_dq(q, k, v, valid, do, o, ls)),
        (lambda do, o, ls, d: attention_bwd_dkv(q, k, v, valid, do, ls, d)),
    )
    for i, fn in enumerate(entries):
        for bad in (dout.bfloat16(), strided_hd, broadcast):
            with pytest.raises(ValueError, match="dout"):
                fn(bad, out, lse, delta)
            if i == 0:
                with pytest.raises(ValueError, match="backward: out "):
                    fn(dout, bad, lse, delta)
        with pytest.raises(ValueError, match="lse"):
            fn(dout, out, None, delta)
        if i == 1:
            with pytest.raises(ValueError, match="delta"):
                fn(dout, out, lse, delta.double())
        with pytest.raises(ValueError, match="head dim"):
            attention_bwd_dq(q[..., :8], k[..., :8], v[..., :8], valid, dout[..., :8].contiguous(),
                             out[..., :8].contiguous(), lse)
    fn(dout.transpose(1, 2).contiguous().transpose(1, 2), out, lse, delta)


@pytest.mark.parametrize("g,hd,dtype", [(255, 64, torch.bfloat16), (3, 64, torch.bfloat16), (130, 32, torch.bfloat16),
                                        (100, 384, torch.bfloat16), (100, 64, torch.float32), (100, 384, torch.float32)])
def test_attention_backward_takes_strided_dout_without_a_copy(dev, g, hd, dtype):
    """dO laid out (b, nh, g, hd) and handed over as its (b, g, nh, hd)
    view (strides of a transposed tensor; the CE's dO is contiguous, a
    head-major model's would be such a view): kernels D and C read it in
    place and give the same bits as with the contiguous copy, on every
    route (the Hopper bodies at hd = 64, g > 16; mma.sync; the wide route;
    f32). Through the autograd the backward launches D and C once each
    and copies nothing: its device work is exactly those two kernels."""
    q, k, v, valid = _edge_case(dev, g, hd, seed=g + hd, dtype=dtype)
    gen = torch.Generator(device=dev).manual_seed(g + 1)
    dout_hm = torch.randn(q.shape[0], q.shape[2], g, hd, generator=gen, device=dev).to(dtype)
    strided = dout_hm.transpose(1, 2)
    assert not strided.is_contiguous()
    out, lse = attention_fwd(q, k, v, valid, with_lse=True)
    got = _run_bwd(q, k, v, valid, strided, out, lse)
    want = _run_bwd(q, k, v, valid, strided.contiguous(), out, lse)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))

    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    res = attention(*leaves, valid)
    torch.cuda.synchronize()
    before = (attention_bwd_dkv.launches, attention_bwd_dq.launches)
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        grads = torch.autograd.grad(res, leaves, strided)
        torch.cuda.synchronize()
    assert (attention_bwd_dkv.launches, attention_bwd_dq.launches) == tuple(n + 1 for n in before)
    for a, w in zip(grads, (got[2], got[0], got[1])):
        assert torch.equal(a, w)
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert [n for n in names if "attention_bwd" in n] == names and len(names) == 2, names
    assert "attention_bwd_dq" in names[0] and "attention_bwd_dkv" in names[1], names


def _int_mips_inputs(dev, q, d, n, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    # small integers: exact f32 products, so many exact ties to order
    queries = torch.randint(-2, 3, (q, d), generator=gen, device=dev).float()
    items = torch.randint(-2, 3, (n, d), generator=gen, device=dev).float()
    return queries, items


def _profiled_kernels(fn):
    """Names of the device kernels that ``fn()`` ran, under torch.profiler."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA}


@pytest.mark.parametrize("g", [17, 64, 65, 255, 256])
def test_attention_hopper_body_at_ragged_s(dev, g):
    """Kernel A's Hopper body (bf16, hd 64, g > 16: wgmma on TMA tiles,
    persistent blocks) on strided q/k/v slices of one projection at a ragged
    s=300: every row of every pair (prefix lengths at the tile edges, a pair
    with no valid key, holes, a masked tile between valid keys, a masked
    first tile) within 2e-2 of the plain attention, its lse within 1e-5 of
    the plain logsumexp (without the -1e9 of the pair with no valid key),
    the same bits without the lse, and the launch on the wgmma kernel."""
    q, k, v, valid = _edge_case(dev, g, 64, seed=g, s=300, nh=12)
    assert q.stride(1) == 3 * 12 * 64  # a slice of the fused projection
    names = _profiled_kernels(lambda: attention_fwd(q, k, v, valid))
    assert any("attention_fwd_wgmma_kernel" in n for n in names), names
    out, lse = attention_fwd(q, k, v, valid, with_lse=True)
    want = attention_plain(q, k, v, valid).float()
    scores = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float()) / 8.0
    scores = scores + torch.where(valid, 0.0, -1e9)[:, None, None, :]
    shift = torch.where(valid.any(dim=1), 0.0, -1e9)[:, None, None, None]
    want_lse = torch.logsumexp(scores - shift, dim=-1)
    torch.cuda.synchronize()
    err = (out.float() - want).abs().max().item()
    assert err <= 2e-2, err
    assert torch.allclose(lse, want_lse, rtol=1e-5, atol=1e-5)
    assert torch.equal(out, attention_fwd(q, k, v, valid)[0])


def test_attention_hopper_body_walks_many_items_per_block(dev):
    """2,304 work items (48 pairs x 12 heads x 4 query tiles) over the
    card's persistent blocks, random key lengths: each block walks several
    items, its loads running across them, against the plain attention at
    every real row."""
    q, k, v, valid, lengths = _attn_case(dev, 48, 200, 200, 12, 64, torch.bfloat16, seed=11)
    got = attention(q, k, v, valid).float()
    want = attention_plain(q, k, v, valid).float()
    torch.cuda.synchronize()
    rows = torch.arange(200, device=dev)[None, :] < lengths[:, None]
    err = (got - want).abs().amax(dim=(2, 3))[rows].max().item()
    assert err <= 2e-2, err


@pytest.mark.parametrize(
    "q,d,n,n_valid,k",
    [
        (32, 500, 10240, 10000, 100),  # the query path's shape
        (5, 7, 100, 100, 1),  # one block per row, k = 1
        (9, 33, 1000, 700, 256),
        (3, 64, 70000, 69999, 100),  # clusters of 8 blocks of 8750 keys
        (4, 40, 3000, 2000, 500),  # k = 500, the transductive eval's top_k_retvr
        (3, 16, 5000, 5000, 5000),  # k = n_valid: survivors sorted in global memory
        (2, 8, 20000, 20000, 20000),  # k = n_valid > 8192: sort strides across chunks
        (1, 500, 10240, 10000, 100),  # q = 1: one text
        (70, 24, 3000, 3000, 10),  # 64-query tiles and a ragged one
        (256, 500, 104520, 104520, 100),  # an eval batch at ZeShEL-military's entity count
        (700, 8, 104520, 100000, 50),  # score scratch over its budget: two query chunks
        (2, 4, 400000, 400000, 50),  # slices of 50,000 keys, re-read from the score scratch
    ]
    # more than 32 rows of 16-byte rows: the tensor-core route (one ragged
    # 128-query tile, one full, two) at depths under, at and past one stage
    + [(q, d, 3000, 2999, 50) for q in (33, 64, 65, 128) for d in (8, 24, 500, 768)],
)
def test_mips_kernel_matches_plain(dev, q, d, n, n_valid, k):
    queries, items = _int_mips_inputs(dev, q, d, n, seed=n + k)
    before = mips_topk_fused.launches
    s_k, i_k = mips_topk_fused(queries, items, k, n_valid)
    s_p, i_p = mips_topk(queries, items, k, n_valid)
    torch.cuda.synchronize()
    assert mips_topk_fused.launches == before + 1
    assert i_k.dtype == torch.int64 and s_k.dtype == torch.float32
    # exact products: the same scores and, ties to the smallest id, the same ids
    assert torch.equal(s_k, s_p)
    assert torch.equal(i_k, i_p)


@pytest.mark.parametrize("k", [10, 2000])
def test_mips_kernel_never_selects_padding(dev, k):
    """Each query's best item copied into every padded row (ids >= n_valid)."""
    queries, items = _int_mips_inputs(dev, 6, 48, 6000, seed=k)
    n_valid = 5000
    best = (queries @ items[:n_valid].T).argmax(dim=1)
    items[n_valid:] = items[best[0]]
    items[n_valid + 1 : n_valid + 7] = items[best]
    s_k, i_k = mips_topk_fused(queries, items, k, n_valid)
    s_p, i_p = mips_topk(queries, items, k, n_valid)
    torch.cuda.synchronize()
    assert int(i_k.max()) < n_valid
    assert torch.equal(s_k, s_p) and torch.equal(i_k, i_p)


def test_mips_kernel_same_bits_twice(dev):
    queries = torch.randn(40, 100, device=dev)
    items = torch.randn(5000, 100, device=dev)
    first = mips_topk_fused(queries, items, 300)
    second = mips_topk_fused(queries, items, 300)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_mips_kernel_rejects_what_it_cannot_take(dev):
    queries = torch.randn(4, 8, device=dev)
    items = torch.randn(300, 8, device=dev)
    with pytest.raises(ValueError):
        mips_topk_fused(queries, items, 11, n_valid=10)  # k > n_valid, as lax.top_k
    with pytest.raises(ValueError):
        mips_topk_fused(queries, items, 301)
    with pytest.raises(ValueError):
        mips_topk_fused(queries, items, 0)
    with pytest.raises(ValueError):
        mips_topk_fused(queries, items, 10, n_valid=301)
    with pytest.raises(ValueError):
        mips_topk_fused(queries.double(), items.double(), 10)
    with pytest.raises(ValueError):
        mips_topk_fused(queries, items.T.contiguous().T, 10)
    # every k up to n_valid is taken: k = n_valid = 300
    s, i = mips_topk_fused(queries, items, 300)
    torch.cuda.synchronize()
    assert torch.equal(torch.sort(i, dim=1).values, torch.arange(300, device=dev).expand(4, 300))


@pytest.mark.parametrize("n_ex", [0, 26, 210])
@pytest.mark.parametrize("q", [1, 128, 700])
def test_mips_kernel_exclusions_match_plain(dev, q, n_ex):
    _exclusions_match_plain(dev, q, n_ex)


def test_mips_kernel_exclusions_at_the_last_growth_round(dev):
    """The adaptive engine's last growth round of 210 over 8 at its batch of
    512: S = 184 scored ids excluded, through the tensor-core route."""
    _exclusions_match_plain(dev, 512, 184)


def _exclusions_match_plain(dev, q, n_ex):
    """Kernel B with a per-row exclusion list exactly equal to the plain
    ``mips_topk(..., exclude=)`` on small-integer inputs: the excluded ids
    are each row's best (so the pick must reach past them), with a
    duplicate, a -1 and an id past n_valid among them (ignored), the list
    a column slice of a wider buffer; at the adaptive engine's k = 26 and
    at k = n_valid - S, every candidate that is left."""
    d, n, n_valid = 24, 10240, 10000
    queries, items = _int_mips_inputs(dev, q, d, n, seed=q * 1000 + n_ex)
    buf = torch.full((q, 256), -1, dtype=torch.int64, device=dev)
    if n_ex:
        buf[:, :n_ex] = mips_topk(queries, items, n_ex, n_valid)[1]
        buf[:, 1] = buf[:, 0]  # a duplicate
        buf[:, 2] = -1
        buf[:, 3] = n_valid + 7  # a padded id: ignored
    exclude = buf[:, :n_ex]
    before = mips_topk_fused.launches
    for k in (26, n_valid - n_ex):
        s_k, i_k = mips_topk_fused(queries, items, k, n_valid, exclude)
        s_p, i_p = mips_topk(queries, items, k, n_valid, exclude)
        torch.cuda.synchronize()
        assert torch.equal(s_k, s_p) and torch.equal(i_k, i_p), k
        hit = (i_k[:, :, None] == exclude[:, None, :]).any()
        assert not bool(hit)
    assert mips_topk_fused.launches == before + 2
    # the int32 list gives the same answer
    _, i_32 = mips_topk_fused(queries, items, 26, n_valid, exclude.int())
    assert torch.equal(i_32, mips_topk(queries, items, 26, n_valid, exclude)[1])


@pytest.mark.parametrize("fill", [float("-inf"), -1e30])
def test_mips_kernel_exclusions_where_every_score_is_the_sentinel(dev, fill):
    """Every real score of every row equals -inf (the value JAX writes over
    excluded ids) or the plain version's -1e30 fill: the excluded ids must
    still never appear, and the others come in id order."""
    q, d, n, n_valid = 3, 8, 600, 500
    queries = torch.zeros(q, d, device=dev)
    queries[:, 0] = fill
    items = torch.randint(0, 3, (n, d), device=dev).float()
    items[:, 0] = 1.0  # fill * 1 + 0 * x: every score is the fill
    exclude = torch.tensor([[0, 5, 17], [499, 0, 1], [2, 2, 600]], device=dev)
    k = n_valid - 3
    s_k, i_k = mips_topk_fused(queries, items, k, n_valid, exclude)
    _, i_p = mips_topk(queries, items, k, n_valid, exclude)
    torch.cuda.synchronize()
    assert bool((s_k == fill).all())
    assert torch.equal(i_k, i_p)
    for r in range(q):
        left = [i for i in range(n_valid) if i not in set(exclude[r].tolist())]
        assert i_k[r].tolist() == left[:k]


def test_mips_kernel_signed_zero_order_matches_topk_stable(dev):
    """Kernel B ranks +0.0 above -0.0, as ``topk_stable`` and ``lax.top_k``
    do. The score GEMM makes -0.0 only from products that all round to
    -0.0 (fmaf from +0.0): 32 terms of -1e-30 x 1e-30; +0.0 from -1e-30 x
    -1e-30; +-1 from 32 terms of -1e-30 x -+3.125e28."""
    from anncur_tpu_torch.ops.mips import topk_stable

    col = torch.tensor([0.0, -0.0, 1.0, -0.0, 0.0, -1.0, -0.0, 0.0])
    per_term = torch.where(col > 0, -3.125e28, torch.where(col < 0, 3.125e28,
                           torch.where(torch.signbit(col), 1e-30, -1e-30)))
    items = per_term[:, None].expand(8, 32).contiguous().to(dev)
    queries = torch.full((1, 32), -1e-30, device=dev)
    s_k, i_k = mips_topk_fused(queries, items, 8)
    torch.cuda.synchronize()
    assert i_k[0].tolist() == [2, 0, 4, 7, 1, 3, 6, 5]
    assert torch.signbit(s_k[0]).tolist() == torch.signbit(col[i_k[0].cpu()]).tolist()
    row = torch.empty(8)
    row[i_k[0].cpu()] = s_k[0].cpu()
    assert topk_stable(row, 8)[1].tolist() == i_k[0].tolist()


def test_mips_kernel_signed_zero_order_on_the_tensor_cores(dev):
    """The same items at q=64 (the tensor-core route): its f32 sum of the
    stages starts at +0.0, so the items whose products round to -0.0 score
    +0.0 and tie with the +0.0 ones; every row's ids are ``topk_stable``'s
    order of the kernel's own scores (+0.0 above -0.0, ties by id)."""
    from anncur_tpu_torch.ops.mips import topk_stable

    col = torch.tensor([0.0, -0.0, 1.0, -0.0, 0.0, -1.0, -0.0, 0.0])
    per_term = torch.where(col > 0, -3.125e28, torch.where(col < 0, 3.125e28,
                           torch.where(torch.signbit(col), 1e-30, -1e-30)))
    items = per_term[:, None].expand(8, 32).contiguous().to(dev)
    queries = torch.full((64, 32), -1e-30, device=dev)
    s_k, i_k = mips_topk_fused(queries, items, 8)
    torch.cuda.synchronize()
    assert i_k[0].tolist()[0] == 2 and i_k[0].tolist()[-1] == 5
    for r in range(64):
        row = torch.empty(8)
        row[i_k[r].cpu()] = s_k[r].cpu()
        assert topk_stable(row, 8)[1].tolist() == i_k[r].tolist()
        assert torch.signbit(s_k[r].cpu()).tolist() == torch.signbit(row[i_k[r].cpu()]).tolist()


def _tf32_probe(a, b):
    """One TF32 wgmma of kernel B's score stage on raw f32 bits:
    (64, 8) x (128, 8)^T (``mips_tf32_probe``)."""
    from anncur_tpu_torch.ops import cuda_build

    d = torch.empty(64, 128, device=a.device)
    probe = cuda_build.Entry("mips_topk", "mips_tf32_probe", [cuda_build.PTR] * 3, cuda_build.STREAM)
    probe.call(a.data_ptr(), b.data_ptr(), d.data_ptr(), torch.cuda.current_stream(a.device).cuda_stream)
    torch.cuda.synchronize()
    return d


def test_tf32_wgmma_fragments_and_the_low_13_bits(dev):
    """The tensor-core route's operand layouts, and what TF32 wgmma does with
    the low 13 bits of an f32 (whether the raw item tile could serve as the
    big part): small integers come out as the exact product; values whose
    low 13 bits are at least half a tf32 step (round-to-nearest and
    truncation differ) come out as the product of the truncated values."""
    gen = torch.Generator(device=dev).manual_seed(5)
    a = torch.randint(-3, 4, (64, 8), generator=gen, device=dev).float()
    b = torch.randint(-3, 4, (128, 8), generator=gen, device=dev).float()
    assert torch.equal(_tf32_probe(a, b), a @ b.T)

    def low_bits(n, seed):
        # +-(1 + m 2^-23) 2^e with m in [0x1000, 0x1FFF]: bit 12 set
        g = torch.Generator().manual_seed(seed)
        m = torch.randint(0x1000, 0x2000, (n,), generator=g)
        e = torch.randint(-4, 5, (n,), generator=g).double()
        sign = torch.where(torch.rand(n, generator=g) < 0.5, -1.0, 1.0).double()
        return (sign * (1.0 + m.double() * 2.0**-23) * torch.exp2(e)).float()

    a = torch.zeros(64, 8)
    b = torch.zeros(128, 8)
    a[:, 0], b[:, 0] = low_bits(64, 1), low_bits(128, 2)  # one product an output: no sum to round

    def trunc(x):
        return (x.view(torch.int32) & -0x2000).view(torch.float32)

    got = _tf32_probe(a.to(dev), b.to(dev)).cpu()
    want = (trunc(a[:, 0]).double()[:, None] * trunc(b[:, 0]).double()[None, :]).float()
    assert torch.equal(got, want)


def _serving_world(device, n_items=1200, n_anchors=48, n_train=64, seed=0, rank=8):
    """A tiny CE (weights from ``seed``, init widened so rankings exist)
    and a CUR index over a seeded rank-``rank`` train matrix, on ``device``."""
    import numpy as np

    from anncur_tpu_torch.core.cur import build_cur
    from anncur_tpu_torch.core.retriever import CurRetriever
    from anncur_tpu_torch.models.bert import BertSpec
    from anncur_tpu_torch.models.crossencoder import CrossEncoder
    from anncur_tpu_torch.models.tokenizer import WordPieceTokenizer, make_test_vocab

    rng = np.random.default_rng(seed)
    spec = BertSpec.tiny(initializer_range=0.3)
    ce = CrossEncoder(spec, compute_dtype=torch.float32, device=device, seed=seed)
    item_toks = rng.integers(1, spec.vocab_size, size=(n_items, 16)).astype(np.int32)
    train = (rng.standard_normal((n_train, rank)) @ rng.standard_normal((rank, n_items))).astype(np.float32)
    anchors = np.asarray(sorted(rng.choice(n_items, n_anchors, replace=False)))
    index = build_cur(rows=train, cols=train[:, anchors], row_idxs=np.arange(n_train), col_idxs=anchors,
                      approx_preference="rows", validate=False, device=device)
    retriever = CurRetriever(encoder=ce, tokenizer=WordPieceTokenizer(make_test_vocab()), item_tokens=item_toks,
                             index=index, anchor_item_ids=anchors, max_query_len=16, device=device)
    qtoks = rng.integers(1, spec.vocab_size, size=(6, 16)).astype(np.int32)
    return retriever, qtoks


def test_retriever_top_k_retvr_500_matches_cpu(dev):
    """The transductive eval's top_k_retvr=500 through kernel B on the card
    (k = 500) against the port's CPU answer on the same world."""
    import numpy as np

    on_card, qtoks = _serving_world(dev)
    on_cpu, _ = _serving_world("cpu")
    for kw in (dict(top_k=500, rerank=False), dict(top_k=10)):
        s_c, i_c = on_card.query_tokens_batch(qtoks, top_k_retvr=500, **kw)
        s_h, i_h = on_cpu.query_tokens_batch(qtoks, top_k_retvr=500, **kw)
        assert s_c.shape == s_h.shape == i_c.shape == (6, kw["top_k"])
        # CE scores in f32 on both, summed in other orders
        scale = float(np.abs(s_h).max())
        np.testing.assert_allclose(s_c, s_h, rtol=0, atol=1e-5 * scale)
        gaps = -np.diff(s_h, axis=1)
        sep = np.ones(s_h.shape, bool)
        sep[:, :-1] &= gaps > 1e-4 * scale
        sep[:, 1:] &= gaps > 1e-4 * scale
        assert sep.mean() > 0.5
        np.testing.assert_array_equal(i_c[sep], i_h[sep])


def test_retriever_adaptive_matches_cpu(dev):
    """query_tokens_adaptive_fused on the card (kernel B with the scored ids
    excluded, once per growth round) against the port's CPU answer on the
    same world, base rounds and with every query escalating. The train
    matrix has full rank (64) and every ridge solve has S <= 45 ids, so the
    solves are well conditioned and the two devices' roundings pick the
    same items (rank-deficient solves amplify rounding into the picks)."""
    import numpy as np

    on_card, qtoks = _serving_world(dev, rank=64)
    on_cpu, _ = _serving_world("cpu", rank=64)
    for kw, picks in ((dict(total_budget=60, n_rounds=4), 3),
                      (dict(total_budget=30, n_rounds=3, escalate_budget=50, escalate_rounds=2, stability_overlap=1.01), 4)):
        before = mips_topk_fused.launches
        s_c, i_c, st_c = on_card.query_tokens_adaptive_fused(qtoks, top_k=10, return_stats=True, **kw)
        torch.cuda.synchronize()
        assert mips_topk_fused.launches == before + picks
        s_h, i_h, st_h = on_cpu.query_tokens_adaptive_fused(qtoks, top_k=10, return_stats=True, **kw)
        assert st_c == st_h
        scale = float(np.abs(s_h).max())
        np.testing.assert_allclose(s_c, s_h, rtol=0, atol=1e-5 * scale)
        gaps = -np.diff(s_h, axis=1)
        sep = np.ones(s_h.shape, bool)
        sep[:, :-1] &= gaps > 1e-4 * scale
        sep[:, 1:] &= gaps > 1e-4 * scale
        assert sep.mean() > 0.5
        np.testing.assert_array_equal(i_c[sep], i_h[sep])


def test_retriever_at_zeshel_military_scale_matches_cpu(dev):
    """Fixed and adaptive serving over ZeShEL-military's 104,520 items (an
    item axis padded to 105,472: kernel B's score scratch, exclusion lists
    and growth rounds at that width) against the port's CPU answer on the
    same world, ids compared where scores are separated. Full-rank train
    matrix, S <= 45: well-conditioned solves, as above."""
    import numpy as np

    on_card, qtoks = _serving_world(dev, n_items=104520, rank=64)
    on_cpu, _ = _serving_world("cpu", n_items=104520, rank=64)
    assert on_card._padded_n_items() == 105472
    calls = (lambda r: r.query_tokens_batch(qtoks, top_k=10, top_k_retvr=100),
             lambda r: r.query_tokens_adaptive_fused(qtoks, top_k=10, total_budget=60, n_rounds=4))
    for call, picks in zip(calls, (1, 3)):
        before = mips_topk_fused.launches
        s_c, i_c = call(on_card)
        torch.cuda.synchronize()
        assert mips_topk_fused.launches == before + picks
        s_h, i_h = call(on_cpu)
        scale = float(np.abs(s_h).max())
        np.testing.assert_allclose(s_c, s_h, rtol=0, atol=1e-5 * scale)
        gaps = -np.diff(s_h, axis=1)
        sep = np.ones(s_h.shape, bool)
        sep[:, :-1] &= gaps > 1e-4 * scale
        sep[:, 1:] &= gaps > 1e-4 * scale
        assert sep.mean() > 0.5
        np.testing.assert_array_equal(i_c[sep], i_h[sep])
        assert i_c.max() < 104520


def _int8_case(dev, q, d, n, seed):
    """Small-integer f32 queries, int8 values and power-of-two scales:
    every product, sum and scaling is exact in f32, so kernel and plain
    version must agree bit for bit, ties included."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    queries = torch.randint(-3, 4, (q, d), generator=gen, device=dev).float()
    values = torch.randint(-4, 5, (n, d), generator=gen, device=dev).to(torch.int8)
    scales = torch.pow(2.0, torch.randint(-3, 3, (n, 1), generator=gen, device=dev).float())
    return queries, QuantizedItems(values, scales)


@pytest.mark.parametrize(
    "q,d,n,n_valid,k,n_ex",
    [
        (32, 768, 10000, 10000, 64, 0),  # the retrieve-and-rerank search: 16-byte int8 rows
        (1, 768, 20000, 20000, 100, 0),  # one text
        (70, 768, 3000, 2990, 100, 26),  # 64-query tiles, padding and exclusions
        (5, 24, 1000, 1000, 1, 0),  # d % 16 != 0: converted as loaded, k = 1
        (9, 40, 2000, 1500, 500, 10),
        (3, 16, 5000, 5000, 5000, 0),  # k = n_valid: the global sort
    ],
)
def test_mips_int8_kernel_matches_plain(dev, q, d, n, n_valid, k, n_ex):
    queries, items = _int8_case(dev, q, d, n, seed=n + k + d)
    exclude = None
    if n_ex:
        exclude = mips_topk_int8_plain(queries, items, n_ex, n_valid)[1]
        k = min(k, n_valid - n_ex)
    before = (mips_topk_int8_fused.launches, mips_topk_fused.launches)
    s_k, i_k = mips_topk_int8_fused(queries, items, k, n_valid, exclude)
    s_p, i_p = mips_topk_int8_plain(queries, items, k, n_valid, exclude)
    torch.cuda.synchronize()
    assert (mips_topk_int8_fused.launches, mips_topk_fused.launches) == (before[0] + 1, before[1])
    assert torch.equal(s_k, s_p) and torch.equal(i_k, i_p)
    assert int(i_k.max()) < n_valid
    if exclude is not None:
        assert not bool((i_k[:, :, None] == exclude[:, None, :]).any())


def test_mips_int8_kernel_on_quantized_normal_rows(dev):
    """Quantised random rows and random queries: scores within 1e-5 of
    max|score| of the plain version (f32 sums in other orders), and the
    wrapper refuses f32 values and bad scales."""
    gen = torch.Generator(device=dev).manual_seed(7)
    items = quantize_items(torch.randn(30000, 768, generator=gen, device=dev))
    queries = torch.randn(16, 768, generator=gen, device=dev)
    s_k, i_k = mips_topk_int8_fused(queries, items, 100)
    s_p, i_p = mips_topk_int8_plain(queries, items, 100)
    torch.cuda.synchronize()
    scale = s_p.abs().max().item()
    assert (s_k - s_p).abs().max().item() <= 1e-5 * scale
    assert (i_k == i_p).float().mean().item() > 0.9
    with pytest.raises(ValueError):
        mips_topk_int8_fused(queries, QuantizedItems(items.values.float(), items.scales), 10)
    with pytest.raises(ValueError):
        mips_topk_int8_fused(queries, QuantizedItems(items.values, items.scales.double()), 10)


def test_hard_negative_miner_on_the_card_matches_cpu(dev):
    """get_hard_negs_from_embeds (and its blacklist form) through kernel B
    equal the CPU answer on small-integer embeddings (exact ties)."""
    import numpy as np

    from anncur_tpu_torch.train.negatives import get_hard_negs_from_embeds, get_hard_negs_from_embeds_w_blacklist

    rng = np.random.default_rng(0)
    ments = rng.integers(-2, 3, size=(40, 32)).astype(np.float32)
    ents = rng.integers(-2, 3, size=(3000, 32)).astype(np.float32)
    gt = rng.integers(0, 3000, size=40)
    before = mips_topk_fused.launches
    got = get_hard_negs_from_embeds(ments, ents, gt, 63, device=dev)
    assert mips_topk_fused.launches == before + 1
    np.testing.assert_array_equal(got, get_hard_negs_from_embeds(ments, ents, gt, 63, device="cpu"))
    black = [rng.choice(3000, 5, replace=False) for _ in range(40)]
    np.testing.assert_array_equal(
        get_hard_negs_from_embeds_w_blacklist(ments, ents, black, 20, device=dev),
        get_hard_negs_from_embeds_w_blacklist(ments, ents, black, 20, device="cpu"),
    )


@pytest.mark.parametrize("quantize", [False, True])
def test_dense_index_on_the_card_matches_cpu(dev, quantize):
    """DenseIndex.search through kernel B (f32 or int8) against the CPU
    index on the same rows: small-integer rows, so scores and ids agree
    exactly (quantisation keeps them small integers times scales)."""
    import numpy as np

    from anncur_tpu_torch.ops.dense_index import DenseIndex

    rng = np.random.default_rng(1)
    rows = rng.integers(-3, 4, size=(5000, 768)).astype(np.float32)
    queries = rng.integers(-3, 4, size=(33, 768)).astype(np.float32)
    launches = mips_topk_int8_fused if quantize else mips_topk_fused
    before = launches.launches
    s_c, i_c = DenseIndex(rows, quantize=quantize, device=dev).search(queries, 64)
    assert launches.launches == before + 1
    s_h, i_h = DenseIndex(rows, quantize=quantize, device="cpu").search(queries, 64)
    np.testing.assert_array_equal(i_c, i_h)
    np.testing.assert_allclose(s_c, s_h, rtol=1e-6)


def test_retriever_axn_and_host_adaptive_match_cpu(dev):
    """query_tokens_adaptive_fused(method='axn') (kernel B over [E, mean]
    once per growth round) and the host ADACUR query_tokens_adaptive on the
    card against the port's CPU answer on the same world."""
    import numpy as np

    on_card, qtoks = _serving_world(dev, rank=64)
    on_cpu, _ = _serving_world("cpu", rank=64)
    for fn, kw in (("query_tokens_adaptive_fused", dict(total_budget=60, n_rounds=4, method="axn", axn_rank=16)),
                   ("query_tokens_adaptive", dict(total_budget=60, n_rounds=3))):
        before = mips_topk_fused.launches
        s_c, i_c = getattr(on_card, fn)(qtoks, top_k=10, **kw)
        torch.cuda.synchronize()
        assert mips_topk_fused.launches == before + (3 if fn.endswith("fused") else 0)
        s_h, i_h = getattr(on_cpu, fn)(qtoks, top_k=10, **kw)
        scale = float(np.abs(s_h).max())
        np.testing.assert_allclose(s_c, s_h, rtol=0, atol=1e-5 * scale)
        gaps = -np.diff(s_h, axis=1)
        sep = np.ones(s_h.shape, bool)
        sep[:, :-1] &= gaps > 1e-4 * scale
        sep[:, 1:] &= gaps > 1e-4 * scale
        assert sep.mean() > 0.5
        np.testing.assert_array_equal(i_c[sep], i_h[sep])


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2), (torch.float32, 1e-4)])
@pytest.mark.parametrize("g", [1, 2])
def test_attention_kernels_at_the_towers_selected_rows(dev, g, dtype, tol):
    """The bi-encoder towers' last layer under gradients: one query row
    (CLS, g=1) or the two tag rows of the input tower (g=2) against 128
    keys. Kernel A forward and kernels C and D backward against the plain
    attention and its autograd (tolerances as above, x the plain max)."""
    s = 128
    q, k, v, valid, lengths = _attn_case(dev, 16, g, s, 12, 64, dtype, seed=300 + g)
    gen = torch.Generator(device=dev).manual_seed(7 + g)
    dout = torch.randn(q.shape, generator=gen, device=dev).to(dtype)
    before = (attention.launches, attention_bwd_dkv.launches, attention_bwd_dq.launches)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    out = attention(*leaves, valid)
    got = torch.autograd.grad(out, leaves, dout)
    torch.cuda.synchronize()
    assert (attention.launches, attention_bwd_dkv.launches, attention_bwd_dq.launches) == tuple(n + 1 for n in before)
    want_out = attention_plain(q, k, v, valid)
    assert (out.float() - want_out.float()).abs().max().item() <= tol * want_out.float().abs().max().item()
    want = attention_bwd_plain(q, k, v, valid, dout)
    for name, a, b, sel in (("dq", got[0], want[0], torch.ones(q.shape[:2], dtype=torch.bool, device=dev)),
                            ("dk", got[1], want[1], valid), ("dv", got[2], want[2], valid)):
        err = (a.float() - b.float()).abs().amax(dim=(2, 3))[sel].max().item()
        assert err <= tol * b.float().abs().max().item(), (name, err)
    assert not got[1][~valid].any() and not got[2][~valid].any()


def test_bienc_train_step_through_the_kernels_matches_plain_attention(dev):
    """One bi-encoder micro-batch with hard negatives (cls_w_lin towers, the
    CLS-only last layer), bf16, attention dropout 0: the loss and gradient
    norm through kernels A, C and D against the same step with the plain
    attention in every layer (same dropout masks); then a Trainer step
    launches A, C and D 3 x layers x micro-batches times each."""
    import math

    import numpy as np

    from anncur_tpu_torch.config import Config
    from anncur_tpu_torch.models import bert
    from anncur_tpu_torch.models.bert import BertSpec
    from anncur_tpu_torch.models.biencoder import BiEncoder
    from anncur_tpu_torch.train.trainer import Trainer

    spec = BertSpec(num_layers=2, attention_dropout=0.0, hidden_dropout=0.1)
    cfg = Config()
    cfg.update_from_dict({"model_type": "bi_enc", "neg_strategy": "random", "num_negs": 7, "train_batch_size": 8,
                          "grad_acc_steps": 2, "type_optimization": "all_encoder_layers"})
    tr = Trainer(cfg, BiEncoder(spec, "cls_w_lin", "separate", device=dev, seed=3), total_steps=10)
    state = tr.init_state()
    rng = np.random.default_rng(0)
    mb = {"input": torch.as_tensor(rng.integers(1, 30000, (4, 128)), device=dev),
          "pos": torch.as_tensor(rng.integers(1, 30000, (4, 128)), device=dev),
          "negs": torch.as_tensor(rng.integers(1, 30000, (4, 7, 128)), device=dev)}

    def loss_and_norm():
        for p in state.params.values():
            p.grad = None
        loss, _ = tr._loss_fn(mb, torch.Generator().manual_seed(5))
        loss.backward()
        return float(loss.detach()), math.sqrt(sum(float((p.grad.float() ** 2).sum()) for p in state.params.values()
                                          if p.grad is not None))

    loss_k, norm_k = loss_and_norm()
    bert.attention = attention_plain
    try:
        loss_p, norm_p = loss_and_norm()
    finally:
        bert.attention = attention
    assert abs(loss_k - loss_p) <= 2e-2 and abs(norm_k - norm_p) <= 2e-2 * norm_p, (loss_k, loss_p, norm_k, norm_p)
    before = (attention.launches, attention_bwd_dkv.launches, attention_bwd_dq.launches)
    tr.train_step(state, {k: torch.stack([v, v]) for k, v in mb.items()})
    torch.cuda.synchronize()
    want = 3 * spec.num_layers * 2
    assert (attention.launches, attention_bwd_dkv.launches, attention_bwd_dq.launches) == tuple(n + want for n in before)


def test_hard_negative_miners_at_the_mine_shape_match_plain_mips(dev):
    """Both miners through kernel B at the hard-negative mine's shape (1,024
    mentions, 10,000 entities, d=768, k=64; the triplet miner with a
    16-label blacklist) against the plain MIPS's ids on the card, id by id
    where the plain score differs from both neighbours by more than 1e-5
    of the largest (chip_smoke.py's MIPS_TIE_GAP); no gold or blacklisted
    id among the negatives."""
    import numpy as np

    from anncur_tpu_torch.train.negatives import get_hard_negs_from_embeds, get_hard_negs_from_embeds_w_blacklist

    rng = np.random.default_rng(2)
    ments = rng.standard_normal((1024, 768)).astype(np.float32)
    ents = rng.standard_normal((10000, 768)).astype(np.float32)
    gt = rng.integers(0, 10000, size=1024)
    q, it = torch.as_tensor(ments, device=dev), torch.as_tensor(ents, device=dev)
    scores, ids = (t.cpu().numpy() for t in mips_topk(q, it, 64 + 16))
    gap = -np.diff(scores, axis=1) > 1e-5 * np.abs(scores).max()
    sep = np.ones(scores.shape, bool)
    sep[:, :-1] &= gap
    sep[:, 1:] &= gap

    def compare(got, banned, width):
        """got[r] against the plain ids of row r past its banned ids, at the
        separated places; returns how many places were compared."""
        compared = 0
        for r in range(len(got)):
            keep = ~np.isin(ids[r], banned[r])
            want, ok = ids[r][keep][:width], sep[r][keep][:width]
            np.testing.assert_array_equal(got[r][ok], want[ok])
            assert not np.isin(got[r], banned[r]).any()
            compared += int(ok.sum())
        return compared

    before = mips_topk_fused.launches
    got = get_hard_negs_from_embeds(ments, ents, gt, 63, device=dev)
    assert mips_topk_fused.launches == before + 1
    assert compare(got, gt[:, None], 63) > 0.9 * got.size
    black = np.stack([rng.choice(ids[i, :20], 16, replace=False) for i in range(1024)])
    got_b = get_hard_negs_from_embeds_w_blacklist(ments, ents, black, 64, device=dev)
    assert compare(got_b, black, 64) > 0.9 * got_b.size


def test_eval_harnesses_on_the_card_match_cpu(dev):
    """run_transductive_eval (cur, cur_oracle) and run_inductive_eval (cur)
    on the card give the CPU's result dicts on a low-rank matrix (recall
    equal, relative Frobenius error within 2e-3)."""
    import tempfile

    import numpy as np

    from anncur_tpu_torch.evalx.inductive import run_inductive_eval
    from anncur_tpu_torch.evalx.transductive import run_transductive_eval

    rng = np.random.default_rng(3)
    exact = (rng.standard_normal((200, 8)) @ rng.standard_normal((8, 3000))).astype(np.float32)
    kw = dict(methods=("cur", "cur_oracle"), n_seeds=2, n_ment_anchors_vals=[50], n_ent_anchors_vals=[20, 100],
              top_k_vals=[1, 10], top_k_retvr_vals=[50, 200])
    ikw = dict(top_k_vals=[1, 10], n_ent_anchors_vals=[20, 100])
    with tempfile.TemporaryDirectory() as d:
        res = [run_transductive_eval(exact, f"{d}/{x}", device=x, **kw) for x in (dev, "cpu")]
        ind = [run_inductive_eval(exact[150:], exact[:150], f"{d}/i{x}", device=x, **ikw) for x in (dev, "cpu")]

    def close(a, b, path=""):
        if isinstance(b, dict):
            assert set(a) == set(b), path
            for key in b:
                close(a[key], b[key], f"{path}/{key}")
        elif "approx_error" in path and "relative" not in path:
            return
        elif "relative" in path:
            assert abs(a - b) <= 2e-3, path
        else:
            assert a == b, (path, a, b)

    close(res[0], res[1])
    close(ind[0], ind[1])


def test_in_batch_loss_product_is_true_f32_on_the_card(dev):
    """bienc_loss_in_batch_negs keeps its (b, b) product in true f32 with
    TF32 allowed by the caller: equal to a float64 reference at d=768 to
    f32 resolution (TF32 would keep 10 mantissa bits)."""
    import numpy as np

    from anncur_tpu_torch.train.losses import bienc_loss_in_batch_negs

    rng = np.random.default_rng(0)
    a, b = (rng.standard_normal((16, 768)).astype(np.float32) for _ in range(2))
    s = a.astype(np.float64) @ b.astype(np.float64).T
    want = np.mean(np.log(np.exp(s - s.max(1, keepdims=True)).sum(1)) + s.max(1) - np.diag(s))
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = float(bienc_loss_in_batch_negs(torch.as_tensor(a, device=dev), torch.as_tensor(b, device=dev)))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize(
    "q,d,n,n_valid,k",
    [
        (4, 8191, 3000, 3000, 64),  # a TF-IDF width: d % 4 == 3, the 4-byte transposed tiles
        (33, 12347, 2000, 1999, 100),  # d % 4 == 3, 64-query tiles and a ragged one
        (9, 9002, 1200, 1200, 7),  # d % 4 == 2
        (2, 8192, 1500, 1500, 10),  # d % 4 == 0 at the same width: the 16-byte path
    ],
)
def test_mips_kernel_at_tfidf_widths_matches_plain(dev, q, d, n, n_valid, k):
    """Kernel B at the widths of dense TF-IDF rows (d = the fitted
    vocabulary): the GEMM's depth loop over hundreds of tiles and both
    row layouts, exact on integer inputs."""
    queries, items = _int_mips_inputs(dev, q, d, n, seed=d + k)
    before = mips_topk_fused.launches
    s_k, i_k = mips_topk_fused(queries, items, k, n_valid)
    s_p, i_p = mips_topk(queries, items, k, n_valid)
    torch.cuda.synchronize()
    assert mips_topk_fused.launches == before + 1
    assert torch.equal(s_k, s_p)
    assert torch.equal(i_k, i_p)


def test_tfidf_hard_negatives_on_the_card_match_cpu(dev):
    """The TF-IDF miner through kernel B on sparse, l2-normalised rows as
    wide as the corpus vocabulary, against the CPU's ids where the CPU
    scores are separated by more than 1e-5 of the largest."""
    import numpy as np

    from anncur_tpu_torch.data.tfidf import TfidfVectorizer
    from anncur_tpu_torch.train.negatives import get_hard_negs_tfidf

    rng = np.random.default_rng(4)
    words = [f"w{i}" for i in range(9001)]
    entities = [(f"t{i}", " ".join(rng.choice(words, size=60))) for i in range(2000)]
    texts = [" ".join(rng.choice(words, size=40)) for _ in range(64)]
    gt = rng.integers(0, 2000, size=64)
    corpus = [f"{t} {x}" for t, x in entities]
    vec = TfidfVectorizer().fit(corpus)
    assert len(vec.vocabulary_) % 4 != 0 and len(vec.vocabulary_) > 8192
    q = torch.as_tensor(vec.transform(texts))
    scores, ids = (t.numpy() for t in mips_topk(q, torch.as_tensor(vec.transform(corpus)), 16))
    gap = -np.diff(scores, axis=1) > 1e-5 * np.abs(scores).max()
    sep = np.ones(scores.shape, bool)
    sep[:, :-1] &= gap
    sep[:, 1:] &= gap
    before = mips_topk_fused.launches
    got = get_hard_negs_tfidf(texts, entities, gt, 15, device=dev)
    assert mips_topk_fused.launches == before + 1
    want = get_hard_negs_tfidf(texts, entities, gt, 15, device="cpu")
    compared = 0
    for r in range(64):
        keep = ids[r] != gt[r]
        ok = sep[r][keep][:15]
        np.testing.assert_array_equal(got[r][ok], want[r][ok])
        compared += int(ok.sum())
    assert compared > 0.5 * got.size


def test_native_tokenizer_builds_and_matches_python(dev):
    """The native tokenizer builds with g++ on the card's host into the
    package's build directory and gives the Python WordPiece's ids."""
    import numpy as np

    from anncur_tpu_torch.models.native_tokenizer import NativeWordPieceTokenizer
    from anncur_tpu_torch.models.tokenizer import WordPieceTokenizer, make_realistic_vocab

    vocab = make_realistic_vocab()
    native, python = NativeWordPieceTokenizer(vocab), WordPieceTokenizer(vocab)
    assert native.native_available
    rng = np.random.default_rng(0)
    words = [t for t in vocab if t.isalpha()]
    for text in [" ".join(rng.choice(words, size=120)) for _ in range(20)] + ["naïve café", "x" * 150]:
        assert native.encode(text) == python.encode(text)


def test_sharded_mips_on_a_world_size_1_nccl_mesh_matches_fused(dev):
    """mips_topk_sharded over a 1-rank NCCL group: kernel B on the one
    shard, the candidates all-gathered over NCCL, equal to the JAX-named
    fused_mips_topk (kernel B alone); padding rows never selected."""
    import torch.distributed as dist

    from anncur_tpu_torch.ops.mips import mips_topk_sharded
    from anncur_tpu_torch.ops.mips_kernel import fused_mips_topk
    from anncur_tpu_torch.parallel.mesh import mesh_session

    gen = torch.Generator(device=dev).manual_seed(11)
    q = torch.randn(33, 96, generator=gen, device=dev)
    items = torch.randn(5000, 96, generator=gen, device=dev)
    padded = torch.cat([items, torch.zeros(8, 96, device=dev)])
    with mesh_session(dev) as mesh:
        assert dist.get_backend() == "nccl" and mesh.device == dev
        before = mips_topk_fused.launches
        s, i = mips_topk_sharded(q, padded, 40, mesh, n_valid=5000)
        torch.cuda.synchronize()
        assert mips_topk_fused.launches == before + 1
    assert not dist.is_initialized()
    s_ref, i_ref = fused_mips_topk(q, items, 40)
    assert torch.equal(i, i_ref.to(i.dtype)) and torch.equal(s, s_ref)
    assert int(i.max()) < 5000


# ---------------------------------------------------------------- encoder epilogue

BUILD_ROWS = 2048 * 256  # the build cell's rows: 2,048 pairs of 256 tokens
EPILOGUE_ROWS = [1, 7, 33, BUILD_ROWS]
CE_ATOL = 2e-2  # bf16 CE scores through 12 layers, as chip_smoke's


def _assert_within_one_ulp(got, want, terms=None, chunk_rows=1 << 16):
    """Every element of ``got`` within one bf16 ulp of its magnitude (f32
    sums in another order and the math library's last bits move a value
    across at most one rounding boundary), and at least 99% of them the
    same bits. The magnitude is the larger of the two values, or of
    ``terms`` (per column) where the output is a sum that cancels: the
    LayerNorm's y = g·z + shift keeps f32's error of its terms, so a y
    near 0 is compared in ulps of |shift|."""
    assert got.shape == want.shape and got.dtype == want.dtype == torch.bfloat16
    width = got.shape[-1]
    got, want = got.reshape(-1, width), want.reshape(-1, width)
    floor = torch.full((width,), 2.0 ** -126, device=got.device) if terms is None else terms.abs().float()
    same, worst = 0, 0.0
    for i in range(0, got.shape[0], chunk_rows):
        a, b = got[i:i + chunk_rows].float(), want[i:i + chunk_rows].float()
        mag = torch.maximum(torch.maximum(a.abs(), b.abs()), floor).clamp_min(2.0 ** -126)
        ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
        worst = max(worst, ((a - b).abs() / ulp).max().item())
        same += (a == b).sum().item()
    assert worst <= 1.0, worst
    assert same >= 0.99 * got.numel(), same / got.numel()


def _bf16(gen, dev, *shape, std=1.0, mean=0.0):
    return (torch.randn(*shape, generator=gen, device=dev) * std + mean).to(torch.bfloat16)


def _f32(gen, dev, n, std, mean=0.0):
    return torch.randn(n, generator=gen, device=dev) * std + mean


@pytest.mark.parametrize("width", [768, 40])
@pytest.mark.parametrize("rows", EPILOGUE_ROWS)
def test_bias_residual_layernorm_matches_plain(dev, rows, width):
    gen = torch.Generator(device=dev).manual_seed(rows + width)
    mm, res = _bf16(gen, dev, rows, width), _bf16(gen, dev, rows, width, std=2.0, mean=0.3)
    bias, scale, shift = _f32(gen, dev, width, 0.5), _f32(gen, dev, width, 0.1, 1.0), _f32(gen, dev, width, 0.1)
    before = ee.bias_residual_layernorm.launches
    got = ee.bias_residual_layernorm(mm, bias, res, scale, shift, 1e-12)
    want = ee.bias_residual_layernorm_plain(mm, bias, res, scale, shift, 1e-12)
    torch.cuda.synchronize()
    assert ee.bias_residual_layernorm.launches == before + 1
    _assert_within_one_ulp(got, want, terms=shift)


@pytest.mark.parametrize("width", [1032, ee.MAX_LAYERNORM_WIDTH])
def test_bias_residual_layernorm_takes_widths_up_to_its_cap(dev, width):
    """Widths past three vectors a lane (1,032: 129 vectors, 5 a lane) and
    the cap (4,096: 16 a lane), in three leading dims."""
    gen = torch.Generator(device=dev).manual_seed(width)
    mm, res = _bf16(gen, dev, 3, 11, width), _bf16(gen, dev, 3, 11, width)
    bias, scale, shift = _f32(gen, dev, width, 0.5), _f32(gen, dev, width, 0.1, 1.0), _f32(gen, dev, width, 0.1)
    got = ee.bias_residual_layernorm(mm, bias, res, scale, shift, 1e-5)
    _assert_within_one_ulp(got, ee.bias_residual_layernorm_plain(mm, bias, res, scale, shift, 1e-5), terms=shift)


@pytest.mark.parametrize("approximate", [True, False])
@pytest.mark.parametrize("width", [3072, 88])
@pytest.mark.parametrize("rows", EPILOGUE_ROWS)
def test_bias_gelu_matches_plain(dev, rows, width, approximate):
    gen = torch.Generator(device=dev).manual_seed(rows + width + approximate)
    mm, bias = _bf16(gen, dev, rows, width, std=2.0), _f32(gen, dev, width, 0.5)
    before = ee.bias_gelu.launches
    got = ee.bias_gelu(mm, bias, approximate)
    want = ee.bias_gelu_plain(mm, bias, approximate)
    torch.cuda.synchronize()
    assert ee.bias_gelu.launches == before + 1
    _assert_within_one_ulp(got, want)


@pytest.mark.parametrize(
    "rows_q,rows_kv,width",
    [(1, 7, 768), (33, 33, 40), (2048, BUILD_ROWS, 768), (BUILD_ROWS, BUILD_ROWS, 768), (7, 1, 88)],
)
def test_bias_add3_is_the_plain_adds_bit_for_bit(dev, rows_q, rows_kv, width):
    gen = torch.Generator(device=dev).manual_seed(rows_q + rows_kv + width)
    xs = [_bf16(gen, dev, rows, width) for rows in (rows_q, rows_kv, rows_kv)]
    bs = [_f32(gen, dev, width, 0.5) for _ in range(3)]
    want = ee.bias_add3_plain(*(x.clone() for x in xs), *bs)
    before = ee.bias_add3.launches
    got = ee.bias_add3(*xs, *bs)
    torch.cuda.synchronize()
    assert ee.bias_add3.launches == before + 1
    for x, g, w in zip(xs, got, want):
        assert g is x  # in place
        assert torch.equal(g, w)


@pytest.mark.parametrize("entry", ["bias_residual_layernorm", "bias_gelu", "bias_add3"])
def test_epilogue_entries_reject_what_they_cannot_take(dev, entry):
    def args(x, vec):
        return {
            "bias_residual_layernorm": (x, vec, x, vec, vec, 1e-12),
            "bias_gelu": (x, vec, True),
            "bias_add3": (x, x.clone(), x.clone(), vec, vec, vec),
        }[entry]

    fn = getattr(ee, entry)
    x, vec = torch.zeros(4, 64, dtype=torch.bfloat16, device=dev), torch.zeros(64, device=dev)
    for bad, match in (
        (args(x.float(), vec), "bf16"),
        (args(torch.zeros(64, 8, dtype=torch.bfloat16, device=dev).t(), vec), "contiguous"),
        (args(x[:, :60].contiguous(), vec[:60]), "multiple of 8"),
        (args(x.cpu(), vec), "CUDA"),  # mixed devices: only all-CPU arguments take the plain version
        (args(x, vec.to(torch.bfloat16)), "f32"),
    ):
        with pytest.raises(ValueError, match=match):
            fn(*bad)
    if entry == "bias_residual_layernorm":
        wide = torch.zeros(2, ee.MAX_LAYERNORM_WIDTH + 8, dtype=torch.bfloat16, device=dev)
        with pytest.raises(ValueError, match="above"):
            fn(*args(wide, torch.zeros(wide.shape[1], device=dev)))


# (weight std, CE_ATOL or None): chip_smoke's CE at bert-base's 0.02, where
# the fused and plain forwards lie within CE_ATOL of each other; the
# benchmark's 0.05, where 12 random layers amplify any rounding difference
# to the bf16 forward's own distance from f32 (~0.05 at the worst pair), so
# each is held against the f32 forward instead
@pytest.mark.parametrize("std,atol", [(0.02, CE_ATOL), (0.05, None)])
def test_ce_forward_fused_matches_plain_and_counts_launches(dev, monkeypatch, std, atol):
    """A bert-base CE forward over 2,048 pairs of 256 tokens with random key
    lengths launches 24 / 12 / 12 of the epilogue kernels; against the plain
    ops it agrees within ``atol``, and its mean distance from the f32
    forward (the same weights) is at most 1.1x the plain forward's."""
    from anncur_tpu_torch.models import bert
    from anncur_tpu_torch.models.bert import BertSpec
    from anncur_tpu_torch.models.crossencoder import CrossEncoder

    spec = BertSpec(initializer_range=std)
    ce = CrossEncoder(spec, compute_dtype=torch.bfloat16, device=dev, seed=3)
    gen = torch.Generator(device=dev).manual_seed(11)
    b, s = 2048, 256
    toks = torch.randint(1000, spec.vocab_size, (b, s), generator=gen, device=dev)
    lengths = torch.randint(130, s + 1, (b,), generator=gen, device=dev)
    toks = toks.masked_fill(torch.arange(s, device=dev)[None, :] >= lengths[:, None], 0)
    names = ("bias_residual_layernorm", "bias_gelu", "bias_add3")
    before = [getattr(ee, n).launches for n in names]
    got = ce.score(toks, first_segment_end=128)
    torch.cuda.synchronize()
    assert [getattr(ee, n).launches - n0 for n, n0 in zip(names, before)] == [24, 12, 12]
    f32 = CrossEncoder(spec, compute_dtype=torch.float32, device=dev, seed=3).score(toks, first_segment_end=128)
    monkeypatch.setattr(bert, "_fuses_epilogue", lambda *args: False)
    want = ce.score(toks, first_segment_end=128)
    assert [getattr(ee, n).launches - n0 for n, n0 in zip(names, before)] == [24, 12, 12]
    if atol is not None:
        err = (got - want).abs().max().item()
        assert err <= atol, err
    fused_err, plain_err = (got - f32).abs().mean().item(), (want - f32).abs().mean().item()
    assert fused_err <= 1.1 * plain_err, (fused_err, plain_err)
    assert f32.std().item() > 5 * CE_ATOL  # pairs told apart
