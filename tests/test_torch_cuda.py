"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: every test skips without a CUDA card (the CPU tests hold
the plain versions against the JAX package). Run on a GPU host with

    python -m pytest tests/test_torch_cuda.py -q
"""

import pytest
import torch

from anncur_tpu_torch.ops.attention import attention, attention_plain
from anncur_tpu_torch.ops.mips import mips_topk
from anncur_tpu_torch.ops.mips_kernel import mips_topk_fused

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


def test_attention_kernel_rejects_what_it_cannot_take(dev):
    q, k, v, valid, _ = _attn_case(dev, 2, 8, 8, 2, 16, torch.float32, seed=0)
    with pytest.raises(ValueError, match="head dim"):
        attention(q[..., :8], k[..., :8], v[..., :8], valid)
    with pytest.raises(ValueError, match="bf16 or f32"):
        attention(q.half(), k.half(), v.half(), valid)
    with pytest.raises(ValueError, match="one CUDA device"):
        attention(q, k, v, valid.cpu())


@pytest.mark.parametrize(
    "q,d,n,n_valid,k",
    [
        (32, 500, 10240, 10000, 100),  # the query path's shape
        (5, 7, 100, 100, 1),  # one split, k = 1
        (9, 33, 1000, 700, 256),  # k at its cap
        (3, 64, 70000, 69999, 100),  # 274 splits: two merge levels
    ],
)
def test_mips_kernel_matches_plain(dev, q, d, n, n_valid, k):
    gen = torch.Generator(device=dev).manual_seed(n + k)
    # small integers: exact f32 products, so many exact ties to order
    queries = torch.randint(-2, 3, (q, d), generator=gen, device=dev).float()
    items = torch.randint(-2, 3, (n, d), generator=gen, device=dev).float()
    before = mips_topk_fused.launches
    s_k, i_k = mips_topk_fused(queries, items, k, n_valid)
    s_p, i_p = mips_topk(queries, items, k, n_valid)
    torch.cuda.synchronize()
    assert mips_topk_fused.launches == before + 1
    assert i_k.dtype == torch.int64 and s_k.dtype == torch.float32
    # exact products: the same scores and, ties to the smallest id, the same ids
    assert torch.equal(s_k, s_p)
    assert torch.equal(i_k, i_p)


def test_mips_kernel_rejects_what_it_cannot_take(dev):
    queries = torch.randn(4, 8, device=dev)
    items = torch.randn(300, 8, device=dev)
    with pytest.raises(ValueError):
        mips_topk_fused(queries, items, 257)
    with pytest.raises(ValueError):
        mips_topk_fused(queries, items, 10, n_valid=5)
    with pytest.raises(ValueError):
        mips_topk_fused(queries.double(), items.double(), 10)
    with pytest.raises(ValueError):
        mips_topk_fused(queries, items.T.contiguous().T, 10)
