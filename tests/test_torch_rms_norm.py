"""RMSNorm (``ops/rms_norm.py``) and the decoder CE's use of it
(``models/deepseek_v2.py``).

On the CPU: ``rms_norm_plain`` is the source's composition bit for bit;
the model calls the entry for every norm; the entry places itself by
``cuda_build.on_cpu``: the plain composition for CPU tensors, and
otherwise the kernel (``on_cpu`` made to report the card), whose checks
refuse f32 and inputs that record an autograd graph. Tests marked ``cuda``
hold the kernel to the plain composition on the card and count a
forward's launches at the published widths; they skip without one:

    python -m pytest tests/test_torch_rms_norm.py -q -m cuda --noconftest
"""

import pytest
import torch

from anncur_tpu_torch.models import deepseek_v2 as dsv2
from anncur_tpu_torch.ops import cuda_build
from anncur_tpu_torch.ops import rms_norm as rn

EPS = 1e-6


def _source_composition(x, weight, eps):
    """The source's RMSNorm written out: normalised in f32, rounded to x's
    dtype, then times the weight."""
    xf = x.float()
    variance = xf.pow(2).mean(-1, keepdim=True)
    return weight * (xf * torch.rsqrt(variance + eps)).to(x.dtype)


def _inputs(gen, rows, width, dtype, stride=None, std=1.0):
    """(x, weight): rows of ``width`` (the first columns of rows ``stride``
    wide when given), weights around 1."""
    x = (torch.randn(rows, stride or width, generator=gen) * std).to(dtype)[:, :width]
    return x, (1.0 + 0.3 * torch.randn(width, generator=gen)).to(dtype)


@pytest.mark.parametrize("case", ["bf16", "f32", "bf16_strided", "bf16_3d", "bf16_near_zero"])
def test_rms_norm_plain_is_the_source_composition(case):
    gen = torch.Generator().manual_seed(1)
    dtype = torch.float32 if case == "f32" else torch.bfloat16
    x, w = _inputs(gen, 37, 512, dtype, stride=576 if case == "bf16_strided" else None,
                   std=1e-4 if case == "bf16_near_zero" else 1.0)
    if case == "bf16_3d":
        x = x[:36].reshape(4, 9, 512)
    got = rn.rms_norm_plain(x, w, EPS)
    assert got.dtype == dtype and got.shape == x.shape
    assert torch.equal(got, _source_composition(x, w, EPS))


# ------------------------------------------------------- the model's path


def _tiny():
    spec = dsv2.DeepseekV2Spec(
        vocab_size=300, hidden_size=64, num_layers=3, num_heads=4, intermediate_size=96, moe_intermediate_size=16,
        n_routed_experts=8, n_shared_experts=1, num_experts_per_tok=2, kv_lora_rank=32, qk_nope_head_dim=16,
        qk_rope_head_dim=8, v_head_dim=16)
    w = dsv2.init_weights(spec, torch.Generator().manual_seed(1), "cpu", torch.bfloat16, std=0.1)
    gen = torch.Generator().manual_seed(2)
    for lw in [w] + w["layers"]:  # norm weights away from 1
        for name in dsv2.NORMS:
            if name in lw:
                lw[name] = (1.0 + 0.3 * torch.randn(lw[name].shape, generator=gen)).to(torch.bfloat16)
    ids = torch.randint(1, spec.vocab_size, (5, 20), generator=gen)
    ids[1, 13:] = 0
    ids[3, 6:] = 0
    return spec, w, ids


def test_the_model_takes_the_kernel_on_the_card_for_every_norm(monkeypatch):
    """A bf16 forward calls the entry, which takes the kernel on the card,
    for every norm (3 a layer and the final one); on the CPU each call
    gives the plain composition, and the scores are those of the source's
    composition written out, bit for bit."""
    spec, w, ids = _tiny()
    monkeypatch.setattr(dsv2, "rms_norm", _source_composition)
    want = dsv2.DeepseekV2CrossEncoder(spec, "cpu", weights=w).score(ids, 8)
    calls = {"entry": 0, "plain": 0}

    def counted(name, fn):
        def call(*args):
            calls[name] += 1
            return fn(*args)

        return call

    monkeypatch.setattr(dsv2, "rms_norm", counted("entry", rn.rms_norm))
    monkeypatch.setattr(rn, "rms_norm_plain", counted("plain", rn.rms_norm_plain))
    got = dsv2.DeepseekV2CrossEncoder(spec, "cpu", weights=w).score(ids, 8)
    assert calls == {"entry": 3 * spec.num_layers + 1, "plain": 3 * spec.num_layers + 1}
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", ["bf16", "f32", "f32_weight", "x_requires_grad", "weight_requires_grad"])
def test_cpu_tensors_take_the_plain_composition(monkeypatch, case):
    """On the CPU the entry gives the plain composition, whatever the dtype
    and whether autograd records a graph, and never loads the kernel."""
    x, w = _path_inputs(case)

    def refuse(*args):
        raise AssertionError("the RMSNorm kernel ran on the CPU")

    monkeypatch.setattr(cuda_build, "load", refuse)
    got = rn.rms_norm(x, w, EPS)
    assert torch.equal(got, rn.rms_norm_plain(x, w, EPS))
    assert got.requires_grad == case.endswith("requires_grad")


@pytest.mark.parametrize("case", ["f32", "f32_weight", "x_requires_grad", "weight_requires_grad"])
def test_on_the_card_the_kernel_refuses_what_it_cannot_take(monkeypatch, case):
    """``on_cpu`` made to report the card: the entry takes the kernel by the
    device alone, so f32 inputs and inputs that record an autograd graph
    reach the kernel's checks, which raise on them (before they look at the
    device) instead of giving way to the plain composition."""
    x, w = _path_inputs(case)

    def refuse(*args):
        raise AssertionError("the plain RMSNorm ran on the card")

    monkeypatch.setattr(cuda_build, "on_cpu", lambda *tensors: False)
    monkeypatch.setattr(rn, "rms_norm_plain", refuse)
    with pytest.raises(ValueError, match="bf16" if case.startswith("f32") else "requires grad"):
        rn.rms_norm(x, w, EPS)


def _path_inputs(case):
    gen = torch.Generator().manual_seed(3)
    x, w = _inputs(gen, 9, 64, torch.float32 if case == "f32" else torch.bfloat16)
    if case == "f32_weight":
        w = w.float()
    x.requires_grad_(case == "x_requires_grad")
    w.requires_grad_(case == "weight_requires_grad")
    return x, w


def test_the_entry_refuses_cpu_tensors(monkeypatch):
    """The entry keeps CPU tensors from its kernel: at the strided kv_norm
    view of bf16 rows it gives the plain composition, bit for bit, and
    loads no library."""
    x, w = _inputs(torch.Generator().manual_seed(4), 9, 512, torch.bfloat16, stride=576)

    def refuse(name):
        raise AssertionError(f"the {name} library was loaded")

    monkeypatch.setattr(cuda_build, "load", refuse)
    assert torch.equal(rn.rms_norm(x, w, EPS), _source_composition(x, w, EPS))
    assert not cuda_build._LOADED


# ------------------------------------------------------------------ card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["2048", "512_of_576", "1000", "near_zero", "3d"])
def test_kernel_against_the_plain_composition(case):
    """The kernel at the cell's width, at kv_norm's strided view, at a width
    that is not a power of two, on rows near zero (below eps, exact zeros,
    values whose squares are f32 subnormals) and over three dims, each
    element bit-equal or within one bf16 ulp."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(5)
    rows, width, stride = {"2048": (4099, 2048, None), "512_of_576": (4099, 512, 576), "1000": (4099, 1000, None),
                           "near_zero": (600, 2048, None), "3d": (3 * 333, 2048, None)}[case]
    x = torch.randn(rows, stride or width, generator=gen, device=dev).to(torch.bfloat16)[:, :width]
    if case == "near_zero":
        x[:200] *= 1e-4
        x[200:400] = 0
        x[400:] *= 1e-21
    if case == "3d":
        x = x.reshape(3, 333, width)
    w = (1.0 + 0.3 * torch.randn(width, generator=gen, device=dev)).to(torch.bfloat16)
    rn.rms_norm.launches = 0
    got = rn.rms_norm(x, w, EPS)
    torch.cuda.synchronize()
    assert rn.rms_norm.launches == 1
    assert got.shape == x.shape and got.is_contiguous()
    within, same = rn.within_one_ulp(got, x, w, EPS)
    assert within, f"{case}: {1 - same:.4%} of elements not bit-equal, some beyond one bf16 ulp"
    print(f"rms_norm {case}: {1 - same:.4%} of elements not bit-equal")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["f32", "width_12", "width_2056", "stride_580", "columns_apart", "weight_f32",
                                  "x_requires_grad", "weight_requires_grad"])
def test_kernel_refuses_what_it_cannot_take(case):
    dev = _card()
    x = torch.zeros(8, 1024, dtype=torch.bfloat16, device=dev)
    w = torch.ones(512, dtype=torch.bfloat16, device=dev)
    args = {
        "f32": (x[:, :512].float(), w),
        "width_12": (x[:, :12], w[:12]),
        "width_2056": (torch.zeros(2, 2056, dtype=torch.bfloat16, device=dev),
                       torch.ones(2056, dtype=torch.bfloat16, device=dev)),
        "stride_580": (x.view(-1)[:8 * 580].view(8, 580)[:, :512], w),
        "columns_apart": (x[:, ::2], w),
        "weight_f32": (x[:, :512], w.float()),
        "x_requires_grad": (x[:, :512].clone().requires_grad_(), w),
        "weight_requires_grad": (x[:, :512], w.clone().requires_grad_()),
    }[case]
    with pytest.raises(ValueError):
        rn.rms_norm(*args, EPS)


@pytest.mark.cuda
def test_the_cells_forward_counts_82_launches_and_no_plain_norm(monkeypatch):
    """DeepSeek-V2-Lite at its published widths (27 layers, random weights
    on the card) over 4 pairs of 256 tokens: one kernel launch a norm, 82
    in all (attn_norm, kv_norm and mlp_norm in each layer, the final norm),
    and the plain composition never."""
    dev = _card()

    def refuse(*args):
        raise AssertionError("the plain RMSNorm ran on the card")

    monkeypatch.setattr(rn, "rms_norm_plain", refuse)
    ce = dsv2.DeepseekV2CrossEncoder(dsv2.DeepseekV2Spec(), dev, seed=5)
    gen = torch.Generator(device=dev).manual_seed(6)
    ids = torch.randint(1, 100000, (4, 256), generator=gen, device=dev)
    ids[1, 200:] = 0
    rn.rms_norm.launches = 0
    scores = ce.score(ids, 128)
    torch.cuda.synchronize()
    assert rn.rms_norm.launches == 82
    assert torch.isfinite(scores).all()
