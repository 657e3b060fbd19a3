"""The encoder layer's epilogue (``ops/encoder_epilogue.py``) on the CPU:
each ``*_plain`` against the unfused ops of ``models/bert.py`` bit for
bit, the fused branch of ``_encoder_layer`` wired through the plain
versions against the plain branch, and the plain branch wherever the
fused one must not run (the kernels themselves: tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

from anncur_tpu_torch.models import bert
from anncur_tpu_torch.ops import encoder_epilogue as ee

torch.set_num_threads(2)  # xdist runs several test files side by side

DTYPES = [torch.bfloat16, torch.float32]
ENTRIES = ("bias_residual_layernorm", "bias_gelu", "bias_add3")


def _randn(gen, *shape, std=1.0):
    return torch.randn(*shape, generator=gen) * std


def _dense_inputs(seed, rows=37, width=64, out=48):
    gen = torch.Generator().manual_seed(seed)
    x = _randn(gen, rows, width)
    return x, _randn(gen, width, out, std=0.2), _randn(gen, out, std=0.5), gen


@pytest.mark.parametrize("dtype", DTYPES)
def test_bias_residual_layernorm_plain_is_the_unfused_ops(dtype):
    x, w, b, gen = _dense_inputs(1)
    res = _randn(gen, x.shape[0], w.shape[1]).to(dtype)
    scale, shift = 1.0 + _randn(gen, w.shape[1], std=0.1), _randn(gen, w.shape[1], std=0.1)
    x = x.to(dtype)
    want = bert._layer_norm(res + bert._dense(x, w, b, dtype), scale, shift, 1e-12)
    got = ee.bias_residual_layernorm_plain(x @ w.to(dtype), b, res, scale, shift, 1e-12)
    assert got.dtype == dtype
    assert torch.equal(got, want)


@pytest.mark.parametrize("approximate", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
def test_bias_gelu_plain_is_the_unfused_ops(dtype, approximate):
    x, w, b, _ = _dense_inputs(2)
    x = x.to(dtype)
    want = bert._gelu(bert._dense(x, w, b, dtype), approximate)
    got = ee.bias_gelu_plain(x @ w.to(dtype), b, approximate)
    assert got.dtype == dtype
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
def test_bias_add3_plain_is_the_unfused_ops_in_place(dtype):
    gen = torch.Generator().manual_seed(3)
    xs = [_randn(gen, rows, 64).to(dtype) for rows in (1, 40, 40)]
    ws = [_randn(gen, 64, 64, std=0.2) for _ in range(3)]
    bs = [_randn(gen, 64) for _ in range(3)]
    want = [bert._dense(x, w, b, dtype) for x, w, b in zip(xs, ws, bs)]
    mms = [x @ w.to(dtype) for x, w in zip(xs, ws)]
    got = ee.bias_add3_plain(*mms, *bs)
    for g, m, wnt in zip(got, mms, want):
        assert g is m  # in place
        assert torch.equal(g, wnt)


@pytest.mark.parametrize("entry", ENTRIES)
def test_entries_refuse_cpu_tensors(entry):
    x = torch.zeros(4, 16, dtype=torch.bfloat16)
    vec = torch.zeros(16)
    args = {
        "bias_residual_layernorm": (x, vec, x, vec, vec, 1e-12),
        "bias_gelu": (x, vec, True),
        "bias_add3": (x, x.clone(), x.clone(), vec, vec, vec),
    }[entry]
    with pytest.raises(ValueError, match="CUDA"):
        getattr(ee, entry)(*args)


# ---------------------------------------------------------------- the layer's path


@pytest.fixture(scope="module")
def tiny():
    spec = bert.BertSpec.tiny()
    tree = bert.init_bert_params(np.random.default_rng(0), spec)
    rng = np.random.default_rng(1)
    for lp in tree["layers"]:  # biases and LayerNorm parameters away from 0 and 1
        for block in lp.values():
            for key, val in block.items():
                if key.endswith("bias") or key.startswith("ln_"):
                    block[key] = val + rng.standard_normal(val.shape).astype(np.float32) * 0.1
    toks = rng.integers(5, spec.vocab_size, size=(3, 24))
    mask = np.ones_like(toks)
    mask[1, 9:] = 0
    return spec, tree, torch.as_tensor(toks), torch.as_tensor(mask)


def _encode(tiny, dtype=torch.bfloat16, params=None, **kw):
    spec, tree, toks, mask = tiny
    params = bert.params_module(tree, torch.device("cpu")) if params is None else params
    return bert.bert_encode(params, toks, torch.zeros_like(toks), mask, spec, dtype, **kw)


def _counting_plain(monkeypatch):
    """Each entry as seen from models/bert.py replaced by its plain version,
    its calls counted; the CPU taken for the card."""
    calls = dict.fromkeys(ENTRIES, 0)

    def counted(name):
        plain = getattr(ee, f"{name}_plain")

        def call(*args):
            calls[name] += 1
            return plain(*args)

        return call

    monkeypatch.setattr(bert, "_on_card", lambda x: True)
    for name in ENTRIES:
        monkeypatch.setattr(bert, name, counted(name))
    return calls


@pytest.mark.parametrize("rows", ["every", "cls_only", "out_positions", "grad_on_nothing_requires_it"])
def test_fused_branch_through_the_plain_versions_equals_the_plain_branch(tiny, monkeypatch, rows):
    """The fused branch with each kernel replaced by its plain version is
    the plain branch bit for bit, at every row set of the final layer, and
    calls the entries 2 / 1 / 1 times a layer. Grad mode on with nothing
    that requires grad records no graph, so it takes the fused branch."""
    kw = {"cls_only": {"cls_only": True},
          "out_positions": {"out_positions": torch.tensor([[0, 5], [3, 1], [7, 7]])}}.get(rows, {})
    with torch.no_grad():
        want = _encode(tiny, **kw)
    calls = _counting_plain(monkeypatch)
    with torch.set_grad_enabled(rows == "grad_on_nothing_requires_it"):
        got = _encode(tiny, **kw)
    n_layers = tiny[0].num_layers
    assert calls == {"bias_residual_layernorm": 2 * n_layers, "bias_gelu": n_layers, "bias_add3": n_layers}
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _refusing(monkeypatch, on_card=True):
    """Each entry as seen from models/bert.py raises; the CPU taken for the
    card unless ``on_card`` is False."""
    def refuse(*args):
        raise AssertionError("the fused epilogue ran off its path")

    if on_card:
        monkeypatch.setattr(bert, "_on_card", lambda x: True)
    for name in ENTRIES:
        monkeypatch.setattr(bert, name, refuse)


@pytest.mark.parametrize("case", ["grad", "dropout", "f32", "cpu", "tp"])
def test_plain_branch_where_the_fused_one_must_not_run(tiny, monkeypatch, case):
    """Under autograd with parameters that require grad, with dropout, at
    f32, on the CPU and for tensor-parallel layers, ``bert_encode`` never
    reaches an epilogue entry and gives what it gave before."""
    dtype = torch.float32 if case == "f32" else torch.bfloat16
    kw = {}
    if case == "dropout":
        kw = {"dropout_on": True}

    def run():
        params = bert.params_module(tiny[1], torch.device("cpu"))
        if case == "grad":
            params.requires_grad_(True)
        if case == "tp":
            for lp in params["layers"]:
                lp.tp_group = object()  # world size 1: the collectives below are identities
        if case == "dropout":
            kw["generator"] = torch.Generator().manual_seed(5)
        with torch.set_grad_enabled(case == "grad"):
            seq, pooled = _encode(tiny, dtype, params=params, **kw)
        return seq.detach(), pooled.detach()

    if case == "tp":
        monkeypatch.setattr(bert, "copy_to_tp", lambda x, group: x)
        monkeypatch.setattr(bert, "reduce_from_tp", lambda x, group: x)
    want = run()
    _refusing(monkeypatch, on_card=case != "cpu")
    got = run()
    for g, w in zip(got, want):
        assert torch.equal(g, w)

