"""The encoder layer's epilogue (``ops/encoder_epilogue.py``) on the CPU:
each ``*_plain`` against the unfused ops of ``models/bert.py`` bit for
bit, the entries on CPU tensors, the fused branch of ``_encoder_layer``
(whose entries give the plain versions on the CPU) against the plain
branch, and the plain branch wherever the fused one must not run (the
kernels themselves: tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

from anncur_tpu_torch.models import bert
from anncur_tpu_torch.ops import cuda_build
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


def _refuse_libraries(monkeypatch):
    """Loading a kernel library fails the test."""
    def refuse(name):
        raise AssertionError(f"the {name} library was loaded")

    monkeypatch.setattr(cuda_build, "load", refuse)


@pytest.mark.parametrize("entry", ENTRIES)
def test_entries_refuse_cpu_tensors(entry, monkeypatch):
    """The entries keep CPU tensors from their kernels: they give the
    plain composition, bit for bit, and load no library."""
    gen = torch.Generator().manual_seed(4)
    x, res, x2, x3 = (_randn(gen, 4, 16).to(torch.bfloat16) for _ in range(4))
    vecs = [_randn(gen, 16) for _ in range(3)]
    args = {
        "bias_residual_layernorm": (x, vecs[0], res, 1.0 + vecs[1], vecs[2], 1e-12),
        "bias_gelu": (x, vecs[0], True),
        "bias_add3": (x, x2, x3, *vecs),
    }[entry]
    want = getattr(ee, f"{entry}_plain")(*(a.clone() if isinstance(a, torch.Tensor) else a for a in args))
    _refuse_libraries(monkeypatch)
    got = getattr(ee, entry)(*args)
    for g, w in zip(got if entry == "bias_add3" else [got], want if entry == "bias_add3" else [want]):
        assert torch.equal(g, w)
    assert not cuda_build._LOADED


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


def _plain_branch(tiny, **kw):
    """The forward with every layer on the plain branch."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(bert, "_fuses_epilogue", lambda *args: False)
        return _encode(tiny, **kw)


def _counting(monkeypatch, module, suffix=""):
    """Each of ``module``'s ``<entry><suffix>`` wrapped, its calls counted."""
    calls = dict.fromkeys(ENTRIES, 0)

    def counted(name, fn):
        def call(*args):
            calls[name] += 1
            return fn(*args)

        return call

    for name in ENTRIES:
        monkeypatch.setattr(module, name + suffix, counted(name, getattr(module, name + suffix)))
    return calls


@pytest.mark.parametrize("rows", ["every", "cls_only", "out_positions", "grad_on_nothing_requires_it"])
def test_fused_branch_through_the_plain_versions_equals_the_plain_branch(tiny, monkeypatch, rows):
    """The fused branch on the CPU, where each entry gives its plain
    version, is the plain branch bit for bit, at every row set of the final
    layer, and calls the entries 2 / 1 / 1 times a layer. Grad mode on with
    nothing that requires grad records no graph, so it takes the fused
    branch."""
    kw = {"cls_only": {"cls_only": True},
          "out_positions": {"out_positions": torch.tensor([[0, 5], [3, 1], [7, 7]])}}.get(rows, {})
    with torch.no_grad():
        want = _plain_branch(tiny, **kw)
    calls = _counting(monkeypatch, bert)
    with torch.set_grad_enabled(rows == "grad_on_nothing_requires_it"):
        got = _encode(tiny, **kw)
    n_layers = tiny[0].num_layers
    assert calls == {"bias_residual_layernorm": 2 * n_layers, "bias_gelu": n_layers, "bias_add3": n_layers}
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _refusing(monkeypatch):
    """Each entry as seen from models/bert.py raises."""
    def refuse(*args):
        raise AssertionError("the fused epilogue ran off its path")

    for name in ENTRIES:
        monkeypatch.setattr(bert, name, refuse)


@pytest.mark.parametrize("case", ["grad", "dropout", "f32", "cpu", "tp"])
def test_plain_branch_where_the_fused_one_must_not_run(tiny, monkeypatch, case):
    """Under autograd with parameters that require grad, with dropout, at
    f32 and for tensor-parallel layers, ``bert_encode`` never reaches an
    epilogue entry and gives what it gave before. On the CPU at bf16 the
    model takes the fused branch, as on the card, and the entries give
    their plain compositions (each called, no library loaded): the plain
    branch's result, bit for bit."""
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
    if case == "cpu":
        want = _plain_branch(tiny)
        calls = _counting(monkeypatch, ee, "_plain")
        _refuse_libraries(monkeypatch)
        got = run()
        n_layers = tiny[0].num_layers
        assert calls == {"bias_residual_layernorm": 2 * n_layers, "bias_gelu": n_layers, "bias_add3": n_layers}
    else:
        want = run()
        _refusing(monkeypatch)
        got = run()
    for g, w in zip(got, want):
        assert torch.equal(g, w)

