"""Port parity, models: tokenizer/tokenization copies, BERT encoder, the
cross-encoder heads and the attention plain version, held against the JAX
package on the same numpy inputs (CPU)."""

import ast
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from anncur_tpu.data.synthetic import make_tokenized_world, make_world
from anncur_tpu.data.tokenization import tokenize_entities as jax_tokenize_entities
from anncur_tpu.data.tokenization import tokenize_mentions as jax_tokenize_mentions
from anncur_tpu.models import bert as jbert
from anncur_tpu.models.crossencoder import CrossEncoder as JaxCrossEncoder
from anncur_tpu.models.tokenizer import WordPieceTokenizer as JaxTokenizer
from anncur_tpu.models.tokenizer import make_test_vocab as jax_make_test_vocab

from anncur_tpu_torch.data.tokenization import tokenize_entities, tokenize_mentions
from anncur_tpu_torch.models import bert as tbert
from anncur_tpu_torch.models.convert import crossencoder_from_jax_params
from anncur_tpu_torch.models.crossencoder import CrossEncoder
from anncur_tpu_torch.models.tokenizer import WordPieceTokenizer, make_test_vocab
from anncur_tpu_torch.ops.attention import attention, attention_plain

torch.set_num_threads(2)  # xdist runs several test files side by side

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
# f32 on both sides: the two frameworks sum in other orders, nothing else
F32_ATOL = 1e-4
# bf16: each of the 2 layers rounds its activations to 8 mantissa bits at
# different places in the two frameworks (e.g. JAX rounds the attention
# probabilities to bf16 before P@V, the port's plain attention does not)
BF16_ATOL = 3e-2


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tokens_with_padding(rng, vocab, b, s):
    """Random ids with per-row padding lengths; row 1 is all padding but CLS."""
    toks = rng.integers(5, vocab, size=(b, s)).astype(np.int32)
    lengths = rng.integers(2, s + 1, size=b)
    lengths[1] = 1
    for r, n in enumerate(lengths):
        toks[r, n:] = 0
    return toks


# ---------------------------------------------------------------- tokens


def test_tokenizer_and_tokenization_copies_give_identical_ids():
    words = ["alpha", "beta", "castle", "dragon"]
    jt, tt = JaxTokenizer(jax_make_test_vocab(words)), WordPieceTokenizer(make_test_vocab(words))
    assert tt.vocab == jt.vocab
    for text in ["Alpha beta, CASTLE!", "dragonbeta x9 [unused0]", "Élan—naïve 漢字 'q'"]:
        assert tt.encode(text) == jt.encode(text)
    mentions, entities = make_world(np.random.default_rng(3), n_ents=12, n_ments=10)
    np.testing.assert_array_equal(
        tokenize_mentions(mentions, tt, 24), jax_tokenize_mentions(mentions, jt, 24)
    )
    np.testing.assert_array_equal(
        tokenize_entities(entities, tt, 20), jax_tokenize_entities(entities, jt, 20)
    )


# ---------------------------------------------------------------- bert


@pytest.fixture(scope="module")
def bert_setup():
    spec_j = jbert.BertSpec.tiny()
    spec_t = tbert.BertSpec.tiny()
    params = _numpy_tree(jbert.init_bert_params(jax.random.PRNGKey(0), spec_j))
    rng = np.random.default_rng(0)
    toks = _tokens_with_padding(rng, spec_j.vocab_size, 4, 24)
    seg = (np.arange(24)[None, :] >= 10).astype(np.int32) * (toks != 0)
    mask = (toks != 0).astype(np.int32)
    pos = np.stack([rng.permutation(24)[:3] for _ in range(4)]).astype(np.int32)
    return spec_j, spec_t, params, toks, seg, mask, pos


@pytest.mark.parametrize("mode", ["full", "cls_only", "out_positions"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_bert_encode_matches_jax(bert_setup, mode, dtype):
    spec_j, spec_t, params, toks, seg, mask, pos = bert_setup
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    atol = F32_ATOL if dtype == "f32" else BF16_ATOL
    kw_j = {"cls_only": mode == "cls_only", "out_positions": jnp.asarray(pos) if mode == "out_positions" else None}
    kw_t = {"cls_only": mode == "cls_only", "out_positions": torch.as_tensor(pos) if mode == "out_positions" else None}
    seq_j, pooled_j = jbert.bert_encode(
        params, jnp.asarray(toks), jnp.asarray(seg), jnp.asarray(mask), spec_j, compute_dtype=jdt, **kw_j
    )
    seq_t, pooled_t = tbert.bert_encode(
        tbert.params_module(params, CPU), torch.as_tensor(toks), torch.as_tensor(seg),
        torch.as_tensor(mask), spec_t, compute_dtype=tdt, **kw_t,
    )
    assert seq_t.dtype == torch.float32 and tuple(seq_t.shape) == np.shape(seq_j)
    # every row is compared, padded rows included: both sides attend with
    # the same -1e9 key bias, so even the all-padding row 1 agrees
    np.testing.assert_allclose(seq_t.numpy(), np.asarray(seq_j), atol=atol, rtol=0)
    if mode != "out_positions":
        np.testing.assert_allclose(pooled_t.numpy(), np.asarray(pooled_j), atol=atol, rtol=0)


def test_attention_plain_matches_attn_core_at_real_rows():
    rng = np.random.default_rng(1)
    b, s, nh, hd = 3, 20, 4, 16
    q, k, v = (rng.standard_normal((b, s, nh, hd)).astype(np.float32) for _ in range(3))
    lengths = np.array([20, 7, 1])
    valid = np.arange(s)[None, :] < lengths[:, None]
    bias = np.where(valid, 0.0, -1e9).astype(np.float32)[:, None, None, :]
    want = jbert._attn_core(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(bias), None, jnp.float32, 0.0, "bqnk"
    )
    got = attention_plain(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v), torch.as_tensor(valid))
    for r, n in enumerate(lengths):
        np.testing.assert_allclose(got[r, :n].numpy(), np.asarray(want)[r, :n], atol=1e-5, rtol=1e-5)
    # the wrapper takes the plain version for CPU tensors, and a query
    # slice (g < s) is the matching rows of the full result
    sliced = attention(torch.as_tensor(q[:, :3]), torch.as_tensor(k), torch.as_tensor(v), torch.as_tensor(valid))
    np.testing.assert_allclose(sliced.numpy(), got[:, :3].numpy(), atol=1e-6, rtol=0)
    assert attention.launches == 0


# ---------------------------------------------------------------- heads


@pytest.mark.parametrize("cross_enc_type", ["default", "w_embeds"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_crossencoder_heads_match_jax(cross_enc_type, dtype):
    ment, ent, _, tok = make_tokenized_world(seed=2, n_ents=6, n_ments=4, max_ment_len=16, max_ent_len=16)
    spec_j = jbert.BertSpec.tiny(vocab_size=tok.vocab_size, max_position_embeddings=32)
    spec_t = tbert.BertSpec.tiny(vocab_size=tok.vocab_size, max_position_embeddings=32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    ce_j = JaxCrossEncoder(spec=spec_j, cross_enc_type=cross_enc_type, compute_dtype=jdt)
    params = _numpy_tree(ce_j.init(jax.random.PRNGKey(1)))
    ce_t = crossencoder_from_jax_params(params, spec_t, cross_enc_type, device="cpu", dtype=tdt)
    pairs = np.concatenate(
        [np.repeat(ment, len(ent), 0), np.tile(ent[:, 1:], (len(ment), 1))], axis=1
    )
    pairs = np.pad(pairs, ((0, 0), (0, 32 - pairs.shape[1])))
    want = np.asarray(ce_j.score(params, jnp.asarray(pairs), first_segment_end=16))
    got = ce_t.score(pairs, first_segment_end=16).numpy()
    if dtype == "f32":
        np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=1e-5)
    else:
        np.testing.assert_allclose(got, want, atol=BF16_ATOL * max(1.0, np.abs(want).max()), rtol=0)


def test_convert_rejects_mismatched_tree():
    spec = jbert.BertSpec.tiny()
    params = _numpy_tree(JaxCrossEncoder(spec=spec).init(jax.random.PRNGKey(0)))
    with pytest.raises(ValueError):
        crossencoder_from_jax_params(params, tbert.BertSpec.tiny(num_layers=3), device="cpu")
    with pytest.raises(ValueError):
        crossencoder_from_jax_params(params, tbert.BertSpec.tiny(), "w_embeds", device="cpu")


# ---------------------------------------------------------------- package rules


def test_entry_point_without_cpu_raises_when_cuda_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CrossEncoder(tbert.BertSpec.tiny())
    ce = CrossEncoder(tbert.BertSpec.tiny(), device="cpu")
    from anncur_tpu_torch.indexer.score_matrix import ScoreMatrixBuilder

    with pytest.raises(RuntimeError, match="device='cpu'"):
        ScoreMatrixBuilder(ce)
    assert ScoreMatrixBuilder(ce, device="cpu").device == CPU


def test_package_imports_no_jax():
    code = (
        "import sys, pkgutil, importlib, anncur_tpu_torch\n"
        "for m in pkgutil.walk_packages(anncur_tpu_torch.__path__, 'anncur_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import torch\n"
        "assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'anncur_tpu')]\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120
    )
    assert res.returncode == 0, res.stdout + res.stderr


def _imported_roots(path):
    with open(path) as fin:
        tree = ast.parse(fin.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            roots.update(a.value.split(".")[0] for a in node.args if isinstance(a, ast.Constant))
    return roots


def test_chip_smoke_imports_no_jax():
    roots = _imported_roots(os.path.join(REPO, "chip_smoke.py"))
    assert "anncur_tpu_torch" in roots and "torch" in roots
    assert not roots & {"jax", "jaxlib", "anncur_tpu"}, roots
    for dirpath, _, files in os.walk(os.path.join(REPO, "anncur_tpu_torch")):
        for f in files:
            if f.endswith(".py"):
                bad = _imported_roots(os.path.join(dirpath, f)) & {"jax", "jaxlib", "anncur_tpu"}
                assert not bad, (f, bad)


def test_chip_smoke_fails_without_cuda(tmp_path):
    """No card: chip_smoke.py exits non-zero and prints no result line."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
