"""The port's package API against the JAX package's (CPU): every name the
JAX package and its subpackages export has a counterpart (or a listed
reason), importing the package builds and loads no kernel, and the
methods that complete the API (``CrossEncoder.embed_input`` /
``embed_label``, the pooling helpers, ``count_params``,
``CurRetriever.throughput``) match JAX's on the same numpy parameters."""

import ast
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import anncur_tpu
from anncur_tpu.models import bert as jbert
from anncur_tpu.models import pooling as jpool
from anncur_tpu.models.crossencoder import CrossEncoder as JaxCrossEncoder

import anncur_tpu_torch
from anncur_tpu_torch.models import bert as tbert
from anncur_tpu_torch.models import pooling as tpool
from anncur_tpu_torch.models.convert import crossencoder_from_jax_params
from test_torch_retriever import _build_both, world  # noqa: F401  (world: a fixture)

torch.set_num_threads(2)  # xdist runs several test files side by side

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBPACKAGES = ("core", "indexer", "models", "evalx", "ops", "parallel", "train", "data", "utils")
# JAX names without a counterpart in the port, each with its reason
NO_COUNTERPART = {
    # resolve_device (utils/device.py) raises when CUDA is asked for and
    # absent; the CPU is chosen by passing device="cpu", not by a guard
    ("parallel.mesh", "require_accelerator"),
}


def _exported(path):
    """Names a package ``__init__.py`` imports (``from x import a, b``)
    and, at the top level, its ``_LAZY`` table's keys."""
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            names |= {a.asname or a.name for a in node.names}
        if isinstance(node, ast.Assign) and any(getattr(t, "id", None) == "_LAZY" for t in node.targets):
            names |= {k.value for k in node.value.keys}
    return names


@pytest.mark.parametrize("sub", ("",) + SUBPACKAGES)
def test_every_jax_export_has_a_counterpart(sub):
    jax_init = os.path.join(REPO, "anncur_tpu", sub, "__init__.py")
    want = _exported(jax_init)
    assert want, jax_init
    port = __import__("anncur_tpu_torch" + (f".{sub}" if sub else ""), fromlist=["_"])
    missing = sorted(n for n in want if not hasattr(port, n))
    assert not missing, f"anncur_tpu_torch{'.' + sub if sub else ''} lacks {missing}"
    if not sub:
        assert set(anncur_tpu._LAZY) == set(anncur_tpu_torch._LAZY)
        assert set(anncur_tpu_torch._LAZY) <= set(dir(anncur_tpu_torch))


@pytest.mark.parametrize("module", ["parallel.mesh", "parallel.multihost", "parallel.tp"])
def test_parallel_modules_have_jax_functions(module):
    """The public functions of JAX's parallel modules, but the listed ones."""
    jmod = __import__(f"anncur_tpu.{module}", fromlist=["_"])
    tmod = __import__(f"anncur_tpu_torch.{module}", fromlist=["_"])
    want = {n for n, v in vars(jmod).items()
            if callable(v) and not n.startswith("_") and getattr(v, "__module__", "") == jmod.__name__}
    missing = sorted(n for n in want if not hasattr(tmod, n) and (module, n) not in NO_COUNTERPART)
    assert not missing
    assert all(hasattr(jmod, n) for m, n in NO_COUNTERPART if m == module)


def test_lazy_names_resolve():
    from anncur_tpu_torch import CurRetriever, Trainer, default_mesh  # noqa: F401
    from anncur_tpu_torch.core import build_cur  # noqa: F401
    from anncur_tpu_torch.ops import mips_topk_sharded  # noqa: F401

    for name, (module, attr) in anncur_tpu_torch._LAZY.items():
        assert getattr(anncur_tpu_torch, name) is getattr(__import__(module, fromlist=["_"]), attr)
    with pytest.raises(AttributeError, match="no attribute"):
        anncur_tpu_torch.not_a_name  # noqa: B018


def test_import_builds_and_loads_no_kernel():
    """A fresh process importing the package and every subpackage (and its
    top-level names) loads no library of the build directory, builds
    nothing, imports neither JAX nor the JAX package, and keeps TF32 off."""
    code = (
        "import sys, anncur_tpu_torch as a\n"
        f"for s in {SUBPACKAGES!r}: __import__('anncur_tpu_torch.' + s)\n"
        "[getattr(a, n) for n in a._LAZY]\n"
        "from anncur_tpu_torch.ops import cuda_build\n"
        "import torch, os\n"
        "maps = open('/proc/self/maps').read()\n"
        "assert cuda_build.BUILD_DIR not in maps and 'anncur_tpu_torch' not in maps, 'a library was loaded'\n"
        "assert not cuda_build._LOADED\n"
        "assert 'jax' not in sys.modules and 'anncur_tpu' not in sys.modules\n"
        "assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-3000:]


# ---------------------------------------------------------------- methods


@pytest.fixture(scope="module")
def ce_pair():
    """Both CE heads, one numpy parameter tree each, in both packages; pair
    tokens with the [unused0/1/2] tags."""
    from anncur_tpu.data.synthetic import make_tokenized_world

    ment, ent, _, tok = make_tokenized_world(seed=6, n_ents=8, n_ments=6, max_ment_len=16, max_ent_len=16)
    kw = dict(vocab_size=tok.vocab_size, max_position_embeddings=64)
    out = {}
    for head in ("default", "w_embeds"):
        ce_j = JaxCrossEncoder(spec=jbert.BertSpec.tiny(**kw), cross_enc_type=head, pooling_type="cls_w_lin",
                               compute_dtype=jnp.float32)
        params = ce_j.init(jax.random.PRNGKey(3))
        tree = jax.tree_util.tree_map(np.array, params)
        ce_t = crossencoder_from_jax_params(tree, tbert.BertSpec.tiny(**kw), head, device="cpu", dtype=torch.float32)
        out[head] = (ce_j, params, ce_t)
    return out, np.asarray(ment), np.asarray(ent)


@pytest.mark.parametrize("head", ["default", "w_embeds"])
def test_embed_input_and_label_match_jax(ce_pair, head):
    """tests/test_encoders.py's mention-only and entity-only embeddings,
    f32, within f32 rounding through 2 layers."""
    heads, ment, ent = ce_pair
    ce_j, params, ce_t = heads[head]
    for method, toks in (("embed_input", ment), ("embed_label", ent)):
        want = np.asarray(getattr(ce_j, method)(params, jnp.asarray(toks)))
        got = getattr(ce_t, method)(toks).numpy()
        assert got.shape == want.shape == (toks.shape[0], 64)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max(), err_msg=method)


def test_pooling_helpers_match_jax():
    rng = np.random.default_rng(0)
    seq = rng.standard_normal((4, 10, 8)).astype(np.float32)
    toks = rng.integers(5, 50, size=(4, 10))
    toks[0, [2, 5, 7]] = [1, 2, 3]  # [unused0], [unused1], [unused2]
    toks[1, [1, 4, 9]] = [1, 2, 3]
    toks[2, 3] = 1  # no end or title tag: those resolve to position 0
    pos = np.asarray([3, 0, 9, 5])
    st, sj = torch.as_tensor(seq), jnp.asarray(seq)
    tt, tj = torch.as_tensor(toks), jnp.asarray(toks)
    np.testing.assert_array_equal(tpool.gather_token_embedding(st, torch.as_tensor(pos)).numpy(),
                                  np.asarray(jpool.gather_token_embedding(sj, jnp.asarray(pos))))
    for got, want in zip(tpool.special_token_embeds(st, tt), jpool.special_token_embeds(sj, tj)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    np.testing.assert_allclose(tpool.mention_embed(st, tt).numpy(), np.asarray(jpool.mention_embed(sj, tj)), rtol=1e-6)
    np.testing.assert_array_equal(tpool.entity_embed(st, tt).numpy(), np.asarray(jpool.entity_embed(sj, tj)))


def test_count_params_matches_jax(ce_pair):
    heads, _, _ = ce_pair
    for ce_j, params, ce_t in heads.values():
        want = jbert.count_params(params)
        assert tbert.count_params(ce_t.params_tree()) == want
    assert tbert.count_params(tbert.init_bert_params(np.random.default_rng(0), tbert.BertSpec.tiny())) == \
        jbert.count_params(jbert.init_bert_params(jax.random.PRNGKey(0), jbert.BertSpec.tiny()))
    # bert-base without heads, both packages: 109,482,240 values
    assert tbert.count_params(jax.eval_shape(lambda: jbert.init_bert_params(jax.random.PRNGKey(0), jbert.BertSpec()))) \
        == jbert.count_params(jax.eval_shape(lambda: jbert.init_bert_params(jax.random.PRNGKey(0), jbert.BertSpec()))) \
        == 109_482_240


def test_throughput_is_a_positive_rate(world):  # noqa: F811
    ment = world[0]
    _, r_t = _build_both(world)
    qps = r_t.throughput(ment[16:20], top_k=3, top_k_retvr=8, iters=2)
    assert np.isfinite(qps) and qps > 0
