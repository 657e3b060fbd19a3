"""anncur_tpu_torch: the PyTorch + CUDA port of ``anncur_tpu`` for one
NVIDIA H100.

The JAX package stays the reference; this package keeps its module
layout and names so each file has an obvious counterpart:

- ``models``  : BERT encoder, cross-encoder, bi-encoder, tokenizer
                copies, weight conversion from the JAX param pytree.
- ``ops``     : the hand-written CUDA kernels (attention forward and
                backward, fused MIPS top-k over f32 or int8 items) beside
                their plain PyTorch versions, the dense index, pinv.
- ``indexer`` : exact score-matrix build, train/test splits, chunk
                combiners, entity-to-anchor-entity scores.
- ``core``    : CUR index, the retriever (fixed-anchor, adaptive, host
                ADACUR), the adaptive engines, AXN.
- ``parallel``: process-group meshes on ``torch.distributed`` (data
                parallel training, tensor parallel towers, entity-sharded
                builds, sharded MIPS, query-sharded serving).
- ``evalx``   : the paper's CUR eval harnesses (transductive, inductive,
                rank probes, aggregation; plots apart, they need
                matplotlib) and bi-encoder retrieve-and-rerank.
- ``train``   : bi-encoder training (in-batch, hard negatives mined with
                the current towers, distillation) and cross-encoder
                training.
- ``data``    : token representation builders (copies).

Nothing here imports ``jax`` or ``anncur_tpu``. Entry points default to
``device="cuda"`` and raise when CUDA is absent unless the caller passes
``device="cpu"``.

The top-level names load lazily (PEP 562), as the JAX package's do:
``import anncur_tpu_torch`` stays light, and no kernel is built or loaded
before its first call.
"""

import torch

# Score-path matmuls (latent projection, CUR build, pooler, score head)
# must run in true f32: the JAX package measured CUR recall collapsing at
# reduced matmul precision, and TF32 keeps only ~3 decimal digits.
# PyTorch defaults cuBLAS matmuls to f32 but cuDNN to TF32; pin both.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

from anncur_tpu_torch.config import Config  # noqa: E402,F401

_LAZY = {
    "CurIndex": ("anncur_tpu_torch.core.cur", "CurIndex"),
    "build_cur": ("anncur_tpu_torch.core.cur", "build_cur"),
    "CurRetriever": ("anncur_tpu_torch.core.retriever", "CurRetriever"),
    "ScoreMatrixBuilder": ("anncur_tpu_torch.indexer.score_matrix", "ScoreMatrixBuilder"),
    "DenseIndex": ("anncur_tpu_torch.ops.dense_index", "DenseIndex"),
    "BertSpec": ("anncur_tpu_torch.models.bert", "BertSpec"),
    "BiEncoder": ("anncur_tpu_torch.models.biencoder", "BiEncoder"),
    "CrossEncoder": ("anncur_tpu_torch.models.crossencoder", "CrossEncoder"),
    "WordPieceTokenizer": ("anncur_tpu_torch.models.tokenizer", "WordPieceTokenizer"),
    "Trainer": ("anncur_tpu_torch.train.trainer", "Trainer"),
    "default_mesh": ("anncur_tpu_torch.parallel.mesh", "default_mesh"),
    "make_mesh": ("anncur_tpu_torch.parallel.mesh", "make_mesh"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module 'anncur_tpu_torch' has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_LAZY))
