"""The paper's eval harnesses and the retrieve-and-rerank baseline
(counterpart of ``anncur_tpu/evalx``). ``retrieve_rerank`` is the function
of ``evalx/core.py``, as in JAX; importing the module
``anncur_tpu_torch.evalx.retrieve_rerank`` by its full name rebinds that
package attribute to the module, as it does in JAX."""

from anncur_tpu_torch.evalx.core import (  # noqa: F401
    eval_approx_for_all_topk,
    retrieve_rerank,
)
from anncur_tpu_torch.evalx.transductive import run_transductive_eval  # noqa: F401
from anncur_tpu_torch.evalx.inductive import run_inductive_eval  # noqa: F401
