"""BERT, the bi- and cross-encoders and the tokenizer (counterpart of
``anncur_tpu/models``).

Three names keep JAX's name in another form: ``BertParams`` is the same
nested dict (JAX layout) of numpy arrays; ``init_bert_params`` draws from a
``numpy.random.Generator`` where JAX takes a PRNG key; ``bert_encode``
takes the parameters as the module ``bert.params_module`` builds from that
tree, where JAX takes the tree itself.
"""

from anncur_tpu_torch.models.bert import (  # noqa: F401
    BertParams,
    BertSpec,
    bert_encode,
    init_bert_params,
)
from anncur_tpu_torch.models.biencoder import BiEncoder  # noqa: F401
from anncur_tpu_torch.models.crossencoder import CrossEncoder  # noqa: F401
from anncur_tpu_torch.models.tokenizer import WordPieceTokenizer  # noqa: F401
