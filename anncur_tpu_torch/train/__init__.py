"""Training: losses, optimizer, negatives, batches, checkpoints and the
bi-encoder and cross-encoder trainer (counterpart of ``anncur_tpu/train``)."""

from anncur_tpu_torch.train.losses import (  # noqa: F401
    bienc_loss_in_batch_negs,
    bienc_loss_w_negs,
    crossenc_loss,
    distill_loss,
)
from anncur_tpu_torch.train.optimizer import make_optimizer  # noqa: F401
from anncur_tpu_torch.train.trainer import Trainer, TrainState  # noqa: F401
