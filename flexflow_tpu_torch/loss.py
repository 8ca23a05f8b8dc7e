"""Loss functions (flexflow_tpu/loss.py): the scalar loss of a train
step, differentiated by autograd where the reference took
`jax.value_and_grad`."""
from __future__ import annotations

import torch

from .fftype import LossType


def _log_probs(logits: torch.Tensor, from_logits: bool) -> torch.Tensor:
    if from_logits:
        return torch.log_softmax(logits, dim=-1)
    return torch.log(torch.clamp(logits, 1e-12, 1.0))


def compute_loss(loss_type: LossType, logits: torch.Tensor,
                 labels: torch.Tensor, from_logits: bool = True
                 ) -> torch.Tensor:
    """from_logits=False is the reference's convention for a model that
    ends in Softmax: the loss consumes probabilities."""
    if loss_type == LossType.SPARSE_CATEGORICAL_CROSSENTROPY:
        logp = _log_probs(logits, from_logits)
        # class ids with the logits' rank (trailing dim 1) or one less
        if labels.dim() == logits.dim():
            labels = labels[..., 0]
        nll = -torch.gather(logp, -1, labels.long()[..., None])
        return nll.mean()
    if loss_type == LossType.CATEGORICAL_CROSSENTROPY:
        logp = _log_probs(logits, from_logits)
        return -(labels * logp).sum(dim=-1).mean()
    if loss_type == LossType.MEAN_SQUARED_ERROR_AVG_REDUCE:
        return (logits - labels).square().mean()
    if loss_type == LossType.MEAN_SQUARED_ERROR_SUM_REDUCE:
        sq = (logits - labels).square()
        dims = tuple(range(1, sq.dim()))
        return (sq.sum(dim=dims) if dims else sq).mean()
    if loss_type == LossType.IDENTITY:
        return logits.mean()
    raise ValueError(loss_type)


class Loss:
    def __init__(self, loss_type, from_logits: bool = True):
        if isinstance(loss_type, str):
            loss_type = LossType(loss_type)
        self.loss_type = loss_type
        self.from_logits = from_logits

    def __call__(self, logits, labels):
        return compute_loss(self.loss_type, logits, labels, self.from_logits)
