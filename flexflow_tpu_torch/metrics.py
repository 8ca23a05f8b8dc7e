"""Training metrics (flexflow_tpu/metrics.py).

`Metrics.compute` returns per-step sums as device tensors;
`PerfMetrics.accumulate` folds them into device-side running sums
without a host sync, and `finalize` brings them to the host in one
transfer per epoch.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

import numpy as np
import torch

from .fftype import MetricsType


@dataclasses.dataclass
class PerfMetrics:
    train_all: int = 0
    train_correct: int = 0
    cce_loss: float = 0.0
    sparse_cce_loss: float = 0.0
    mse_loss: float = 0.0
    rmse_loss: float = 0.0
    mae_loss: float = 0.0

    _FIELDS = ("train_all", "train_correct", "cce_loss", "sparse_cce_loss",
               "mse_loss", "rmse_loss", "mae_loss")
    _LOSSES = ("cce_loss", "sparse_cce_loss", "mse_loss", "rmse_loss",
               "mae_loss")

    def __post_init__(self):
        # running device-side sums (see accumulate); a plain attribute,
        # so dataclass eq/asdict see only the fields
        self._device_acc: Dict[str, torch.Tensor] = {}

    def update(self, other: Dict[str, float]):
        self.train_all += int(other.get("train_all", 0))
        self.train_correct += int(other.get("train_correct", 0))
        for f in self._LOSSES:
            setattr(self, f, getattr(self, f) + float(other.get(f, 0.0)))

    def accumulate(self, step_metrics: Dict[str, torch.Tensor]):
        """Fold one step's metric tensors into the device-side sums."""
        for k in self._FIELDS:
            v = step_metrics.get(k)
            if v is None:
                continue
            acc = self._device_acc.get(k)
            self._device_acc[k] = v if acc is None else acc + v

    def finalize(self) -> "PerfMetrics":
        """One host transfer: the accumulated sums, stacked as float64
        (exact for the integer counts), folded into the fields.
        Idempotent between accumulate() calls."""
        if self._device_acc:
            keys = list(self._device_acc)
            vals = torch.stack([self._device_acc[k].to(torch.float64)
                                for k in keys]).cpu().numpy()
            self._device_acc = {}
            self.update(dict(zip(keys, vals.tolist())))
        return self

    @property
    def accuracy(self) -> float:
        return self.train_correct / max(1, self.train_all)

    def summary(self) -> str:
        parts = [f"accuracy={self.accuracy*100:.2f}% "
                 f"({self.train_correct}/{self.train_all})"]
        for f in self._LOSSES:
            v = getattr(self, f)
            if v:
                parts.append(f"{f}={v:.4f}")
        return " ".join(parts)


class Metrics:
    def __init__(self, loss_type, metrics: Sequence):
        self.metrics = [MetricsType(m) if isinstance(m, str) else m
                        for m in metrics]
        self.loss_type = loss_type

    def compute(self, logits: torch.Tensor,
                labels: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Scalar sums per metric, on the logits' device."""
        sparse = labels.dim() < logits.dim() or labels.shape[-1] == 1
        if sparse:
            # class ids with the logits' rank (trailing dim 1) or one less
            lab = labels[..., 0] if labels.dim() == logits.dim() else labels
            lab = lab.long()
            n_scored = int(np.prod(lab.shape))
        else:
            # one-hot labels: one scored position per class-dim slice
            n_scored = int(np.prod(labels.shape[:-1]))
        # a fill, not a copy from the host: capturable (capture.py)
        out: Dict[str, torch.Tensor] = {"train_all": torch.full(
            (), n_scored, dtype=torch.int32, device=logits.device)}
        for m in self.metrics:
            if m == MetricsType.ACCURACY:
                pred = logits.argmax(dim=-1)
                tgt = lab if sparse else labels.argmax(dim=-1)
                out["train_correct"] = (pred == tgt).sum().to(torch.int32)
            elif m == MetricsType.SPARSE_CATEGORICAL_CROSSENTROPY:
                logp = torch.log_softmax(logits, dim=-1)
                out["sparse_cce_loss"] = -torch.gather(
                    logp, -1, lab[..., None]).sum()
            elif m == MetricsType.CATEGORICAL_CROSSENTROPY:
                logp = torch.log(torch.clamp(logits, 1e-12, 1.0))
                out["cce_loss"] = -(labels * logp).sum()
            elif m == MetricsType.MEAN_SQUARED_ERROR:
                out["mse_loss"] = (logits - labels).square().mean(-1).sum()
            elif m == MetricsType.ROOT_MEAN_SQUARED_ERROR:
                out["rmse_loss"] = torch.sqrt(
                    (logits - labels).square().mean(-1)).sum()
            elif m == MetricsType.MEAN_ABSOLUTE_ERROR:
                out["mae_loss"] = (logits - labels).abs().mean(-1).sum()
        return out
