"""Optimizers (flexflow_tpu/optimizer.py): SGD with momentum, nesterov
and weight decay, and Adam, with the reference's update rules and state
layout ({} or {"v"} for SGD, {"m", "v", "t"} for Adam, each slot a
{op: {weight: tensor}} dictionary like the weights).

The rules are written out on tensors, not taken from torch.optim.  The
reference's update is a pure function whose inputs the jitted step
donates; here `update` writes the weights and slots IN PLACE under
torch.no_grad(), so no second copy of either exists, and returns the
same dictionaries.

The learning rate (SGD's `lr`, Adam's `alpha`) is read by `update` from
a float32 0-d tensor on the weights' device, made by `init_state` (or
by the first `update`); `set_lr` writes it, on every device, in place.
A step captured as a CUDA graph (capture.py) reads that tensor at every
replay, where a Python float would be frozen into the graph.  The
float field keeps the value as the caller set it (`get_lr`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, Tuple

import torch

Weights = Dict[str, Dict[str, torch.Tensor]]


def _pairs(tree: Weights, *others: Weights) -> Iterator[Tuple]:
    """(leaf of tree, leaves of others at the same op and name)"""
    for op, entries in tree.items():
        for name, w in entries.items():
            yield (w,) + tuple(o[op][name] for o in others)


def _zeros_like(weights: Weights) -> Weights:
    return {op: {k: torch.zeros_like(w) for k, w in entries.items()}
            for op, entries in weights.items()}


class Optimizer:
    def init_state(self, weights: Weights) -> Dict[str, Any]:
        raise NotImplementedError

    def _bind_rate(self, weights: Weights) -> None:
        """Make the learning-rate tensor on the weights' device before
        the first step (a capture must not make it)."""
        if weights:
            self._rate_on(next(_pairs(weights))[0].device)

    def _rate_on(self, device: torch.device) -> torch.Tensor:
        """The learning rate as a float32 0-d tensor on `device`, what
        `update` reads: made at the first call for the device, written
        in place by `set_lr` from then on."""
        rates = self.__dict__.setdefault("_rates", {})
        rate = rates.get(device)
        if rate is None:
            rate = rates[device] = torch.tensor(
                self.get_lr(), dtype=torch.float32, device=device)
        return rate

    def next_step(self, state):
        """Host-side per-iteration bookkeeping (the reference's
        Optimizer::next): none."""
        return state

    def update(self, weights: Weights, grads: Weights, state):
        raise NotImplementedError

    # one way to reach the learning rate: SGD stores `lr`, Adam `alpha`
    def get_lr(self) -> float:
        lr = getattr(self, "lr", None)
        return self.alpha if lr is None else lr

    def set_lr(self, lr: float):
        if hasattr(self, "alpha"):
            self.alpha = lr
        else:
            self.lr = lr
        with torch.no_grad():
            for rate in self.__dict__.get("_rates", {}).values():
                rate.fill_(lr)


@dataclasses.dataclass
class SGDOptimizer(Optimizer):
    lr: float = 0.01
    momentum: float = 0.0
    nesterov: bool = False
    weight_decay: float = 0.0

    def init_state(self, weights):
        self._bind_rate(weights)
        if self.momentum == 0.0:
            return {}
        return {"v": _zeros_like(weights)}

    @torch.no_grad()
    def update(self, weights, grads, state):
        """w -= lr (g + wd w); with momentum v = mu v + g + wd w, then
        w -= lr v, or w -= lr (g + wd w + mu v) under nesterov."""
        if not weights:
            return weights, state
        lr = self._rate_on(next(_pairs(weights))[0].device)
        wd, mu = self.weight_decay, self.momentum
        if mu == 0.0:
            for w, g in _pairs(weights, grads):
                w.sub_(lr * (g + wd * w))
            return weights, state
        for w, g, v in _pairs(weights, grads, state["v"]):
            v.mul_(mu).add_(g).add_(wd * w)
            if self.nesterov:
                w.sub_(lr * (g + wd * w + mu * v))
            else:
                w.sub_(lr * v)
        return weights, state


@dataclasses.dataclass
class AdamOptimizer(Optimizer):
    alpha: float = 0.001
    beta1: float = 0.9
    beta2: float = 0.999
    weight_decay: float = 0.0
    epsilon: float = 1e-8

    def init_state(self, weights):
        self._bind_rate(weights)
        dev = next(_pairs(weights))[0].device if weights else None
        return {
            "m": _zeros_like(weights),
            "v": _zeros_like(weights),
            "t": torch.zeros((), dtype=torch.int32, device=dev),
        }

    @torch.no_grad()
    def update(self, weights, grads, state):
        t = state["t"]
        t.add_(1)
        tf = t.to(torch.float32)
        # bias-corrected alpha in float32, on the device (the reference's
        # Optimizer::next)
        alpha_t = (self._rate_on(t.device)
                   * torch.sqrt(1.0 - torch.pow(self.beta2, tf))
                   / (1.0 - torch.pow(self.beta1, tf)))
        b1, b2 = self.beta1, self.beta2
        for w, g, m, v in _pairs(weights, grads, state["m"], state["v"]):
            g = g + self.weight_decay * w
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g.square())
            w.sub_(alpha_t * m / (v.sqrt() + self.epsilon))
        return weights, state
