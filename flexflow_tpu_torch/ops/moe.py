"""Mixture-of-Experts ops: TopK, GroupBy, Aggregate and AggregateSpec
(flexflow_tpu/ops/moe.py).

GroupBy stacks the tokens each expert serves into one [experts,
capacity, dim] tensor, capacity-bounded, and Aggregate combines the
expert outputs weighted by the renormalized gate scores; both move rows
through the cumsum dispatch of ops/moe_dispatch.py.  Aggregate's
load-balance loss (lambda_bal · n · Σ_e fraction_e · prob_e) is left on
the op as `_last_aux` for the executor to add to the step's loss.  Under
expert parallelism the plan (parallel/spmd.py) hands Aggregate its
`combine` (the rows of this rank's pairs) and a `balance_reduce` that
takes the loss's counts and sums over the global batch.  The
expert-activation `Cache` is the identity on the device; on the host it
keeps a ring of the batches it saw and their staleness score, which a
RecompileState's trigger reads (recompile.py).
"""
from __future__ import annotations

import dataclasses
import inspect
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..fftype import DataType, OperatorType
from ..tensor import ParallelDim, ParallelTensorShape
from .moe_dispatch import sort_combine, sort_group_by
from .op import Op, ShapeError


def _data_dims(shape):
    return [d for d in shape.dims if not d.is_replica_dim]


@dataclasses.dataclass(frozen=True)
class TopKParams:
    k: int
    sorted: bool = False


class TopK(Op):
    """values, indices = topk(x, k) along the last dim, the indices
    int32.  A stable descending sort puts the lower index first among
    equal values, as jax.lax.top_k does (torch.topk gives no tie
    order)."""

    op_type = OperatorType.TOPK

    def infer_output_shapes(self, input_shapes):
        (ishape,) = input_shapes
        dd = _data_dims(ishape)
        if dd[-1].degree != 1:
            raise ShapeError(f"{self.name}: topk axis is partitioned")
        if self.params.k > dd[-1].size:
            raise ShapeError(f"{self.name}: k > dim size")
        dims = tuple(ParallelDim(d.size, d.degree) for d in dd[:-1]) + (
            ParallelDim(self.params.k, 1),
            ParallelDim(1, ishape.replica_degree, is_replica_dim=True),
        )
        return [ParallelTensorShape(dims, ishape.dtype),
                ParallelTensorShape(dims, DataType.INT32)]

    def forward(self, inputs, weights, *, training=False, generator=None):
        k = self.params.k
        values, indices = torch.sort(inputs[0], dim=-1, descending=True,
                                     stable=True)
        return [values[..., :k], indices[..., :k].to(torch.int32)]


def _capacity(batch: int, k: int, n: int, alpha: float) -> int:
    return max(1, int(math.ceil(alpha * k * batch / n)))


@dataclasses.dataclass(frozen=True)
class GroupByParams:
    n: int  # number of experts
    alpha: float  # capacity factor


class GroupBy(Op):
    """data [b, d], assign [b, k] -> [n, capacity, d], capacity =
    ceil(alpha · k · b / n)."""

    op_type = OperatorType.GROUP_BY

    def infer_output_shapes(self, input_shapes):
        data, assign = input_shapes
        dd = _data_dims(data)
        ad = _data_dims(assign)
        if len(dd) != 2 or len(ad) != 2:
            raise ShapeError(f"{self.name}: expect data [b,d], assign [b,k]")
        if dd[0].size != ad[0].size:
            raise ShapeError(f"{self.name}: batch mismatch")
        cap = _capacity(dd[0].size, ad[1].size, self.params.n,
                        self.params.alpha)
        dims = (
            ParallelDim(self.params.n, self.shard.expert),
            ParallelDim(cap, 1),
            ParallelDim(dd[1].size, dd[1].degree),
            ParallelDim(1, data.replica_degree, is_replica_dim=True),
        )
        return [ParallelTensorShape(dims, data.dtype)]

    def forward(self, inputs, weights, *, training=False, generator=None):
        data, assign = inputs
        p: GroupByParams = self.params
        b, k = assign.shape
        return [sort_group_by(data, assign, p.n,
                              _capacity(b, k, p.n, p.alpha))]


@dataclasses.dataclass(frozen=True)
class AggregateParams:
    n: int
    lambda_bal: float = 0.0
    alpha: float = 1.0


class Aggregate(Op):
    """Combine expert outputs weighted by the renormalized gate scores.

    Inputs: gate_scores [b, k], assign [b, k] (int), the gate's full
    softmax [b, n] (for the load-balance loss), expert_out [n, cap, e];
    output [b, e]."""

    op_type = OperatorType.AGGREGATE

    def infer_output_shapes(self, input_shapes):
        gate_scores, assign, gate_full, expert_out = input_shapes
        ed = _data_dims(expert_out)
        bd = _data_dims(gate_scores)
        dims = (
            ParallelDim(bd[0].size, bd[0].degree),
            ParallelDim(ed[-1].size, ed[-1].degree),
            ParallelDim(1, expert_out.replica_degree, is_replica_dim=True),
        )
        return [ParallelTensorShape(dims, expert_out.dtype)]

    def forward(self, inputs, weights, *, training=False, generator=None,
                combine=None, balance_reduce=None):
        gate_scores, assign, gate_full, expert_out = inputs
        p: AggregateParams = self.params
        e = expert_out.shape[-1]
        b, k = assign.shape
        denom = gate_scores.sum(dim=-1, keepdim=True) + 1e-9
        norm_scores = gate_scores / denom
        rows = self._rows(expert_out, assign, combine)  # [bk, e]
        y = (rows.reshape(b, k, e) * norm_scores[:, :, None]).sum(dim=1)
        self._last_aux = self._balance_loss(assign, gate_full, p.n,
                                            p.lambda_bal, balance_reduce)
        return [y.to(expert_out.dtype)]

    @staticmethod
    def _rows(expert_out, assign, combine):
        if combine is not None:
            return combine(expert_out, assign)
        return sort_combine(expert_out, assign, expert_out.shape[1])[0]

    @staticmethod
    def _balance_loss(assign: torch.Tensor, gate_full: torch.Tensor,
                      n: int, lambda_bal: float,
                      reduce=None) -> Optional[torch.Tensor]:
        """lambda_bal · n · Σ_e (share of samples whose first choice is
        e) · (mean gate probability of e); None when lambda_bal is 0.
        `reduce(counts, prob_sums)` -> (counts, sums, batch) takes them
        over the global batch when this rank holds a shard of it."""
        if lambda_bal == 0.0:
            return None
        counts = F.one_hot(assign[:, 0].long(), n).sum(dim=0).float()
        if reduce is None:
            frac = counts / assign.shape[0]
            prob = gate_full.mean(dim=0)
        else:
            counts, sums, batch = reduce(counts, gate_full.sum(dim=0))
            frac, prob = counts / batch, sums / batch
        return lambda_bal * n * (frac * prob).sum()


class AggregateSpec(Aggregate):
    """Speculative aggregate: each assigned expert's prediction is a
    sample of its own, output [k·b, e] sample-major; the step repeats
    each label k times to match (FFModel.aggregate_spec)."""

    op_type = OperatorType.AGGREGATE_SPEC

    def infer_output_shapes(self, input_shapes):
        gate_scores, assign, gate_full, expert_out = input_shapes
        ed = _data_dims(expert_out)
        bd = _data_dims(assign)
        dims = (
            ParallelDim(bd[0].size * bd[1].size, bd[0].degree),
            ParallelDim(ed[-1].size, ed[-1].degree),
            ParallelDim(1, expert_out.replica_degree, is_replica_dim=True),
        )
        return [ParallelTensorShape(dims, expert_out.dtype)]

    def forward(self, inputs, weights, *, training=False, generator=None,
                combine=None, balance_reduce=None):
        gate_scores, assign, gate_full, expert_out = inputs
        p: AggregateParams = self.params
        preds = self._rows(expert_out, assign, combine)  # [bk, e]
        self._last_aux = self._balance_loss(assign, gate_full, p.n,
                                            p.lambda_bal, balance_reduce)
        return [preds.to(expert_out.dtype)]


@dataclasses.dataclass(frozen=True)
class CacheParams:
    num_batches: int
    seed: int = 0


def default_cache_score(cached_score, input_arr, cached_arr, vol):
    """The reference's default score: an EMA (gamma 0.99) of whether the
    batch equals the cached one exactly, near 1 while batches repeat and
    decaying to 0 as they drift."""
    gamma = 0.99
    cached_score = cached_score * gamma
    if np.array_equal(input_arr, cached_arr):
        cached_score += 1.0 - gamma
    return cached_score


class Cache(Op):
    """The expert-activation cache (the reference's ops/moe.py Cache).

    On the device the identity.  A training step hands the op's input
    batch to the host (the executor's cache tap; FFModel folds it in one
    step late), where `update` scores it against the cached batch of its
    slot in a ring of `num_batches` and refreshes the slot: the score is
    ``score_f(cached_score, input, cached, vol)``, the reference's
    signature, `default_cache_score` unless the op's `score_fn` takes four
    arguments (a one-argument `score_fn(ff)` is the model-level form fit
    polls after each batch instead).  `trigger` is the latest score.  With
    `use_cached(True)` the op's output is the cached batch of the current
    slot in place of its input.  Reading its batch on the host keeps a
    step that holds the op from being captured (capture.capture_blockers).
    """

    op_type = OperatorType.CACHE

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.score_history = []
        self.cache_score = 0.0
        self.batch_ctr = 0
        self._ring = [None] * self.params.num_batches
        self._load_cached = False
        self.score_fn = None

    def infer_output_shapes(self, input_shapes):
        return [input_shapes[0]]

    def forward(self, inputs, weights, *, training=False, generator=None):
        return [inputs[0]]

    def _score_f(self):
        fn = self.score_fn
        if fn is not None and not self._is_legacy_score():
            return fn
        return default_cache_score

    def update(self, batch: np.ndarray):
        """Fold one training batch in: its score against the cached
        batch of this slot, then the slot refreshed."""
        batch = np.asarray(batch)
        slot = self.batch_ctr
        cached = self._ring[slot]
        if cached is not None and cached.shape == batch.shape:
            self.cache_score = float(
                self._score_f()(self.cache_score, batch, cached, batch.size))
        self._ring[slot] = batch.copy()
        self.batch_ctr = (self.batch_ctr + 1) % self.params.num_batches
        self.update_score(self.cache_score)

    def cached_value(self) -> np.ndarray:
        """The cached batch a use_cached step reads (zeros before the
        slot was filled)."""
        v = self._ring[self.batch_ctr]
        if v is None:
            dt = self.outputs[0].dtype.torch_dtype
            return np.zeros(self.outputs[0].shape.logical_shape,
                            torch.empty(0, dtype=dt).numpy().dtype)
        return v

    def use_cached(self, c: bool):
        self._load_cached = bool(c)

    def _is_legacy_score(self) -> bool:
        """Whether `score_fn` is the model-level `score_fn(ff)` form (fit
        polls it), not the reference's four-argument scorer."""
        fn = self.score_fn
        if fn is None:
            return False
        try:
            return len(inspect.signature(fn).parameters) < 4
        except (TypeError, ValueError):
            return True

    def update_score(self, score: float):
        self.score_history.append(float(score))
        if len(self.score_history) > self.params.num_batches:
            self.score_history.pop(0)

    @property
    def trigger(self) -> float:
        """The latest staleness score."""
        if not self.score_history:
            return 0.0
        return self.score_history[-1]
