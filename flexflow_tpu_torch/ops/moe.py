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
expert-activation `Cache` waits for recompile.py (ROADMAP §1.E).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

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
