"""Machine views, host half (flexflow_tpu/parallel/machine.py).

A MachineView assigns named mesh axes to each dim of a parallel tensor
(the reference's machine_view.h, normalized to mesh-aligned views).
`assign_axes` factors a tensor's per-dim degrees onto the mesh axes and
`validate_view` checks the result.  Lowering a view onto a device mesh
(the reference's view_to_spec and make_mesh) is DeviceMesh / DTensor
work of the multi-GPU executor, ROADMAP §1.D.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class MachineView:
    """Assignment of mesh axes to a parallel tensor's dims.

    axes[i] is the tuple of mesh-axis names sharding dims[i] (the full
    dims tuple, replica dim included).  Empty tuple = dim not sharded.
    Axes on the replica dim mean the tensor is replicated across them
    (for weights this is the data-parallel axis).
    """

    axes: Tuple[Tuple[str, ...], ...]

    def used_axes(self) -> Tuple[str, ...]:
        out = []
        for a in self.axes:
            out.extend(a)
        return tuple(out)

    def __str__(self) -> str:
        return "View(" + ",".join("+".join(a) if a else "_" for a in self.axes) + ")"


def validate_view(view: MachineView, shape, mesh_axis_sizes: Dict[str, int]) -> None:
    """Check the view is consistent with the shape's degrees and the mesh."""
    if len(view.axes) != len(shape.dims):
        raise ValueError(
            f"view rank {len(view.axes)} != tensor rank {len(shape.dims)}"
        )
    seen = set()
    for dim, axes in zip(shape.dims, view.axes):
        prod = 1
        for ax in axes:
            if ax in seen:
                raise ValueError(f"mesh axis {ax!r} used twice in {view}")
            seen.add(ax)
            if ax not in mesh_axis_sizes:
                raise ValueError(f"unknown mesh axis {ax!r}")
            prod *= mesh_axis_sizes[ax]
        if prod != dim.degree:
            raise ValueError(
                f"axes {axes} (size {prod}) != degree {dim.degree} for dim {dim}"
            )


def assign_axes(shape, mesh_axis_sizes: Dict[str, int]) -> MachineView:
    """Normalize per-dim degrees onto named mesh axes (the view normalizer).

    Axis-preference heuristic keeps producer/consumer views aligned on
    the canonical (data, model, ...) mesh:
      - the leading data dim (logical dim 0) and replica dims consume
        axes in declaration order (the "data" axis first — replica dims
        on weights ARE data-parallel replication);
      - all other dims (channel/attribute/expert) consume axes in
        REVERSE declaration order, so a weight's out-channel dim lands
        on the same trailing "model" axis as the matching activation dim.
    The strategy search can always override views explicitly.
    """
    available = dict(mesh_axis_sizes)
    decl_order = list(mesh_axis_sizes.keys())

    def take(need: int, order) -> Tuple[str, ...]:
        order = list(order)
        # pass 1: a single axis of exactly this size (most views are
        # one-axis-per-dim; exact match avoids eating an axis another
        # dim needs)
        for ax in order:
            if ax in available and available[ax] == need:
                del available[ax]
                return (ax,)
        # pass 2: greedy multi-axis factoring
        chosen = []
        for ax in order:
            if ax not in available:
                continue
            size = available[ax]
            if need % size == 0:
                chosen.append(ax)
                del available[ax]
                need //= size
                if need == 1:
                    break
        if need != 1:
            for ax in chosen:
                available[ax] = mesh_axis_sizes[ax]
            raise ValueError(
                f"cannot factor degree onto mesh axes {mesh_axis_sizes} "
                f"(remaining {available}, still need {need})"
            )
        return tuple(chosen)

    axes_out = []
    logical_idx = 0
    for dim in shape.dims:
        if dim.degree <= 1:
            axes_out.append(())
            if not dim.is_replica_dim:
                logical_idx += 1
            continue
        if dim.is_replica_dim or logical_idx == 0:
            axes_out.append(take(dim.degree, decl_order))
        else:
            axes_out.append(take(dim.degree, reversed(decl_order)))
        if not dim.is_replica_dim:
            logical_idx += 1
    return MachineView(tuple(axes_out))
