"""Machine views, host half (flexflow_tpu/parallel/machine.py).

A MachineView assigns named mesh axes to each dim of a parallel tensor
(the reference's machine_view.h, normalized to mesh-aligned views).
`assign_axes` factors a tensor's per-dim degrees onto the mesh axes and
`validate_view` checks the result.

The lowering half runs a view on a `torch.distributed` group.
`view_to_spec` gives, per logical dim, the tuple of mesh axes that
shard it (the reference's PartitionSpec: replica dims dropped, so an
axis a tensor does not use replicates it).  `make_mesh` lays the
group's ranks out in C order over the strategy's named axes, as the
reference's reshape of the device list does, so that a group of ranks
here is the group the simulator priced (on `{data: 2, model: 8}`
data's groups are {0, 8}, {1, 9}, ...).  It builds one process group
per axis and coordinate of the other axes, in the same order on every
rank.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple


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


Spec = Tuple[Tuple[str, ...], ...]


def view_to_spec(pt) -> Spec:
    """Per logical dim of `pt`, the mesh axes sharding it, major first
    (the reference's PartitionSpec with its trailing Nones kept as ()
    entries, one per logical dim)."""
    view: Optional[MachineView] = pt.machine_view
    rank = pt.shape.logical_rank
    if view is None:
        return ((),) * rank
    return tuple(tuple(axes) for dim, axes in zip(pt.shape.dims, view.axes)
                 if not dim.is_replica_dim)


class DeviceMesh:
    """The strategy's named axes over the ranks of the default
    `torch.distributed` group, in C order.  `coord(axis)` is this rank's
    index on an axis, `group(axis)` the process group of the ranks that
    differ from this one only there (None for the whole world), and
    `device` the card (or the CPU) this rank computes on."""

    def __init__(self, axis_sizes: Dict[str, int], rank: int,
                 device, groups: Dict[str, object],
                 members: Dict[str, List[int]]):
        self.axis_sizes = dict(axis_sizes)
        self.names = tuple(axis_sizes)
        self.rank = rank
        self.device = device
        self._groups = groups
        self._members = members
        self.coords = {}
        rest = rank
        for name in reversed(self.names):
            self.coords[name] = rest % self.axis_sizes[name]
            rest //= self.axis_sizes[name]

    @property
    def world(self) -> int:
        return math.prod(self.axis_sizes.values())

    def size(self, axis: str) -> int:
        return self.axis_sizes[axis]

    def coord(self, axis: str) -> int:
        return self.coords[axis]

    def group(self, axis: str):
        return self._groups[axis]

    def members(self, axis: str) -> List[int]:
        """The global ranks of this rank's group on `axis`, by
        coordinate."""
        return self._members[axis]

    def __repr__(self) -> str:
        return (f"DeviceMesh({self.axis_sizes}, rank={self.rank}, "
                f"coords={self.coords})")


def _axis_groups(axis_sizes: Dict[str, int]):
    """For each axis, the rank lists of its groups (C order), in one
    fixed order."""
    names = list(axis_sizes)
    sizes = [axis_sizes[n] for n in names]
    world = math.prod(sizes)
    out = {}
    for i, name in enumerate(names):
        stride = math.prod(sizes[i + 1:])
        groups = []
        seen = set()
        for r in range(world):
            base = r - ((r // stride) % sizes[i]) * stride
            if base in seen:
                continue
            seen.add(base)
            groups.append([base + k * stride for k in range(sizes[i])])
        out[name] = groups
    return out


def make_mesh(axis_sizes: Dict[str, int], device=None) -> DeviceMesh:
    """The DeviceMesh of `axis_sizes` over the initialized default
    group, whose size must be their product.  Every rank must call it,
    in the same order: it creates the axes' process groups."""
    import torch
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized torch.distributed "
                           "group (flexflow_tpu_torch.distributed.initialize)")
    world, rank = dist.get_world_size(), dist.get_rank()
    n = math.prod(axis_sizes.values()) if axis_sizes else 1
    if n != world:
        raise ValueError(f"mesh {dict(axis_sizes)} needs {n} ranks, the "
                         f"group has {world}")
    groups, members = {}, {}
    for name, rank_lists in _axis_groups(axis_sizes).items():
        for ranks in rank_lists:
            g = (None if len(ranks) == world
                 else dist.new_group(ranks) if len(ranks) > 1 else None)
            if rank in ranks:
                groups[name] = g
                members[name] = ranks
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend() == "nccl" else torch.device("cpu"))
    return DeviceMesh(axis_sizes, rank, torch.device(device), groups,
                      members)


def mesh_axis_sizes(mesh: DeviceMesh) -> Dict[str, int]:
    return dict(mesh.axis_sizes)
