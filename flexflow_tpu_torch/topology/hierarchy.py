"""Slice hierarchy: the two-level machine model of a multi-node run
(flexflow_tpu/topology/hierarchy.py).

On H100s a slice is one HGX node: its GPUs talk over NVLink through
NVSwitch (the "ici" tier, in the reference's names) and the nodes over
InfiniBand, one NIC per GPU (the "dcn" tier).  Placement and reduction
strategy must be searched together on such a hierarchy (arXiv:
2110.10548); this module holds the model both searches and the
executor share:

  * `SliceHierarchy` - a `GpuNodeModel` whose node count is the slice
    count: it keeps the flat per-axis collective costs and adds the
    two-level ones.  A hierarchical all-reduce is a reduce-scatter
    inside each slice over NVLink, an all-reduce of the scattered shard
    between slices over InfiniBand, and an all-gather back inside each
    slice;
  * the placement helpers - `legal_placements` and `resolve_placement`
    pick which strategy mesh axis spans the slice boundary (every other
    axis stays inside a slice), and `expand_mesh_axes` lowers that
    choice to the execution mesh: the placement axis splits into a
    leading `SLICE_AXIS` of size S and its intra-slice remainder, so
    that the mesh's C order puts the slice outermost and the executor
    can name the intra-slice axis.

The intra tier is flat: NVSwitch joins every pair of GPUs of a node in
one hop, so a slice has no torus.  `--slice-topology` is validated as
the reference validates it (its product must be the GPUs per slice),
but only its product enters a cost; torus shapes live in
`sim/network.py`.  Every cost is a `CommCost` with the per-tier time
and ring bytes.  All times in seconds, sizes in bytes.
"""
from __future__ import annotations

import logging
from typing import Dict, List, Optional, Tuple

from ..sim.machine_model import (H100_SXM, IB_LAT, IB_NDR_BW, NVLINK_BW,
                                 NVLINK_LAT, DeviceSpec, GpuNodeModel)
from .comm import ZERO_COST, CommCost, ring_bytes

#: the execution mesh's axis name for the dim between slices.  No
#: strategy generates it; compile runs flat when a strategy names it.
SLICE_AXIS = "slice"

_log = logging.getLogger("flexflow_tpu_torch.topology")


class SliceHierarchy(GpuNodeModel):
    """`slices` HGX nodes of `prod(topology)` GPUs each, with two-level
    collective costs beside the flat per-axis ones.

    A mesh axis inside a slice rides NVLink; the searched placement
    axis spans the slices, and its collectives cost the hierarchical
    (or pure InfiniBand) form through `collective_cost`.  The rates
    default to the datasheet figures of `sim/machines/hgx_h100_16.json`
    (NVLink-4 450e9 B/s, InfiniBand NDR 50e9 B/s each way per GPU)."""

    version = 3

    def __init__(self, topology: Tuple[int, ...] = (8,), slices: int = 2,
                 device: DeviceSpec = H100_SXM,
                 nvlink_bw: float = NVLINK_BW,
                 nvlink_lat: float = NVLINK_LAT,
                 ib_bw: float = IB_NDR_BW, ib_lat: float = IB_LAT):
        if slices < 1:
            raise ValueError(f"slices must be >= 1, got {slices}")
        self.topology = tuple(int(t) for t in topology)
        super().__init__(num_nodes=slices, gpus_per_node=_prod(self.topology),
                         device=device, nvlink_bw=nvlink_bw,
                         nvlink_lat=nvlink_lat, ib_bw=ib_bw, ib_lat=ib_lat)

    @property
    def slices(self) -> int:
        return self.num_nodes

    # -- single-tier legs (flat API, tier explicit) ---------------------
    def tier_collective(self, kind: str, size: float, n: int,
                        over_dcn: bool = False,
                        dcn_lat_scale: float = 1.0) -> CommCost:
        """One ring collective entirely on one tier.  `dcn_lat_scale`
        scales the latency term of InfiniBand legs only (the grad-sync
        bucketing of sim/simulator.py); NVLink legs and every bandwidth
        term are untouched."""
        if n <= 1:
            return ZERO_COST
        if over_dcn:
            bw, lat = self.ib_bw, self.ib_lat * dcn_lat_scale
        else:
            bw, lat = self.nvlink_bw, self.nvlink_lat
        steps = 2 * (n - 1) if kind == "allreduce" else n - 1
        b = ring_bytes(kind, size, n)
        t = b / bw + steps * lat
        if over_dcn:
            return CommCost(dcn_time=t, dcn_bytes=b)
        return CommCost(ici_time=t, ici_bytes=b)

    # -- two-level collective costs -------------------------------------
    def split_group(self, group_len: int) -> Tuple[int, int]:
        """(intra, inter) factorization of a group that crosses slices:
        the inter leg is the slice count whenever it divides the group,
        else the whole group degrades to InfiniBand."""
        s = self.slices
        if s <= 1 or group_len <= 1:
            return group_len, 1
        if group_len % s == 0:
            return group_len // s, s
        return 1, group_len

    def hierarchical_allreduce_time(self, size: float, intra: int,
                                    inter: int) -> float:
        return self.hierarchical_cost("allreduce", size, intra, inter).time

    def hierarchical_cost(self, kind: str, size: float, intra: int,
                          inter: int,
                          dcn_lat_scale: float = 1.0) -> CommCost:
        """Two-level form of one collective over `intra * inter` GPUs
        whose inter leg crosses slices:

        all-reduce:      RS inside -> AR of size/intra between -> AG inside;
        reduce-scatter:  RS inside -> RS of size/intra between;
        all-gather:      AG of size/intra between -> AG inside;
        all-to-all:      the exchange inside plus the (inter-1)/inter of
                         it that goes to other slices, between.
        """
        if intra <= 1:
            return self.tier_collective(kind, size, inter, over_dcn=True,
                                        dcn_lat_scale=dcn_lat_scale)
        if inter <= 1:
            return self.tier_collective(kind, size, intra)
        if kind == "allreduce":
            return (self.tier_collective("reducescatter", size, intra)
                    + self.tier_collective("allreduce", size / intra, inter,
                                           over_dcn=True,
                                           dcn_lat_scale=dcn_lat_scale)
                    + self.tier_collective("allgather", size, intra))
        if kind == "reducescatter":
            return (self.tier_collective("reducescatter", size, intra)
                    + self.tier_collective("reducescatter", size / intra,
                                           inter, over_dcn=True,
                                           dcn_lat_scale=dcn_lat_scale))
        if kind == "allgather":
            return (self.tier_collective("allgather", size / intra, inter,
                                         over_dcn=True,
                                         dcn_lat_scale=dcn_lat_scale)
                    + self.tier_collective("allgather", size, intra))
        cross = size * (inter - 1) / inter
        return (self.tier_collective("alltoall", size - cross, intra)
                + self.tier_collective("alltoall", cross, inter,
                                       over_dcn=True,
                                       dcn_lat_scale=dcn_lat_scale))

    def collective_cost(self, kind: str, size: float, group_len: int,
                        cross: bool = False,
                        dcn_lat_scale: float = 1.0) -> CommCost:
        """What the simulator charges one collective: the flat NVLink
        ring when the group stays inside a slice, the two-level form
        when it spans slices.  `dcn_lat_scale` scales the InfiniBand
        legs' latency only."""
        if group_len <= 1:
            return ZERO_COST
        if not cross or self.slices <= 1:
            return self.tier_collective(kind, size, group_len)
        intra, inter = self.split_group(group_len)
        return self.hierarchical_cost(kind, size, intra, inter,
                                      dcn_lat_scale=dcn_lat_scale)


PodModel = SliceHierarchy  # the reference's alias


# ----------------------------------------------------------------------
# placement: which strategy mesh axis spans the slice boundary
# ----------------------------------------------------------------------

def legal_placements(mesh_axes: Dict[str, int], slices: int) -> List[str]:
    """Axes a strategy may place across slices: those the slice count
    divides (each slice then holds 1/S of the axis)."""
    if slices <= 1:
        return []
    return [a for a, n in mesh_axes.items() if n >= slices and n % slices == 0]


def resolve_placement(mesh_axes: Dict[str, int],
                      slices: int) -> Optional[str]:
    """The default placement of a strategy that carries none: the first
    legal axis in declaration order (strategies declare the data axis
    first, so the model and expert groups stay inside a slice and the
    grads cross slices once per step).  None when no axis can span the
    slices (the run is then flat)."""
    legal = legal_placements(mesh_axes, slices)
    return legal[0] if legal else None


def expand_mesh_axes(mesh_axes: Dict[str, int], slices: int,
                     placement: str) -> Tuple[Dict[str, int], Optional[str]]:
    """Lower a placement to the execution mesh: (exec_axes, intra_axis).

    A placement axis larger than the slice count splits: a leading
    `SLICE_AXIS` of size S, and the axis under its own name at 1/S of
    its size, which `intra_axis` names (the executor's hierarchical
    reduction scatters over it).  A placement axis of exactly the slice
    count is the slice dim itself: it moves to the front and there is no
    intra remainder.  The leading position puts the slice outermost in
    the mesh's C order: the slice of rank r is r // (ranks per slice).
    """
    size = mesh_axes.get(placement, 0)
    if slices <= 1 or size < slices or size % slices:
        raise ValueError(f"placement {placement!r} (size {size}) cannot span "
                         f"{slices} slices")
    if size == slices:
        out = {placement: size}
        out.update((k, v) for k, v in mesh_axes.items() if k != placement)
        return out, None
    out = {SLICE_AXIS: slices}
    for k, v in mesh_axes.items():
        out[k] = v // slices if k == placement else v
    return out, placement


def execution_mesh(mesh_axes: Dict[str, int], slices: int, num_devices: int,
                   placement: Optional[str] = None, pipeline=None
                   ) -> Tuple[Dict[str, int], Optional[str]]:
    """(exec_axes, hier_axis) a compile on `num_devices` devices runs a
    strategy's mesh as under `slices`: the expanded mesh, or the mesh
    as it is (hier_axis None) with the reference's warning when the
    run is flat - one slice, a pipeline, devices that do not split into
    the slices, a mesh that already names the slice axis, or no axis
    the slices divide.  An illegal placement falls back to the
    default."""
    mesh_axes = dict(mesh_axes)
    if slices <= 1 or pipeline:
        return mesh_axes, None
    if num_devices % slices:
        _log.warning("%d devices do not split into %d slices; executing "
                     "flat", num_devices, slices)
        return mesh_axes, None
    if SLICE_AXIS in mesh_axes:
        _log.warning("mesh axis %r collides with the reserved slice axis; "
                     "executing flat (placement-less)", SLICE_AXIS)
        return mesh_axes, None
    if placement is not None and placement not in legal_placements(
            mesh_axes, slices):
        _log.warning("strategy placement %r is not legal for mesh %s with %d "
                     "slices; using the default placement", placement,
                     mesh_axes, slices)
        placement = None
    if placement is None:
        placement = resolve_placement(mesh_axes, slices)
    if placement is None:
        _log.warning("no mesh axis of %s is divisible by %d slices; "
                     "executing flat (cross-slice collectives "
                     "unsynthesized)", mesh_axes, slices)
        return mesh_axes, None
    return expand_mesh_axes(mesh_axes, slices, placement)


def placement_stats(strategy, slices: int) -> Dict[str, object]:
    """The search_stats entries of a winner's placement: the effective
    cross-slice axis ("" on flat runs) and whether its grad reduction
    takes the hierarchical form (an intra-slice remainder exists)
    rather than a pure InfiniBand ring.  A pipeline winner reports none:
    compile runs it flat."""
    if slices <= 1 or getattr(strategy, "pipeline", None):
        return {"placement": "", "hierarchical_reduction": False}
    eff = getattr(strategy, "placement", None)
    if eff not in legal_placements(strategy.mesh_axes, slices):
        eff = resolve_placement(strategy.mesh_axes, slices)
    return {"placement": eff or "",
            "hierarchical_reduction": bool(
                eff and strategy.mesh_axes.get(eff, 0) > slices)}


def hierarchy_from_config(cfg, num_devices: int) -> SliceHierarchy:
    """The run's SliceHierarchy from FFConfig (slices, slice_topology,
    dcn_bandwidth, dcn_latency).  A slice defaults to num_devices /
    slices GPUs.  A machine-model file gives the device roofline and
    the NVLink rate and latency of one slice (the DCN fields own the
    tier between slices), and its GPUs per node are the default slice
    when slice_topology is unset and they fit."""
    from ..sim.machine_model import detect_device_spec

    slices = max(1, int(cfg.slices))
    if num_devices % slices:
        raise ValueError(f"{num_devices} devices do not split into {slices} "
                         "equal slices")
    per_slice = num_devices // slices
    device = None
    link_kw = {}
    file_topo: Optional[Tuple[int, ...]] = None
    if getattr(cfg, "machine_model_file", None):
        base = GpuNodeModel.from_file(cfg.machine_model_file)
        device = base.device()
        link_kw = {"nvlink_bw": base.nvlink_bw, "nvlink_lat": base.nvlink_lat}
        file_topo = (base.gpus_per_node,)
    if cfg.slice_topology:
        topo = parse_slice_topology(cfg.slice_topology)
    elif file_topo is not None and _prod(file_topo) == per_slice:
        topo = file_topo
    else:
        topo = (per_slice,)
    if _prod(topo) != per_slice:
        raise ValueError(
            f"slice topology {topo} has {_prod(topo)} GPUs per slice but "
            f"{num_devices} devices / {slices} slices = {per_slice}")
    return SliceHierarchy(
        topology=topo, slices=slices,
        device=device if device is not None else detect_device_spec(),
        ib_bw=float(cfg.dcn_bandwidth), ib_lat=float(cfg.dcn_latency),
        **link_kw)


def _prod(dims: Tuple[int, ...]) -> int:
    n = 1
    for d in dims:
        n *= d
    return n


def parse_slice_topology(spec: str) -> Tuple[int, ...]:
    """'4x4' or '4,4' -> (4, 4); ValueError on anything else."""
    parts = [p for p in str(spec).replace("x", ",").split(",") if p.strip()]
    if not parts:
        raise ValueError(f"empty slice topology {spec!r}")
    try:
        dims = tuple(int(p) for p in parts)
    except ValueError:
        raise ValueError(f"slice topology {spec!r} must be comma/x-separated "
                         "ints") from None
    if any(d < 1 for d in dims):
        raise ValueError(f"slice topology {spec!r} has non-positive dims")
    return dims


__all__ = [
    "SLICE_AXIS", "CommCost", "ZERO_COST", "PodModel", "SliceHierarchy",
    "execution_mesh", "expand_mesh_axes", "hierarchy_from_config",
    "legal_placements", "parse_slice_topology", "placement_stats",
    "resolve_placement", "ring_bytes",
]
