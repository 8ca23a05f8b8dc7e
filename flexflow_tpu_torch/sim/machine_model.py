"""Machine models of H100 clusters, feeding the strategy search
(flexflow_tpu/sim/machine_model.py).

`SimpleMachineModel` is the reference's v0 (flat intra-node and
inter-node bandwidths) as it is.  `GpuNodeModel` (version 2) takes the
place of the reference's TPU torus model: HGX H100 nodes, where
NVSwitch joins every pair of GPUs of a node in one hop at NVLink-4
bandwidth, and InfiniBand NDR joins the nodes, one NIC per GPU.  It
exposes the axis-aware collective interface (`axis_allreduce_time`,
`axis_allgather_time`, `axis_alltoall_time`) that the simulator and the
Unity search prefer when a machine has it.

All times in seconds, sizes in bytes.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, FrozenSet, Sequence, Tuple


@dataclasses.dataclass
class DeviceSpec:
    """Per-card compute and memory capability.  Defaults: one NVIDIA H100
    SXM5, from NVIDIA's H100 Tensor Core GPU datasheet (dense rates,
    without sparsity)."""

    peak_flops: float = 989.4e12      # dense bf16 tensor-core FLOP/s
    # float32 outside the tensor cores: the port runs float32 with TF32
    # off (the datasheet's FP32 row)
    peak_flops_f32: float = 66.9e12
    hbm_bandwidth: float = 3.35e12    # HBM3, bytes/s
    hbm_capacity: float = 80e9        # bytes
    # shared memory + L1 per SM: 228 KiB of the 256 KiB unified SRAM is
    # configurable as shared memory (the H100 tuning guide)
    vmem_bytes: float = 228 * 2**10


H100_SXM = DeviceSpec()


def detect_device_spec() -> DeviceSpec:
    """The spec of the card the process runs on.  The port models one
    card type, so every H100 (and the CPU, keeping the CPU tests
    deterministic) gets the H100 SXM5 spec; another card is an error,
    since its roofline would be a guess."""
    import torch

    if not torch.cuda.is_available():
        return H100_SXM
    name = torch.cuda.get_device_name(0)
    if "H100" not in name:
        raise NotImplementedError(
            f"no DeviceSpec for {name!r}: the port models the NVIDIA H100 "
            "only; pass a machine-model file (FFConfig.machine_model_file)")
    return H100_SXM


class MachineModel:
    """Interface consumed by the simulator and the searches."""

    version: int = -1

    def num_devices(self) -> int:
        raise NotImplementedError

    def device(self) -> DeviceSpec:
        raise NotImplementedError

    def p2p_time(self, size: int, src: int, dst: int) -> float:
        raise NotImplementedError

    # -- collective costs over a device group ---------------------------
    def allreduce_time(self, size: int, group: Sequence[int]) -> float:
        n = len(group)
        if n <= 1:
            return 0.0
        # ring: 2 (n-1)/n * size over the slowest link in the group
        bw, lat = self._group_link(group)
        return 2.0 * (n - 1) / n * size / bw + 2 * (n - 1) * lat

    def allgather_time(self, size: int, group: Sequence[int]) -> float:
        n = len(group)
        if n <= 1:
            return 0.0
        bw, lat = self._group_link(group)
        return (n - 1) / n * size / bw + (n - 1) * lat

    def reducescatter_time(self, size: int, group: Sequence[int]) -> float:
        return self.allgather_time(size, group)

    def ps_link(self) -> Tuple[float, float]:
        """(bandwidth, latency) of parameter-server gradient sync: the
        reference's flat 2*size/BW estimate (simulator.cc:786-813) rides
        one link to the server."""
        if isinstance(self, GpuNodeModel):
            return self.nvlink_bw, self.nvlink_lat
        return (getattr(self, "intra_bw", 100e9),
                getattr(self, "intra_lat", 1e-6))

    def alltoall_time(self, size: int, group: Sequence[int]) -> float:
        n = len(group)
        if n <= 1:
            return 0.0
        bw, lat = self._group_link(group)
        return (n - 1) / n * size / bw + (n - 1) * lat

    def _group_link(self, group: Sequence[int]) -> Tuple[float, float]:
        """(bandwidth, latency) of the slowest link inside the group."""
        raise NotImplementedError


class SimpleMachineModel(MachineModel):
    """Flat two-level model, the reference's v0 (machine_model.cc:58:
    intra-node bandwidth, inter-node bandwidth / num_nodes).  The
    bandwidth and latency defaults are the reference's."""

    version = 0

    def __init__(self, num_nodes: int = 1, devices_per_node: int = 8,
                 device: DeviceSpec = H100_SXM,
                 intra_bw: float = 100e9, inter_bw: float = 25e9,
                 intra_lat: float = 1e-6, inter_lat: float = 10e-6):
        self._num_nodes = num_nodes
        self._per_node = devices_per_node
        self._device = device
        self.intra_bw, self.inter_bw = intra_bw, inter_bw
        self.intra_lat, self.inter_lat = intra_lat, inter_lat

    def num_devices(self) -> int:
        return self._num_nodes * self._per_node

    def device(self) -> DeviceSpec:
        return self._device

    def node_of(self, d: int) -> int:
        return d // self._per_node

    def p2p_time(self, size: int, src: int, dst: int) -> float:
        if src == dst:
            return 0.0
        if self.node_of(src) == self.node_of(dst):
            return self.intra_lat + size / self.intra_bw
        return self.inter_lat + size / (self.inter_bw / max(1, self._num_nodes))

    def _group_link(self, group: Sequence[int]) -> Tuple[float, float]:
        nodes = {self.node_of(d) for d in group}
        if len(nodes) > 1:
            return self.inter_bw, self.inter_lat
        return self.intra_bw, self.intra_lat


# NVLink-4 on an H100 SXM5: 18 links, 900 GB/s in both directions
# together (NVIDIA H100 datasheet), so 450e9 B/s each way per GPU; the
# NVSwitch crossbar gives every pair of GPUs of an HGX node that rate in
# one hop.
NVLINK_BW = 450e9
# InfiniBand NDR: one 400 Gb/s ConnectX-7 per GPU on an HGX H100
# (NVIDIA DGX H100 user guide), 50e9 B/s each way per GPU.
IB_NDR_BW = 50e9
# Per-step latency of a ring collective.  Model constants, not
# measurements: NVLink through NVSwitch is of the order of a
# microsecond per hop, and an InfiniBand NDR hop with its host-side
# posting of the order of five.
NVLINK_LAT = 1e-6
IB_LAT = 5e-6
# The card's host link: PCIe Gen5 x16 on an H100 SXM5, 128 GB/s in both
# directions together (NVIDIA H100 datasheet), so 64e9 B/s each way.  A
# KV block handed between two replicas on one card crosses it twice, a
# device->host read and a host->device write (serving/disagg.py).
PCIE_GEN5_BW = 64e9
# Per-copy latency of a host<->device transfer: a model constant of the
# order of ten microseconds (a launch and a synchronisation), not a
# measurement.
PCIE_LAT = 10e-6


class GpuNodeModel(MachineModel):
    """HGX H100 nodes: `gpus_per_node` GPUs on one NVSwitch per node,
    `num_nodes` nodes on InfiniBand.

    A collective over a group that fits in one node rides NVLink at
    `nvlink_bw` per GPU per direction; one that spans nodes is a ring
    whose slowest step is a GPU's NIC, at `ib_bw`.  Mesh axes map onto
    GPUs in C order with the last axis fastest; `node_spanning_axes`
    says which axes' groups cross the node boundary under that mapping,
    and the simulator passes it to the axis-aware costs.  NVSwitch is a
    crossbar, so an all-to-all pays no bisection penalty, unlike a
    torus."""

    version = 2

    def __init__(self, num_nodes: int = 1, gpus_per_node: int = 8,
                 device: DeviceSpec = H100_SXM,
                 nvlink_bw: float = NVLINK_BW, nvlink_lat: float = NVLINK_LAT,
                 ib_bw: float = IB_NDR_BW, ib_lat: float = IB_LAT):
        if num_nodes < 1 or gpus_per_node < 1:
            raise ValueError(f"need >= 1 node and >= 1 GPU per node, got "
                             f"{num_nodes} x {gpus_per_node}")
        self.num_nodes = num_nodes
        self.gpus_per_node = gpus_per_node
        self._device = device
        self.nvlink_bw, self.nvlink_lat = nvlink_bw, nvlink_lat
        self.ib_bw, self.ib_lat = ib_bw, ib_lat

    @classmethod
    def from_file(cls, path: str) -> "GpuNodeModel":
        """A machine-model JSON: {"num_nodes", "gpus_per_node",
        "nvlink_bw", "nvlink_lat", "ib_bw", "ib_lat", "device": {...}};
        absent keys take the defaults above."""
        with open(path) as f:
            d = json.load(f)
        return cls(
            num_nodes=int(d.get("num_nodes", 1)),
            gpus_per_node=int(d.get("gpus_per_node", 8)),
            device=DeviceSpec(**d.get("device", {})),
            nvlink_bw=float(d.get("nvlink_bw", NVLINK_BW)),
            nvlink_lat=float(d.get("nvlink_lat", NVLINK_LAT)),
            ib_bw=float(d.get("ib_bw", IB_NDR_BW)),
            ib_lat=float(d.get("ib_lat", IB_LAT)),
        )

    def num_devices(self) -> int:
        return self.num_nodes * self.gpus_per_node

    def device(self) -> DeviceSpec:
        return self._device

    def node_of(self, d: int) -> int:
        return d // self.gpus_per_node

    def p2p_time(self, size: int, src: int, dst: int) -> float:
        if src == dst:
            return 0.0
        if self.node_of(src) == self.node_of(dst):
            return self.nvlink_lat + size / self.nvlink_bw
        return self.ib_lat + size / self.ib_bw

    def _group_link(self, group: Sequence[int]) -> Tuple[float, float]:
        if len({self.node_of(d) for d in group}) > 1:
            return self.ib_bw, self.ib_lat
        return self.nvlink_bw, self.nvlink_lat

    def node_spanning_axes(self, mesh_axes: Dict[str, int]) -> FrozenSet[str]:
        """The mesh axes whose device groups span nodes.  Mesh axes map
        onto GPUs in C order (the last axis fastest), so the GPUs of one
        group of axis `a` lie `stride` apart, `stride` being the product
        of the later axes' sizes; the group fits in one node exactly
        when stride * len(a) <= gpus_per_node (all sizes dividing the
        node).  On {data: 2, model: 8} over two 8-GPU nodes the data
        groups are {0, 8}, {1, 9}, ...: data spans the nodes, model
        does not."""
        out = set()
        stride = 1
        for name, n in reversed(list(mesh_axes.items())):
            if n > 1 and stride * n > self.gpus_per_node:
                out.add(name)
            stride *= n
        return frozenset(out)

    def _axis_link(self, axis_len: int,
                   spans_nodes: bool) -> Tuple[float, float]:
        if spans_nodes or axis_len > self.gpus_per_node:
            return self.ib_bw, self.ib_lat
        return self.nvlink_bw, self.nvlink_lat

    # -- axis-aware collective costs (the simulator's preferred API) ----
    # `spans_nodes` says the group's GPUs lie on more than one node (the
    # caller reads it from node_spanning_axes); a group longer than a
    # node spans nodes whatever the flag says
    def axis_allreduce_time(self, size: int, axis_len: int,
                            spans_nodes: bool = False) -> float:
        """Ring all-reduce: 2 (n-1)/n of the data through each GPU."""
        if axis_len <= 1:
            return 0.0
        bw, lat = self._axis_link(axis_len, spans_nodes)
        return (2.0 * (axis_len - 1) / axis_len * size / bw
                + 2 * (axis_len - 1) * lat)

    def axis_allgather_time(self, size: int, axis_len: int,
                            spans_nodes: bool = False) -> float:
        if axis_len <= 1:
            return 0.0
        bw, lat = self._axis_link(axis_len, spans_nodes)
        return ((axis_len - 1) / axis_len * size / bw
                + (axis_len - 1) * lat)

    def axis_alltoall_time(self, size: int, axis_len: int,
                           spans_nodes: bool = False) -> float:
        # NVSwitch is a crossbar (no bisection penalty); across nodes each
        # GPU's (n-1)/n share leaves through its own NIC
        return self.axis_allgather_time(size, axis_len, spans_nodes)


#: the machine-model files committed with the package
MACHINES_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "machines")


def machine_file(name: str) -> str:
    """Path of a committed machine-model file, e.g. "hgx_h100_8"."""
    return os.path.join(MACHINES_DIR, f"{name}.json")


def make_machine_model(config, num_devices: int) -> MachineModel:
    """Build from FFConfig (--machine-model-version/-file): with
    slices > 1 the multi-slice SliceHierarchy (topology/hierarchy.py),
    whatever the version, unless the devices do not fit it (then the
    flat model, with a warning); a file is a GpuNodeModel; version 0 is
    the reference's SimpleMachineModel over `num_nodes` nodes; any other
    version a GpuNodeModel of that many devices over `num_nodes` nodes.
    The device roofline is the live card's (detect_device_spec)."""
    if getattr(config, "slices", 1) > 1:
        import logging

        from ..topology.hierarchy import hierarchy_from_config

        try:
            return hierarchy_from_config(config, num_devices)
        except ValueError as e:
            logging.getLogger("flexflow_tpu_torch.topology").warning(
                "slice hierarchy unusable for %d devices (%s); falling "
                "back to the flat machine model", num_devices, e)
    if config.machine_model_file:
        return GpuNodeModel.from_file(config.machine_model_file)
    spec = detect_device_spec()
    nodes = max(1, config.num_nodes)
    per_node = max(1, num_devices // nodes)
    if config.machine_model_version == 0:
        return SimpleMachineModel(num_nodes=nodes, devices_per_node=per_node,
                                  device=spec)
    return GpuNodeModel(num_nodes=nodes, gpus_per_node=per_node, device=spec)
