"""Event-driven task-graph simulation (flexflow_tpu/sim/taskgraph.py):
a native C++ event loop and a pure-Python one with the same semantics.

Reference: the simulator's event loop `simulate_runtime`
(src/runtime/simulator.cc:822-1250) with `expand_allreduce` (:1690).
The hot loop is C++ (native/taskgraph_sim.cc, built with g++ at first
use and loaded through ctypes); the Python loop backs it where no
toolchain is found, and the two are tested for exact agreement.

On the reference's machines devices sit on a bidirectional ring of
links and a collective of k devices runs over k consecutive devices, as
in the reference.  On a GpuNodeModel the network is switched: each GPU
sends through its own NVLink port to a GPU of its node (NVSwitch) and
through its own NIC to a GPU of another node (InfiniBand), and a
collective runs over the GPUs of its mesh axes (C order, read from the
tensors' MachineViews), so a group that spans nodes pays InfiniBand as
the analytic model (sim/simulator.py) does.  Collectives are expanded
into ring phases (an all-reduce over n devices of S bytes is 2(n-1)
phases of n neighbour transfers of S/n bytes), so contention between
overlapping collectives is simulated, which the analytic model cannot
see.  On a NetworkedMachineModel (sim/network.py) every transfer
follows its routed path over the topology's links, each link with its
own rate, and a collective runs over the devices of its mesh axes as
on a switched network.
"""
from __future__ import annotations

import ctypes
import dataclasses
import heapq
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..fftype import OperatorType
from ..pcg.graph import Graph
from .machine_model import GpuNodeModel, MachineModel
from .simulator import (OpCostModel, SimResult, partial_sum_axes,
                        replica_axes, reshard_axes)


@dataclasses.dataclass
class TaskGraphArrays:
    compute_time: np.ndarray  # f64 [T]
    device_of: np.ndarray  # i32 [T]
    dep_offsets: np.ndarray  # i64 [T+1]
    dep_ids: np.ndarray  # i32
    edge_src: np.ndarray  # i32 [E]
    edge_dst: np.ndarray  # i32 [E]
    edge_bytes: np.ndarray  # f64 [E]
    route_offsets: np.ndarray  # i64 [E+1]
    route_links: np.ndarray  # i32
    link_bandwidth: np.ndarray  # f64 [L]
    link_latency: np.ndarray  # f64 [L]
    num_devices: int


class TaskGraphBuilder:
    """Accumulates tasks/deps/edges, then freezes to CSR arrays."""

    def __init__(self, num_devices: int, machine: MachineModel):
        self.machine = machine
        self.D = num_devices
        self._compute: List[float] = []
        self._device: List[int] = []
        self._deps: List[List[int]] = []
        self._edges: List[Tuple[int, int, float, List[int]]] = []
        # a NetworkedMachineModel: one contention link per directed
        # edge of its topology, routed; switched (GpuNodeModel): link
        # 2*d is d's NVLink port, 2*d+1 its NIC; otherwise a
        # bidirectional ring: link 2*d = d -> (d+1)%D, 2*d+1 = d ->
        # (d-1)%D
        from .network import NetworkedMachineModel

        self.net = (machine if isinstance(machine, NetworkedMachineModel)
                    else None)
        self.switched = isinstance(machine, GpuNodeModel)
        if self.net is not None:
            links, self._link_index = machine.link_table()
            rates = [machine.link_rate(u, v) for u, v in links]
            self._link_bw = [bw for bw, _ in rates]
            self._link_lat = [lat for _, lat in rates]
        elif self.switched:
            self._link_bw = [machine.nvlink_bw, machine.ib_bw] * num_devices
            self._link_lat = ([machine.nvlink_lat, machine.ib_lat]
                              * num_devices)
        else:
            bw, lat = getattr(machine, "intra_bw", 100e9), getattr(
                machine, "intra_lat", 1e-6
            )
            self._link_bw = [bw] * (2 * num_devices)
            self._link_lat = [lat] * (2 * num_devices)

    def add_task(self, compute: float, device: int,
                 deps: Sequence[int] = ()) -> int:
        tid = len(self._compute)
        self._compute.append(float(compute))
        self._device.append(int(device))
        self._deps.append(list(deps))
        return tid

    def add_dep(self, task: int, dep: int):
        self._deps[task].append(dep)

    def route(self, src: int, dst: int) -> List[int]:
        """Link ids along src->dst: routed over the topology's shortest
        path on a NetworkedMachineModel (the reference's route_transfer,
        simulator.cc:1488-1689), the sender's NVLink port or NIC on a
        switched network, else over the ring."""
        if src == dst:
            return []
        if self.net is not None:
            return self.net.route_links(src, dst, self._link_index)
        if self.switched:
            same = self.machine.node_of(src) == self.machine.node_of(dst)
            return [2 * src if same else 2 * src + 1]
        return self.ring_route(src, dst)

    def ring_route(self, src: int, dst: int) -> List[int]:
        """Store-and-forward over consecutive ring links, shorter way."""
        if src == dst:
            return []
        D = self.D
        fwd = (dst - src) % D
        bwd = (src - dst) % D
        links = []
        cur = src
        if fwd <= bwd:
            for _ in range(fwd):
                links.append(2 * cur)
                cur = (cur + 1) % D
        else:
            for _ in range(bwd):
                links.append(2 * cur + 1)
                cur = (cur - 1) % D
        return links

    def add_edge(self, src_task: int, dst_task: int, nbytes: float,
                 src_dev: int, dst_dev: int):
        self._edges.append(
            (src_task, dst_task, float(nbytes),
             self.route(src_dev, dst_dev))
        )

    def expand_allreduce(
        self, group: Sequence[int], nbytes: float,
        dep_task_of: Dict[int, int],
    ) -> Dict[int, int]:
        """Ring all-reduce expansion (reference expand_allreduce,
        simulator.cc:1690-1800): 2(n-1) phases of neighbor transfers of
        nbytes/n.  dep_task_of: device -> task the collective waits on.
        Returns device -> final phase task."""
        n = len(group)
        if n <= 1:
            return dict(dep_task_of)
        chunk = nbytes / n
        prev = dict(dep_task_of)
        for _ in range(2 * (n - 1)):
            cur: Dict[int, int] = {}
            for i, d in enumerate(group):
                t = self.add_task(0.0, d, [prev[d]])
                left = group[(i - 1) % n]
                self.add_edge(prev[left], t, chunk, left, d)
                cur[d] = t
            prev = cur
        return prev

    def expand_allgather(
        self, group: Sequence[int], nbytes: float,
        dep_task_of: Dict[int, int],
    ) -> Dict[int, int]:
        """Ring all-gather: n-1 phases of nbytes/n neighbor transfers."""
        n = len(group)
        if n <= 1:
            return dict(dep_task_of)
        chunk = nbytes / n
        prev = dict(dep_task_of)
        for _ in range(n - 1):
            cur: Dict[int, int] = {}
            for i, d in enumerate(group):
                t = self.add_task(0.0, d, [prev[d]])
                left = group[(i - 1) % n]
                self.add_edge(prev[left], t, chunk, left, d)
                cur[d] = t
            prev = cur
        return prev

    def finalize(self) -> TaskGraphArrays:
        T = len(self._compute)
        dep_offsets = np.zeros(T + 1, np.int64)
        for t in range(T):
            dep_offsets[t + 1] = dep_offsets[t] + len(self._deps[t])
        dep_ids = np.asarray(
            [d for deps in self._deps for d in deps], np.int32
        )
        E = len(self._edges)
        route_offsets = np.zeros(E + 1, np.int64)
        for e in range(E):
            route_offsets[e + 1] = route_offsets[e] + len(self._edges[e][3])
        return TaskGraphArrays(
            compute_time=np.asarray(self._compute, np.float64),
            device_of=np.asarray(self._device, np.int32),
            dep_offsets=dep_offsets,
            dep_ids=dep_ids,
            edge_src=np.asarray([e[0] for e in self._edges], np.int32),
            edge_dst=np.asarray([e[1] for e in self._edges], np.int32),
            edge_bytes=np.asarray([e[2] for e in self._edges], np.float64),
            route_offsets=route_offsets,
            route_links=np.asarray(
                [l for e in self._edges for l in e[3]], np.int32
            ),
            link_bandwidth=np.asarray(self._link_bw, np.float64),
            link_latency=np.asarray(self._link_lat, np.float64),
            num_devices=self.D,
        )


# ---------------------------------------------------------------------------
# event loops
# ---------------------------------------------------------------------------

def simulate_native(tg: TaskGraphArrays) -> Optional[Tuple[float, np.ndarray]]:
    """Run the C++ event loop; None when the native lib is unavailable."""
    from ..native import get_lib

    lib = get_lib()
    if lib is None:
        return None
    T = len(tg.compute_time)
    makespan = ctypes.c_double()
    busy = np.zeros(tg.num_devices, np.float64)

    def p(arr, ctype):
        if len(arr) == 0:
            return None
        return arr.ctypes.data_as(ctypes.POINTER(ctype))

    rc = lib.ffsim_simulate(
        ctypes.c_int64(T),
        p(tg.compute_time, ctypes.c_double),
        p(tg.device_of, ctypes.c_int32),
        p(tg.dep_offsets, ctypes.c_int64),
        p(tg.dep_ids, ctypes.c_int32),
        ctypes.c_int64(len(tg.edge_src)),
        p(tg.edge_src, ctypes.c_int32),
        p(tg.edge_dst, ctypes.c_int32),
        p(tg.edge_bytes, ctypes.c_double),
        p(tg.route_offsets, ctypes.c_int64),
        p(tg.route_links, ctypes.c_int32),
        ctypes.c_int64(len(tg.link_bandwidth)),
        p(tg.link_bandwidth, ctypes.c_double),
        p(tg.link_latency, ctypes.c_double),
        ctypes.c_int32(tg.num_devices),
        ctypes.byref(makespan),
        busy.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        None,
    )
    if rc != 0:
        raise RuntimeError(f"ffsim_simulate failed with code {rc}")
    return makespan.value, busy


def simulate_python(tg: TaskGraphArrays) -> Tuple[float, np.ndarray]:
    """Pure-Python event loop, semantically identical to the native one
    (same (time, seq) tie-breaking; tested for exact agreement)."""
    T = len(tg.compute_time)
    remaining = (tg.dep_offsets[1:] - tg.dep_offsets[:-1]).astype(np.int64)
    dep_out: List[List[int]] = [[] for _ in range(T)]
    for t in range(T):
        for i in range(tg.dep_offsets[t], tg.dep_offsets[t + 1]):
            dep_out[tg.dep_ids[i]].append(t)
    edge_out: List[List[int]] = [[] for _ in range(T)]
    for e in range(len(tg.edge_src)):
        edge_out[tg.edge_src[e]].append(e)
        remaining[tg.edge_dst[e]] += 1

    ready_time = np.zeros(T, np.float64)
    link_avail = np.zeros(len(tg.link_bandwidth), np.float64)
    dev_busy = np.zeros(tg.num_devices, np.float64)
    dev_idle = [True] * tg.num_devices
    dev_queue: List[List[Tuple[float, int]]] = [
        [] for _ in range(tg.num_devices)
    ]
    events: List[Tuple[float, int, int, int]] = []  # (time, seq, kind, task)
    seq = 0
    completed = 0
    makespan = 0.0

    for t in range(T):
        if remaining[t] == 0:
            heapq.heappush(events, (0.0, seq, 0, t))
            seq += 1

    def try_start(dev: int, now: float):
        nonlocal seq
        while dev_idle[dev] and dev_queue[dev]:
            ready, task = heapq.heappop(dev_queue[dev])
            start = max(now, ready)
            fin = start + tg.compute_time[task]
            dev_idle[dev] = False
            dev_busy[dev] += tg.compute_time[task]
            heapq.heappush(events, (fin, seq, 1, task))
            seq += 1

    def satisfy(t: int, at: float):
        nonlocal seq
        if at > ready_time[t]:
            ready_time[t] = at
        remaining[t] -= 1
        if remaining[t] == 0:
            heapq.heappush(events, (ready_time[t], seq, 0, t))
            seq += 1

    while events:
        now, _, kind, task = heapq.heappop(events)
        dev = tg.device_of[task]
        if kind == 0:
            heapq.heappush(dev_queue[dev], (now, task))
            try_start(dev, now)
        else:
            completed += 1
            makespan = max(makespan, now)
            for d in dep_out[task]:
                satisfy(d, now)
            for e in edge_out[task]:
                t_cur = now
                for i in range(tg.route_offsets[e], tg.route_offsets[e + 1]):
                    l = tg.route_links[i]
                    begin = max(t_cur, link_avail[l])
                    bw = tg.link_bandwidth[l]
                    done = begin + tg.link_latency[l] + (
                        tg.edge_bytes[e] / bw if bw > 0 else 0.0
                    )
                    link_avail[l] = done
                    t_cur = done
                satisfy(tg.edge_dst[e], t_cur)
            dev_idle[dev] = True
            try_start(dev, now)

    if completed != T:
        raise RuntimeError("task graph has a cycle")
    return makespan, dev_busy


# ---------------------------------------------------------------------------
# PCG -> task graph
# ---------------------------------------------------------------------------

def mesh_groups(mesh_axes: Dict[str, int], axes) -> List[List[int]]:
    """The device groups of a collective over the mesh axes `axes`:
    devices map onto the mesh in C order (the last axis fastest), and a
    group holds the devices that agree on every other axis."""
    sizes = [int(n) for n in mesh_axes.values()]
    coords = np.stack(np.unravel_index(np.arange(int(np.prod(sizes))),
                                       sizes), axis=1)
    keep = [i for i, name in enumerate(mesh_axes) if name not in axes]
    groups: Dict[Tuple, List[int]] = {}
    for d, c in enumerate(coords):
        groups.setdefault(tuple(c[keep]), []).append(d)
    return list(groups.values())


class TaskGraphSimulator:
    """Expand a strategy-applied PCG into an SPMD per-device task graph
    (tasks per (op, device); collectives as ring phases) and run the
    event simulation.  Complements the analytic Simulator: this one sees
    pipelining, device imbalance, and link contention."""

    def __init__(self, machine: MachineModel,
                 cost_model: Optional[OpCostModel] = None,
                 force_python: bool = False,
                 ring_attention: bool = True):
        self.machine = machine
        self.cost_model = cost_model or OpCostModel(machine)
        self.force_python = force_python
        # model seq-sharded attention's KV rotation as ring phases
        # (ablation toggle for tests/what-if costing)
        self.ring_attention = ring_attention

    def build(self, graph: Graph, mesh_axes: Dict[str, int],
              training: bool = True) -> TaskGraphArrays:
        D = 1
        for v in mesh_axes.values():
            D *= v
        b = TaskGraphBuilder(D, self.machine)
        self._mesh = mesh_axes
        # tensor guid -> {device: producing task}
        producer: Dict[int, Dict[int, int]] = {}
        all_devices = list(range(D))
        for op in graph.topo_order():
            if op.op_type == OperatorType.INPUT:
                tasks = {d: b.add_task(0.0, d) for d in all_devices}
                for t in op.outputs:
                    producer[t.guid] = tasks
                continue
            cm = self.cost_model.cost(op)
            compute = cm.forward_time + (cm.backward_time if training else 0.0)
            if op.is_parallel_op():
                compute = 0.0
            tasks = {}
            for d in all_devices:
                deps = [
                    producer[t.guid][d] for t in op.inputs
                    if t.guid in producer
                ]
                tasks[d] = b.add_task(compute, d, deps)
            if op.is_parallel_op():
                tasks = self._expand_parallel_op(b, op, tasks, all_devices)
            else:
                out_rep = (
                    op.outputs[0].shape.replica_degree if op.outputs else 1
                )
                in_rep = max(
                    (t.shape.replica_degree for t in op.inputs), default=1
                )
                if out_rep > in_rep:
                    # contraction-dim partial sums -> psum (ring allreduce)
                    k = out_rep // max(1, in_rep)
                    size = op.outputs[0].shape.shard_bytes()
                    tasks = self._grouped_collective(
                        b, "allreduce", k, size, tasks, all_devices,
                        partial_sum_axes(op),
                    )
                if (
                    self.ring_attention
                    and op.op_type == OperatorType.MULTIHEAD_ATTENTION
                    and len(op.inputs) >= 3
                ):
                    # ring attention: seq-sharded KV rotates once around
                    # the sp group per forward (ppermute per block step),
                    # ~2x more for backward re-rotation + dK/dV — the
                    # bandwidth equivalent of 3 allgathers of the local
                    # KV (replaces the analytic flat term, unity.py
                    # _sp_candidates)
                    dd = [
                        d for d in op.inputs[0].shape.dims
                        if not d.is_replica_dim
                    ]
                    if len(dd) >= 2 and dd[1].degree > 1:
                        sp = dd[1].degree
                        kv = (
                            op.inputs[1].shape.shard_bytes()
                            + op.inputs[2].shape.shard_bytes()
                        )
                        tasks = self._grouped_collective(
                            b, "allgather", sp,
                            3.0 * kv * sp if training else kv * sp,
                            tasks, all_devices, _seq_axes(op.inputs[0]),
                        )
            for t in op.outputs:
                producer[t.guid] = tasks
        if training:
            # gradient sync: ring allreduce per replicated weight, hanging
            # off that op's tasks (reference optimizer ncclAllReduce)
            for op in graph.ops:
                if op.op_type == OperatorType.INPUT or op.is_parallel_op():
                    continue
                base = (
                    producer[op.outputs[0].guid] if op.outputs else None
                )
                if base is None:
                    continue
                for w in op.weights:
                    rep = w.shape.replica_degree
                    if rep > 1 and w.create_gradients:
                        self._grouped_collective(
                            b, "allreduce", rep, w.shape.shard_bytes(),
                            base, all_devices, replica_axes(w),
                        )
        return b.finalize()

    def _grouped_collective(self, b: TaskGraphBuilder, kind: str, k: int,
                            size: float, dep_tasks: Dict[int, int],
                            all_devices: List[int],
                            axes=None) -> Dict[int, int]:
        """Run a collective over groups of size k: on a switched network
        the groups of its mesh axes `axes` (None: the tensors carry no
        views), else contiguous groups as in the reference."""
        D = len(all_devices)
        k = min(k, D)
        if (b.switched or b.net is not None) and axes is not None:
            groups = mesh_groups(self._mesh, axes)
            if len(groups[0]) != k:
                raise RuntimeError(
                    f"a {kind} of {k} devices over mesh axes "
                    f"{sorted(axes)} of {self._mesh}: the views disagree "
                    "with the degrees")
        else:
            groups = [all_devices[g * k:(g + 1) * k]
                      for g in range(max(1, D // k))]
        out: Dict[int, int] = {}
        for group in groups:
            if not group:
                continue
            deps = {d: dep_tasks[d] for d in group}
            fn = (b.expand_allreduce if kind == "allreduce"
                  else b.expand_allgather)
            res = fn(group, size, deps)
            out.update(res)
        for d in all_devices:
            out.setdefault(d, dep_tasks[d])
        return out

    def _expand_parallel_op(self, b: TaskGraphBuilder, op,
                            tasks: Dict[int, int],
                            all_devices: List[int]) -> Dict[int, int]:
        t = op.op_type
        out_shape = op.outputs[0].shape
        axes = reshard_axes(op)
        if t == OperatorType.COMBINE:
            return self._grouped_collective(
                b, "allgather", op.params.degree,
                op.inputs[0].shape.shard_bytes() * op.params.degree,
                tasks, all_devices, axes,
            )
        if t == OperatorType.REDUCTION:
            return self._grouped_collective(
                b, "allreduce", op.params.degree,
                out_shape.shard_bytes(), tasks, all_devices, axes,
            )
        if t == OperatorType.REPLICATE:
            return self._grouped_collective(
                b, "allgather", op.params.degree,
                out_shape.shard_bytes(), tasks, all_devices, axes,
            )
        if t == OperatorType.ALLTOALL:
            # each device exchanges shard/n with every peer: model as one
            # ring allgather of the shard (bandwidth-equivalent on a ring)
            return self._grouped_collective(
                b, "allgather", op.params.degree,
                out_shape.shard_bytes(), tasks, all_devices, axes,
            )
        # Repartition of on-device data: slicing, no transfer
        return tasks

    def simulate(self, graph: Graph, mesh_axes: Dict[str, int],
                 training: bool = True) -> SimResult:
        tg = self.build(graph, mesh_axes, training)
        res = None if self.force_python else simulate_native(tg)
        used_native = res is not None
        if res is None:
            res = simulate_python(tg)
        makespan, busy = res
        compute = float(busy.max()) if len(busy) else 0.0
        return SimResult(
            total_time=makespan,
            compute_time=compute,
            comm_time=makespan - compute,
            sync_time=0.0,
            per_device_memory=0,
            breakdown={"native": float(used_native)},
        )


def _seq_axes(pt):
    """The mesh axes of a tensor's sequence dim (its second non-replica
    dim), from its MachineView; None without one."""
    view = getattr(pt, "machine_view", None)
    if view is None:
        return None
    dims = [i for i, d in enumerate(pt.shape.dims) if not d.is_replica_dim]
    return frozenset(view.axes[dims[1]])
