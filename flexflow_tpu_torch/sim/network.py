"""Network topology and routing for the simulator
(flexflow_tpu/sim/network.py, the reference's src/runtime/network.cc
and the NetworkedMachineModel of include/flexflow/simulator.h:172-605).

A connection matrix (entry = the number of links between two nodes),
shortest-path routing with every equal-cost route kept (ECMP), the
generators of the reference (fully connected, big switch, the flat
degree-constrained random graph, the N-D torus and slices of tori
joined node to node), and a `NetworkedMachineModel` whose transfers
follow routed paths: per-hop latency, and the narrowest link's
bandwidth.

Beyond the reference, a link may carry its own bandwidth and latency
(`link_bandwidths`, `link_latencies`), so that a two-tier fabric is
one model: `gpu_node_network` lays a `GpuNodeModel`'s HGX nodes out as
a big switch per node (NVSwitch, at NVLink's rate) plus a link between
the GPUs of the same index of every two nodes (one InfiniBand NIC per
GPU, at its rate), and the task-graph simulator (sim/taskgraph.py)
then prices the same graph over the routed network.
"""
from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .machine_model import (H100_SXM, NVLINK_BW, NVLINK_LAT, DeviceSpec,
                            GpuNodeModel, MachineModel)

ConnectionMatrix = np.ndarray  # int [n, n]; entry = links between nodes


# ----------------------------------------------------------------------
# topology generators
# ----------------------------------------------------------------------

def fully_connected(num_nodes: int) -> ConnectionMatrix:
    conn = np.ones((num_nodes, num_nodes), np.int32)
    np.fill_diagonal(conn, 0)
    return conn


def big_switch(num_nodes: int) -> ConnectionMatrix:
    """num_nodes hosts and one switch (index num_nodes), one link each
    way between every host and the switch (network.cc:577-585)."""
    n = num_nodes + 1
    conn = np.zeros((n, n), np.int32)
    conn[:num_nodes, num_nodes] = 1
    conn[num_nodes, :num_nodes] = 1
    return conn


def flat_degree_constrained(num_nodes: int, degree: int,
                            seed: int = 0) -> ConnectionMatrix:
    """Random connected multigraph with `degree` interfaces per node
    (network.cc:481-558): a random-walk spanning tree first, then a
    random pairing of the interfaces left."""
    if degree < 2:
        raise ValueError("degree must be >= 2 for a connected topology")
    rng = np.random.RandomState(seed)
    conn = np.zeros((num_nodes, num_nodes), np.int32)

    visited = {0}
    curr = 0
    while len(visited) < num_nodes:
        nxt = int(rng.randint(num_nodes))
        if nxt == curr:
            continue
        if nxt not in visited:
            if conn[curr, nxt] == degree:
                continue
            conn[curr, nxt] += 1
            conn[nxt, curr] += 1
            visited.add(nxt)
            curr = nxt

    avail: List[List[int]] = [
        [i, degree - int(conn[i].sum())]
        for i in range(num_nodes) if conn[i].sum() < degree
    ]
    # random pairing, until fewer than two nodes have interfaces left
    guard = 10000
    while len(avail) > 1 and guard:
        guard -= 1
        a, b = rng.randint(len(avail)), rng.randint(len(avail))
        if a == b:
            continue
        na, nb = avail[a][0], avail[b][0]
        if conn[na, nb] >= degree:
            continue
        conn[na, nb] += 1
        conn[nb, na] += 1
        avail[a][1] -= 1
        avail[b][1] -= 1
        avail = [x for x in avail if x[1] > 0]
    return conn


def torus(dims: Sequence[int]) -> ConnectionMatrix:
    """N-D torus: each node links to its +-1 neighbours on every axis,
    with wraparound; an axis of size 2 gets one link, not two."""
    dims = tuple(int(d) for d in dims)
    n = int(np.prod(dims))
    conn = np.zeros((n, n), np.int32)
    strides = np.cumprod((1,) + dims[:-1])

    def flat(coord):
        return int(sum(c * s for c, s in zip(coord, strides)))

    for idx in range(n):
        coord = [(idx // int(s)) % d for s, d in zip(strides, dims)]
        for ax, d in enumerate(dims):
            if d == 1:
                continue
            for delta in (1, -1):
                nb = list(coord)
                nb[ax] = (nb[ax] + delta) % d
                j = flat(nb)
                if j != idx:
                    conn[idx, j] = 1
    return conn


def multi_slice_torus(dims: Sequence[int], slices: int,
                      dcn_links: int = 1) -> ConnectionMatrix:
    """`slices` identical tori joined node to node: node i of every
    slice links to node i of every other slice with `dcn_links`
    parallel links.  Node order is slice-major (node s * per_slice + i
    is node i of slice s), the C order `topology.expand_mesh_axes`
    gives.  All links share one rate unless the model is given
    per-link rates."""
    if slices < 1:
        raise ValueError(f"slices must be >= 1, got {slices}")
    intra = torus(dims)
    per_slice = intra.shape[0]
    n = per_slice * slices
    conn = np.zeros((n, n), np.int32)
    for s in range(slices):
        base = s * per_slice
        conn[base:base + per_slice, base:base + per_slice] = intra
    for i in range(per_slice):
        for a in range(slices):
            for b in range(slices):
                if a != b:
                    conn[a * per_slice + i, b * per_slice + i] = dcn_links
    return conn


# ----------------------------------------------------------------------
# routing
# ----------------------------------------------------------------------

class RoutingStrategy:
    conn: np.ndarray

    def get_routes(self, src: int, dst: int) -> List[List[Tuple[int, int]]]:
        """Equal-cost routes, each a list of (u, v) hops."""
        raise NotImplementedError

    def hop_count(self, src: int, dst: int) -> Tuple[int, int]:
        """(hops, narrowest link multiplicity) along one shortest path."""
        routes = self.get_routes(src, dst)
        if not routes:
            return 0, 0
        r = routes[0]
        narrow = min((self.conn[u, v] for u, v in r), default=0)
        return len(r), int(narrow)


class WeightedShortestPathRouting(RoutingStrategy):
    """Dijkstra over unit weights (network.cc:53-105), every equal-cost
    predecessor kept so that the ECMP route sets are available (at most
    `max_ecmp` routes)."""

    def __init__(self, conn: ConnectionMatrix, max_ecmp: int = 4):
        self.conn = np.asarray(conn)
        self.n = self.conn.shape[0]
        self.max_ecmp = max_ecmp
        self._cache: Dict[int, Tuple[np.ndarray, List[List[int]]]] = {}

    def _sssp(self, src: int) -> Tuple[np.ndarray, List[List[int]]]:
        if src in self._cache:
            return self._cache[src]
        dist = np.full(self.n, np.inf)
        preds: List[List[int]] = [[] for _ in range(self.n)]
        dist[src] = 0.0
        pq: List[Tuple[float, int]] = [(0.0, src)]
        done = np.zeros(self.n, bool)
        while pq:
            d, u = heapq.heappop(pq)
            if done[u]:
                continue
            done[u] = True
            for v in np.nonzero(self.conn[u])[0]:
                nd = d + 1.0
                if nd < dist[v]:
                    dist[v] = nd
                    preds[v] = [u]
                    heapq.heappush(pq, (nd, int(v)))
                elif nd == dist[v] and u not in preds[v]:
                    preds[v].append(u)
        self._cache[src] = (dist, preds)
        return dist, preds

    def get_routes(self, src: int, dst: int) -> List[List[Tuple[int, int]]]:
        if src == dst:
            return []
        if self.conn[src, dst] > 0:
            return [[(src, dst)]]
        _, preds = self._sssp(src)
        routes: List[List[Tuple[int, int]]] = []

        def walk(node: int, suffix: List[Tuple[int, int]]):
            if len(routes) >= self.max_ecmp:
                return
            if node == src:
                routes.append(list(suffix))
                return
            for p in preds[node]:
                walk(p, [(p, node)] + suffix)

        walk(dst, [])
        return routes


# ----------------------------------------------------------------------
# machine model
# ----------------------------------------------------------------------

class NetworkedMachineModel(MachineModel):
    """A MachineModel over any topology (simulator.h:515-605): a
    transfer follows its shortest routed path (a latency per hop, the
    narrowest link's bandwidth); a collective is a ring over the
    group's members with routed hops between neighbours.

    `link_bandwidth` and `link_latency` are per link (an entry of k in
    the connection matrix multiplies the bandwidth by k); the [n, n]
    arrays `link_bandwidths` and `link_latencies`, when given, set each
    link's own.  The first `num_compute_nodes` nodes are the devices (a
    switch is a node after them), each with the roofline `device`."""

    def __init__(self, conn: ConnectionMatrix,
                 link_bandwidth: float = NVLINK_BW,
                 link_latency: float = NVLINK_LAT,
                 device: DeviceSpec = H100_SXM,
                 routing: Optional[RoutingStrategy] = None,
                 num_compute_nodes: Optional[int] = None,
                 link_bandwidths: Optional[np.ndarray] = None,
                 link_latencies: Optional[np.ndarray] = None):
        self.conn = np.asarray(conn)
        self.n = self.conn.shape[0]
        self._num_compute = num_compute_nodes or self.n
        self.link_bw = link_bandwidth
        self.link_lat = link_latency
        self._device = device
        self._bw = (np.full(self.conn.shape, float(link_bandwidth))
                    if link_bandwidths is None
                    else np.asarray(link_bandwidths, np.float64))
        self._lat = (np.full(self.conn.shape, float(link_latency))
                     if link_latencies is None
                     else np.asarray(link_latencies, np.float64))
        self.routing = routing or WeightedShortestPathRouting(self.conn)

    def num_devices(self) -> int:
        return self._num_compute

    def device(self) -> DeviceSpec:
        return self._device

    def link_rate(self, u: int, v: int) -> Tuple[float, float]:
        """(bandwidth, latency) of the directed link u -> v, all its
        parallel links together."""
        return float(self._bw[u, v] * self.conn[u, v]), float(self._lat[u, v])

    def p2p_time(self, size: int, src: int, dst: int) -> float:
        if src == dst:
            return 0.0
        routes = self.routing.get_routes(src, dst)
        if not routes:
            return float("inf")
        best = min(routes, key=len)
        rates = [self.link_rate(u, v) for u, v in best]
        return sum(lat for _, lat in rates) + size / min(bw for bw, _ in rates)

    def _ring_phase_time(self, chunk: float, group: Sequence[int]) -> float:
        """One phase of a ring collective: every member sends `chunk` to
        its successor at once; the slowest routed transfer sets it."""
        k = len(group)
        return max(self.p2p_time(int(chunk), group[i], group[(i + 1) % k])
                   for i in range(k))

    def allreduce_time(self, size: int, group: Sequence[int]) -> float:
        k = len(group)
        if k <= 1:
            return 0.0
        return 2 * (k - 1) * self._ring_phase_time(size / k, list(group))

    def allgather_time(self, size: int, group: Sequence[int]) -> float:
        k = len(group)
        if k <= 1:
            return 0.0
        return (k - 1) * self._ring_phase_time(size / k, list(group))

    def reducescatter_time(self, size: int, group: Sequence[int]) -> float:
        return self.allgather_time(size, group)

    def alltoall_time(self, size: int, group: Sequence[int]) -> float:
        k = len(group)
        if k <= 1:
            return 0.0
        # each member sends size/k to every other, its k-1 routed sends
        # in series, the members in parallel
        return max(sum(self.p2p_time(int(size / k), g, h)
                       for h in group if h != g) for g in group)

    # -- task-graph integration ------------------------------------------
    def link_table(self) -> Tuple[List[Tuple[int, int]],
                                  Dict[Tuple[int, int], int]]:
        """The directed links [(u, v)] and their index, for the
        per-link contention arrays of the task graph."""
        links: List[Tuple[int, int]] = []
        index: Dict[Tuple[int, int], int] = {}
        for u in range(self.n):
            for v in np.nonzero(self.conn[u])[0]:
                index[(u, int(v))] = len(links)
                links.append((u, int(v)))
        return links, index

    def route_links(self, src: int, dst: int,
                    index: Dict[Tuple[int, int], int]) -> List[int]:
        routes = self.routing.get_routes(src, dst)
        if not routes:
            raise ValueError(f"no route {src}->{dst}")
        return [index[hop] for hop in min(routes, key=len)]


def gpu_node_network(machine: GpuNodeModel) -> NetworkedMachineModel:
    """`machine`'s HGX nodes as a routed network: GPU g of node a is
    network node a * gpus_per_node + g; each node's NVSwitch is a big
    switch after the GPUs, joined to every GPU of its node at NVLink's
    rate with half its latency a hop (a GPU-to-GPU path inside a node
    is two hops); GPU g of every node links GPU g of every other node
    at InfiniBand's rate and latency (one NIC per GPU, rail to rail).
    A path between nodes then takes one InfiniBand hop and, between
    GPUs of different index, one NVSwitch crossing."""
    nodes, per = machine.num_nodes, machine.gpus_per_node
    gpus = nodes * per
    n = gpus + nodes
    conn = np.zeros((n, n), np.int32)
    bw = np.zeros((n, n), np.float64)
    lat = np.zeros((n, n), np.float64)
    for a in range(nodes):
        sw = gpus + a
        for g in range(per):
            d = a * per + g
            for u, v in ((d, sw), (sw, d)):
                conn[u, v] = 1
                bw[u, v] = machine.nvlink_bw
                lat[u, v] = machine.nvlink_lat / 2
            for b in range(nodes):
                if b != a:
                    e = b * per + g
                    conn[d, e] = 1
                    bw[d, e] = machine.ib_bw
                    lat[d, e] = machine.ib_lat
    return NetworkedMachineModel(
        conn, link_bandwidth=machine.nvlink_bw,
        link_latency=machine.nvlink_lat, device=machine.device(),
        num_compute_nodes=gpus, link_bandwidths=bw, link_latencies=lat)


__all__ = [
    "ConnectionMatrix", "NetworkedMachineModel", "RoutingStrategy",
    "WeightedShortestPathRouting", "big_switch", "flat_degree_constrained",
    "fully_connected", "gpu_node_network", "multi_slice_torus", "torus",
]
