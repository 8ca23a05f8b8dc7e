"""The port's topology-routed simulator (tests/test_network_sim.py):
sim/network.py's generators, shortest-path and ECMP routing,
`NetworkedMachineModel`'s transfer times, and routed task graphs in the
Python and the C++ event loops; then the port's addition, per-link
rates, with which `gpu_node_network` lays HGX H100 nodes out as
NVSwitch big switches joined GPU to GPU by InfiniBand.

Each generator's matrix, each route set and each time is held against
the reference's on the same inputs (the same rates where a rate
enters).
"""
import numpy as np
import pytest

from flexflow_tpu.sim import network as RN
from flexflow_tpu.sim import taskgraph as RT
from flexflow_tpu_torch.sim.machine_model import (GpuNodeModel,
                                                  SimpleMachineModel,
                                                  machine_file)
from flexflow_tpu_torch.sim.network import (NetworkedMachineModel,
                                            WeightedShortestPathRouting,
                                            big_switch,
                                            flat_degree_constrained,
                                            fully_connected, gpu_node_network,
                                            multi_slice_torus, torus)
from flexflow_tpu_torch.sim import taskgraph as PT
from flexflow_tpu_torch.sim.taskgraph import (TaskGraphBuilder,
                                              simulate_native,
                                              simulate_python)


def _connected(conn):
    n = conn.shape[0]
    seen = {0}
    stack = [0]
    while stack:
        u = stack.pop()
        for v in np.nonzero(conn[u])[0]:
            if int(v) not in seen:
                seen.add(int(v))
                stack.append(int(v))
    return len(seen) == n


def test_generators_shapes_and_connectivity():
    fc = fully_connected(5)
    assert fc.shape == (5, 5) and fc.diagonal().sum() == 0 and _connected(fc)
    np.testing.assert_array_equal(fc, RN.fully_connected(5))
    bs = big_switch(6)
    assert bs.shape == (7, 7) and _connected(bs)
    assert bs[:6, :6].sum() == 0
    np.testing.assert_array_equal(bs, RN.big_switch(6))
    for seed in range(3):
        fd = flat_degree_constrained(8, degree=3, seed=seed)
        assert _connected(fd)
        assert (fd.sum(axis=1) <= 3).all()
        assert (fd == fd.T).all()
        np.testing.assert_array_equal(
            fd, RN.flat_degree_constrained(8, degree=3, seed=seed))


def test_torus_generator():
    t = torus((4, 4))
    assert t.shape == (16, 16) and _connected(t)
    assert (t.sum(axis=1) == 4).all()
    t3 = torus((2, 2, 2))
    assert _connected(t3)
    assert (t3.sum(axis=1) == 3).all()
    for dims in ((4, 4), (2, 2, 2), (3, 5)):
        np.testing.assert_array_equal(torus(dims), RN.torus(dims))


def test_multi_slice_torus_generator():
    conn = multi_slice_torus((2, 2), slices=3, dcn_links=2)
    assert conn.shape == (12, 12) and _connected(conn)
    assert (conn[:4, :4] == torus((2, 2))).all()
    assert conn[0, 4] == 2 and conn[4, 8] == 2
    assert conn[0, 5] == 0
    assert (conn == conn.T).all()
    np.testing.assert_array_equal(
        conn, RN.multi_slice_torus((2, 2), slices=3, dcn_links=2))


def test_shortest_path_routing():
    conn = np.zeros((4, 4), np.int32)
    for i in range(3):
        conn[i, i + 1] = conn[i + 1, i] = 1
    r = WeightedShortestPathRouting(conn)
    assert r.get_routes(0, 3) == [[(0, 1), (1, 2), (2, 3)]]
    hops, narrow = r.hop_count(0, 3)
    assert hops == 3 and narrow == 1
    assert r.get_routes(2, 2) == []
    assert r.get_routes(1, 2) == [[(1, 2)]]
    ref = RN.WeightedShortestPathRouting(conn)
    for s in range(4):
        for d in range(4):
            assert r.get_routes(s, d) == ref.get_routes(s, d)


def test_ecmp_multiple_routes():
    conn = np.zeros((4, 4), np.int32)
    for u, v in [(0, 1), (1, 3), (0, 2), (2, 3)]:
        conn[u, v] = conn[v, u] = 1
    r = WeightedShortestPathRouting(conn)
    routes = r.get_routes(0, 3)
    assert len(routes) == 2
    assert sorted(tuple(x) for x in routes) == [((0, 1), (1, 3)),
                                                ((0, 2), (2, 3))]
    big = flat_degree_constrained(12, degree=3, seed=4)
    mine, ref = (WeightedShortestPathRouting(big),
                 RN.WeightedShortestPathRouting(big))
    for s in range(12):
        for d in range(12):
            assert mine.get_routes(s, d) == ref.get_routes(s, d)


def test_networked_machine_model_times():
    conn = torus((4,))
    m = NetworkedMachineModel(conn, link_bandwidth=1e9, link_latency=1e-6)
    ref = RN.NetworkedMachineModel(conn, link_bandwidth=1e9,
                                   link_latency=1e-6)
    direct = m.p2p_time(1 << 20, 0, 1)
    two_hop = m.p2p_time(1 << 20, 0, 2)
    assert two_hop > direct
    assert np.isclose(direct, 1e-6 + (1 << 20) / 1e9)
    ar = m.allreduce_time(1 << 20, [0, 1, 2, 3])
    ag = m.allgather_time(1 << 20, [0, 1, 2, 3])
    assert ar > ag > 0
    assert np.isclose(ar / ag, 2.0)
    assert m.allreduce_time(1 << 20, [0]) == 0.0
    group = [0, 1, 2, 3]
    for got, want in (
            (two_hop, ref.p2p_time(1 << 20, 0, 2)),
            (ar, ref.allreduce_time(1 << 20, group)),
            (ag, ref.allgather_time(1 << 20, group)),
            (m.reducescatter_time(1 << 20, group),
             ref.reducescatter_time(1 << 20, group)),
            (m.alltoall_time(1 << 20, group),
             ref.alltoall_time(1 << 20, group))):
        assert got == pytest.approx(want, rel=1e-12)


def test_bigger_links_are_faster():
    fat = NetworkedMachineModel(2 * torus((4,)), link_bandwidth=1e9)
    thin = NetworkedMachineModel(torus((4,)), link_bandwidth=1e9)
    assert fat.p2p_time(1 << 20, 0, 1) < thin.p2p_time(1 << 20, 0, 1)


def _contention(pkg, pairs):
    conn = np.zeros((3, 3), np.int32)
    conn[0, 1] = conn[1, 0] = 1
    conn[1, 2] = conn[2, 1] = 1
    if pkg is RT:
        m = RN.NetworkedMachineModel(conn, link_bandwidth=1e9,
                                     link_latency=0.0, compute_tflops=1.0)
    else:
        m = NetworkedMachineModel(conn, link_bandwidth=1e9, link_latency=0.0)
    b = pkg.TaskGraphBuilder(3, m)
    srcs = {}
    for s, _ in pairs:
        if s not in srcs:
            srcs[s] = b.add_task(0.0, s)
    for s, d in pairs:
        t = b.add_task(0.0, d)
        b.add_edge(srcs[s], t, 1e6, s, d)
    total, _ = pkg.simulate_python(b.finalize())
    return total


def test_routed_taskgraph_contention():
    """Two transfers on the same links serialize: one takes 2 ms over
    its two hops, two take 3 ms; the reference's loop reads the same."""
    shared = _contention(PT, [(0, 2), (0, 2)])
    single = _contention(PT, [(0, 2)])
    assert np.isclose(single, 2e-3)
    assert np.isclose(shared, 3e-3)
    assert shared == _contention(RT, [(0, 2), (0, 2)])


def _random_graph(m, n, seed=0):
    rng = np.random.RandomState(seed)
    b = TaskGraphBuilder(n, m)
    prev = [b.add_task(rng.rand() * 1e-3, d) for d in range(n)]
    for _ in range(4):
        cur = []
        for d in range(n):
            t = b.add_task(rng.rand() * 1e-3, d, [prev[d]])
            src = int(rng.randint(n))
            b.add_edge(prev[src], t, rng.rand() * 1e6, src, d)
            cur.append(t)
        prev = cur
    return b.finalize()


def test_native_sim_agrees_on_routed_topology():
    conn = flat_degree_constrained(6, degree=3, seed=1)
    m = NetworkedMachineModel(conn, link_bandwidth=1e9, link_latency=1e-6)
    tg = _random_graph(m, 6)
    res = simulate_native(tg)
    if res is None:
        pytest.skip("native lib unavailable")
    total_n, busy_n = res
    total_p, busy_p = simulate_python(tg)
    assert np.isclose(total_n, total_p, rtol=1e-12)
    np.testing.assert_allclose(busy_n, busy_p, rtol=1e-12)
    ref = RN.NetworkedMachineModel(conn, link_bandwidth=1e9,
                                   link_latency=1e-6, compute_tflops=1.0)
    rng = np.random.RandomState(0)
    rb = RT.TaskGraphBuilder(6, ref)
    prev = [rb.add_task(rng.rand() * 1e-3, d) for d in range(6)]
    for _ in range(4):
        cur = []
        for d in range(6):
            t = rb.add_task(rng.rand() * 1e-3, d, [prev[d]])
            src = int(rng.randint(6))
            rb.add_edge(prev[src], t, rng.rand() * 1e6, src, d)
            cur.append(t)
        prev = cur
    assert RT.simulate_python(rb.finalize())[0] == pytest.approx(total_p,
                                                                 rel=1e-12)


def test_taskgraph_ring_fallback_still_works():
    m = SimpleMachineModel(num_nodes=1, devices_per_node=4)
    b = TaskGraphBuilder(4, m)
    t0 = b.add_task(1e-3, 0)
    t1 = b.add_task(1e-3, 2, [t0])
    b.add_edge(t0, t1, 1e6, 0, 2)
    total, _ = simulate_python(b.finalize())
    assert np.isfinite(total) and total > 0


# -- per-link rates: HGX H100 nodes as a routed network -------------------

def test_gpu_node_network_prices_transfers_as_the_node_model():
    """Inside a node a GPU reaches another through NVSwitch (two hops of
    half NVLink's latency, at its rate); between nodes GPU g reaches GPU
    g of the other node in one InfiniBand hop, and another GPU through
    one NVSwitch crossing more."""
    node = GpuNodeModel.from_file(machine_file("hgx_h100_16"))
    net = gpu_node_network(node)
    assert net.num_devices() == 16 and net.conn.shape == (18, 18)
    size = 64 << 20
    for src, dst in ((0, 5), (0, 8), (3, 11)):
        assert net.p2p_time(size, src, dst) == pytest.approx(
            node.p2p_time(size, src, dst), rel=1e-12)
    assert net.p2p_time(size, 0, 9) == pytest.approx(
        node.p2p_time(size, 0, 9) + node.nvlink_lat, rel=1e-12)
    assert net.device() == node.device()


def test_gpu_node_network_routes_a_task_graph_both_loops():
    """A task graph over 2 nodes x 2 GPUs routed through the switches and
    the NICs: the C++ loop agrees with the Python one to 1e-12, and a
    transfer between nodes costs InfiniBand's rate."""
    node = GpuNodeModel(num_nodes=2, gpus_per_node=2)
    net = gpu_node_network(node)
    tg = _random_graph(net, 4, seed=3)
    total_p, busy_p = simulate_python(tg)
    res = simulate_native(tg)
    if res is None:
        pytest.skip("native lib unavailable")
    assert np.isclose(res[0], total_p, rtol=1e-12)
    np.testing.assert_allclose(res[1], busy_p, rtol=1e-12)
    b = TaskGraphBuilder(4, net)
    t0 = b.add_task(0.0, 0)
    t1 = b.add_task(0.0, 2, [])
    b.add_edge(t0, t1, 50e6, 0, 2)
    total, _ = simulate_python(b.finalize())
    assert total == pytest.approx(node.ib_lat + 50e6 / node.ib_bw, rel=1e-12)


def test_task_graph_simulator_prices_a_strategy_on_both_machine_forms():
    """The same strategy-applied graph priced by TaskGraphSimulator on a
    GpuNodeModel (switched) and on its routed network: both finite and
    positive, and equal where no collective crosses a node."""
    from flexflow_tpu_torch import FFConfig, FFModel
    from flexflow_tpu_torch.sim.taskgraph import TaskGraphSimulator
    from flexflow_tpu_torch.strategy import (apply_strategy, assign_views,
                                             data_parallel_strategy)

    ff = FFModel(FFConfig(device="cpu", batch_size=16))
    x = ff.create_tensor([16, 64], name="x")
    t = ff.dense(x, 64)
    ff.dense(t, 4)
    s = data_parallel_strategy(4)
    g = apply_strategy(ff.layers, s)
    assign_views(g, s.mesh_axes)
    prices = {}
    for nodes in (1, 2):
        node = GpuNodeModel(num_nodes=nodes, gpus_per_node=4 // nodes)
        for form, m in (("switched", node), ("routed", gpu_node_network(node))):
            res = TaskGraphSimulator(m).simulate(g, s.mesh_axes)
            assert np.isfinite(res.total_time) and res.total_time > 0
            prices[nodes, form] = res.total_time
    assert prices[2, "routed"] > prices[1, "routed"]
    assert prices[2, "switched"] > prices[1, "switched"]
