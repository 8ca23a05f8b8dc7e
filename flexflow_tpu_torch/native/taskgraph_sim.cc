// Discrete-event task-graph simulator: the native core of the
// strategy-cost engine (a copy of flexflow_tpu/native/taskgraph_sim.cc).
//
// Counterpart of the reference's C++ simulator event loop
// (src/runtime/simulator.cc:822-1250 simulate_runtime, with routed
// per-link transfers and ring all-reduce expansion).  A single
// chronological event heap drives per-device FIFO execution and per-link
// FIFO transfer serialization; collectives arrive already expanded into
// ring phases by the Python builder (sim/taskgraph.py).
//
// Build: g++ -O2 -std=c++17 -shared -fPIC, at first use, by
// flexflow_tpu_torch/native/__init__.py into flexflow_tpu_torch/_build/.
// ABI: plain C, consumed via ctypes; arrays are CSR-encoded.
//
// Determinism contract (mirrored by the pure-Python loop in
// sim/taskgraph.py): ties broken by (time, sequence-number), transfers
// scheduled in the chronological order of their producing task's finish
// event, links traversed store-and-forward in route order.

#include <cstdint>
#include <cstring>
#include <queue>
#include <vector>

namespace {

struct Event {
  double time;
  int64_t seq;   // tie-break: deterministic ordering
  int kind;      // 0 = task ready on its device, 1 = task finish
  int64_t task;
  bool operator>(const Event& o) const {
    if (time != o.time) return time > o.time;
    if (seq != o.seq) return seq > o.seq;
    return task > o.task;
  }
};

struct ReadyItem {
  double ready;
  int64_t task;
  bool operator>(const ReadyItem& o) const {
    if (ready != o.ready) return ready > o.ready;
    return task > o.task;
  }
};

}  // namespace

extern "C" {

// Returns 0 on success, nonzero on malformed input (cycle / bad ids).
//
// Tasks: num_tasks entries; compute_time[t] seconds on device_of[t].
// Dependencies (plain, same- or cross-device with zero transfer):
//   CSR dep_offsets[num_tasks+1] -> dep_ids[].
// Comm edges (producer -> consumer with routed transfer):
//   num_edges entries, edge_src/edge_dst tasks, edge_bytes[],
//   CSR route_offsets[num_edges+1] -> route_links[] (link ids in
//   traversal order; empty route = zero-time dependency).
// Links: link_bandwidth[l] bytes/s, link_latency[l] seconds.
// Outputs: out_makespan, out_device_busy[num_devices],
//   out_finish[num_tasks] (may be null).
int ffsim_simulate(
    int64_t num_tasks, const double* compute_time, const int32_t* device_of,
    const int64_t* dep_offsets, const int32_t* dep_ids,
    int64_t num_edges, const int32_t* edge_src, const int32_t* edge_dst,
    const double* edge_bytes,
    const int64_t* route_offsets, const int32_t* route_links,
    int64_t num_links, const double* link_bandwidth,
    const double* link_latency,
    int32_t num_devices,
    double* out_makespan, double* out_device_busy, double* out_finish) {
  if (num_tasks <= 0 || num_devices <= 0) return 1;

  // per-task incoming counts = plain deps + incoming comm edges
  std::vector<int64_t> remaining(num_tasks, 0);
  std::vector<double> ready_time(num_tasks, 0.0);
  for (int64_t t = 0; t < num_tasks; ++t)
    remaining[t] = dep_offsets[t + 1] - dep_offsets[t];
  // outgoing adjacency for plain deps: build reverse CSR
  std::vector<std::vector<int32_t>> dep_out(num_tasks);
  for (int64_t t = 0; t < num_tasks; ++t)
    for (int64_t i = dep_offsets[t]; i < dep_offsets[t + 1]; ++i) {
      int32_t p = dep_ids[i];
      if (p < 0 || p >= num_tasks) return 2;
      dep_out[p].push_back((int32_t)t);
    }
  std::vector<std::vector<int32_t>> edge_out(num_tasks);
  for (int64_t e = 0; e < num_edges; ++e) {
    if (edge_src[e] < 0 || edge_src[e] >= num_tasks) return 2;
    if (edge_dst[e] < 0 || edge_dst[e] >= num_tasks) return 2;
    edge_out[edge_src[e]].push_back((int32_t)e);
    remaining[edge_dst[e]] += 1;
  }

  std::vector<double> link_avail(num_links, 0.0);
  std::vector<double> dev_busy(num_devices, 0.0);
  std::vector<bool> dev_idle(num_devices, true);
  std::vector<double> finish(num_tasks, 0.0);
  std::vector<std::priority_queue<ReadyItem, std::vector<ReadyItem>,
                                  std::greater<ReadyItem>>>
      dev_queue(num_devices);

  std::priority_queue<Event, std::vector<Event>, std::greater<Event>> events;
  int64_t seq = 0;
  int64_t completed = 0;
  double makespan = 0.0;

  for (int64_t t = 0; t < num_tasks; ++t)
    if (remaining[t] == 0)
      events.push(Event{0.0, seq++, 0, t});

  auto try_start = [&](int32_t dev, double now) {
    while (dev_idle[dev] && !dev_queue[dev].empty()) {
      ReadyItem it = dev_queue[dev].top();
      dev_queue[dev].pop();
      double start = now > it.ready ? now : it.ready;
      double fin = start + compute_time[it.task];
      dev_idle[dev] = false;
      dev_busy[dev] += compute_time[it.task];
      finish[it.task] = fin;
      events.push(Event{fin, seq++, 1, it.task});
    }
  };

  auto satisfy = [&](int64_t t, double at) {
    if (at > ready_time[t]) ready_time[t] = at;
    if (--remaining[t] == 0)
      events.push(Event{ready_time[t], seq++, 0, t});
  };

  while (!events.empty()) {
    Event ev = events.top();
    events.pop();
    double now = ev.time;
    int32_t dev = device_of[ev.task];
    if (dev < 0 || dev >= num_devices) return 3;
    if (ev.kind == 0) {  // ready
      dev_queue[dev].push(ReadyItem{now, ev.task});
      try_start(dev, now);
    } else {  // finish
      ++completed;
      if (now > makespan) makespan = now;
      // plain dependents
      for (int32_t d : dep_out[ev.task]) satisfy(d, now);
      // routed transfers, in deterministic (finish-event, edge) order
      for (int32_t e : edge_out[ev.task]) {
        double t = now;
        for (int64_t i = route_offsets[e]; i < route_offsets[e + 1]; ++i) {
          int32_t l = route_links[i];
          if (l < 0 || l >= num_links) return 4;
          double begin = t > link_avail[l] ? t : link_avail[l];
          double done = begin + link_latency[l] +
                        (link_bandwidth[l] > 0.0
                             ? edge_bytes[e] / link_bandwidth[l]
                             : 0.0);
          link_avail[l] = done;
          t = done;
        }
        satisfy(edge_dst[e], t);
      }
      dev_idle[dev] = true;
      try_start(dev, now);
    }
  }

  if (completed != num_tasks) return 5;  // cycle or unreachable tasks
  *out_makespan = makespan;
  if (out_device_busy)
    std::memcpy(out_device_busy, dev_busy.data(),
                sizeof(double) * num_devices);
  if (out_finish)
    std::memcpy(out_finish, finish.data(), sizeof(double) * num_tasks);
  return 0;
}

// ABI version probe for the ctypes loader.
int ffsim_abi_version() { return 1; }

}  // extern "C"
