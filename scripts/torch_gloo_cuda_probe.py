"""Which torch.distributed collectives the `gloo` backend takes on CUDA
tensors under this machine's torch build.

Spawns two ranks that share card 0 and, for each collective the port's
executor uses, joins them into a fresh gloo group (a collective that
fails can break the group's connections) and calls it directly on CUDA
tensors (no staging through host memory), checking the values.  Prints one JSON line:
{"torch": ..., "cuda": ..., "card": ..., "collectives": {name: "ok" or
the error}}.  Run on a machine with a card:

    python3 scripts/torch_gloo_cuda_probe.py
"""
import datetime
import json
import socket
import sys
import tempfile


def _rank(rank, ports, out_dir):
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    x = torch.full((4,), float(rank + 1), device=dev)

    def all_reduce():
        t = x.clone()
        dist.all_reduce(t)
        assert t.tolist() == [3.0] * 4

    def all_gather():
        parts = [torch.empty_like(x) for _ in range(2)]
        dist.all_gather(parts, x)
        assert parts[1].tolist() == [2.0] * 4

    def all_gather_into_tensor():
        out = torch.empty(8, device=dev)
        dist.all_gather_into_tensor(out, x)
        assert out.tolist() == [1.0] * 4 + [2.0] * 4

    def reduce_scatter():
        out = torch.empty(2, device=dev)
        dist.reduce_scatter(out, [x[:2].clone(), x[2:].clone()])
        assert out.tolist() == [3.0] * 2

    def reduce_scatter_tensor():
        out = torch.empty(2, device=dev)
        dist.reduce_scatter_tensor(out, x.clone())
        assert out.tolist() == [3.0] * 2

    def all_to_all_single():
        out = torch.empty(4, device=dev)
        dist.all_to_all_single(out, x.clone())
        assert out.tolist() == [1.0, 1.0, 2.0, 2.0]

    def batch_isend_irecv():
        buf = torch.empty_like(x)
        peer = 1 - rank
        reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, x, peer),
                                       dist.P2POp(dist.irecv, buf, peer)])
        for r in reqs:
            r.wait()
        assert buf.tolist() == [float(peer + 1)] * 4

    def broadcast():
        t = x.clone()
        dist.broadcast(t, 0)
        assert t.tolist() == [1.0] * 4

    out = {}
    fns = (all_reduce, all_gather, all_gather_into_tensor, reduce_scatter,
           reduce_scatter_tensor, all_to_all_single, batch_isend_irecv,
           broadcast)
    for fn, port in zip(fns, ports):
        dist.init_process_group("gloo",
                                init_method=f"tcp://localhost:{port}",
                                world_size=2, rank=rank,
                                timeout=datetime.timedelta(seconds=30))
        try:
            fn()
            torch.cuda.synchronize()
            out[fn.__name__] = "ok"
        except Exception as e:  # the probe's finding, not a failure
            out[fn.__name__] = f"{type(e).__name__}: {str(e)[:160]}"
        dist.destroy_process_group()
        with open(f"{out_dir}/{rank}.json", "w") as f:
            json.dump(out, f)


def main() -> int:
    import multiprocessing as mp
    import subprocess

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    socks = [socket.socket() for _ in range(8)]
    for s in socks:
        s.bind(("localhost", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    with tempfile.TemporaryDirectory() as d:
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_rank, args=(r, ports, d))
                 for r in range(2)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(300)
            if p.is_alive():
                p.kill()
        found = {}
        for r in range(2):
            try:
                with open(f"{d}/{r}.json") as f:
                    found[f"rank{r}"] = json.load(f)
            except FileNotFoundError:
                found[f"rank{r}"] = f"no result (exit {procs[r].exitcode})"
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "card": card, "collectives": found}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
