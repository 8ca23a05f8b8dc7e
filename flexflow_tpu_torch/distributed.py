"""Multi-process bring-up (flexflow_tpu/distributed.py): joining this
process into a `torch.distributed` group, and feeding each rank its
rows of the global batch.

Every rank runs the same script.  `initialize` resolves the group the
way the reference does, then calls `torch.distributed.init_process_group`
and selects this rank's card.  The preemption barrier waits for the
store layer (ROADMAP §1.E).
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


def _env_int(*names: str) -> Optional[int]:
    for name in names:
        v = os.environ.get(name)
        if v is not None and v != "":
            return int(v)
    return None


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids: Optional[Sequence[int]] = None, *,
               backend: Optional[str] = None,
               device: str = "cuda") -> bool:
    """Join this process into a torch.distributed group.

    Resolution order, the reference's:
      1. explicit arguments;
      2. ``FLEXFLOW_COORDINATOR`` / ``FLEXFLOW_NUM_PROCS`` /
         ``FLEXFLOW_PROC_ID``, or the OMPI rank variables under mpirun;
      3. the launcher's ``MASTER_ADDR``:``MASTER_PORT`` / ``WORLD_SIZE``
         / ``RANK`` (torchrun), as jax.distributed.initialize()
         autodetects a pod.
    With none of these this is one process: returns False.  A launch of
    more than one process without a coordinator raises ValueError.

    The backend is NCCL with one rank per card, unless `device` is
    "cpu" or `backend` names another (gloo, when ranks share a card).
    On CUDA the rank computes on `cuda:local_device_ids[0]`, else
    ``cuda:LOCAL_RANK`` (``OMPI_COMM_WORLD_LOCAL_RANK``), else
    ``cuda:rank % device_count``.  Returns True when the group has more
    than one process.  Idempotent."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    if coordinator_address is None:
        coordinator_address = os.environ.get("FLEXFLOW_COORDINATOR")
    if num_processes is None:
        num_processes = _env_int("FLEXFLOW_NUM_PROCS",
                                 "OMPI_COMM_WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("FLEXFLOW_PROC_ID", "OMPI_COMM_WORLD_RANK")
    if coordinator_address is None and num_processes is None \
            and "MASTER_ADDR" in os.environ:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
        num_processes = _env_int("WORLD_SIZE")
        process_id = _env_int("RANK")
    if coordinator_address is None:
        if num_processes is not None and num_processes > 1:
            raise ValueError(
                "multi-process launch needs a coordinator: set "
                "FLEXFLOW_COORDINATOR=<rank0-host:port> (or pass "
                "coordinator_address=)")
        return False
    if num_processes is None or process_id is None:
        raise ValueError(
            f"coordinator {coordinator_address} given without the number "
            "of processes and this process's id (FLEXFLOW_NUM_PROCS, "
            "FLEXFLOW_PROC_ID)")
    on_cpu = torch.device(device).type == "cpu"
    backend = backend or ("gloo" if on_cpu else "nccl")
    if not on_cpu:
        if local_device_ids:
            local = int(local_device_ids[0])
        else:
            local = _env_int("LOCAL_RANK", "OMPI_COMM_WORLD_LOCAL_RANK")
            if local is None:
                local = process_id % max(1, torch.cuda.device_count())
        torch.cuda.set_device(local)
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=url,
                            world_size=int(num_processes),
                            rank=int(process_id))
    return dist.get_world_size() > 1


def world_size() -> int:
    """The group's size, 1 without a group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def local_batch_slice(global_batch_size: int, sharding=None,
                      mesh=None) -> slice:
    """Rows of the global batch this rank feeds.  With a `sharding` (a
    Layout of the input, the rank's `mesh` beside it): the rows of its
    chunk of the batch dim, or all of them when the batch dim is not
    sharded.  Without one: process i of P feeds rows [i*B/P, (i+1)*B/P)
    (contiguous, batch-major, the loader's order)."""
    if sharding is not None:
        if not sharding.spec or not sharding.spec[0]:
            return slice(0, global_batch_size)
        idx, n = sharding.chunk(0, mesh)
    else:
        n = world_size()
        idx = dist.get_rank() if n > 1 else 0
    if global_batch_size % n != 0:
        raise ValueError(
            f"global batch {global_batch_size} is not divisible by {n} "
            "shards: rows would be dropped")
    per = global_batch_size // n
    return slice(idx * per, (idx + 1) * per)


def shard_host_batch(global_batch: Dict[str, np.ndarray],
                     shardings: Dict[str, object],
                     mesh=None) -> Dict[str, np.ndarray]:
    """Each array's rows that this rank feeds (`local_batch_slice` by
    its Layout in `shardings`); one process keeps the arrays whole."""
    if mesh is None:
        return dict(global_batch)
    return {name: arr[local_batch_slice(len(arr), shardings[name], mesh)]
            for name, arr in global_batch.items()}
