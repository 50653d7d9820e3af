"""Multi-process launch on torch.distributed (counterpart of
gs_icp_slam_tpu/parallel/launch.py).

Every rank runs the SAME program and feeds the SAME frame stream;
`init_distributed()` joins the job's process group, after which
`global_mesh()` spans it and `FusedEngine(seq, cfg, mesh=global_mesh())`
runs unchanged.  Under torchrun, one process per GPU:

    torchrun --nproc_per_node=4 my_run.py   # init_distributed(); ...

A CUDA device always joins over NCCL; gloo only when the caller asks for
the CPU.  (A test or a rehearsal that runs several ranks on one card makes
its own gloo group and passes it to parallel.make_mesh.)
"""
from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from .. import resolve_device
from .mapping import Mesh, make_mesh


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, device="cuda",
                     timeout_s: float = 600.0) -> None:
    """Join the job's process group: NCCL for a CUDA device (and select
    the rank's card: LOCAL_RANK under torchrun, else process_id modulo
    the cards), gloo for the CPU.  With no arguments, reads torchrun's
    environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK); a
    coordinator "host:port" with num_processes and process_id overrides
    it.  Once per process, before any mesh is made."""
    dev = resolve_device(device)
    kwargs = dict(timeout=datetime.timedelta(seconds=timeout_s))
    if coordinator_address is None:
        kwargs["init_method"] = "env://"
        rank = int(os.environ.get("RANK", "0"))
    else:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs num_processes "
                             "and process_id")
        kwargs.update(init_method=f"tcp://{coordinator_address}",
                      world_size=num_processes, rank=process_id)
        rank = process_id
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        torch.cuda.set_device(local if dev.index is None else dev.index)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, **kwargs)


def global_mesh(device="cuda") -> Mesh:
    """1-D mesh over every rank of the job."""
    return make_mesh(device)
