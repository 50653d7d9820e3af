"""Which torch.distributed collectives take CUDA tensors, and how long a
gradient-sized all-reduce takes: gloo with two processes sharing one card,
then NCCL at world size 1 in this process.

    python scripts/torch_collectives_probe.py

For each backend, each collective of the port's parallel/ package
(all_reduce, all_gather_into_tensor, reduce_scatter_tensor, and
all_gather and broadcast beside them) on float32, uint8 and int64 CUDA
tensors prints "ok" with its result or the error it raised (a probe: the
port itself never catches one), then the mean time of a 14.7 MB all-reduce
(2^18 x 14 float32, path C's parameter bytes; host clock around 5 synced
calls).  Needs one card; the card's name is the first line.
"""
from __future__ import annotations

import datetime
import multiprocessing
import os
import socket
import sys
import tempfile
import time

import torch
import torch.distributed as dist

OPS = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
       "all_gather", "broadcast")


def run_op(op: str, x: torch.Tensor, world: int) -> torch.Tensor:
    if op == "all_reduce":
        dist.all_reduce(x)
        return x
    if op == "all_gather_into_tensor":
        out = torch.empty(x.numel() * world, dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x)
        return out
    if op == "reduce_scatter_tensor":
        out = torch.empty(x.numel() // world, dtype=x.dtype, device=x.device)
        dist.reduce_scatter_tensor(out, x)
        return out
    if op == "all_gather":
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x)
        return torch.cat(parts)
    dist.broadcast(x, 0)
    return x


def probe(tag: str, rank: int, world: int) -> None:
    dev = torch.device("cuda", 0)
    for dt in (torch.float32, torch.uint8, torch.int64):
        for op in OPS:
            x = (torch.arange(8, device=dev) + rank).to(dt)
            try:
                got = run_op(op, x, world)
                torch.cuda.synchronize()
                msg = f"ok {got.cpu().tolist()}"
            except (RuntimeError, ValueError) as e:
                msg = f"ERR {type(e).__name__}: {str(e).splitlines()[0]}"
            print(tag, rank, op, dt, msg, flush=True)
    x = torch.ones(2 ** 18 * 14, device=dev)
    for _ in range(2):
        dist.all_reduce(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        dist.all_reduce(x)
    torch.cuda.synchronize()
    print(tag, rank, "all_reduce of 14,680,064 bytes, ms:",
          (time.perf_counter() - t0) / 5 * 1e3, flush=True)


def gloo_rank(rank: int, world: int, store: str) -> None:
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    try:
        probe("gloo", rank, world)
    finally:
        dist.destroy_process_group()


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    print(torch.cuda.get_device_name(0), torch.__version__, flush=True)
    build = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "build")
    os.makedirs(build, exist_ok=True)
    store = os.path.join(tempfile.mkdtemp(dir=build), "store")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=gloo_rank, args=(r, 2, store))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(120)
        if p.is_alive():
            p.kill()
    print("gloo exit codes", [p.exitcode for p in procs], flush=True)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        probe("nccl", 0, 1)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
