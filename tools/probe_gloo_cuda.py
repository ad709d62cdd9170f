#!/usr/bin/env python3
"""Which gloo collectives take CUDA tensors, on this machine's torch.

    python3 tools/probe_gloo_cuda.py

Spawns 2 and then 4 ranks that all use cuda:0 (a one-card machine: NCCL
does not place two ranks on one GPU, so the sharded training path's
ranks share the card over gloo), runs each collective that path uses on
CUDA tensors, and prints, per collective, "ok", "WRONG ..." or the
exception it raised; then the median of 5 host-clock times of an
all_reduce of 64 KiB and 64 MiB, on the CUDA tensor and staged through a
pinned host buffer. Rendezvous through a file store in a temporary
directory; every process group has a 60 s timeout. Needs a CUDA device.
"""
import datetime
import os
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

OPS = ["all_reduce_sum_f32", "all_reduce_max_f32", "all_reduce_sum_i32",
       "all_reduce_max_i32", "reduce_scatter_tensor",
       "all_gather_into_tensor", "all_gather_list", "broadcast", "barrier"]


def run(op, rank, world, dev):
    base = torch.arange(8 * world, dtype=torch.float32)
    x = (base + rank).to(dev)
    total = sum(base + r for r in range(world))
    if op == "barrier":
        dist.barrier()
        return "ok"
    if op.startswith("all_reduce"):
        y = x.clone() if op.endswith("f32") else x.to(torch.int32)
        red = dist.ReduceOp.MAX if "max" in op else dist.ReduceOp.SUM
        dist.all_reduce(y, op=red)
        want = base + world - 1 if "max" in op else total
    elif op == "reduce_scatter_tensor":
        y = torch.empty(8, device=dev)
        dist.reduce_scatter_tensor(y, x)
        want = total[rank * 8:(rank + 1) * 8]
    elif op == "all_gather_into_tensor":
        y = torch.empty(8 * world * world, device=dev)
        dist.all_gather_into_tensor(y, x)
        want = torch.cat([base + r for r in range(world)])
    elif op == "all_gather_list":
        ys = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(ys, x)
        y = torch.cat(ys)
        want = torch.cat([base + r for r in range(world)])
    else:
        y = x.clone()
        dist.broadcast(y, 0)
        want = base
    torch.cuda.synchronize()
    return ("ok" if torch.equal(y.cpu(), want.to(y.dtype))
            else f"WRONG {y.cpu().tolist()[:6]}")


def worker(rank, world, store, results):
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method="file://" + store,
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    res = {}
    for op in OPS:
        try:
            res[op] = run(op, rank, world, dev)
        except Exception as e:  # noqa: BLE001 - the probe reports it
            res[op] = f"RAISES {type(e).__name__}: {str(e)[:160]}"
        dist.barrier()
    for n in (1 << 14, 1 << 24):
        x = torch.ones(n, device=dev)
        for mode in ("direct", "staged"):
            times = []
            for _ in range(5):
                dist.barrier()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if mode == "direct":
                    dist.all_reduce(x)
                else:
                    host = torch.empty(n, pin_memory=True)
                    host.copy_(x)
                    dist.all_reduce(host)
                    x.copy_(host)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            res[f"all_reduce_{mode}_{n * 4}B_ms"] = sorted(times)[2] * 1e3
    results.put((rank, res))
    dist.destroy_process_group()


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    ctx = mp.get_context("spawn")
    for world in (2, 4):
        results = ctx.Queue()
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.time()
            procs = [ctx.Process(target=worker, args=(
                r, world, os.path.join(tmp, "store"), results))
                for r in range(world)]
            for p in procs:
                p.start()
            out = dict(results.get(timeout=240) for _ in procs)
            for p in procs:
                p.join(60)
            print("world", world, "took", round(time.time() - t0, 1), "s")
            for key, value in out[0].items():
                print("  ", key, value)
    return 0


if __name__ == "__main__":
    sys.exit(main())
