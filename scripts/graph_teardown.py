"""Whether torch.distributed.destroy_process_group() returns while a CUDA
graph that captured NCCL collectives is alive, on every GPU of the host.

    python3 scripts/graph_teardown.py [--hang-s 20] [--out FILE]

One process per GPU (four or more; NCCL, one rank a GPU). Each rank
captures an all-reduce of 4 MiB as a CUDA graph (graphs.CapturedCall,
collectives=True: the first call runs it eagerly and captures, the second
replays), checks the replay's sum, and ends the group in one of three
ways, each in a fresh group of fresh processes:

- kept: torch.distributed.destroy_process_group() with the graph alive;
- dropped: the graph's last reference deleted first, then the same call;
- released: parallel/mesh.destroy_process_group() with the graph alive
  (it drops the graphs of graphs.release_collective_graphs first).

A rank writes a mark just before it ends the group and another once that
returned. Once every rank has marked the first, the script waits
--hang-s seconds for the processes to finish, then kills them and
reports the mode as hung. One JSON line goes to stdout (and to --out):
per mode, the ranks that reached the teardown, those whose teardown
returned, its seconds, and whether the processes were killed. Imports
nothing of JAX or depthestimation_tpu.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ("kept", "dropped", "released")


def _mark(work: str, rank: int, name: str, **data) -> None:
    with open(os.path.join(work, f"{name}{rank}.json"), "w") as f:
        json.dump(data, f)


def rank_main(rank: int, world: int, port: int, mode: str, work: str) -> None:
    """One rank: capture and replay an all-reduce, then end the group."""
    sys.path.insert(0, REPO)
    import gc

    import torch
    import torch.distributed as dist

    from depthestimation_torch.graphs import CapturedCall
    from depthestimation_torch.parallel.mesh import destroy_process_group, initialize_distributed

    initialize_distributed(f"localhost:{port}", world, rank)
    x = torch.full((1 << 20,), float(rank + 1), device="cuda")

    def reduce(t):
        t = t.clone()
        dist.all_reduce(t)
        return t

    call = CapturedCall(reduce, "all_reduce", collectives=True)
    call(x)
    replay_ok = float(call(x)[0]) == world * (world + 1) / 2 and call.replays == 1
    _mark(work, rank, "start", replay_ok=replay_ok)
    t0 = time.perf_counter()
    if mode == "kept":
        dist.destroy_process_group()
    elif mode == "dropped":
        del call
        gc.collect()
        dist.destroy_process_group()
    else:
        destroy_process_group()
    _mark(work, rank, "end", teardown_s=time.perf_counter() - t0)


def run_mode(mode: str, world: int, hang_s: float, cap_s: float = 180.0) -> dict:
    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory() as work:
        ctx = mp.start_processes(rank_main, args=(world, port, mode, work), nprocs=world,
                                 join=False, start_method="spawn")
        t0 = time.monotonic()
        all_started = None
        killed = False
        while not ctx.join(timeout=0.5):
            started = sum(os.path.exists(os.path.join(work, f"start{r}.json"))
                          for r in range(world))
            now = time.monotonic()
            if started == world and all_started is None:
                all_started = now
            if (all_started is not None and now - all_started > hang_s) or now - t0 > cap_s:
                for p in ctx.processes:
                    p.kill()
                for p in ctx.processes:
                    p.join()
                killed = True
                break

        def read(name):
            out = {}
            for r in range(world):
                path = os.path.join(work, f"{name}{r}.json")
                if os.path.exists(path):
                    with open(path) as f:
                        out[r] = json.load(f)
            return out

        start, end = read("start"), read("end")
    return {"reached_teardown": sorted(start), "replays_ok": all(v["replay_ok"]
                                                                 for v in start.values()),
            "teardown_returned": sorted(end),
            "teardown_s": [end[r]["teardown_s"] for r in sorted(end)],
            "killed_after_s": hang_s if killed else None, "hung": killed}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--hang-s", type=float, default=20.0)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        print("graph_teardown: needs four GPUs or more", file=sys.stderr)
        return 1
    world = torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout
    out = {"gpus": world, "smi": smi.strip().splitlines(), "torch": torch.__version__,
           "nccl": ".".join(map(str, torch.cuda.nccl.version())),
           "modes": {m: run_mode(m, world, args.hang_s) for m in MODES}}
    line = json.dumps(out)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
