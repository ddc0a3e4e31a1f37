"""Run one cell of the benchmark of depthestimation_torch once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with as many CUDA cards as the
cell asks for. The cell (BENCHMARK.json) names its configuration and its
traffic mix; the files of each, the limits of its check and the readers
of its metrics are found by name under benchmark/ (benchlib/spec.py).

The run makes its inputs from --seed, warms up every shape the traffic
uses (set-up), measures for --seconds, reads the peak of the card's
memory, frees the program, and checks a sample of the window's answers,
drawn from the seed, against the plain reference. With --trace 0 it
reports the cell's end-to-end metrics; with --trace 1 its per-layer
metrics, from spans around calls into the program over the window and a
torch.profiler trace of the window's first items. The last line of
standard output is the result as one JSON object; the last lines of
standard error are the numbers the check compared, each beside its
limit.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for p in (ROOT, HERE):
    if p not in sys.path:
        sys.path.insert(0, p)

# Every build and kernel cache of the program stays at fixed paths inside
# the checkout (the kernel library builds into build/ by itself).
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")

import torch  # noqa: E402

from benchlib import check, drivers, spec, tracing  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "depthestimation_tpu")


def forbidden_modules():
    """Top-level names in sys.modules that the benchmark must not load."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run(cell: spec.Cell, seed: int, seconds: int, trace: bool, device: torch.device,
        t_start: float = T_START) -> dict:
    """One run of `cell` on `device`: the result object, checks last."""
    layer = {m["name"]: spec.load_module("layer_metrics", m["name"]) for m in cell.per_layer}
    spans = tracing.Spans(t for mod in layer.values() for t in getattr(mod, "SPANS", ())
                          if trace)
    profiler = tracing.Profiler(cell.traffic["trace_items"] if trace else 0, device)
    driver = drivers.DRIVERS[cell.traffic["driver"]]
    try:
        r = driver(cell.config, cell.traffic, seed, seconds, device, profiler, spans, t_start)
    finally:
        profiler.stop()
        spans.remove()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()

    metrics = {}
    extra = {}
    if trace:
        view = tracing.read(profiler, spans, r, cell.config)
        profiler.prof = None
        for m in cell.per_layer:
            value = layer[m["name"]].read(view)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        extra["busy_s"] = view.busy_us / 1e6
        extra["window_s"] = view.window_us / 1e6
        breakdown = view.breakdown
    else:
        for m in cell.end_to_end:
            value = spec.load_module("end_to_end", m["name"]).read(r)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    def reference(key):
        return check.reference_outputs(cell.config, r.outputs, *r.inputs[key], device)

    t_check = time.perf_counter()
    with torch.no_grad():
        correct, numbers = check.judge(r.samples, reference, r.outputs, cell.limits, r.failed)
    print(f"{len(r.latencies)} items in {r.window_s:.3f} s; set-up {r.setup_s:.3f} s; "
          f"{len(r.samples)} answers checked in {time.perf_counter() - t_check:.3f} s",
          file=sys.stderr)

    result = {"correct": correct, "attempted": r.attempted, "failed": r.failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if device.type == "cuda" else device.type,
                         "kind": (torch.cuda.get_device_name(device)
                                  if device.type == "cuda" else "cpu"),
                         "count": cell.chips, "memory_peak_bytes": r.peak_bytes, **extra}}
    if trace:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in numbers.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=int, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result = run(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        print(f"the run loaded {', '.join(found)}; the benchmark measures the port alone",
              file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
