"""The control of the check: the plain reference with its stages after
the matcher computed in bfloat16 (the type below the configuration's
float32), put in the program's place, read by the check's own numbers
against the float32 reference on the inputs of a cell's runs.

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...]

Prints one JSON line a seed: the numbers the check compares, which the
limits (limits/<cell>.json) have to fail. The benchmark's runs do not
run it.
"""

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
for p in (os.path.dirname(HERE), HERE):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

from benchlib import check, drivers, spec  # noqa: E402


def readings(cell: spec.Cell, seeds, device) -> dict:
    """seed -> {number: the largest reading over the run's first
    `sample` inputs}."""
    driver = cell.traffic["driver"]
    names = drivers.OUTPUTS[driver]
    out = {}
    for seed in seeds:
        inputs = drivers.INPUTS[driver](cell.config, cell.traffic, seed, device)
        values = {"mismatch_share": 0.0, "depth_rel_gap": 0.0}
        with torch.no_grad():
            for left, right in inputs[:cell.traffic["sample"]]:
                want = check.reference_outputs(cell.config, names, left, right, device)
                got = check.reference_outputs(cell.config, names, left, right, device,
                                              torch.bfloat16)
                share, gap = check.compare([g.cpu().numpy() for g in got], want, names)
                values["mismatch_share"] = max(values["mismatch_share"], share)
                values["depth_rel_gap"] = max(values["depth_rel_gap"], gap)
        out[seed] = values
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 3
    cell = spec.load_cell(args.workload)
    for seed, values in readings(cell, args.seeds, torch.device("cuda", 0)).items():
        print(json.dumps({"workload": cell.name, "seed": seed, **values}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
