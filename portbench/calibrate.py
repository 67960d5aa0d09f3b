"""The readings that the limits of `correct` are set from.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        --control-seeds 1,2,3 --seconds 3

For each seed it runs the cell's window (short; each run judges as many
units or tenants as a benchmark run does) and prints the numbers the
judgement compared (the lower readings); for each control seed also the
control's numbers: the reference computed in the precision below the
configuration's, put in the program's place (the upper readings).  The
last line sums them up: the largest reading of the program and the
smallest of the control, for each number.  It runs on the card, in one
process; the benchmark's own runs never run it."""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import portbench.run  # noqa: E402,F401  (the run's caches, before torch)


def main(argv=None) -> int:
    import argparse
    import torch
    from portbench import spec
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    import importlib
    from portbench.drivers.common import Run
    bench = spec.load_benchmark()
    cell = spec.workload(bench, args.workload)
    cfg = spec.config(bench, cell["config"])
    mix = spec.traffic(cell["traffic"])
    limits = json.loads((spec.HERE / "limits" / f"{cell['name']}.json")
                        .read_text())
    driver = importlib.import_module(f"portbench.drivers.{mix['driver']}")
    dev = torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    ctl = {int(s) for s in args.control_seeds.split(",") if s}
    lows, highs = {}, {}
    rows = []
    for seed in seeds + sorted(ctl - set(seeds)):
        t0 = time.time()
        out = driver.run(Run(cell, cfg, mix, seed, args.seconds, False, dev,
                             lambda: None, limits))
        row = {"seed": seed, "numbers": out.numbers,
               "checks": {c.name: c.value for c in out.checks},
               "correct": all(c.ok for c in out.checks),
               "seconds": time.time() - t0}
        if seed in seeds:
            for k, v in row["checks"].items():
                lows[k] = max(lows.get(k, 0), v)
        if seed in ctl:
            row["control"] = out.control()
            for k, v in row["control"].items():
                if isinstance(v, (int, float)) and k in row["checks"]:
                    highs[k] = min(highs.get(k, float("inf")), v)
        rows.append(row)
        print(json.dumps(row), flush=True)
        del out
        torch.cuda.empty_cache()
    summary = {"workload": args.workload, "program_max": lows,
               "control_min": highs, "seeds": seeds,
               "control_seeds": sorted(ctl),
               "device": torch.cuda.get_device_name(dev)}
    if args.out:
        Path(args.out).write_text("\n".join(json.dumps(r) for r in rows
                                            + [summary]) + "\n")
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
