"""Run one cell of BENCHMARK.json once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The run loads the cell's configuration and traffic mix, builds and warms
up the system under test (`uptune_tpu_torch`, on one NVIDIA card), runs
the mix for `--seconds`, judges what the window produced against the
plain reference, and prints one JSON object as the last line of its
standard output: `correct`, `attempted`, `failed`, `metrics` (the
cell's end-to-end metrics, or with `--trace 1` its per-layer metrics
read from the device trace, the program's spans and counters), `device`,
with `--trace 1` `breakdown`, and last `checks`: each number the
judgement compared, beside its limit (also printed on standard error).

It exits non-zero and prints no result without a card, with fewer cards
than the cell asks for, without the program, or with JAX loaded."""
from __future__ import annotations

import gc
import os
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# every cache of the run at a fixed path inside the checkout, set before
# torch is imported; transformers (if anything loads it) without Flax
CACHE = HERE / ".cache"
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = str(CACHE / sub)
os.environ["USE_FLAX"] = "0"
os.environ.setdefault("USE_TF", "0")
sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "uptune_tpu")
# torch's CPU threads: few and fixed, so that its thread pool neither
# follows the host's core count nor spins against the serving cells'
# client processes
TORCH_THREADS = 4


def process_start() -> float:
    """This process's start on time.time()'s clock (/proc), or now."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        ticks = int(fields[19])
        btime = next(int(line.split()[1]) for line in
                     Path("/proc/stat").read_text().splitlines()
                     if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def written_bytes() -> int:
    """The bytes this process has caused to be written to storage
    (/proc/self/io), or -1."""
    try:
        for line in Path("/proc/self/io").read_text().splitlines():
            if line.startswith("write_bytes:"):
                return int(line.split()[1])
    except OSError:
        pass
    return -1


def forbidden_modules() -> list:
    """Top-level names in sys.modules that are JAX or the JAX package,
    compared whole (`uptune_tpu_torch` is not `uptune_tpu`)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def main(argv=None) -> int:
    import argparse
    import json
    t_start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import spec
    bench = spec.load_benchmark()
    cell = spec.workload(bench, args.workload)
    import torch
    torch.set_num_threads(TORCH_THREADS)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < int(cell["chips"]):
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); torch sees {cards}", file=sys.stderr)
        return 2
    try:
        import uptune_tpu_torch  # noqa: F401  (the system under test)
    except ImportError as exc:
        print(f"portbench: the program is missing: {exc}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    line = run_cell(bench, cell, args.seed, args.seconds, bool(args.trace),
                    device, t_start)
    found = forbidden_modules()
    if found:
        print(f"portbench: loaded {found}, which the benchmark must not",
              file=sys.stderr)
        return 3
    bad = spec.check_result(line, bool(args.trace))
    if bad:
        print(f"portbench: malformed result: {bad}", file=sys.stderr)
        return 4
    print(f"portbench: this process wrote {written_bytes()} bytes",
          file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


def run_cell(bench, cell, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> dict:
    """One run of `cell` on `device`: the result line (a dict)."""
    import importlib
    import json
    from portbench import spec
    from portbench.drivers.common import Run
    cfg = spec.config(bench, cell["config"])
    mix = spec.traffic(cell["traffic"])
    limits = json.loads((spec.HERE / "limits" / f"{cell['name']}.json")
                        .read_text())
    setup = {}

    def setup_done():
        # what set-up made is frozen out of the cyclic collector's
        # traversals, so that the window's collections walk only what
        # the window makes; the collector still runs in the window, over
        # the program's garbage as in any deployment
        gc.collect()
        gc.freeze()
        setup["s"] = time.time() - t_start
    driver = importlib.import_module(f"portbench.drivers.{mix['driver']}")
    if device.type == "cuda":
        import torch
        torch.cuda.reset_peak_memory_stats(device)
    run = Run(cell, cfg, mix, seed, seconds, trace, device, setup_done,
              limits, t_start)
    run.note("driver loaded")
    out = driver.run(run)
    run.note("judged")
    metrics = {}
    for m in spec.cell_metrics(bench, cell["name"], trace):
        if m["name"] == "setup_s":
            v = setup["s"]
        elif trace:
            v = spec.metric_reader(m["name"])(out.trace)
        else:
            v = out.rates.get(m["name"])
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (__import__("torch").cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": int(cell["chips"]),
           "memory_peak_bytes": out.memory_peak_bytes}
    line = {"correct": all(c.ok for c in out.checks),
            "attempted": out.attempted, "failed": out.failed,
            "metrics": metrics, "device": dev}
    if trace:
        from portbench import devtrace
        t = out.trace
        dev["busy_s"] = devtrace.busy_ns(t.ops, t.t0, t.t1) / 1e9
        dev["window_s"] = t.window_s
        line["breakdown"] = devtrace.breakdown(t.ops, t.spans, t.t0, t.t1)
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                      for c in out.checks}
    return line


if __name__ == "__main__":
    sys.exit(main())
