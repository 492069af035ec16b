"""One run of one benchmark cell of quantumattention_tpu_torch on the card.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is ``perfbench/workloads/<cell>.json``; its configuration
``perfbench/configs/<config>.json``; which metrics it reports,
``BENCHMARK.json`` at the checkout's root.  With ``--trace 0`` the line
carries the cell's end-to-end metrics, with ``--trace 1`` its per-layer
metrics (each read by ``perfbench/metrics/<name>.py``), the device's busy
and traced seconds and a breakdown.  The last line on standard output is
the result; the numbers that decided ``correct`` are the last lines on
standard error and the last key of the result.

Caches stay inside the checkout, at fixed paths: the kernels build into
``build/kernels/`` (the program's own rule) and the autotuner's cache is
``build/perfbench/cache``.  The run exits non-zero and prints no result
without a CUDA card (or fewer than the cell asks for), and when the JAX
package, JAX or flax is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "quantumattention_tpu")


def process_start() -> float:
    """This process's start on the epoch clock (from /proc; the first line
    of this file's execution where that cannot be read)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return T_IMPORT


T_IMPORT = time.time()


def fixed_cache_dirs() -> None:
    """Every cache the program or a library could write, at fixed paths in
    the checkout (the kernels' own build directory is the program's rule).
    Triton's and torch's extension caches are pinned too, though no kernel
    uses them yet: a later kernel built that way must find them here."""
    cache = ROOT / "build" / "perfbench"
    os.environ["QUANTUM_ATTN_CACHE_DIR"] = str(cache / "cache")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def reader(name: str):
    path = ROOT / "perfbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: str):
    """(end-to-end, per-layer) entries of BENCHMARK.json this cell reports."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if cell in m.get("workloads", ()) or ("workloads" not in m and m["moves"] in names)]
    return e2e, layer


def execute(workload: str, seed: int, seconds: float, traced: bool, t_process: float,
            device: str = "cuda", bench: dict = None, cell: dict = None) -> dict:
    """Set up, measure and check one run; returns the result line's dict."""
    import torch

    from perfbench import spec

    bench = bench or spec.benchmark()
    cell = cell or spec.load_cell(workload)
    cfg = spec.program_config(cell["model"])
    driver = importlib.import_module(f"perfbench.drivers.{cell['driver']}")
    out = driver.run(cell, cfg, seed, seconds, traced, t_process, device=device)
    e2e, layer = cell_metrics(bench, workload)
    on_card = torch.device(device).type == "cuda"
    metrics = {}
    for m in layer if traced else e2e:
        value = reader(m["name"]).read(out["ctx"]) if traced else out["e2e"][m["name"]]
        if value is None:
            continue
        # Off the card only a count of the program's stands: a time, rate or
        # share is not the device's.
        if not on_card and m["source"] != "program_counter":
            value = "not measured"
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(0) if on_card else "not measured",
        "count": int(cell["chips"]),
        "memory_peak_bytes": out["memory_peak_bytes"] if on_card else "not measured",
    }
    result = {"correct": out["correct"], "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": dev}
    if traced:
        tr = out["ctx"].trace
        dev["busy_s"] = tr.busy_s if on_card else "not measured"
        dev["window_s"] = tr.window_s
        result["breakdown"] = tr.breakdown() if on_card else {"device_ops": [], "idle_gaps": []}
    result["checks"] = out["checks"]
    return result


def main(argv=None) -> int:
    t_process = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    fixed_cache_dirs()
    sys.path.insert(0, str(ROOT))
    import torch

    from perfbench import spec

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"error: {args.workload} needs {cell['chips']} CUDA card(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = execute(args.workload, args.seed, args.seconds, bool(args.trace), t_process, cell=cell)
    found = forbidden_modules()
    if found:
        print(f"error: loaded in the measuring process: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
