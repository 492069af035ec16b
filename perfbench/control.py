"""Control readings of a serving cell's correctness check.

    python3 perfbench/control.py --workload <cell> --seeds 11,12,13

For each seed, at the cell's own size and load: the engine serves one wave
of the cell's traffic, the same sample of finished requests as a run is
drawn, and the configuration family's float32 reference reads (a) the
widest gap of the served tokens below its best and their mean gap, the
program's readings, and (b) at each of those positions the gap of the
token that the reference computed with every product's matrix rounded to
int4 puts first, the control: the nearest precision below the
configuration's int8 weights.  ``--witness`` adds the
same reference computed in bfloat16, which shows how far rounding alone
moves the served tokens.  One JSON line a seed.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(workload: str, seed: int, device="cuda", cell=None, witness=False) -> dict:
    import torch

    from perfbench import spec
    from perfbench.drivers import serve
    from perfbench.traffic import load as load_traffic

    cell = cell or spec.load_cell(workload)
    cfg = spec.program_config(cell["model"])
    eng = serve.build_engine(cell, cfg, seed, torch.device(device))
    gen = load_traffic(cell["traffic"], cfg.vocab_size, seed)
    records = serve.run_wave(eng, gen.wave(0), cell["engine"]["decode_burst"])
    sample = serve.sample_requests(records, cell["check"]["sample_requests"], seed)
    del eng
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    variants = {"ref": lambda w: w, "int4": spec.family(cell["model"]).reference.int4_roundtrip}
    if witness:
        variants["bf16"] = (lambda w: w, torch.bfloat16)
    gaps = serve.reference_gaps(cell["model"], seed, sample, torch.device(device), variants=variants)
    out = {"workload": workload, "seed": seed, "tokens": int(sum(g.numel() for g in gaps["ref"])),
           "compare": cell["check"]["compare"], "limit": cell["check"]["limit"]}
    for name, label in (("ref", "program"), ("int4", "control"), ("bf16", "bf16_reference")):
        if name in gaps:
            flat = torch.cat(gaps[name])
            out[label] = {**serve.gap_readings(flat), "off_share": float((flat > 0).float().mean()),
                          "first_token_gap_max": float(max(g[0] for g in gaps[name]))}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--witness", action="store_true",
                    help="also read the reference computed in bfloat16 (how far rounding alone moves it)")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from perfbench.run import fixed_cache_dirs

    fixed_cache_dirs()
    import torch

    for seed in (int(s) for s in args.seeds.split(",")):
        if torch.cuda.is_available():
            gc.collect()
            torch.cuda.empty_cache()
        t = time.perf_counter()
        out = readings(args.workload, seed, witness=args.witness)
        out["seconds"] = time.perf_counter() - t
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
