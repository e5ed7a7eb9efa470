"""A cell's control on the card, at the cell's own size: each seed runs
the cell as the benchmark does (set-up, a window of ``--seconds``), then
judges the control's answers in the program's place, and prints the
program's readings beside the control's, one JSON line a seed.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 --seconds 30

The control of the sort is the plain reference on keys one bit narrower;
that of a served model the float32 reference with its weights rounded to
float8 e4m3 (the precision below the bf16 it is served in), judged at each
checked position by the gap of the token it puts first (greedy answers)
or draws from its top k (sampled ones), under the program's names and
limits; the program's own readings of the same run come beside them as
``program_*``.  A control has failed where ``control_correct`` is false.
The benchmark's own runs never run it."""
from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    run._setup_paths()
    for seed in (int(s) for s in args.seeds.split(",")):
        out = run.run(args.workload, seed, args.seconds, False, "cuda",
                      control=True)
        ck = out["checks"]
        held = lambda ks: all(ck[k]["value"] <= ck[k]["limit"] for k in ks)
        prog = [k for k in ck if k.startswith("program_")]
        print(json.dumps({
            "seed": seed, "control_correct": out["correct"],
            "program_correct": held(prog + ["checked_short"]) if prog
            else None, "checks": ck}), flush=True)
        gc.collect()                # the last seed's weights and caches
        import torch
        torch.cuda.empty_cache()
    run.guard("at the end")
    return 0


if __name__ == "__main__":
    sys.exit(main())
