"""Readings for the output check's limits: the program's and the
lower-precision control's, on the same answers, seed by seed.

    python3 portbench/tools/calibrate.py --workload moe-closed64 \
        --seconds 10 --seeds 11,12,13

For each seed one process sets the cell up from the seed, runs one window
at the cell's own load, and compares the sampled answers with the plain
reference twice: the program's answers, then the reference computed in
the precision below the configuration's (int4 for the CNN's int8, TF32
for the MoE's float32) put in the program's place.  Prints one JSON line
per seed (also appended to ``chiprun_out/calibrate-<cell>.jsonl``).
Runs on a CUDA card.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from portbench import harness  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args()
    out = Path("chiprun_out") / f"calibrate-{args.workload}.jsonl"
    out.parent.mkdir(exist_ok=True)
    for seed in (int(s) for s in args.seeds.split(",")):
        bench = harness.Bench(args.workload, seed)

        async def main_():
            await bench.server.warm()
            rec, _ = await bench.window(args.seconds)
            return rec

        rec = asyncio.run(main_())
        data = bench.data(rec, args.seconds, 0.0, None)
        bench.release()
        row = {"cell": args.workload, "seed": seed,
               "program": bench.check(rec, data),
               "control": bench.check(rec, data, control=True)}
        line = json.dumps(row)
        print(line, flush=True)
        with open(out, "a") as f:
            f.write(line + "\n")
        del bench, rec, data


if __name__ == "__main__":
    main()
