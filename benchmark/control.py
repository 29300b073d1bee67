"""Readings of a cell over many seeds in one process, for setting the
limits of ``correct``: the sound program's, and the control's.

    python3 -m benchmark.control --workload <cell> --seeds 1,2,3 --seconds 40
        [--control deskew_off|camera_late] [--out readings.jsonl] [--dump DIR]

Each seed runs the cell as ``benchmark.run`` does (set-up, warm-up, the
window, the reference); one JSON line a seed gives the numbers compared,
the numbers found beside them, the end-to-end metrics and ``correct``;
``--dump`` also writes each seed's raw answers (``<workload>_<control>_<seed>.npz``).
The control ``deskew_off`` breaks the guarantee that every point is placed
at its own time in the sweep: the points are handed over with the sweep's
start time, so the step cannot undo the motion within a sweep.
``camera_late`` breaks the guarantee that the camera's clock is the IMU's:
every frame is stamped 30 ms after it was taken, and the configuration
keeps td fixed at 0. The benchmark's own runs never run either.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402

from . import run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", default=None, choices=(None, "deskew_off", "camera_late"))
    ap.add_argument("--out", default=None, help="also append the lines to this file")
    ap.add_argument("--dump", default=None, help="write each seed's raw answers here")
    args = ap.parse_args(argv)
    t0 = T_START
    for seed in (int(s) for s in args.seeds.split(",")):
        out = run.run_cell(args.workload, seed, args.seconds, False, t_start=t0,
                           control=args.control)
        line = json.dumps({"workload": args.workload, "seed": seed, "control": args.control,
                           "correct": out["correct"], "attempted": out["attempted"],
                           "failed": out["failed"], "metrics": out["metrics"],
                           "found": out["found"], "checks": out["checks"]})
        print(line, flush=True)
        if args.dump:
            os.makedirs(args.dump, exist_ok=True)
            np.savez(os.path.join(args.dump, f"{args.workload}_{args.control}_{seed}.npz"),
                     **out["answers"])
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        t0 = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
