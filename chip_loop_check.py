"""The LIO replay cell's loop closure on the card, held over a long run and
against the plain reference.

    python3 chip_loop_check.py --seeds 4400000042,4400000043 --sensor-s 230 \
        [--compare 4400000042] [--workers 4] [--dump DIR]

Each seed drives the cell ``lio_mid360_replay`` with the benchmark's own
pieces (``benchmark.run.make_lap``, ``system.program_config``,
``LioPipeline``, ``system.lio_warm`` through the throttle) for
``--sensor-s`` seconds of sensor time, and prints one JSON line:

- ``hold``: the cell's checks (``run.numbers`` / ``run.judge``) over the
  stretch from the traffic's ``warm_s`` to the end, and the median 5 s
  heading-change error of each 40 s lap of it;
- ``loops``: the loop checks (ICP verifications) and factors added, the
  slots used at the end, keyframes, and the sensor time of the upload batch
  that held the 16th and the 64th factor;
- for the seeds named in ``--compare``: ``posegraph`` and ``icp``, the
  run's last graph solve and last loop ICP, each as the step handed it
  over, against ``benchmark/plain_loop.py`` (``benchmark/loop_compare.py``:
  the tolerances and the controls that must fail them). ``--dump`` saves
  both inputs (``torch.load`` them to redo a comparison).

Seeds run in ``--workers`` processes at once on the one card (the step is
host-bound). The last line is a summary: every seed's ``ok``.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import sys
from unittest import mock

import numpy as np

CELL = "lio_mid360_replay"


def _seed_run(seed: int, sensor_s: float, compare: bool, threads: int,
              dump: str | None = None) -> dict:
    import torch

    torch.set_num_threads(threads)
    from benchmark import reference as ref
    from benchmark import run, spec
    from benchmark import system as S
    from lvislam_tpu_torch.models.lio import mapping
    from lvislam_tpu_torch.ops import icp as icp_ops

    cell = spec.cell(CELL)
    dev = torch.device("cuda")
    lap = run.make_lap(cell, seed, dev)
    cfg = S.program_config(cell.config, cell.traffic)
    pipe = S.LioPipeline(cfg, device=dev)

    last = {}  # the last solve's and loop ICP's inputs, as the step handed them over
    real_opt, real_icp, real_scan = mapping._optimize_graph, icp_ops.icp_point2point, pipe.process_scan

    def opt(state, k):
        last["solve"] = (state, k)
        return real_opt(state, k)

    def icp(*a, **kw):
        last["icp"] = (a, kw, real_icp(*a, **kw))
        return last["icp"][2]

    fed, at = [], {}  # stamps mapped; loop count -> the stamp that ended its upload batch

    def scan(sweep, *rest):
        fed.append(sweep["stamp"])
        real_scan(sweep, *rest)
        for n in (16, 64):
            if mapping.LOOPS_ADDED >= n:
                at.setdefault(n, sweep["stamp"])

    mapping.LOOP_CHECKS = mapping.LOOPS_ADDED = 0
    win = S.Window()
    with mock.patch.object(mapping, "_optimize_graph", opt), \
            mock.patch.object(icp_ops, "icp_point2point", icp), \
            mock.patch.object(pipe, "process_scan", scan):
        S.lio_warm(pipe, lap, dict(cell.traffic, warm_s=sensor_s), S.Throttle(
            cell.config["mapping_process_interval"]), win, dev, None)
    st = np.array([s for s, _ in win.lio])
    x6 = np.stack([x for _, x in win.lio])
    warm, period = cell.traffic["warm_s"], cell.traffic["motion"]["period"]
    win.lio_window_from = int(np.searchsorted(st, warm - 1e-9))
    win.attempted = sum(s >= warm - 1e-9 for s in fed)
    win.done = len(win.lio) - win.lio_window_from
    found = run.numbers(cell, win)
    correct, checks = run.judge(cell, found)
    w = win.lio_window_from
    rel = ref.lio_relative(st[w:], x6[w:], cell.traffic["motion"],
                           cell.traffic["short_horizon_s"])["rel_yaw"]
    starts = st[w:][: len(rel)]
    laps = {f"{a:.0f}-{a + period:.0f}": ref.median(rel[(starts >= a) & (starts < a + period)])
            for a in np.arange(warm, st[-1], period) if ((starts >= a) & (starts < a + period)).any()}
    limit = checks["lio_rel_yaw_median_err_rad"]["limit"]
    hold = {"sensor_s": float(st[-1]), "mapped": len(win.lio), "checks": checks,
            "rel_yaw_median_by_lap_rad": laps,
            "ok": bool(correct and max(laps.values(), default=0.0) <= limit)}
    s = pipe.state
    loops = {"checks": mapping.LOOP_CHECKS, "added": mapping.LOOPS_ADDED,
             "slots_used": int(s.n_loops), "keyframes": int(s.kf_count),
             "max_loops": cfg.caps.max_loops, "sensor_s_at_16": at.get(16),
             "sensor_s_at_64": at.get(64)}
    out = {"seed": seed, "device": torch.cuda.get_device_name(dev), "hold": hold, "loops": loops}
    ok = hold["ok"]
    if compare:
        from benchmark import loop_compare as LC

        if dump:
            os.makedirs(dump, exist_ok=True)
            (state, k), (a, kw, _) = last["solve"], last["icp"]
            torch.save({"graph": {f: v.cpu() for f, v in state.graph._asdict().items()}, "k": k,
                        "icp": [v.cpu() if torch.is_tensor(v) else v for v in a], "icp_kw": kw},
                       os.path.join(dump, f"loop_{seed}.pt"))
        out["posegraph"] = LC.compare_posegraph(*last["solve"])
        out["icp"] = LC.compare_icp(*last["icp"])
        ok = ok and out["posegraph"]["ok"] and out["icp"]["ok"]
    out["ok"] = bool(ok)
    return out


def _worker(seeds, sensor_s, compare, threads, dump, q):
    for seed in seeds:
        try:
            q.put(_seed_run(seed, sensor_s, seed in compare, threads, dump))
        except Exception as e:  # a seed that raised reports and fails
            import traceback

            traceback.print_exc()
            q.put({"seed": seed, "ok": False, "error": repr(e)})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sensor-s", type=float, default=230.0)
    ap.add_argument("--compare", default="")
    ap.add_argument("--workers", type=int, default=1)
    ap.add_argument("--dump", default=None, help="save each compared seed's last solve and ICP here")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    compare = {int(s) for s in args.compare.split(",") if s}
    import torch

    if not torch.cuda.is_available():
        print("chip_loop_check: no CUDA device; no result", file=sys.stderr)
        return 2
    n = max(1, min(args.workers, len(seeds)))
    threads = max(1, (os.cpu_count() or 1) // n)
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_worker, args=(seeds[w::n], args.sensor_s, compare, threads,
                                               args.dump, q)) for w in range(n)]
    for p in procs:
        p.start()
    results = []
    for _ in seeds:
        results.append(q.get())
        print(json.dumps(results[-1]), flush=True)
    for p in procs:
        p.join()
    summary = {"ok": all(r["ok"] for r in results),
               "seeds": {str(r["seed"]): r["ok"] for r in results}}
    print(json.dumps(summary), flush=True)
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
