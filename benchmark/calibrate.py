"""Readings that set a cell's limits and rate, many runs in one process.

    python3 benchmark/calibrate.py --workload <name> --seconds 10 \
        --modes '[{"seeds": [1, 2, 3]}, {"control": true, "seeds": [4, 5, 6]}, {"fault": "parent", "seeds": [7]}]'
    python3 benchmark/calibrate.py --workload <name> --seconds 20 --modes '[{"seeds": [1]}]' --rates 8,10,12

Each run is a whole run of the cell (``run.py``'s ``run_cell``: weights,
pipeline, warm-up, window, the reference's judgement) with the build and
the imports shared, one JSON line a run: the numbers the check compares
(``readings``), ``correct`` and the end-to-end metrics. A mode runs the
program (``{}``), a control (``"control": true``, the configuration
file's; or a dict of the change, as a configuration's ``control`` is
written) or the program with a fault planted (``"fault"``, one that the
configuration's family names, planted by ``benchmark/faults.py``).
``--rates`` runs an open-loop cell at each rate in turn, to find the
highest it sustains: a rate is sustained when no more than one batch
waits at the window's close (``unanswered_at_close`` at most two batches,
one of them in flight). The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def err_summary(errs: list) -> dict:
    """How the judged numbers spread: quantiles and each request's mean
    and largest."""
    import numpy as np

    flat = np.concatenate([np.atleast_1d(np.asarray(e, dtype=np.float64)) for e in errs])
    return {"quantiles": {q: float(np.quantile(flat, q)) for q in (0.5, 0.9, 0.99, 0.999)},
            "request_mean": [float(np.mean(e)) for e in errs], "request_max": [float(np.max(e)) for e in errs]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--modes", required=True, help="JSON list of {control?, fault?, seeds}")
    parser.add_argument("--rates", default="")
    parser.add_argument("--judged", type=int, default=0, help="requests the reference judges a run")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark import faults, harness, run

    run._cache_dirs()
    base = harness.load_workload(args.workload)
    family = harness.family_module(harness.load_config(base["config"])["family"])
    width = base["traffic"]["beam_width"]
    rates = [float(r) for r in args.rates.split(",") if r] or [None]
    for mode in json.loads(args.modes):
        for seed in mode["seeds"]:
            for rate in rates:
                workload = copy.deepcopy(base)
                if rate is not None:
                    workload["traffic"]["rate"] = rate
                with faults.planted(family, mode.get("fault"), width):
                    out = run.run_cell(args.workload, seed, args.seconds, False, "cuda", workload=workload,
                                       control=mode.get("control", False), judged=args.judged or None, keep=True)
                rec = out["record"]
                errs = out["readings"].pop("errs")
                line = {"workload": args.workload, "seed": seed, "control": out["ctx"].control,
                        "fault": mode.get("fault"), "rate": rate, "correct": out["result"]["correct"],
                        "readings": out["readings"],
                        "metrics": {k: v["value"] for k, v in out["result"]["metrics"].items()},
                        "setup_s": out["ctx"].setup_s, "completed": rec["completed"], "failed": rec["failed"],
                        "window_s": rec["window_s"], "errs": err_summary(errs) if errs else None}
                for key in ("unanswered_at_close", "late_submit_ms", "batches", "batched_requests"):
                    if key in rec:
                        line[key] = rec[key]
                print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
