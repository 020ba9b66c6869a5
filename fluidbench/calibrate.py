"""Readings for a cell's correctness limits: the numbers compared, from
sound runs of the program on many seeds, from its control (the program
on the lower-precision path that limits/<cell>.json names under
"control") and from the faults of the cell's driver (its FAULTS), each
through a whole run's window, all in one process.

    python3 fluidbench/calibrate.py --workload stam3d-256.dct \
        --seeds 1-12 --control-seeds 101-103 --fault-seeds 201-203 \
        --seconds 20

Writes one JSON line a run to <out>/calibrate_<workload>.jsonl (``--out``,
build/calibrate by default) and prints, per number, the largest sound
reading and the smallest reading of the control and of each fault."""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from fluidbench import common, run  # noqa: E402


def seeds(text: str) -> list[int]:
    lo, _, hi = text.partition("-")
    return list(range(int(lo), int(hi or lo) + 1))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--out", default=str(common.ROOT / "build" / "calibrate"))
    a = p.parse_args(argv)
    w = common.workload(common.manifest(), a.workload)
    config, _, limits = common.cell_files(w)
    driver = common.module("drivers", config["driver"])
    control = limits["control"]
    out_dir = Path(a.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    sides = [("program", a.seeds, None), ("control", a.control_seeds, None)]
    sides += [(name, a.fault_seeds, name) for name in driver.FAULTS
              if a.fault_seeds]
    readings = {side: {} for side, _, _ in sides}
    with open(out_dir / f"calibrate_{a.workload}.jsonl", "a") as log:
        for side, group, fault in sides:
            for seed in seeds(group) if group else []:
                args = run.parse(["--workload", a.workload, "--seed",
                                  str(seed), "--seconds", str(a.seconds)])
                restore = driver.plant(fault) if fault else None
                try:
                    res = run.run(args, overrides=control
                                  if side == "control" else None)
                finally:
                    if restore:
                        restore()
                row = {"side": side, "seed": seed, "frames": res["attempted"],
                       "checks": res["checks"], "metrics": res["metrics"]}
                log.write(json.dumps(row) + "\n")
                log.flush()
                print(json.dumps(row), flush=True)
                for name, c in res["checks"].items():
                    readings[side].setdefault(name, []).append(c["value"])
    for side, by_name in readings.items():
        for name, values in by_name.items():
            worst = max if side == "program" else min
            print(f"{a.workload} {name}: {side} "
                  f"{'max' if side == 'program' else 'min'} "
                  f"{worst(values)!r} over {len(values)} seeds")


if __name__ == "__main__":
    main()
