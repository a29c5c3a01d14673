"""Readings for the limits of the comparison that decides ``correct``.

    python3 -m hpcbench.control --workload <cell> --seeds 11,12,13 --seconds 3 [--system float32]

runs the cell's set-up, a short window and the comparison once per seed in
one process, and prints one JSON line per seed with the numbers compared
(``checks``). ``--system port`` (the default) reads the program's numbers,
the lower readings of each limit; ``--system float32`` puts the control in
the program's place, the plain reference computed in float32 (the nearest
precision below the configuration's float64), whose numbers the limits
must fail. On a cell of several cards the control runs on the first
card alone. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import types

import torch

from hpcbench.reference import matvec
from hpcbench.reference.cg import cg
from hpcbench.registry import Bench
from hpcbench.run import run_cell
from hpcbench.systems import Runner

CONTROL_DTYPE = torch.float32


def reference_runner(config: dict, problem, device, dtype=CONTROL_DTYPE) -> Runner:
    """The plain reference in ``dtype`` as the system: same inputs, its
    result cast back to the configuration's dtype."""
    A = matvec(config["reference"], problem, dtype, device)

    def solve(b, x0):
        out = cg(A, b.to(dtype), x0.to(dtype), max_iter=config["max_iter"], tolerance=config["tolerance"])
        return types.SimpleNamespace(x=out["x"].to(b.dtype), niters=torch.tensor(out["niters"]),
                                     normr=torch.tensor(out["normr"]), trace=out["trace"])

    return Runner(solve, problem.rhs, problem.x0, notes={"system": f"reference in {str(dtype)[6:]}"})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--system", choices=("port", "float32"), default="port")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    system = None
    if args.system == "float32":
        def system(config, problem, devices, spans):
            return reference_runner(config, problem, devices[0])
    bench = Bench()
    for seed in (int(s) for s in args.seeds.split(",")):
        out = run_cell(bench, args.workload, seed, args.seconds, False, device=args.device,
                       system=system, all_cards=system is None)
        print(json.dumps({"seed": seed, "system": args.system, "correct": out["correct"],
                          "attempted": out["attempted"], "metrics": out["metrics"], "notes": out["notes"],
                          "checks": out["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
