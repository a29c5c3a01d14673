"""One run of a benchmark cell with the port's spans on or off throughout.

    python scripts/bench_spans.py --spans on|off --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout; the arguments after ``--spans`` are
``python -m hpcbench.run``'s, and the last line of standard output is its
result line. With ``on`` the set-up and the window (``--trace 0``) or the
profiled stretch (``--trace 1``) record the port's spans
(``hpccg_tpu_torch.utils.trace``); ``off`` imports the same modules first
and leaves them off, as the benchmark does, so the two give the cost of
tracing. In a traced run with ``on`` the breakdown's idle gaps name the
port's phases. After an untraced run with ``on``, standard error ends with
the run's spans (its set-up and window): count and seconds by name.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from hpccg_tpu_torch.utils import trace  # noqa: E402
from hpcbench import program_spans, run  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--spans", choices=("on", "off"), required=True)
    args, rest = ap.parse_known_args()
    if args.spans == "on":
        trace.enable()
    rc = run.main(rest)
    records = trace.take()
    trace.disable()
    if records:
        print(f"bench_spans: the run's spans (count, s) {program_spans.summary(records)}", file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main())
