"""reorder.to_dia_s (s): the summed time of the structure chooser's
conversions to diagonal storage (``to_dia``), the port's ``reorder.to_dia``
spans in the traced run's set-up with the spans on
(``hpcbench.program_spans``)."""

from pathlib import Path

from hpcbench.program_spans import count, gather, total_s

CHECKS = Path(__file__).resolve().parents[1] / "checks"


def read(ctx):
    if not gather(ctx, CHECKS) or not count(ctx.setup_spans, "reorder.to_dia"):
        return None
    return total_s(ctx.setup_spans, "reorder.to_dia")
