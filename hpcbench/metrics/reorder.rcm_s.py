"""reorder.rcm_s (s): the summed time of the reverse Cuthill-McKee
orderings (``rcm_permutation``, its ``to_coo`` and CSR build included), the
port's ``reorder.rcm`` spans in the traced run's set-up with the spans on
(``hpcbench.program_spans``)."""

from pathlib import Path

from hpcbench.program_spans import count, gather, total_s

CHECKS = Path(__file__).resolve().parents[1] / "checks"


def read(ctx):
    if not gather(ctx, CHECKS) or not count(ctx.setup_spans, "reorder.rcm"):
        return None
    return total_s(ctx.setup_spans, "reorder.rcm")
