"""collective.wait_share (share): the time block 0 of each rank of the
collective kernels spins on its peers (halo arrivals and allreduce slots),
summed over the ranks and solves, over the ranks' kernel time, summed the
same way: the port's counts ``collective.wait_ns`` and
``collective.kernel_ns`` (one of each per rank a solve, measured by the
kernel on %globaltimer and read back with its error word), of the solves of
the traced run's un-profiled stretch (``hpcbench.program_spans``). The
counts of that stretch are those recorded after its first span opened; the
set-up's warm-up solves come before it. Nothing to read where the port
records no such counts."""

from pathlib import Path

from hpcbench.program_spans import gather

CHECKS = Path(__file__).resolve().parents[1] / "checks"


def loop_counts(ctx) -> list:
    """The port's counts of the stretch (taken from the port once a run)."""
    if not hasattr(ctx, "loop_counts"):
        ctx.loop_counts = []
        try:
            from hpccg_tpu_torch.utils.trace import take_counts
        except ImportError:
            return ctx.loop_counts
        start = min(r.start for r in ctx.loop_spans)
        ctx.loop_counts = [c for c in take_counts() if c.at >= start]
    return ctx.loop_counts


def read(ctx):
    if not gather(ctx, CHECKS) or not ctx.loop_spans:
        return None
    counts = loop_counts(ctx)
    wait = sum(c.value for c in counts if c.name == "collective.wait_ns")
    kernel = sum(c.value for c in counts if c.name == "collective.kernel_ns")
    return wait / kernel if kernel > 0 else None
