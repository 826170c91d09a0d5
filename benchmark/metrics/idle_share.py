"""Share of the traced slice's wall time in which no operation ran on the
device (torch.profiler device trace), in percent."""

from benchlib.layers import idle_pct


def read(ctx):
    return idle_pct(ctx)
