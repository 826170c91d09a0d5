"""Host milliseconds a batch in the packed hash search's stage
``search.codes``: query centring, projection, sign codes, directed probes
and window starts.  The self time of the program's span, waits for the
card included, median over the run's ``Server.search`` batches."""

from benchlib.spans import stage_ms


def read(ctx):
    return stage_ms("search.codes")
