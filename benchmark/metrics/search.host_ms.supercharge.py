"""Host milliseconds a batch in the packed hash search's stage
``search.supercharge``: the expansion through the kNN graph, its merge and
the cut to k.  The self time of the program's span, waits for the card
included, median over the run's ``Server.search`` batches."""

from benchlib.spans import stage_ms


def read(ctx):
    return stage_ms("search.supercharge")
