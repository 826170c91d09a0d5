"""Host milliseconds a batch in the packed hash search's stage
``search.probe``: the probe kernel's inputs and its launch.  The self time
of the program's span, waits for the card included, median over the
run's ``Server.search`` batches."""

from benchlib.spans import stage_ms


def read(ctx):
    return stage_ms("search.probe")
