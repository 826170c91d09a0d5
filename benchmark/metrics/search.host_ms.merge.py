"""Host milliseconds a batch in the packed hash search's stage
``search.merge``: the winners' slot-to-id lookup, masking and the
cross-table merge.  The self time of the program's span, waits for the
card included, median over the run's ``Server.search`` batches."""

from benchlib.spans import stage_ms


def read(ctx):
    return stage_ms("search.merge")
