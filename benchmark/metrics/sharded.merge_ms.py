"""Host milliseconds a batch in the sharded merge on rank 0: the program's
``sharded.merge`` span (local ids to global, the all-gather of every
rank's top lists, the top-k over them) under ``sharded.search``, median
over the run's batches."""

from benchlib.spans import records, self_ms


def read(ctx):
    return self_ms(records(), "sharded.merge", root="sharded.search")
