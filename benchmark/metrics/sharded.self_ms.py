"""Host milliseconds a batch inside ``ShardedServer.search`` on rank 0
outside the engine's span (``exact.twophase``) and the merge's
(``sharded.merge``): query placement, routing and what lies between them,
the self time of the program's ``sharded.search`` span, median over the
run's batches whose search has a child span."""

from benchlib.spans import records, self_ms


def read(ctx):
    return self_ms(records(), "sharded.search", root="sharded.search", nested=True)
