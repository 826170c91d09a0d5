"""Host milliseconds a batch inside ``Server.search`` outside the engine's
spans (query placement, routing, what lies between the stages): the self
time of the program's ``server.search`` span, median over the run's
batches whose engine has a span of its own (the exact kernels' and the
packed hash search's; a CPU oracle has none, and its time is not the
entry's)."""

from benchlib.spans import stage_ms


def read(ctx):
    return stage_ms("server.search", nested=True)
