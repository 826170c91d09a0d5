"""95th percentile of the batches' latency, from the queries in host
memory to the ids and distances in host memory, over the window's untraced
batches: in a closed loop with one batch in flight, the tail of the
service time."""

from benchlib.layers import latency_ms


def read(ctx):
    return latency_ms(ctx, 0.95)
