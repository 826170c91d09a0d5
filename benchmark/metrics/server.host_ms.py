"""Host milliseconds per batch from the call into Server.search until it
returns (the benchmark's own host-clock span, before the answers are
copied back), mean over the window's untraced batches."""

from benchlib.layers import host_ms


def read(ctx):
    return host_ms(ctx)
