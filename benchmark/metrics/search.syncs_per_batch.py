"""Host syncs of one Server.search batch, counted under
torch.cuda.set_sync_debug_mode("warn") after the window, outside the
traced slice: a count, which repeats exactly."""


def read(ctx):
    return None if ctx.syncs is None else float(ctx.syncs)
