"""``device.idle_share``: the share of the traced window in which no
operation ran on the card (the union of the profiler's device
intervals), in percent."""


def read(ctx):
    if not ctx.get("trace_window_s") or ctx.get("busy_s") is None:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["trace_window_s"])
