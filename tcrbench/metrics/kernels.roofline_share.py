"""``kernels.roofline_share``: kernels B1-B6 over the traced window, the
sum of each launch's bound (``tcrbench/roofline/<kernel>.py``) over the
sum of their device time, in percent. Nothing when no launch of them ran
on the device."""


def read(ctx):
    kern = ctx.get("kernels") or {}
    device_s = sum(k["device_s"] for k in kern.values())
    if device_s <= 0:
        return None
    return 100.0 * sum(k["bound_s"] for k in kern.values()) / device_s
