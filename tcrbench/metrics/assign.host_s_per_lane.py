"""``assign.host_s_per_lane``: the launch thread's host seconds at the
``assign.dispatch`` site a lane (each lane's ``telemetry.json``)."""


def read(ctx):
    vals = [t["dispatch"]["assign.dispatch"]["host_s"] for t in ctx["telemetry"]
            if "assign.dispatch" in t.get("dispatch", {})]
    if not vals:
        return None
    return sum(vals) / len(vals)
