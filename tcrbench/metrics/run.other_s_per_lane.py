"""``run.other_s_per_lane``: a lane's wall seconds less the stages that
the other readers of this folder declare (``STAGES``): the run and graph
executor's own time, the region split, the counts and whatever no stage
times."""

import os

from tcrbench.metrics._stages import declared


def read(ctx):
    if not ctx["lanes"] or not ctx["timings"]:
        return None
    stages = declared(os.path.dirname(os.path.abspath(__file__)))
    staged = sum(t.get(n, 0.0) for t in ctx["timings"] for n in stages)
    return (sum(ctx["lane_s"]) - staged) / ctx["lanes"]
