"""``polish.s_per_lane``: the polish layer's StageTimer seconds a lane,
over the traced window's lanes."""

from tcrbench.metrics._stages import per_lane

STAGES = ("round1_polish", "round1_consensus")


def read(ctx):
    return per_lane(ctx, STAGES)
