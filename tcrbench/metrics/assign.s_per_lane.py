"""``assign.s_per_lane``: the assign layer's StageTimer seconds a lane,
over the traced window's lanes."""

from tcrbench.metrics._stages import per_lane

STAGES = ("self_homology", "round1_fused_assign", "round2_fused_assign")


def read(ctx):
    return per_lane(ctx, STAGES)
