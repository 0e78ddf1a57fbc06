"""``qc.wait_s_per_lane``: the seconds a lane's critical path waits on QC
(the commits of work done on the overlap workers, whose own ``*_bg``
seconds are not counted)."""

from tcrbench.metrics._stages import per_lane

STAGES = ("round1_error_profile", "round2_error_profile", "write_region_fastas")


def read(ctx):
    return per_lane(ctx, STAGES)
