"""``umi.s_per_lane``: the UMI layer's StageTimer seconds a lane (the
records and the clustering of both rounds), over the traced window's
lanes."""

from tcrbench.metrics._stages import per_lane

STAGES = ("round1_umi_records", "round2_umi_records", "round1_umi_cluster",
          "round2_umi_cluster")


def read(ctx):
    return per_lane(ctx, STAGES)
