"""A lane small enough for the CPU: two regions of 1.50-1.56 kb, one
near-duplicate, one negative control, two molecules a region of 5-6
reads, the deep lane's UMIs, adapters and error model."""

TINY = {"num_regions": 2, "region_len": [1500, 1560], "num_similar_pairs": 1,
        "similar_divergence": 0.01, "num_negative_controls": 1,
        "molecules_per_region": [2, 2], "reads_per_molecule": [5, 6],
        "umi_fwd": "TTTVVTTVVVVTTVVVVTTVVVVTTVVVVTTT",
        "umi_rev": "AAABBBBAABBBBAABBBBAABBBBAABBAAA", "with_adapters": True}
