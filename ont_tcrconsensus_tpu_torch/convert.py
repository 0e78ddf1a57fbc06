"""State carried across from the JAX package: the reference panel.

This slice has no learned weights on its path; its state is the reference
panel (encoded regions, their k-mer profiles, the region -> cluster map).
:func:`panel_from_numpy` builds the port's panel from the JAX panel's arrays
(as numpy), so both packages align against the identical panel.
"""

from __future__ import annotations

import numpy as np
import torch

from ont_tcrconsensus_tpu_torch.pipeline.assign import ReferencePanel


def panel_from_numpy(codes, lens, profiles, names, region_cluster,
                     device: str | torch.device = "cpu", seqs=None) -> ReferencePanel:
    """The port's :class:`ReferencePanel` from numpy arrays.

    Args: codes (R, Wr) uint8, lens (R,) int32, profiles (R, dim) float32,
    names (R region names), region_cluster {name: cluster id}; ``seqs``
    {name: sequence} (decoded from ``codes`` when None).
    """
    codes = np.array(codes, dtype=np.uint8)  # owned, writable copies
    lens = np.array(lens, dtype=np.int32)
    profiles = np.array(profiles, dtype=np.float32)
    names = list(names)
    if seqs is None:
        from ont_tcrconsensus_tpu_torch.ops import encode

        seqs = dict(zip(names, encode.decode_batch(codes, lens)))
    return ReferencePanel(
        names=names, seqs=dict(seqs), codes=codes, lens=lens, profiles=profiles,
        region_cluster=dict(region_cluster),
        cluster_of_region=np.array([region_cluster[n] for n in names], dtype=np.int32),
        d_codes=torch.from_numpy(codes).to(device),
        d_lens=torch.from_numpy(lens).to(device),
        d_profiles=torch.from_numpy(profiles).to(device),
    )
