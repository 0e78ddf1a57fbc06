"""State carried across from the JAX package: the reference panel and the
polisher's weights.

:func:`panel_from_numpy` builds the port's panel (encoded regions, their
k-mer profiles, the region -> cluster map) from the JAX panel's arrays (as
numpy), so both packages align against the identical panel.
:func:`polisher_from_numpy` builds the bi-GRU polisher from a Flax params
tree (as numpy, e.g. ``models.polisher.load_params``).
"""

from __future__ import annotations

import numpy as np
import torch

from ont_tcrconsensus_tpu_torch.device import resolve_device
from ont_tcrconsensus_tpu_torch.pipeline.assign import ReferencePanel


def panel_from_numpy(codes, lens, profiles, names, region_cluster,
                     device: str | torch.device | None = None, seqs=None) -> ReferencePanel:
    """The port's :class:`ReferencePanel` from numpy arrays, its device
    copies on ``device`` (the card when None).

    Args: codes (R, Wr) uint8, lens (R,) int32, profiles (R, dim) float32,
    names (R region names), region_cluster {name: cluster id}; ``seqs``
    {name: sequence} (decoded from ``codes`` when None).
    """
    device = resolve_device(device)
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


def _gru_direction(cell: dict) -> dict[str, np.ndarray]:
    """One Flax ``GRUCell``'s params as torch's weights, gates in torch's
    order r, z, n. Flax puts the r and z biases on the input side and the n
    bias on both sides (``in`` and, inside the reset product, ``hn``), so
    torch's hidden-side r and z biases are zero."""
    def cat(names, part):
        return np.concatenate([np.asarray(cell[n][part], np.float32) for n in names], axis=-1)

    hidden = np.asarray(cell["hn"]["bias"]).shape[0]
    return {
        "weight_ih": cat(("ir", "iz", "in"), "kernel").T,
        "bias_ih": cat(("ir", "iz", "in"), "bias"),
        "weight_hh": cat(("hr", "hz", "hn"), "kernel").T,
        "bias_hh": np.concatenate([np.zeros(2 * hidden, np.float32),
                                   np.asarray(cell["hn"]["bias"], np.float32)]),
    }


def polisher_from_numpy(params: dict, device: str | torch.device | None = None):
    """The port's :class:`~.models.polisher.ConsensusPolisher` from a Flax
    params tree of numpy arrays, on ``device`` (the card when None).

    ``embed`` and ``head`` are Dense layers (kernel (in, out), transposed
    into ``Linear.weight``); ``bigru<i>/GRUCell_0`` is layer i's forward
    direction and ``GRUCell_1`` its backward one (torch's ``_reverse``
    parameters).
    """
    from ont_tcrconsensus_tpu_torch.models.polisher import ConsensusPolisher

    device = resolve_device(device)
    hidden = np.asarray(params["embed"]["kernel"]).shape[1]
    layers = sorted((k for k in params if k.startswith("bigru")), key=lambda k: int(k[5:]))
    model = ConsensusPolisher(feature_dim=np.asarray(params["embed"]["kernel"]).shape[0],
                              hidden=hidden, num_layers=len(layers))
    state = {}
    for name in ("embed", "head"):
        state[f"{name}.weight"] = np.asarray(params[name]["kernel"], np.float32).T
        state[f"{name}.bias"] = np.asarray(params[name]["bias"], np.float32)
    for i, layer in enumerate(layers):
        for cell, suffix in (("GRUCell_0", ""), ("GRUCell_1", "_reverse")):
            for key, arr in _gru_direction(params[layer][cell]).items():
                state[f"grus.{i}.{key}_l0{suffix}"] = arr
    model.load_state_dict({k: torch.tensor(np.ascontiguousarray(v)) for k, v in state.items()})
    model = model.to(device).eval()
    for gru in model.grus:
        gru.flatten_parameters()
    return model
