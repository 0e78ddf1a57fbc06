"""State carried across from the JAX package: the reference panel and the
polisher's weights.

:func:`panel_from_numpy` builds the port's panel (encoded regions, their
k-mer profiles, the region -> cluster map) from the JAX panel's arrays (as
numpy), so both packages align against the identical panel.
:func:`polisher_from_numpy` builds the bi-GRU polisher from a Flax params
tree (as numpy, e.g. ``models.polisher.load_params``), and
:func:`polisher_to_numpy` gives a trained polisher's tree back in Flax's
layout (``models.polisher.save_params`` writes it as Flax's bytes).
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


def _tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    return torch.tensor(np.asarray(a, dtype=np.float32))


def _bigru_layers(params: dict) -> list[str]:
    return sorted((k for k in params if k.startswith("bigru")), key=lambda k: int(k[5:]))


def state_from_tree(params: dict) -> dict[str, torch.Tensor]:
    """The :class:`~.models.polisher.ConsensusPolisher` state (tensors, on
    the leaves' device) of a Flax params tree whose leaves are numpy arrays
    or tensors.

    ``embed`` and ``head`` are Dense layers (kernel (in, out), transposed
    into ``Linear.weight``); ``bigru<i>/GRUCell_0`` is layer i's forward
    direction and ``GRUCell_1`` its backward one (torch's ``_reverse``
    parameters). A GRU cell's gates go in torch's order r, z, n. Flax puts
    the r and z biases on the input side and the n bias on both sides
    (``in`` and, inside the reset product, ``hn``), so torch's hidden-side
    r and z biases are zero.
    """
    state = {}
    for name in ("embed", "head"):
        state[f"{name}.weight"] = _tensor(params[name]["kernel"]).T
        state[f"{name}.bias"] = _tensor(params[name]["bias"])
    for i, layer in enumerate(_bigru_layers(params)):
        for cell, suffix in (("GRUCell_0", ""), ("GRUCell_1", "_reverse")):
            c = params[layer][cell]

            def cat(names, part, c=c):
                return torch.cat([_tensor(c[n][part]) for n in names], dim=-1)

            hn_bias = _tensor(c["hn"]["bias"])
            pre = f"grus.{i}."
            state[f"{pre}weight_ih_l0{suffix}"] = cat(("ir", "iz", "in"), "kernel").T
            state[f"{pre}bias_ih_l0{suffix}"] = cat(("ir", "iz", "in"), "bias")
            state[f"{pre}weight_hh_l0{suffix}"] = cat(("hr", "hz", "hn"), "kernel").T
            state[f"{pre}bias_hh_l0{suffix}"] = torch.cat(
                [hn_bias.new_zeros(2 * hn_bias.shape[0]), hn_bias])
    return state


def _sorted_tree(tree: dict) -> dict:
    """Keys sorted at every level, the order of Flax's msgpack files."""
    return {k: _sorted_tree(v) if isinstance(v, dict) else v for k, v in sorted(tree.items())}


def tree_from_state(state: dict[str, torch.Tensor]) -> dict:
    """The inverse of :func:`state_from_tree`: the Flax params tree
    (tensors, keys sorted at every level) of a polisher's state. Torch's
    n-gate biases go back to ``in`` and ``hn``; its hidden-side r and z
    biases have no Flax counterpart and must be zero (training keeps their
    gradient zero), else this raises."""
    tree: dict = {}
    for name in ("embed", "head"):
        tree[name] = {"kernel": state[f"{name}.weight"].T, "bias": state[f"{name}.bias"]}
    n_layers = len({k.split(".")[1] for k in state if k.startswith("grus.")})
    for i in range(n_layers):
        layer = {}
        for cell, suffix in (("GRUCell_0", ""), ("GRUCell_1", "_reverse")):
            def get(key, i=i, suffix=suffix):
                return state[f"grus.{i}.{key}_l0{suffix}"]

            w_ih, b_ih, w_hh, b_hh = (get(k) for k in
                                      ("weight_ih", "bias_ih", "weight_hh", "bias_hh"))
            hidden = w_hh.shape[1]
            if bool((b_hh[: 2 * hidden] != 0).any()):
                raise ValueError(f"bigru{i}/{cell}: the hidden-side r and z biases are not "
                                 "zero, which a Flax GRUCell cannot hold")
            gates = {}
            for g, (gi, gh) in enumerate((("ir", "hr"), ("iz", "hz"), ("in", "hn"))):
                rows = slice(g * hidden, (g + 1) * hidden)
                gates[gi] = {"kernel": w_ih[rows].T, "bias": b_ih[rows]}
                gates[gh] = {"kernel": w_hh[rows].T}
            gates["hn"]["bias"] = b_hh[2 * hidden:]
            layer[cell] = gates
        tree[f"bigru{i}"] = layer
    return _sorted_tree(tree)


def polisher_from_numpy(params: dict, device: str | torch.device | None = None,
                        dtype: torch.dtype = torch.float32):
    """The port's :class:`~.models.polisher.ConsensusPolisher` from a Flax
    params tree of numpy arrays (or tensors), on ``device`` (the card when
    None), its parameters in ``dtype`` (bfloat16 for the bf16 serving
    copy), in eval mode (training calls ``.train()``: cuDNN's RNN backward
    needs it). The layout mapping is :func:`state_from_tree`'s.
    """
    from ont_tcrconsensus_tpu_torch.models.polisher import ConsensusPolisher

    device = resolve_device(device)
    fan_in, hidden = _tensor(params["embed"]["kernel"]).shape
    model = ConsensusPolisher(feature_dim=fan_in, hidden=hidden,
                              num_layers=len(_bigru_layers(params)))
    model.load_state_dict({k: v.detach().cpu().contiguous()
                           for k, v in state_from_tree(params).items()})
    model = model.to(device=device, dtype=dtype).eval()
    for gru in model.grus:
        gru.flatten_parameters()
    return model


def polisher_to_numpy(model) -> dict:
    """The Flax params tree (float32 numpy, keys sorted at every level) of
    a :class:`~.models.polisher.ConsensusPolisher`: the inverse of
    :func:`polisher_from_numpy` (see :func:`tree_from_state`)."""
    def host(tree):
        return {k: host(v) if isinstance(v, dict)
                else v.detach().to(device="cpu", dtype=torch.float32).numpy().copy()
                for k, v in tree.items()}

    return host(tree_from_state(model.state_dict()))
