"""The data mesh: device batches split over slices, one program per slice.

The counterpart of the JAX package's ``parallel/mesh.py``. There a mesh is
a ``jax.sharding.Mesh`` and each shard runs the exact single-chip program
under ``shard_map`` with no collectives. Here a :class:`Mesh` is a small
value of the port's own:

- its axis names and sizes (``data``, optionally ``model``);
- an ordered grid of :class:`Slice` s, each a ``torch.device`` plus a slice
  id (labels ``f"{platform}:{id}"``, the JAX package's, so the CPU slices
  read ``cpu:0`` ... ``cpu:7``);
- :func:`shard_map_compat`, which runs the single-card function once per
  data slice on that slice's rows and concatenates the outputs in slice
  order.

Where the slices come from:

- by default, the platform of the run's device: every card of the host
  (``cuda:0`` ... ``cuda:{n-1}``), or one CPU slice;
- slices installed for the calling job (:func:`install_slice_devices`),
  the way a job's device set is restricted; the tests install eight CPU
  slices, the counterpart of the JAX tests' eight virtual XLA devices;
- an explicit ``devices=`` list. Installed or explicit slices may name one
  card more than once (two slices of one card run one after the other on
  its stream); they never mix the CPU with a card.

The ``model`` axis carries the polisher's tensor-parallel layout for
training (:func:`polisher_param_sharding`, :func:`sharded_train_step`);
every other function here runs once per DATA index, on the first slice of
that data row.

A slice's function may be a generator: the runner then advances every
slice one step before the next (:func:`lockstep`), so a host loop that
launches a little work a step (the pileup traceback's plain steps) keeps
every card busy instead of finishing card 0's loop before card 1 starts,
and every slice launches its kernels before any slice waits. Outputs are
gathered onto the first slice's device.
"""

from __future__ import annotations

import dataclasses
import inspect
import threading

import numpy as np
import torch

from ont_tcrconsensus_tpu_torch.device import resolve_device
from ont_tcrconsensus_tpu_torch.obs import metrics as obs_metrics
from ont_tcrconsensus_tpu_torch.obs import transfers as obs_transfers
from ont_tcrconsensus_tpu_torch.robustness import faults, jobscope

# --- per-job slice install ----------------------------------------------------
# A job whose run may use only some of the host's devices installs them
# here before dispatch; every make_mesh inside that job (overlap workers
# included, which adopt the job scope) sees only those. A thread-local
# fallback serves unscoped callers (the tests); plain one-shot runs see the
# host's devices.
_TLS = threading.local()


def install_slice_devices(devices) -> None:
    """Restrict ``make_mesh``'s default slices for the calling job scope
    (or thread, unscoped): devices (``torch.device`` or strings), each one
    slice, in order; ``None`` clears."""
    devs = list(devices) if devices is not None else None
    if jobscope.active():
        jobscope.set("slice_devices", devs)
        return
    _TLS.devices = devs


def slice_devices():
    """The calling job's installed slice devices (None = the host's)."""
    devs = jobscope.get("slice_devices")
    if devs is not None:
        return devs
    return getattr(_TLS, "devices", None)


def install_degrade_hook(hook) -> None:
    """Install a callable(lost_slices) fired when :func:`degrade_mesh`
    drops a data slice inside the calling job scope (or thread, unscoped);
    ``None`` clears."""
    if jobscope.active():
        jobscope.set("degrade_hook", hook)
        return
    _TLS.degrade_hook = hook


# --- the mesh -------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Slice:
    """One slice of a mesh: a device and the slice's id (its position in
    the device list the mesh was built from; the card index in the
    default mesh of a host)."""

    id: int
    device: torch.device

    @property
    def platform(self) -> str:
        return self.device.type

    @property
    def label(self) -> str:
        return f"{self.platform}:{self.id}"


class PartitionSpec(tuple):
    """Per-dimension axis names of one argument or output: ``P("data",
    None)`` splits the leading dimension over the data axis, ``P()`` is
    replicated (the spelling of ``jax.sharding.PartitionSpec``)."""

    def __new__(cls, *names):
        return super().__new__(cls, names)

    def __repr__(self):
        return f"P{tuple(self)!r}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Axis names and a grid of slices (``devices`` has the axis sizes as
    its shape, like a ``jax.sharding.Mesh``)."""

    axis_names: tuple[str, ...]
    devices: np.ndarray

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def data_slices(self) -> list[Slice]:
        """One slice per data index: the first slice of each data row."""
        grid = self.devices
        if "data" not in self.axis_names:
            return [grid.flat[0]]
        axis = self.axis_names.index("data")
        rows = np.moveaxis(grid, axis, 0).reshape(grid.shape[axis], -1)
        return [row[0] for row in rows]


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the spelling of ``jax.sharding.NamedSharding``)."""

    mesh: Mesh
    spec: PartitionSpec


def _host_devices(device=None) -> list[torch.device]:
    """The default slices for a run on ``device`` (the card when None):
    every card of the host, or one CPU slice."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device(dev.type)]


def make_mesh(shape: dict[str, int] | None = None, devices=None, device=None) -> Mesh:
    """Build a mesh; the default puts every slice on the data axis.

    ``shape`` e.g. {"data": 4, "model": 2}; the axis sizes multiply to the
    slices used, the first ones of ``devices``, else the installed slices
    (:func:`install_slice_devices`), else the host's devices of the
    platform of ``device`` (the run's device; the card when None).
    """
    if devices is None:
        devices = slice_devices()
    devices = [torch.device(d) for d in
               (devices if devices is not None else _host_devices(device))]
    if device is not None:
        want = torch.device(device).type
        if any(d.type != want for d in devices):
            raise ValueError(f"mesh slices {[str(d) for d in devices]} are not all "
                             f"on the run's platform {want!r}")
    if not shape:
        shape = {"data": len(devices)}
    names = tuple(shape)
    sizes = tuple(shape[n] for n in names)
    total = int(np.prod(sizes))
    if total > len(devices):
        raise ValueError(f"mesh {shape} needs {total} devices, have {len(devices)}")
    grid = np.empty(total, dtype=object)
    for i in range(total):
        grid[i] = Slice(i, devices[i])
    return Mesh(names, grid.reshape(sizes))


def mesh_data_size(mesh: Mesh) -> int:
    """Size of the mesh's ``data`` axis (the one shared helper for every
    divisibility check before a sharded dispatch)."""
    return mesh.shape["data"]


def data_sharding(mesh: Mesh, ndim: int) -> NamedSharding:
    """Split the leading (batch) axis over the data axis; rest replicated."""
    return NamedSharding(mesh, P("data", *([None] * (ndim - 1))))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def axis_sharding(mesh: Mesh, axis: str, ndim: int) -> NamedSharding:
    """The sharding splitting the leading dim over ``axis`` (the runtime
    face of one :func:`node_sharding_plan` entry)."""
    return NamedSharding(mesh, P(axis, *([None] * (ndim - 1))))


# --- placement ------------------------------------------------------------------


@dataclasses.dataclass
class Placed:
    """One array placed on a mesh: a tensor per data slice, in slice order
    (the rows of that slice, or the whole array when replicated). Slices
    of one device share one replicated tensor."""

    shards: list[torch.Tensor]
    sharding: NamedSharding

    def gather(self) -> torch.Tensor:
        """The whole array on the first slice's device."""
        if not self.sharding.spec:
            return self.shards[0]
        dev = self.shards[0].device
        return torch.cat([s.to(dev, non_blocking=True) for s in self.shards])


def _as_tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    return torch.from_numpy(np.ascontiguousarray(a))


def _place(mesh: Mesh, a, split: bool) -> Placed:
    """``a`` on every data slice: its rows split in slice order, or one
    copy per device (slices of one device share it)."""
    slices = mesh.data_slices()
    t = _as_tensor(a)
    if split:
        n = len(slices)
        if t.shape[0] % n:
            raise ValueError(f"leading dim {t.shape[0]} does not divide the data axis {n}")
        rows = t.shape[0] // n
        shards = [t[i * rows:(i + 1) * rows].to(s.device, non_blocking=True)
                  for i, s in enumerate(slices)]
        return Placed(shards, data_sharding(mesh, t.dim()))
    copies: dict[torch.device, torch.Tensor] = {}
    shards = []
    for s in slices:
        if s.device not in copies:
            copies[s.device] = t.to(s.device, non_blocking=True)
        shards.append(copies[s.device])
    return Placed(shards, replicated(mesh))


def replicate(mesh: Mesh, a) -> Placed:
    """``a`` on every data slice, one copy per device (the engines keep
    their panel constants placed this way for the life of a mesh)."""
    return _place(mesh, a, split=False)


def materialized_shard_bytes(placed) -> int:
    """Bytes the devices actually hold for one placed array: each distinct
    shard tensor once. A data-split array sums to its logical size; a
    replicated one to one copy per DEVICE, so slices that share a device
    share its copy. (The JAX package charges one copy per slice, N copies,
    because each of its slices is its own device.) Plain arrays and
    tensors count their logical size."""
    if isinstance(placed, Placed):
        seen, total = set(), 0
        for s in placed.shards:
            key = (s.device, s.data_ptr(), s.numel())
            if key not in seen:
                seen.add(key)
                total += s.numel() * s.element_size()
        return total
    return obs_transfers.nbytes_of(placed)


def mark_mesh_slices(mesh: Mesh, busy: float = 1.0) -> None:
    """Per-slice busy gauge (``tcr_mesh_slice_busy``): every slice of the
    mesh marked ``busy``; :func:`degrade_mesh` re-marks survivors 1 and
    the lost slices 0. Every sharded dispatch marks its mesh, so a
    /metrics scrape shows which slices carry work. Free no-op when
    telemetry is off."""
    if not obs_metrics.armed():
        return
    for s in mesh.devices.flat:
        obs_metrics.mesh_slice_set(s.label, busy)
    obs_metrics.gauge_set("mesh.slice_busy", float(mesh.devices.size) * busy)


def shard_batch(mesh: Mesh, *arrays):
    """Place each array with its leading axis split over the data slices
    (:class:`Placed`). Leading dimensions must divide the data-axis size;
    callers pad batches.

    The transfer ledger is charged the bytes each slice receives
    (:func:`materialized_shard_bytes`), and every slice is marked busy.
    """
    faults.inject("mesh.dispatch")
    out = [_place(mesh, a, split=True) for a in arrays]
    obs_transfers.h2d("transfer.h2d", None,
                      nbytes=sum(materialized_shard_bytes(p) for p in out))
    mark_mesh_slices(mesh)
    return tuple(out) if len(out) > 1 else out[0]


# --- the per-slice runner ---------------------------------------------------------

_CURRENT = threading.local()


def current_slice_label() -> str | None:
    """The label of the slice whose program the calling thread is running
    (None outside a sharded call): the kernel wrappers count their
    launches by slice under it."""
    return getattr(_CURRENT, "label", None)


def count_slice_launch(by_slice: dict) -> None:
    """Add one launch to ``by_slice`` under the running slice's label
    (nothing outside a sharded call)."""
    label = current_slice_label()
    if label is not None:
        by_slice[label] = by_slice.get(label, 0) + 1


def lockstep(programs: list, labels: list[str] | None = None) -> list:
    """Run per-slice programs to their ends; a generator advances one step
    on every slice before any slice takes its next, other values are
    results already. Returns each program's result in order."""
    results = list(programs)
    live = [i for i, p in enumerate(programs) if inspect.isgenerator(p)]
    prev = current_slice_label()
    try:
        while live:
            for i in list(live):
                if labels:
                    _CURRENT.label = labels[i]
                try:
                    next(programs[i])
                except StopIteration as stop:
                    results[i] = stop.value
                    live.remove(i)
    finally:
        _CURRENT.label = prev
    return results


def _split_spec(spec) -> bool:
    if isinstance(spec, NamedSharding):
        spec = spec.spec
    if spec is None or len(spec) == 0:
        return False
    if spec[0] != "data":
        raise ValueError(f"the port's mesh functions split the data axis only, got {spec}")
    return True


def _gather_out(parts: list, spec, dev: torch.device):
    """Concatenate per-slice outputs shaped like ``spec`` (a dict, tuple or
    one spec) in slice order on ``dev``."""
    if isinstance(spec, dict):
        return {k: _gather_out([p[k] for p in parts], spec[k], dev) for k in spec}
    if isinstance(spec, (list, tuple)) and not isinstance(spec, PartitionSpec):
        return tuple(_gather_out([p[i] for p in parts], s, dev) for i, s in enumerate(spec))
    if parts[0] is None:
        return None
    if not _split_spec(spec) or len(parts) == 1:
        return parts[0]
    return torch.cat([p.to(dev, non_blocking=True) for p in parts])


def shard_map_compat(f, mesh: Mesh, in_specs, out_specs):
    """``f`` (the single-card function) run once per data slice.

    Each argument whose spec splits the data axis is split on its leading
    axis (which must divide the data-axis size), a slice's rows moved to
    the slice's device; ``P()`` arguments go whole to every slice
    (tensors copied once per device, other values as they are); a
    :class:`Placed` argument hands each slice its own shard. ``f`` may be
    a generator function (see :func:`lockstep`). The outputs, shaped like
    ``out_specs``, are concatenated in slice order on the first slice's
    device. No collective runs: each slice computes exactly what one card
    computes alone on those rows.
    """
    slices = mesh.data_slices()
    labels = [s.label for s in slices]

    def run(*args):
        if len(args) != len(in_specs):
            raise TypeError(f"{len(args)} arguments for {len(in_specs)} specs")
        per_arg = []
        for a, spec in zip(args, in_specs):
            if isinstance(a, Placed):
                per_arg.append(a.shards)
            elif isinstance(a, (torch.Tensor, np.ndarray)):
                per_arg.append(_place(mesh, a, _split_spec(spec)).shards)
            else:
                per_arg.append([a] * len(slices))
        mark_mesh_slices(mesh)
        programs = []
        prev = current_slice_label()
        try:
            for i, lbl in enumerate(labels):
                _CURRENT.label = lbl
                programs.append(f(*(shards[i] for shards in per_arg)))
        finally:
            _CURRENT.label = prev
        parts = lockstep(programs, labels)
        return _gather_out(parts, out_specs, slices[0].device)

    return run


# --- degradation and the graph's plan ---------------------------------------------


def degrade_mesh(mesh: Mesh) -> Mesh | None:
    """The surviving mesh after one data slice is lost, or ``None`` when
    the data axis cannot shrink (already 1; the caller re-raises and the
    run dies honestly).

    The new data axis is the largest power of two <= (n_data - 1), over
    the FIRST surviving slices of the old mesh: power of two keeps the
    pipeline's batch divisibility intact, so the re-dispatched node runs
    the single-card program per slice, on fewer slices. Other axes are
    kept. The lost slices' gauges drop to 0, the survivors' read 1, and
    the installed degrade hook (its errors swallowed) gets the lost
    slices.
    """
    axes = mesh.shape
    n_data = axes.get("data", 1)
    if n_data <= 1:
        return None
    new_n = 1
    while new_n * 2 <= n_data - 1:
        new_n *= 2
    axes["data"] = new_n
    names = tuple(axes)
    sizes = tuple(axes[n] for n in names)
    flat = list(mesh.devices.flat)
    survivors = flat[: int(np.prod(sizes))]
    lost = flat[len(survivors):]
    grid = np.empty(len(survivors), dtype=object)
    for i, s in enumerate(survivors):
        grid[i] = s
    new_mesh = Mesh(names, grid.reshape(sizes))
    if obs_metrics.armed():
        for s in lost:
            obs_metrics.mesh_slice_set(s.label, 0.0)
    mark_mesh_slices(new_mesh)
    hook = jobscope.get("degrade_hook")
    if hook is None:
        hook = getattr(_TLS, "degrade_hook", None)
    if hook is not None:
        try:
            hook(lost)
        except Exception:
            pass  # quarantine bookkeeping must never fail the degrade path
    return new_mesh


def node_sharding_plan(spec, mesh: Mesh) -> dict[str, dict]:
    """Per-node paired in/out shardings from the graph's declared
    ``Edge.sharding`` specs: for every node, each hbm edge with a declared
    sharding maps to its leading mesh axis. Producer out specs equal
    consumer in specs by construction of the graph (graftcheck's
    reshard-site lint is the executor's hard gate), so stage boundaries
    never reshard. Returns ``{node: {"in": {edge: axis}, "out": {edge:
    axis}}}`` for the nodes touching at least one declared edge."""
    plan: dict[str, dict] = {}
    for node in spec.schedule:
        ins = {
            e: spec.edges[e].sharding for e in node.inputs
            if e in spec.edges and spec.edges[e].placement == "hbm"
            and spec.edges[e].sharding is not None
        }
        outs = {
            e: spec.edges[e].sharding for e in node.outputs
            if e in spec.edges and spec.edges[e].placement == "hbm"
            and spec.edges[e].sharding is not None
        }
        if ins or outs:
            plan[node.name] = {"in": ins, "out": outs}
    return plan


# --- the polisher's training layout -------------------------------------------------


def _model_split_axis(path: str, ndim: int) -> int | None:
    """The axis of a Flax polisher leaf (``path`` like ``embed/kernel``)
    split over ``model``: the embed kernel's output axis (column-parallel),
    the head kernel's input axis (row-parallel: its 10 outputs do not
    divide); None for every other leaf (replicated)."""
    if ndim == 2 and path.endswith("kernel"):
        if "embed" in path:
            return 1
        if "head" in path:
            return 0
    return None


def polisher_param_sharding(mesh: Mesh, params) -> dict:
    """The polisher's tensor-parallel layout: per leaf of a Flax params tree
    a :class:`NamedSharding`, ``P(None, "model")`` for the embed kernel,
    ``P("model", None)`` for the head kernel, ``P()`` for the rest (and for
    every leaf when the mesh has no ``model`` axis): the JAX package's
    specs, leaf for leaf."""
    has_model = "model" in mesh.axis_names

    def spec_for(path: str, leaf):
        axis = _model_split_axis(path, np.ndim(leaf)) if has_model else None
        if axis is None:
            return NamedSharding(mesh, P())
        return NamedSharding(mesh, P(*("model" if d == axis else None for d in range(2))))

    def walk(tree, prefix):
        return {k: walk(v, f"{prefix}{k}/") if isinstance(v, dict) else spec_for(prefix + k, v)
                for k, v in tree.items()}

    return walk(params, "")


@dataclasses.dataclass
class GridPlaced:
    """One array placed on every slice of the mesh's grid (data x model, in
    grid order): each slice's own piece, the rows of its data index
    (``data_axis``) and the part of its model index (``model_axis``), or
    the whole array. Every piece is a tensor of its own, as each slice of
    a multi-card mesh holds its own copy."""

    pieces: list[torch.Tensor]
    mesh: Mesh
    data_axis: int | None
    model_axis: int | None

    def gather(self) -> torch.Tensor:
        """The whole array on the first slice's device."""
        shape = self.mesh.devices.shape
        names = self.mesh.axis_names
        dev = self.pieces[0].device
        grid = np.empty(len(self.pieces), dtype=object)
        for i, p in enumerate(self.pieces):
            grid[i] = p
        grid = grid.reshape(shape)
        # one piece per data index and model index (the others are copies)
        d_n = shape[names.index("data")] if "data" in names else 1
        m_n = shape[names.index("model")] if "model" in names else 1

        def piece(d, m):
            idx = [0] * len(shape)
            if "data" in names:
                idx[names.index("data")] = d
            if "model" in names:
                idx[names.index("model")] = m
            return grid[tuple(idx)].to(dev)

        rows = []
        for d in range(d_n if self.data_axis is not None else 1):
            parts = [piece(d, m) for m in range(m_n if self.model_axis is not None else 1)]
            rows.append(torch.cat(parts, dim=self.model_axis) if len(parts) > 1 else parts[0])
        return torch.cat(rows, dim=self.data_axis) if len(rows) > 1 else rows[0]


def _grid_place(mesh: Mesh, t: torch.Tensor, data_axis: int | None,
                model_axis: int | None) -> GridPlaced:
    """``t``'s piece on every slice of the grid (see :class:`GridPlaced`)."""
    names = mesh.axis_names
    shape = mesh.devices.shape
    d_n = shape[names.index("data")] if "data" in names else 1
    m_n = shape[names.index("model")] if "model" in names else 1
    for axis, n in ((data_axis, d_n), (model_axis, m_n)):
        if axis is not None and t.shape[axis] % n:
            raise ValueError(f"dim {axis} ({t.shape[axis]}) does not divide the mesh axis {n}")
    pieces = []
    for pos in np.ndindex(*shape):
        part = t
        if data_axis is not None and "data" in names:
            d, n = pos[names.index("data")], d_n
            part = part.narrow(data_axis, d * t.shape[data_axis] // n, t.shape[data_axis] // n)
        if model_axis is not None and "model" in names:
            m, n = pos[names.index("model")], m_n
            part = part.narrow(model_axis, m * t.shape[model_axis] // n,
                               t.shape[model_axis] // n)
        slice_dev = mesh.devices[pos].device
        pieces.append(part.detach().to(slice_dev, copy=True).contiguous())
    return GridPlaced(pieces, mesh, data_axis, model_axis)


def _grid_bytes(placed) -> int:
    return sum(p.numel() * p.element_size() for p in placed.pieces)


def _tree_map(fn, tree, prefix=""):
    """``fn(path, leaf)`` over a nested dict, paths like ``embed/kernel``."""
    return {k: _tree_map(fn, v, f"{prefix}{k}/") if isinstance(v, dict) else fn(prefix + k, v)
            for k, v in tree.items()}


def sharded_train_step(mesh: Mesh, optimizer):
    """The polisher's train step over ``mesh``: the batch split over
    ``data``, the dense kernels over ``model`` (:func:`polisher_param_sharding`).
    Returns (step_fn, place_params, place_batch):

    - ``place_params(params)``: every leaf of a Flax params tree (numpy or
      tensors) placed on every slice of the grid, a tree of
      :class:`GridPlaced`;
    - ``place_batch(feats, labels, ins_labels, mask)``: each array's rows
      of every data index on the slices of that index;
    - ``step_fn(model, placed_params, *placed_batch) -> (placed_params,
      loss)``: the pieces gathered on the first slice into ``model``'s
      parameters (which ``optimizer`` steps), one step of
      ``models.polisher.make_train_step(optimizer)`` on the whole batch,
      and the updated tree placed again.

    Both placements charge the bytes every slice receives to
    ``transfer.h2d``, one piece a slice, as the JAX package charges its
    devices' shards. The update is the unsharded step's: no collective
    runs, the pieces only move. On one card every slice is that card.
    """
    from ont_tcrconsensus_tpu_torch import convert
    from ont_tcrconsensus_tpu_torch.models import polisher as polisher_mod

    base_step = polisher_mod.make_train_step(optimizer)
    has_model = "model" in mesh.axis_names

    def place_tree(params):
        def leaf(path, a):
            t = _as_tensor(a) if not isinstance(a, torch.Tensor) else a
            axis = _model_split_axis(path, t.dim()) if has_model else None
            return _grid_place(mesh, t, None, axis)

        return _tree_map(leaf, params)

    def place_params(params):
        placed = place_tree(params)
        leaves = []
        _tree_map(lambda _, p: leaves.append(p), placed)
        obs_transfers.h2d("transfer.h2d", None, nbytes=sum(_grid_bytes(p) for p in leaves))
        return placed

    def place_batch(feats, labels, ins_labels, mask):
        placed = tuple(_grid_place(mesh, _as_tensor(a), 0, None)
                       for a in (feats, labels, ins_labels, mask))
        obs_transfers.h2d("transfer.h2d", None, nbytes=sum(_grid_bytes(p) for p in placed))
        return placed

    def step_fn(model, placed_params, feats, labels, ins_labels, mask):
        mark_mesh_slices(mesh)
        state = convert.state_from_tree(_tree_map(lambda _, p: p.gather(), placed_params))
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(state[name])
        loss = base_step(model, *(a.gather() for a in (feats, labels, ins_labels, mask)))
        return place_tree(convert.tree_from_state(model.state_dict())), loss

    return step_fn, place_params, place_batch
