"""Multi-process distribution: ``torch.distributed`` over gloo, libraries
sharded by process.

The counterpart of the JAX package's ``parallel/distributed.py``:

- **library-level data parallelism across processes**: barcode libraries
  are independent, so each process owns a deterministic shard of the
  library list (:func:`shard_libraries`) and runs the whole per-library
  pipeline on its own cards (the mesh of :mod:`.mesh` splits batches
  within the process). Nothing crosses processes during a library.
- **end-of-run gather**: each process's per-library counts (and failures)
  are all-gathered (:func:`allgather_object`), so every process returns
  the complete results.

The backend is gloo: the only collectives are two barriers around the
output tree's creation and that one gather of small host objects, so
NCCL, whose collectives move card memory, buys nothing here, and gloo is
part of every torch build.

Bring-up: pass ``coordinator_address`` (``host:port``; process 0 listens
there), ``num_processes`` and ``process_id``, or set torchrun's
``MASTER_ADDR``, ``MASTER_PORT``, ``RANK`` and ``WORLD_SIZE``.
"""

from __future__ import annotations

import json
import os
import sys

_ENV_KEYS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def _dist():
    import torch.distributed as dist

    return dist


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               required: bool = False) -> None:
    """Bring up the gloo process group (idempotent).

    No-op when already initialized. ``required=True`` (what
    ``RunConfig.distributed`` requests) re-raises any bring-up failure:
    degrading an intended multi-process run to N independent
    single-process runs would race every process over the same output
    tree. Without ``required``, a failed bring-up (a plain single-process
    run with nothing to find) is a stderr note; an explicit
    ``num_processes`` > 1 always re-raises.
    """
    dist = _dist()
    if dist.is_initialized():
        return
    try:
        if coordinator_address is not None:
            if num_processes is None or process_id is None:
                raise ValueError("a coordinator address needs num_processes and process_id")
            dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                                    world_size=num_processes, rank=process_id)
        else:
            missing = [k for k in _ENV_KEYS if not os.environ.get(k)]
            if missing:
                raise ValueError(f"no coordinator: pass an address or set {missing}")
            dist.init_process_group("gloo", init_method="env://")
    except (ValueError, RuntimeError) as exc:
        if required or num_processes not in (None, 1):
            raise
        print(f"torch.distributed not started ({exc}); continuing single-process",
              file=sys.stderr)


def process_index() -> int:
    dist = _dist()
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    dist = _dist()
    return dist.get_world_size() if dist.is_initialized() else 1


def shard_libraries(paths: list[str], index: int | None = None,
                    count: int | None = None) -> list[str]:
    """The library shard owned by this process: round-robin over the
    *sorted* list, so every process derives the same partition without
    communicating."""
    index = process_index() if index is None else index
    count = process_count() if count is None else count
    if count <= 1:
        return list(paths)
    return [p for i, p in enumerate(sorted(paths)) if i % count == index]


def barrier(name: str = "barrier") -> None:
    """Block until every process arrives (no-op single-process); ``name``
    labels the call site, as in the JAX package."""
    if process_count() > 1:
        _dist().barrier()


def allgather_object(obj) -> list:
    """All-gather one JSON-serializable object per process, in process
    order: JSON text in, parsed JSON out (so every process sees the same
    normalized values, as in the JAX package)."""
    if process_count() <= 1:
        return [obj]
    out: list = [None] * process_count()
    _dist().all_gather_object(out, json.dumps(obj, sort_keys=True))
    return [json.loads(p) for p in out]


def merge_results(local: dict[str, dict[str, int]]) -> dict[str, dict[str, int]]:
    """Union of every process's {library: {region: count}} results."""
    merged: dict[str, dict[str, int]] = {}
    for part in allgather_object(local):
        merged.update(part)
    return merged
