"""Shared arithmetic of the stage readers: a layer's StageTimer seconds
summed over the window's lanes, per lane. Each stage reader names its own
stages (``STAGES``); :func:`declared` gathers them from every reader in
this folder."""

import importlib.util
import os


def per_lane(ctx: dict, stages):
    if not ctx["lanes"] or not any(n in t for t in ctx["timings"] for n in stages):
        return None
    return sum(t.get(n, 0.0) for t in ctx["timings"] for n in stages) / ctx["lanes"]


def declared(folder: str) -> set:
    """The union of the ``STAGES`` that the readers in ``folder`` declare."""
    stages = set()
    for fname in sorted(os.listdir(folder)):
        if fname.endswith(".py") and not fname.startswith("_"):
            spec = importlib.util.spec_from_file_location(
                "tcrbench_stages_" + fname[:-3].replace(".", "_"), os.path.join(folder, fname))
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            stages |= set(getattr(mod, "STAGES", ()))
    return stages
