"""A configuration file read as the port's settings and as the
reference's.

``shapes`` are ``[raw_w, raw_h, orientation]`` per image; ``options`` the
port's ``StitchOptions`` fields; ``runtime`` the ``RuntimeConfig`` fields
besides ``device`` and ``engine``, where ``budget`` is ``"default"`` (the
port's 2 GB ``MemoryBudget``), ``"from_device"`` (``budget_from_device``:
0.6 of the card), a whole number of device bytes (``hbm_bytes``) or an
object of ``MemoryBudget`` fields; ``server`` the ``StitchServer`` keyword
arguments besides ``config``.  A CPU rehearsal divides every side by the
workload's ``rehearsal.scale`` and runs the port's plain engine
(``engine="torch"``) on the CPU.
"""

from __future__ import annotations

from typing import List, Tuple

from .reference import layout as ref_layout


def shapes(config: dict, scale: int = 1) -> List[Tuple[int, int, int]]:
    return [(max(1, w // scale), max(1, h // scale), o)
            for w, h, o in config["shapes"]]


def options(config: dict):
    from imagestitching_tpu_torch import StitchOptions

    return StitchOptions(**config["options"])


def runtime(config: dict, device: str, rehearsal: bool):
    from imagestitching_tpu_torch import RuntimeConfig
    from imagestitching_tpu_torch.config import (MemoryBudget,
                                                 budget_from_device)

    fields = dict(config.get("runtime", {}))
    budget = fields.pop("budget", "default")
    if budget == "from_device":
        budget = budget_from_device(device)
    elif budget == "default":
        budget = MemoryBudget()
    elif isinstance(budget, int) and not isinstance(budget, bool):
        budget = MemoryBudget(hbm_bytes=budget)
    elif isinstance(budget, dict):
        budget = MemoryBudget(**budget)
    else:
        raise ValueError(f"unknown budget {budget!r}")
    return RuntimeConfig(**fields, device=device, budget=budget,
                         engine="torch" if rehearsal else "auto")


def server(config: dict, device: str, rehearsal: bool):
    """The configuration's ``StitchServer``: its ``server`` fields as
    keyword arguments, on the configuration's runtime."""
    from imagestitching_tpu_torch import StitchServer

    kwargs = dict(config.get("server", {}))
    if rehearsal:
        kwargs["engine"] = "torch"
    return StitchServer(**kwargs,
                        config=runtime(config, device, rehearsal))


def layout(config: dict, job_shapes) -> ref_layout.Layout:
    """The frozen reference's layout of one job."""
    o = config["options"]
    return ref_layout.solve(job_shapes, o.get("direction", "vertical"),
                            o.get("mode", "min"), o.get("gap", 0.0),
                            o.get("supersample", False),
                            o.get("background", (255, 255, 255)))
