"""Runtime configuration of the PyTorch port.

Port of ``imagestitching_tpu/config.py:159-203`` (``RuntimeConfig``) and of
``MemoryBudget.from_device`` (:74-103).  The user-facing options and the
limits are shared with the JAX package by import: ``StitchOptions``,
``CanvasLimits`` and ``MemoryBudget`` are the layout contract.

The port's ``RuntimeConfig`` carries only what the port implements.  The
JAX package's ``interpret``, ``profile``, ``overlap`` and ``mesh`` arrive
with the slices that implement them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from imagestitching_tpu.config import CanvasLimits, MemoryBudget, StitchOptions

__all__ = ["CanvasLimits", "ENGINES", "MemoryBudget", "RuntimeConfig",
           "StitchOptions", "budget_from_device"]

#: ``auto`` -- the resize-and-place engine: the CUDA kernel on a CUDA
#: device, its plain PyTorch version on the CPU; ``cuda`` -- the same, but
#: only on a CUDA device; ``torch`` -- the plain whole-job engine
#: (``ops.torch_compose``), the cross-check, on either device; ``oracle``
#: -- the float64 NumPy oracle on the host.
ENGINES = ("auto", "cuda", "torch", "oracle")


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Engine and runtime knobs of the port."""

    engine: str = "auto"
    device: str = "cuda"               # torch device: cuda, cuda:N or cpu
    # Default canvas caps for entry points without an explicit ``limits=``.
    limits: CanvasLimits = dataclasses.field(default_factory=CanvasLimits)
    budget: MemoryBudget = dataclasses.field(default_factory=MemoryBudget)
    decode_threads: int = 8            # host codec pool
    # Per-image decode watchdog; None disables it.
    decode_timeout_s: Optional[float] = 30.0

    def validate(self) -> "RuntimeConfig":
        if self.engine not in ENGINES:
            raise ValueError(f"unknown engine {self.engine!r}; "
                             f"one of {ENGINES}")
        kind = str(self.device).split(":", 1)[0]
        if kind not in ("cuda", "cpu"):
            raise ValueError(f"device must be cuda[:N] or cpu, "
                             f"got {self.device!r}")
        if self.engine == "cuda" and kind != "cuda":
            raise ValueError("engine='cuda' launches the CUDA kernel and "
                             "needs a CUDA device")
        if self.decode_timeout_s is not None and self.decode_timeout_s <= 0:
            raise ValueError("decode_timeout_s must be positive or None, "
                             f"got {self.decode_timeout_s}")
        return self


def budget_from_device(device: str = "cuda") -> MemoryBudget:
    """A ``MemoryBudget`` of 0.6 of the card's total memory (twin of
    ``MemoryBudget.from_device``'s default), from
    ``torch.cuda.mem_get_info``."""
    import torch

    _, total = torch.cuda.mem_get_info(torch.device(device))
    return MemoryBudget(hbm_bytes=int(total * 0.6))
