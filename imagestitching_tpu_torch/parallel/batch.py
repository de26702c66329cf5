"""Batched multi-job stitching (BASELINE config 5: 64 concurrent 9-image jobs).

Port of ``imagestitching_tpu/parallel/batch.py``.  Jobs sharing a layout
signature stack into ``(B, H_i, W_i, C)`` tensors per image slot and run
through one placement loop (``ops.cuda_resize.stitch_batch``):

* ``engine="auto"`` -- the batched CUDA kernel on a CUDA device (one launch
  per resampled placement for the whole batch, taps shared by the batch), its
  plain PyTorch version on the CPU; the twin of ``_batched_pallas``;
* ``engine="cuda"`` -- the same, on a CUDA device only;
* ``engine="torch"`` -- the plain whole-job engine on either device, every
  drawn placement resampled; the twin of ``_batched_xla``.

PyTorch runs eagerly, so there is nothing to compile per batch size: the
JAX class's ``jax.jit``, ``ensure_compile_cache`` and
``check_plan_feasible`` (the gather kernel has no ``Infeasible``) have no
twin.  A jobs mesh (the shard_map branch) arrives with the multi-GPU slice.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..core.layout import LayoutPlan
from ..ops import cuda_resize
from ..runtime.pipeline import resolve_device

ENGINES = ("auto", "cuda", "torch")


class BatchedStitch:
    """Batched stitch for one layout signature x batch size.

    Jobs with mismatched shapes must be bucketed by ``plan.signature()``
    upstream (see serve.server).  The object holds the plan's device taps,
    so a cache of these objects holds their taps too.
    """

    def __init__(self, plan: LayoutPlan, batch_size: int, channels: int = 3,
                 engine: str = "auto", device="cuda", mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "a jobs mesh (batches data-parallel over several cards) "
                "arrives with the port's multi-GPU slice")
        if engine not in ENGINES:
            raise ValueError(f"unsupported batch engine {engine!r}")
        self.device = resolve_device(device)
        if engine == "cuda" and self.device.type != "cuda":
            raise ValueError("engine='cuda' launches the CUDA kernel and "
                             "needs a CUDA device")
        self.plan = plan
        self.batch_size = batch_size
        self.channels = channels
        self.engine = engine
        self._steps = cuda_resize.plan_steps(plan, self.device)

    def _run(self, stacks: Sequence) -> torch.Tensor:
        return cuda_resize.stitch_batch(self.plan, stacks, self.device,
                                        plain=self.engine == "torch",
                                        steps=self._steps)

    def warm(self) -> None:
        """Run once on zero inputs made on the device, then fetch one
        element: no host-to-device staging of B copies of every input and
        no full-canvas readback."""
        zeros = [torch.zeros((self.batch_size, p.raw_h, p.raw_w,
                              self.channels), dtype=torch.uint8,
                             device=self.device)
                 for p in self.plan.placements]
        out = self._run(zeros)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        out[:1, :1, :1, :1].cpu()

    def __call__(self, stacked_images: Sequence[np.ndarray]) -> np.ndarray:
        """stacked_images[i]: (B, H_i, W_i, C) uint8 for image slot i;
        returns the (B, canvas_h, canvas_w, C) uint8 canvases."""
        if len(stacked_images) != len(self.plan.placements):
            raise ValueError("image-slot count does not match plan")
        for arr, p in zip(stacked_images, self.plan.placements):
            shape = tuple(arr.shape)
            if len(shape) != 4 or shape[0] != self.batch_size:
                raise ValueError(
                    f"slot {p.index}: expected (B={self.batch_size}, H, W, C),"
                    f" got {shape}")
        out = self._run(stacked_images)
        if self.device.type == "cuda":
            # a kernel fault surfaces here, inside the caller's flush
            torch.cuda.synchronize(self.device)
        return out.cpu().numpy()


def stitch_batch(plan: LayoutPlan, stacked_images: Sequence[np.ndarray],
                 engine: str = "auto", device="cuda",
                 mesh=None) -> np.ndarray:
    """One-shot :class:`BatchedStitch` over ``stacked_images``."""
    shape = tuple(stacked_images[0].shape)
    if len(shape) != 4:
        raise ValueError(f"slot 0: expected (B, H, W, C), got {shape}")
    return BatchedStitch(plan, shape[0], shape[3], engine, device,
                         mesh)(stacked_images)
