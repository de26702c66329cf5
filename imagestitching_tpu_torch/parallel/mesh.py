"""Device meshes of the port.

Port of ``imagestitching_tpu/parallel/mesh.py``.  Stitch jobs are
independent, so the mesh has two named axes:

* ``jobs``  -- data parallelism over concurrent stitch jobs (serving): each
  jobs row runs its share of a batch (:class:`..parallel.batch.BatchedStitch`);
* ``space`` -- one job's canvas split into row bands, one per space index
  (:class:`..parallel.sharding.ShardedStitch`).

A :class:`DeviceMesh` is a numpy object array of ``torch.device`` with named
axes.  There is no ``jax.sharding``, no SPMD partitioner and no
``torch.distributed``: neither path has a collective, so each shard's work is
enqueued on its device from this process and the results come back as host
copies, as the JAX package gathers them.  A mesh may name one device several
times (``["cpu"] * 8`` in the CPU tests, ``["cuda:0"] * 4`` on a one-card
host): its shards then run one after another on that device.

``job_sharding`` and ``row_sharding`` are the twins of the JAX helpers of the
same names: where the JAX ones return a ``NamedSharding`` for XLA to place
data, these return which device holds which slice of the batch or of the
canvas rows; ``replicated`` returns the distinct devices that hold a copy.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

AXES = ("jobs", "space")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class DeviceMesh:
    """Devices in a grid with named axes: ``devices`` is a numpy object
    array of ``torch.device``, ``shape`` maps each axis name to its size
    (``mesh.shape["jobs"]``, as on a JAX ``Mesh``)."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        if devices.ndim != len(self.axis_names):
            raise ValueError(f"{devices.ndim}-d device array for axes "
                             f"{self.axis_names}")
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              devices.shape))

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along ``axis`` at index 0 of every other axis: the
        device that runs each index of ``axis``.  A 2D mesh replicates over
        its other axis; the port runs each index once, on this device."""
        if axis not in self.shape:
            raise ValueError(f"mesh has no axis {axis!r} (axes "
                             f"{self.axis_names})")
        index = [0] * len(self.axis_names)
        out = []
        for k in range(self.shape[axis]):
            index[self.axis_names.index(axis)] = k
            out.append(self.devices[tuple(index)])
        return out


def _device(d) -> torch.device:
    try:
        dev = torch.device(d)
    except RuntimeError as e:   # an unknown device type
        raise ValueError(f"mesh devices are cpu or cuda[:N], got {d!r}") \
            from e
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"mesh devices are cpu or cuda[:N], got {d!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(f"mesh device {str(d)!r} but CUDA is not "
                           "available on this host; pass cpu devices to run "
                           "the plain PyTorch version")
    index = torch.cuda.current_device() if dev.index is None else dev.index
    if not 0 <= index < torch.cuda.device_count():
        raise ValueError(f"mesh device {str(d)!r}: this host has "
                         f"{torch.cuda.device_count()} CUDA devices")
    return torch.device("cuda", index)


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = AXES,
              devices: Optional[Sequence] = None) -> DeviceMesh:
    """A mesh over ``devices`` (default: every card, ``cuda:0..n-1``; a host
    without CUDA raises, it never falls back to the CPU).

    Default shape: every device on the ``jobs`` axis, ``(n, 1)`` for the
    axes ``("jobs", "space")``.  A device may be named more than once."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh() spans every CUDA card, but CUDA is not "
                "available on this host; pass devices=['cpu'] * n to run "
                "the plain PyTorch version")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = [_device(d) for d in devices]
    n = len(devs)
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names) or int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} does not cover {n} devices "
                         f"on axes {tuple(axis_names)}")
    arr = np.empty(n, dtype=object)
    arr[:] = devs
    return DeviceMesh(arr.reshape(shape), axis_names)


def job_sharding(mesh: DeviceMesh, batch_size: int, axis: str = "jobs"
                 ) -> List[Tuple[torch.device, Tuple[int, int]]]:
    """``(device, (lo, hi))`` per index of ``axis``: jobs ``[lo, hi)`` of a
    batch run on ``device``.  The batch must divide evenly."""
    devs = mesh.axis_devices(axis)
    if batch_size % len(devs) != 0:
        raise ValueError(
            f"a batch under a mesh needs batch_size ({batch_size}) divisible "
            f"by the {axis} axis ({len(devs)}); pad the batch "
            "(serve.server rounds to jobs multiples)")
    b = batch_size // len(devs)
    return [(d, (k * b, (k + 1) * b)) for k, d in enumerate(devs)]


def row_sharding(mesh: DeviceMesh, canvas_h: int, axis: str = "space"
                 ) -> List[Tuple[torch.device, Tuple[int, int]]]:
    """``(device, (lo, hi))`` per index of ``axis``: canvas rows
    ``[lo, hi)`` compose on ``device``.  Bands are ``cdiv(canvas_h, n)``
    rows; a trailing band may be short or empty (``lo == hi``)."""
    devs = mesh.axis_devices(axis)
    band = _cdiv(canvas_h, len(devs))
    return [(d, (min(k * band, canvas_h), min((k + 1) * band, canvas_h)))
            for k, d in enumerate(devs)]


def replicated(mesh: DeviceMesh, axis: Optional[str] = None
               ) -> List[torch.device]:
    """The distinct devices of ``mesh`` (of ``axis`` only, when given), in
    mesh order: where a replicated value (a source of the space-sharded
    compose) is held, once on each."""
    devs = mesh.devices.flat if axis is None else mesh.axis_devices(axis)
    out: List[torch.device] = []
    for d in devs:
        if d not in out:
            out.append(d)
    return out
