"""The port's batched engine (``parallel.batch``, ``cuda_resize.stitch_batch``)
on the CPU, where the batched kernel's wrapper runs its plain version,
against the JAX package's ``parallel.batch.stitch_batch`` (the Pallas kernel
in interpret mode, and the XLA engine) and the float64 oracle.

Every job of a batch gets its own numpy data (``default_rng``), fed to both
packages, each on its own plan of the job (the port's layout types and the
JAX package's, solved from the same specs).  Tolerance: 1 uint8 step against the JAX engines and the oracle
(f32 gathers against the JAX kernel's matmul order and the oracle's f64);
identity-copy slots are exact; a batch of one equals the single-job path bit
for bit, because both run the same placement loop and arithmetic.
"""

import numpy as np
import pytest
import torch

from imagestitching_tpu import config as jax_config
from imagestitching_tpu.core import layout as jax_layout
from imagestitching_tpu.core import oracle
from imagestitching_tpu.parallel import batch as jax_batch
from imagestitching_tpu_torch import StitchOptions
from imagestitching_tpu_torch.core import geometry
from imagestitching_tpu_torch.core.layout import ImageSpec, solve
from imagestitching_tpu_torch.ops import cuda_resize
from imagestitching_tpu_torch.parallel import batch
from imagestitching_tpu_torch.parallel.mesh import make_mesh

# name: ([(raw w, raw h, orientation)], options, channels)
_CASES = {
    "mixed": ([(48, 32, 1), (32, 40, 1)], dict(gap=3), 3),
    "orient6-min": ([(48, 32, 6), (32, 48, 1)], dict(mode="min"), 3),
    "horizontal-frac": ([(40, 30, 3), (50, 28, 8), (36, 36, 1)],
                        dict(direction="horizontal", gap=2.5), 3),
    "triangle-down": ([(90, 70, 6), (30, 20, 1)],
                      dict(direction="horizontal", filter="triangle"), 3),
    "gray": ([(50, 40, 1), (30, 35, 8)], dict(direction="horizontal"), 1),
    # min mode: the 4x4 image's rounded draw height is 0 (an empty span)
    "empty-span": ([(33, 4, 1), (4, 4, 1)], dict(mode="min"), 3),
}
_B = 3


def _jax_plan(shapes, **kw):
    """The JAX package's plan of the same job, from its own types."""
    return jax_layout.solve(
        [jax_layout.ImageSpec(w, h, o) for w, h, o in shapes],
        jax_config.StitchOptions(supersample=False, **kw))


def _case(name, b=_B):
    shapes, kw, c = _CASES[name]
    plan = solve([ImageSpec(w, h, o) for w, h, o in shapes],
                 StitchOptions(supersample=False, **kw))
    rng = np.random.default_rng(sum(map(ord, name)))
    stacks = [rng.integers(0, 256, (b, h, w, c), np.uint8)
              for w, h, _ in shapes]
    return plan, stacks


def _maxdiff(a, b):
    assert a.shape == b.shape, (a.shape, b.shape)
    return int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())


def _oracle(plan, stacks):
    return np.stack([oracle.stitch(plan, [s[j] for s in stacks])
                     for j in range(stacks[0].shape[0])])


@pytest.mark.parametrize("name", sorted(_CASES))
def test_batched_matches_jax_engines_and_oracle(name):
    plan, stacks = _case(name)
    shapes, kw, _ = _CASES[name]
    jplan = _jax_plan(shapes, **kw)
    got = batch.stitch_batch(plan, stacks, device="cpu")
    c = stacks[0].shape[3]
    assert got.shape == (_B, plan.canvas_h, plan.canvas_w, c)
    assert got.dtype == np.uint8
    want = _oracle(jplan, stacks)
    assert _maxdiff(got, want) <= 1
    # the jobs really differ: no job's canvas leaked into another's
    assert not np.array_equal(got[0], got[1])
    for engine, ekw in (("pallas", dict(interpret=True)), ("xla", {})):
        ref = np.asarray(jax_batch.stitch_batch(jplan, stacks, engine=engine,
                                                **ekw))
        assert _maxdiff(got, ref) <= 1, engine
    for p in plan.placements:
        if geometry.placement_copy_offsets(p, plan.filter) is None:
            continue
        (r0, r1), (c0, c1) = p.row_span, p.col_span
        np.testing.assert_array_equal(got[:, r0:r1, c0:c1],
                                      want[:, r0:r1, c0:c1])
    if name == "empty-span":
        assert any(p.row_span[0] == p.row_span[1] for p in plan.placements)


@pytest.mark.parametrize("o", range(1, 9))
def test_batched_orientations_match_oracle(o):
    plan = solve([ImageSpec(37, 23, o), ImageSpec(45, 29)],
                 StitchOptions(mode="max", gap=2.5, supersample=False))
    rng = np.random.default_rng(40 + o)
    stacks = [rng.integers(0, 256, (2, 23, 37, 3), np.uint8),
              rng.integers(0, 256, (2, 29, 45, 3), np.uint8)]
    got = batch.BatchedStitch(plan, 2, device="cpu")(stacks)
    jplan = _jax_plan([(37, 23, o), (45, 29, 1)], mode="max", gap=2.5)
    assert _maxdiff(got, _oracle(jplan, stacks)) <= 1


@pytest.mark.parametrize("name", ["mixed", "orient6-min", "gray",
                                  "empty-span"])
def test_batch_of_one_equals_single_job_path(name):
    plan, stacks = _case(name, b=1)
    got = batch.BatchedStitch(plan, 1, stacks[0].shape[3],
                              device="cpu")(stacks)
    single = cuda_resize.stitch(plan, [s[0] for s in stacks], "cpu")
    np.testing.assert_array_equal(got[0], single.numpy())


@pytest.mark.parametrize("name", ["mixed", "horizontal-frac", "gray"])
def test_torch_engine_equals_auto_engine(name):
    """The plain whole-job engine (every placement resampled, the twin of
    ``_batched_xla``) gives the same bits as the kernel engine's plain path:
    identity taps resample to an exact copy."""
    plan, stacks = _case(name)
    auto = batch.stitch_batch(plan, stacks, engine="auto", device="cpu")
    plain = batch.stitch_batch(plan, stacks, engine="torch", device="cpu")
    np.testing.assert_array_equal(auto, plain)


def test_batched_validates_shapes():
    plan = solve([ImageSpec(16, 16)], StitchOptions(supersample=False))
    rng = np.random.default_rng(3)
    b = batch.BatchedStitch(plan, batch_size=2, device="cpu")
    with pytest.raises(ValueError, match="B=2"):
        b([rng.integers(0, 256, (3, 16, 16, 3), np.uint8)])   # wrong batch
    with pytest.raises(ValueError, match="plan says"):
        b([rng.integers(0, 256, (2, 8, 16, 3), np.uint8)])    # wrong dims
    with pytest.raises(ValueError, match="uint8"):
        b([np.zeros((2, 16, 16, 3), np.float32)])
    with pytest.raises(ValueError, match="slot count"):
        b([np.zeros((2, 16, 16, 3), np.uint8)] * 2)
    with pytest.raises(ValueError, match="H, W, C"):
        b([np.zeros((2, 16, 16), np.uint8)])                  # not BHWC


def test_batched_rejects_mixed_channels():
    plan = solve([ImageSpec(16, 16), ImageSpec(16, 8)],
                 StitchOptions(supersample=False))
    with pytest.raises(ValueError, match="channels"):
        batch.stitch_batch(plan, [np.zeros((2, 16, 16, 3), np.uint8),
                                  np.zeros((2, 8, 16, 1), np.uint8)],
                           device="cpu")


@pytest.mark.parametrize("jobs", [_B, 1], ids=["full", "padded"])
@pytest.mark.parametrize("name", sorted(_CASES))
def test_per_job_arrays_equal_the_stack(name, jobs):
    """Each slot given as its jobs' own arrays, copied into their rows on
    the device, gives the canvases of the same jobs stacked on the host;
    rows past the jobs are zero jobs, as a stack padded with zeros."""
    plan, stacks = _case(name)
    for s in stacks:
        s[jobs:] = 0
    bs = batch.BatchedStitch(plan, _B, stacks[0].shape[3], device="cpu")
    got = bs([list(s[:jobs]) for s in stacks])
    np.testing.assert_array_equal(got, bs(stacks))


def _per_job_slots(bad):
    plan = solve([ImageSpec(16, 16), ImageSpec(16, 8)],
                 StitchOptions(supersample=False))
    a, b = np.zeros((16, 16, 3), np.uint8), np.zeros((8, 16, 3), np.uint8)
    slots = {
        "too-many-jobs": [[a, a, a], [b, b, b]],
        "stack-too-many-jobs": [np.stack([a, a, a]), np.stack([b, b, b])],
        "uneven-jobs": [[a, a], [b]],
        "wrong-dims": [[a, a], [a, a]],
        "not-hwc": [[a, a[..., 0]], [b, b]],
        "float": [[a, a.astype(np.float32)], [b, b]],
        "channels": [[a, a], [b, b[..., :1]]],
    }[bad]
    return plan, slots


@pytest.mark.parametrize("bad,match", [
    ("too-many-jobs", "B=2"), ("stack-too-many-jobs", "B=2"),
    ("uneven-jobs", "jobs"), ("wrong-dims", "plan says"),
    ("not-hwc", "H, W, C"), ("float", "uint8"), ("channels", "channels"),
])
def test_batched_validates_per_job_arrays(bad, match):
    plan, slots = _per_job_slots(bad)
    with pytest.raises(ValueError, match=match):
        batch.BatchedStitch(plan, 2, device="cpu")(slots)


@pytest.mark.parametrize("kw,exc", [
    (dict(engine="pallas"), ValueError),
    (dict(engine="cuda", device="cpu"), ValueError),
    # a batch of 2 over a jobs axis of 4: not divisible
    (dict(mesh=make_mesh(devices=["cpu"] * 4)), ValueError),
])
def test_batched_stitch_arguments(kw, exc):
    plan = solve([ImageSpec(16, 16)], StitchOptions(supersample=False))
    args = dict(batch_size=2, device="cpu")
    args.update(kw)
    with pytest.raises(exc):
        batch.BatchedStitch(plan, **args)


def test_cuda_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    plan = solve([ImageSpec(16, 16)], StitchOptions(supersample=False))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        batch.BatchedStitch(plan, 2, device="cuda")


@pytest.mark.parametrize("mesh", [None, 4], ids=["one-device", "jobs-mesh"])
def test_short_stack_pads_with_zero_jobs(mesh):
    """A ``(b, H, W, C)`` stack of fewer than B rows is accepted: its rows
    are the jobs, and the rows past them zero jobs, as in the same stack
    padded with zeros (on a jobs mesh, the last shards hold no job)."""
    plan, stacks = _case("mixed", b=8)
    kw = dict(device="cpu") if mesh is None else dict(
        mesh=make_mesh(devices=["cpu"] * mesh))
    bs = batch.BatchedStitch(plan, 8, **kw)
    got = bs([s[:3] for s in stacks])
    for s in stacks:
        s[3:] = 0
    np.testing.assert_array_equal(got, bs(stacks))


def test_warm_runs_a_zero_batch():
    plan, _ = _case("mixed")
    bs = batch.BatchedStitch(plan, 4, device="cpu")
    bs.warm()
    cpu = torch.device("cpu")
    assert bs._steps == {cpu: cuda_resize.plan_steps(plan, cpu)}
    assert bs._steps[cpu] is cuda_resize.plan_steps(plan, cpu)


def _wrapper_operands(b=3, c=3):
    rng = np.random.default_rng(9)
    src = torch.from_numpy(rng.integers(0, 256, (b, 20, 30, c), np.uint8))
    ri0, rw = geometry.filter_taps(0, 10, 0.0, 10.0, 20)
    ci0, cw = geometry.filter_taps(0, 12, 0.0, 12.0, 30)
    taps = [torch.from_numpy(ri0), torch.from_numpy(rw.astype(np.float32)),
            torch.from_numpy(ci0), torch.from_numpy(cw.astype(np.float32))]
    return src, taps, torch.zeros((b, 16, 20, c), dtype=torch.uint8)


def test_batch_wrapper_on_cpu_runs_plain_version_without_launching():
    src, taps, canvas = _wrapper_operands()
    before = (cuda_resize.launches, cuda_resize.batch_launches)
    cuda_resize.resize_place_batch(src, 6, *taps, canvas, 3, 5)
    assert (cuda_resize.launches, cuda_resize.batch_launches) == before
    for j in range(3):
        want = cuda_resize.resize_place_ref(src[j], 6, *taps)
        assert torch.equal(canvas[j, 3:13, 5:17], want)
    assert int(canvas[:, :3].sum()) == 0 and int(canvas[:, :, :5].sum()) == 0


@pytest.mark.parametrize("bad", ["hwc-src", "batch-mismatch", "empty-batch",
                                 "batch-over-grid", "off-canvas", "channels",
                                 "meta-device"])
def test_batch_wrapper_rejects_what_the_kernel_does_not_take(bad):
    src, taps, canvas = _wrapper_operands()
    r0 = 0
    if bad == "hwc-src":
        src = src[0]
    elif bad == "batch-mismatch":
        canvas = canvas[:2]
    elif bad in ("empty-batch", "batch-over-grid"):
        # the kernel's z grid holds 1 to MAX_BATCH jobs
        b = 0 if bad == "empty-batch" else cuda_resize.MAX_BATCH + 1
        src = src[:1].expand(b, -1, -1, -1)
        canvas = canvas[:1].expand(b, -1, -1, -1)
    elif bad == "off-canvas":
        r0 = 7
    elif bad == "channels":
        canvas = torch.zeros((3, 16, 20, 1), dtype=torch.uint8)
    else:
        src, canvas = src.to("meta"), canvas.to("meta")
        taps = [t.to("meta") for t in taps]
    with pytest.raises(ValueError):
        cuda_resize.resize_place_batch(src, 1, *taps, canvas, r0, 0)
