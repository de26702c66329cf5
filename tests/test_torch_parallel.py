"""The port's multi-device module (``parallel.mesh``, ``parallel.sharding``,
``BatchedStitch(mesh=)``, ``StitchServer(use_mesh=True)`` and the pipeline's
``space-sharded`` branch) on meshes of ``cpu`` devices: twins of
tests/test_parallel.py, of test_tiler_pipeline.py's sharded OOM case, of
test_grid.py's space-mesh grid and of test_server.py's mesh cases.

Every input is made with numpy from a seed and fed to both packages, each on
its own plan of the job; the JAX package runs under the 8-device CPU mesh of
tests/conftest.py.  Tolerances: within 1 uint8 step of the float64 oracle
and of the JAX package's engines (JAX's ``ShardedStitch(engine="xla")`` and,
in one small case, its Pallas sharded compose in interpret mode); equal bit
for bit to the port's own resident canvas (``engine="auto"``: on the CPU
kernel #3's wrapper runs its plain version, whose crops cover every tap, so
band seams cannot differ) and to its single-device batch; 0 on copy spans.
The JAX tests of ``Infeasible`` and of the compiled HLO have no twin: the
port has no ``Infeasible``, and the HLO check becomes a check that each jobs
shard's canvases were made on its own device, b = B / n jobs each.
"""

import jax
import numpy as np
import pytest
import torch

from imagestitching_tpu import api as jax_api
from imagestitching_tpu import config as jax_config
from imagestitching_tpu.core import layout as jax_layout
from imagestitching_tpu.core import oracle
from imagestitching_tpu.ops import pallas_resize
from imagestitching_tpu.parallel import batch as jax_batch
from imagestitching_tpu.parallel import mesh as jax_mesh
from imagestitching_tpu.parallel import sharding as jax_sharding
from imagestitching_tpu_torch import (MemoryBudget, RuntimeConfig,
                                      StitchOptions, api)
from imagestitching_tpu_torch.core import geometry
from imagestitching_tpu_torch.core.grid import plan_grid
from imagestitching_tpu_torch.core.layout import ImageSpec, solve
from imagestitching_tpu_torch.ops import cuda_resize
from imagestitching_tpu_torch.ops.window import WindowPlan
from imagestitching_tpu_torch.parallel import batch, mesh, sharding
from imagestitching_tpu_torch.parallel.sharding import ShardedStitch
from imagestitching_tpu_torch.runtime import pipeline, tiler
from imagestitching_tpu_torch.runtime.logger import get_logger
from imagestitching_tpu_torch.serve.server import StitchServer

CPU = torch.device("cpu")
rng = np.random.default_rng(31)


def cpu_mesh(shape=None, n=8):
    n = int(np.prod(shape)) if shape is not None else n
    return mesh.make_mesh(shape, devices=["cpu"] * n)


def rand(w, h, c=3):
    return rng.integers(0, 256, (h, w, c), np.uint8)


def rand_stack(b, w, h, c=3):
    return rng.integers(0, 256, (b, h, w, c), np.uint8)


def plan_for(specs, **kw):
    kw.setdefault("supersample", False)
    return solve(specs, StitchOptions(**kw))


def jax_plan_for(specs, **kw):
    kw.setdefault("supersample", False)
    return jax_layout.solve(
        [jax_layout.ImageSpec(s.raw_w, s.raw_h, s.orientation)
         for s in specs], jax_config.StitchOptions(**kw))


def maxdiff(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())


def resident(plan, imgs):
    return cuda_resize.stitch(plan, imgs, CPU).numpy()


def oracle_batch(plan, stacks):
    return np.stack([oracle.stitch(plan, [s[b] for s in stacks])
                     for b in range(stacks[0].shape[0])])


def copy_spans_max(plan, got, want):
    """Max |diff| over the copy placements' spans."""
    worst = 0
    for p in plan.placements:
        if geometry.placement_copy_offsets(p, plan.filter) is not None:
            (r0, r1), (c0, c1) = p.row_span, p.col_span
            worst = max(worst, maxdiff(got[r0:r1, c0:c1],
                                       want[r0:r1, c0:c1]))
    return worst


def check_sharded(specs, imgs, n=8, jax_engine="xla", **kw):
    """The port's sharded canvas (both engines) against its resident canvas
    (bits), the oracle and JAX's ``ShardedStitch`` (within 1)."""
    plan = plan_for(specs, **kw)
    m = cpu_mesh((1, n))
    got = ShardedStitch(plan, m)(imgs)
    res = resident(plan, imgs)
    assert np.array_equal(got, res)
    plain = ShardedStitch(plan, m, engine="torch")(imgs)
    assert np.array_equal(plain, cuda_resize.stitch(
        plan, imgs, CPU, plain=True).numpy())
    want = oracle.stitch(jax_plan_for(specs, **kw), imgs)
    assert maxdiff(got, want) <= 1 and maxdiff(plain, want) <= 1
    assert copy_spans_max(plan, got, want) == 0
    jmesh = jax_mesh.make_mesh((1, n), devices=jax.devices()[:n])
    jax_out = jax_sharding.ShardedStitch(
        jax_plan_for(specs, **kw), jmesh, engine=jax_engine,
        interpret=jax_engine == "pallas")(imgs)
    assert maxdiff(got, jax_out) <= 1
    return plan, got


# ------------------------------------------------------------------- mesh

def test_make_mesh_default():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mesh.make_mesh()
    m = cpu_mesh()
    assert m.shape == {"jobs": 8, "space": 1}
    assert dict(jax_mesh.make_mesh().shape) == m.shape


def test_make_mesh_2d():
    m = cpu_mesh((2, 4))
    assert m.shape["jobs"] == 2 and m.shape["space"] == 4
    assert dict(jax_mesh.make_mesh((2, 4)).shape) == m.shape
    with pytest.raises(ValueError, match="does not cover"):
        mesh.make_mesh((3, 2), devices=["cpu"] * 8)
    with pytest.raises(ValueError):
        jax_mesh.make_mesh((3, 2))


def test_mesh_helpers_name_devices_and_slices():
    m = cpu_mesh((2, 4))
    assert [s for _, s in mesh.job_sharding(m, 6)] == [(0, 3), (3, 6)]
    with pytest.raises(ValueError, match="divisible"):
        mesh.job_sharding(m, 5)
    # 9 rows over 4 bands of 3: the last band is empty
    assert [s for _, s in mesh.row_sharding(m, 9)] == [
        (0, 3), (3, 6), (6, 9), (9, 9)]
    assert mesh.replicated(m) == [CPU]
    assert all(d == CPU for d, _ in mesh.row_sharding(m, 9))


@pytest.mark.parametrize("devices,exc", [
    (["tpu:0"], ValueError), (["cuda:0"], RuntimeError)])
def test_make_mesh_rejects_devices(devices, exc):
    if exc is RuntimeError and torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(exc):
        mesh.make_mesh(devices=devices)


def test_runtime_config_mesh_must_be_a_device_mesh():
    RuntimeConfig(device="cpu", mesh=cpu_mesh()).validate()
    with pytest.raises(ValueError, match="DeviceMesh"):
        RuntimeConfig(device="cpu", mesh=object()).validate()


# ------------------------------------------------------------------- batch

@pytest.mark.parametrize("engine", ["torch", "auto"])
def test_batched_matches_oracle(engine):
    specs = [ImageSpec(48, 32), ImageSpec(32, 40)]
    plan = plan_for(specs, gap=3)
    stacks = [rand_stack(4, 48, 32), rand_stack(4, 32, 40)]
    got = batch.stitch_batch(plan, stacks, engine=engine, device="cpu")
    want = oracle_batch(jax_plan_for(specs, gap=3), stacks)
    assert got.shape == want.shape == (4, plan.canvas_h, plan.canvas_w, 3)
    assert maxdiff(got, want) <= 1
    jax_out = jax_batch.stitch_batch(
        jax_plan_for(specs, gap=3), stacks,
        engine="xla" if engine == "torch" else "pallas",
        interpret=engine == "auto")
    assert maxdiff(got, jax_out) <= 1


def test_batched_with_orientation():
    specs = [ImageSpec(48, 32, orientation=6), ImageSpec(32, 48)]
    plan = plan_for(specs, mode="min")
    stacks = [rand_stack(3, 48, 32), rand_stack(3, 32, 48)]
    got = batch.stitch_batch(plan, stacks, device="cpu",
                             mesh=cpu_mesh(n=3))
    assert maxdiff(got, oracle_batch(jax_plan_for(specs, mode="min"),
                                     stacks)) <= 1
    assert np.array_equal(got, batch.stitch_batch(plan, stacks,
                                                  device="cpu"))


def test_batched_sharded_over_jobs_mesh():
    specs = [ImageSpec(40, 24), ImageSpec(24, 24)]
    plan = plan_for(specs)
    stacks = [rand_stack(16, 40, 24), rand_stack(16, 24, 24)]
    got = batch.stitch_batch(plan, stacks, engine="torch", mesh=cpu_mesh())
    jplan = jax_plan_for(specs)
    assert maxdiff(got, oracle_batch(jplan, stacks)) <= 1
    jax_out = jax_batch.stitch_batch(jplan, stacks, engine="xla",
                                     mesh=jax_mesh.make_mesh())
    assert maxdiff(got, jax_out) <= 1


def test_batched_kernel_sharded_over_jobs_mesh():
    """Each jobs shard runs on its own device with B / n jobs (the twin of
    the JAX test's per-device shard shapes; the port has no HLO), and the
    gathered batch equals the single-device batch bit for bit."""
    m = cpu_mesh()
    specs = [ImageSpec(48, 32), ImageSpec(32, 40)]
    plan = plan_for(specs, gap=2)
    stacks = [rand_stack(16, 48, 32), rand_stack(16, 32, 40)]
    bs = batch.BatchedStitch(plan, 16, mesh=m)
    shards = bs.run_shards([torch.from_numpy(s) for s in stacks])
    assert len(shards) == 8
    assert [t.device for t in shards] == m.axis_devices("jobs")
    assert {tuple(t.shape) for t in shards} == {
        (2, plan.canvas_h, plan.canvas_w, 3)}
    single = batch.BatchedStitch(plan, 16, device="cpu")(stacks)
    assert np.array_equal(np.concatenate([t.numpy() for t in shards]),
                          single)
    assert np.array_equal(bs(stacks), single)
    assert maxdiff(single, oracle_batch(jax_plan_for(specs, gap=2),
                                        stacks)) <= 1


def test_batched_mesh_requires_divisible_batch():
    plan = plan_for([ImageSpec(48, 32), ImageSpec(32, 40)], gap=2)
    with pytest.raises(ValueError, match="divisible"):
        batch.BatchedStitch(plan, 12, mesh=cpu_mesh())


def test_batched_validates_shapes():
    plan = plan_for([ImageSpec(16, 16)])
    b = batch.BatchedStitch(plan, batch_size=2, engine="torch",
                            mesh=cpu_mesh(n=2))
    with pytest.raises(ValueError):
        b([rand_stack(3, 16, 16)])     # wrong batch
    with pytest.raises(ValueError):
        b([rand_stack(2, 8, 16)])      # wrong dims


@pytest.mark.parametrize("form", ["per-job", "stack"])
def test_jobs_mesh_refuses_extra_jobs_before_any_shard(form, monkeypatch):
    """B + 3 jobs for a batch of B over a jobs mesh of 4 are refused
    before any shard is enqueued: no shard's slice drops the jobs past B
    silently."""
    plan = plan_for([ImageSpec(16, 16), ImageSpec(16, 8)])
    stacks = [rand_stack(11, 16, 16), rand_stack(11, 16, 8)]
    slots = stacks if form == "stack" else [list(s) for s in stacks]
    bs = batch.BatchedStitch(plan, 8, engine="torch", mesh=cpu_mesh(n=4))
    enqueued = []
    monkeypatch.setattr(bs, "_shard", lambda *a: enqueued.append(a))
    with pytest.raises(ValueError, match="B=8"):
        bs(slots)
    assert enqueued == []


def test_batch_on_2d_mesh_jobs_axis():
    """A (jobs, space) mesh: the batch splits over jobs; each jobs shard is
    computed once, on its row's first device."""
    m = cpu_mesh((4, 2))
    specs = [ImageSpec(40, 24), ImageSpec(24, 32)]
    plan = plan_for(specs, gap=1)
    stacks = [rand_stack(8, 40, 24), rand_stack(8, 24, 32)]
    want = oracle_batch(jax_plan_for(specs, gap=1), stacks)
    single = batch.stitch_batch(plan, stacks, device="cpu")
    for engine in ("torch", "auto"):
        bs = batch.BatchedStitch(plan, 8, engine=engine, mesh=m)
        assert len(bs.shards) == 4
        out = bs(stacks)
        assert maxdiff(out, want) <= 1
        if engine == "auto":
            assert np.array_equal(out, single)


def test_batched_accepts_empty_span_placement():
    plan = plan_for([ImageSpec(33, 4), ImageSpec(4, 4)], mode="min")
    assert any(p.row_span[0] == p.row_span[1] for p in plan.placements)
    stacks = [rand_stack(2, 33, 4), rand_stack(2, 4, 4)]
    got = batch.BatchedStitch(plan, 2, mesh=cpu_mesh(n=2))(stacks)
    want = oracle_batch(jax_plan_for([ImageSpec(33, 4), ImageSpec(4, 4)],
                                     mode="min"), stacks)
    assert maxdiff(got, want) <= 1


def test_batched_mesh_kernel_fault_propagates(monkeypatch):
    def fault(*a, **k):
        raise RuntimeError("resize_place kernel launch failed: injected")

    # the batched kernel's launch on the main path: the prepared form
    monkeypatch.setattr(cuda_resize.PlaceLaunch, "__call__", fault)
    plan = plan_for([ImageSpec(48, 32), ImageSpec(32, 40)], gap=2)
    bs = batch.BatchedStitch(plan, 4, mesh=cpu_mesh(n=2))
    with pytest.raises(RuntimeError, match="injected"):
        bs([rand_stack(4, 48, 32), rand_stack(4, 32, 40)])


# ------------------------------------------------------------------- shard

def test_sharded_rows_match_oracle():
    specs = [ImageSpec(64, 100), ImageSpec(80, 133)]
    check_sharded(specs, [rand(64, 100), rand(80, 133)], mode="min", gap=5)


def test_sharded_band_seams_with_orientations():
    specs = [ImageSpec(40, 64, orientation=8), ImageSpec(64, 48)]
    check_sharded(specs, [rand(40, 64), rand(64, 48)], mode="max", gap=2)


def test_sharded_uneven_rows():
    specs = [ImageSpec(32, 61)]
    plan, _ = check_sharded(specs, [rand(32, 61)])
    assert plan.canvas_h % 8 != 0


def test_sharded_trailing_bands_short_or_empty():
    """9 canvas rows over 8 shards: bands of 2 rows, the fifth holds 1 and
    the last three none; the canvas is still the resident one."""
    specs = [ImageSpec(20, 9), ImageSpec(10, 4)]
    imgs = [rand(20, 9), rand(10, 4)]
    plan = plan_for(specs, direction="horizontal", mode="max")
    assert plan.canvas_h == 9
    ss = ShardedStitch(plan, cpu_mesh((1, 8)))
    assert [hi - lo for _, (lo, hi) in ss.shards] == [2, 2, 2, 2, 1, 0, 0, 0]
    assert np.array_equal(ss(imgs), resident(plan, imgs))


@pytest.mark.parametrize("engine", ["torch", "auto"])
def test_pipeline_space_mesh_integration(engine):
    specs = [ImageSpec(64, 100), ImageSpec(80, 133)]
    imgs = [rand(64, 100), rand(80, 133)]
    opts = StitchOptions(mode="min", gap=5)
    out, m = api.stitch_arrays(
        imgs, options=opts, config=RuntimeConfig(
            engine=engine, device="cpu", mesh=cpu_mesh((1, 8))),
        return_metrics=True)
    assert m.strategy == "space-sharded"
    plan = plan_for(specs, mode="min", gap=5)
    assert np.array_equal(out, cuda_resize.stitch(
        plan, imgs, CPU, plain=engine == "torch").numpy())
    assert maxdiff(out, oracle.stitch(jax_plan_for(specs, mode="min",
                                                   gap=5), imgs)) <= 1
    jax_out = jax_api.stitch_arrays(
        imgs, options=jax_config.StitchOptions(mode="min", gap=5),
        config=jax_config.RuntimeConfig(
            engine="xla", mesh=jax_mesh.make_mesh((1, 8))))
    assert maxdiff(out, jax_out) <= 1


def test_sharded_triangle_filter():
    specs = [ImageSpec(200, 160), ImageSpec(64, 48)]
    check_sharded(specs, [rand(200, 160), rand(64, 48)], mode="min", gap=2,
                  filter="triangle")


def test_sharded_kernel_engine_matches_oracle():
    """Resample placements through kernel #3's wrapper, copies as slices;
    held once against JAX's Pallas sharded compose (interpret mode)."""
    specs = [ImageSpec(64, 100), ImageSpec(80, 133),
             ImageSpec(48, 64, orientation=6)]
    imgs = [rand(64, 100), rand(80, 133), rand(48, 64)]
    plan = plan_for(specs, mode="min", gap=3)
    ss = ShardedStitch(plan, cpu_mesh((1, 8)))
    kinds = {p.index: copy is None for p, copy, _ in ss._work}
    assert kinds == {0: False, 1: True, 2: False}
    check_sharded(specs, imgs, jax_engine="pallas", mode="min", gap=3)


def test_sharded_kernel_in_middle_bands_only():
    """A kernel placement only the middle bands meet (huge gap): the other
    bands launch nothing for it and stay background."""
    specs = [ImageSpec(96, 40), ImageSpec(64, 48), ImageSpec(96, 40)]
    imgs = [rand(96, 40), rand(64, 48), rand(96, 40)]
    plan, got = check_sharded(specs, imgs, mode="max", gap=200)
    ss = ShardedStitch(plan, cpu_mesh((1, 8)))
    p, copy, wp = next(w for w in ss._work if w[1] is None)
    met = [valid > 0 for _, valid, _ in map(wp.chunk_window,
                                           range(wp.n_chunks))]
    assert 0 < sum(met) < 8 and not met[0] and not met[-1]
    calls = []
    real = cuda_resize.WindowLauncher.__call__

    def counting(self, crop, *a):
        calls.append(a)
        return real(self, crop, *a)

    cuda_resize.WindowLauncher.__call__ = counting
    try:
        assert np.array_equal(ss(imgs), got)
    finally:
        cuda_resize.WindowLauncher.__call__ = real
    assert len(calls) == sum(met)


def test_sharded_deep_downscale_one_window_per_band():
    """2048 -> 256 with lanczos3: JAX shrinks its chunk height for VMEM;
    the port takes one window per (band, placement) and stays exact."""
    specs = [ImageSpec(2048, 512), ImageSpec(256, 400)]
    imgs = [rand(2048, 512), rand(256, 400)]
    plan = plan_for(specs, mode="min", filter="lanczos3")
    ss = ShardedStitch(plan, cpu_mesh((1, 8)))
    p, copy, wp = ss._work[0]
    assert copy is None and wp.n_chunks == 8
    assert np.array_equal(ss(imgs), resident(plan, imgs))
    want = oracle.stitch(jax_plan_for(specs, mode="min",
                                      filter="lanczos3"), imgs)
    assert maxdiff(ss(imgs), want) <= 1


def test_sharded_wide_k_filter():
    specs = [ImageSpec(400, 96), ImageSpec(100, 80)]
    check_sharded(specs, [rand(400, 96), rand(100, 80)], mode="min",
                  filter="lanczos3")


@pytest.mark.parametrize("n", [2, 3, 5])
def test_sharded_equals_resident_at_any_shard_count(n):
    specs = [ImageSpec(300, 220, 6), ImageSpec(90, 70, 3),
             ImageSpec(130, 130, 1)]
    imgs = [rand(300, 220), rand(90, 70), rand(130, 130)]
    plan = plan_for(specs, mode="min", gap=1.5, filter="lanczos3")
    for engine in ("auto", "torch"):
        got = ShardedStitch(plan, cpu_mesh((1, n)), engine=engine)(imgs)
        assert np.array_equal(got, cuda_resize.stitch(
            plan, imgs, CPU, plain=engine == "torch").numpy())


def test_sharded_gray_job():
    specs = [ImageSpec(50, 40), ImageSpec(30, 35, 8)]
    imgs = [rand(50, 40, 1)[..., 0], rand(30, 35, 1)[..., 0]]
    plan = plan_for(specs, direction="horizontal")
    got = ShardedStitch(plan, cpu_mesh((1, 4)), channels=1)(imgs)
    assert np.array_equal(got, resident(plan, imgs))


def test_pipeline_space_mesh_uses_kernel_engine():
    specs = [ImageSpec(64, 100), ImageSpec(80, 133)]
    imgs = [rand(64, 100), rand(80, 133)]
    opts = StitchOptions(mode="min", gap=2)
    get_logger().clear()
    got, m = api.stitch_arrays(
        imgs, specs, opts, config=RuntimeConfig(device="cpu",
                                                mesh=cpu_mesh((1, 8))),
        return_metrics=True)
    assert m.strategy == "space-sharded"
    assert m.h2d_bytes == sum(a.nbytes for a in imgs)   # one device
    plan = solve(specs, opts)
    assert np.array_equal(got, resident(plan, imgs))
    events = [e for e in get_logger().ring()
              if e["tag"] == "pipeline.space_sharded"]
    assert [(e["engine"], e["shards"]) for e in events] == [("auto", 8)]


def test_pipeline_jobs_only_mesh_runs_the_ladder():
    """A mesh whose space axis is 1 does not shard a single job, and a mesh
    keeps an all-copy job off the host blit (as JAX's gate does)."""
    imgs = [rand(40, 30), rand(40, 20)]
    cfg = RuntimeConfig(device="cpu", mesh=cpu_mesh())
    out, m = api.stitch_arrays(imgs, config=cfg, return_metrics=True)
    assert m.strategy == "resident"
    assert np.array_equal(out, np.concatenate(imgs))
    _, m = api.stitch_arrays(imgs, config=RuntimeConfig(device="cpu"),
                             return_metrics=True)
    assert m.strategy == "host-blit"
    assert api._blit_copies(plan_for([ImageSpec(40, 30), ImageSpec(40, 20)]),
                            cfg) is None


def test_space_sharded_budget_reject_falls_back():
    specs = [ImageSpec(60, 40), ImageSpec(40, 60)]
    imgs = [rand(60, 40), rand(40, 60)]
    plan = plan_for(specs, gap=2)
    m4 = cpu_mesh((1, 4))
    peak = tiler.sharded_peak_bytes(plan, 4, 3)
    get_logger().clear()
    out, m = pipeline.run(plan, imgs, RuntimeConfig(
        device="cpu", mesh=m4, budget=MemoryBudget(hbm_bytes=peak - 1)))
    assert m.strategy != "space-sharded"
    want = oracle.stitch(jax_plan_for(specs, gap=2), imgs)
    assert maxdiff(out, want) <= 1
    tags = [r["tag"] for r in get_logger().ring()]
    assert "pipeline.sharded_budget_reject" in tags
    out2, m2 = pipeline.run(plan, imgs, RuntimeConfig(
        device="cpu", mesh=m4, budget=MemoryBudget(hbm_bytes=peak * 4)))
    assert m2.strategy == "space-sharded"
    assert np.array_equal(out2, out)
    assert np.array_equal(out2, resident(plan, imgs))


@pytest.mark.parametrize("where", ["stitch", "band"])
def test_sharded_oom_falls_back_to_single_card(monkeypatch, where):
    """An OOM inside the space-sharded compose (the estimate admitted it)
    demotes to the single-card ladder on config.device."""
    def oom(*a, **k):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory (injected)")

    if where == "stitch":
        class Boom:
            def __init__(self, *a, **k):
                pass

            __call__ = staticmethod(oom)

        monkeypatch.setattr(sharding, "ShardedStitch", Boom)
    else:
        monkeypatch.setattr(sharding, "new_canvas", oom)
    specs = [ImageSpec(100, 80), ImageSpec(90, 70)]
    imgs = [rand(100, 80), rand(90, 70)]
    plan = plan_for(specs, mode="min", gap=1)
    get_logger().clear()
    out, m = pipeline.run(plan, imgs, RuntimeConfig(device="cpu",
                                                    mesh=cpu_mesh((1, 8))))
    assert m.strategy == "resident"
    retries = [e["failed"] for e in get_logger().ring()
               if e["tag"] == "pipeline.oom_retry"]
    assert retries == ["space-sharded"]
    assert np.array_equal(out, resident(plan, imgs))
    assert maxdiff(out, oracle.stitch(jax_plan_for(specs, mode="min",
                                                   gap=1), imgs)) <= 1


def test_sharded_kernel_fault_propagates(monkeypatch):
    """A fault of kernel #3 in a shard is not an OOM: it leaves
    pipeline.run, no demotion."""
    def fault(self, *a, **k):
        raise RuntimeError("resize_place kernel launch failed: injected")

    monkeypatch.setattr(cuda_resize.WindowLauncher, "__call__", fault)
    specs = [ImageSpec(64, 100), ImageSpec(80, 133)]
    imgs = [rand(64, 100), rand(80, 133)]
    get_logger().clear()
    with pytest.raises(RuntimeError, match="injected"):
        api.stitch_arrays(imgs, specs, StitchOptions(mode="min"),
                          config=RuntimeConfig(device="cpu",
                                               mesh=cpu_mesh((1, 4))))
    assert not [e for e in get_logger().ring()
                if e["tag"] == "pipeline.oom_retry"]


def test_sharded_stitch_arguments():
    plan = plan_for([ImageSpec(16, 16)])
    with pytest.raises(ValueError, match="engine"):
        ShardedStitch(plan, cpu_mesh((1, 2)), engine="pallas")
    with pytest.raises(ValueError, match="CUDA"):
        ShardedStitch(plan, cpu_mesh((1, 2)), engine="cuda")
    with pytest.raises(ValueError, match="image count"):
        ShardedStitch(plan, cpu_mesh((1, 2)))([])


# ------------------------------------------------------- WindowPlan windows

@pytest.mark.parametrize("kind", ["bilinear", "lanczos3"])
def test_window_plan_explicit_windows(kind):
    """Explicit windows equal to the r0-aligned chunks give the same plan;
    band-aligned windows size the crop over the real intersections, as
    JAX's ``_WindowPlan(windows=)`` does."""
    specs = [ImageSpec(360, 280, 6), ImageSpec(120, 80)]
    plan = plan_for(specs, mode="min", filter=kind)
    jplan = jax_plan_for(specs, mode="min", filter=kind)
    p, jp = plan.placements[0], jplan.placements[0]
    assert p.row_span == (0, 154)
    default = WindowPlan(p, plan.filter, 37)
    explicit = WindowPlan(p, plan.filter, windows=default.windows)
    assert (explicit.crop_rows, explicit.chunk) == (default.crop_rows,
                                                    default.chunk)
    for g in range(default.n_chunks):
        assert explicit.chunk_window(g) == default.chunk_window(g)
        for a, b in zip(explicit.chunk_taps(g), default.chunk_taps(g)):
            assert np.array_equal(a, b)
    lo = [0, 70, 150, 151, 154, 200]   # the last band misses p
    windows = [sharding._window(p, a, b) for a, b in zip(lo, lo[1:])]
    wp = WindowPlan(p, plan.filter, windows=windows)
    if kind == "bilinear":
        jwp = pallas_resize._WindowPlan(jp, jplan.filter, 3, chunk_rows=256,
                                        windows=windows)
        assert wp.crop_rows == jwp.crop_rows
        assert [wp.chunk_window(g) for g in range(5)] == [
            jwp.chunk_window(g) for g in range(5)]
    oriented = geometry.orient_array(rand(360, 280), p.orientation)
    whole = cuda_resize.resize_place_ref(
        torch.from_numpy(np.ascontiguousarray(oriented)), 1,
        *cuda_resize.plan_steps(plan, CPU)[0].taps)
    for g in range(wp.n_chunks):
        a, valid, s_lo = wp.chunk_window(g)
        if valid == 0:
            continue
        crop = torch.from_numpy(np.ascontiguousarray(
            oriented[s_lo:s_lo + wp.crop_rows]))
        region = cuda_resize.resize_place_window_ref(
            crop, *cuda_resize.plan_steps(plan, CPU)[0].taps, a, s_lo, valid)
        assert torch.equal(region, whole[a:a + valid])


def test_window_plan_rejects_bad_windows():
    p = plan_for([ImageSpec(90, 70), ImageSpec(30, 20)],
                 mode="min").placements[0]
    n = p.row_span[1] - p.row_span[0]
    for windows in ([(0, n + 1)], [(5, 3)], [(4, 4)], [(0, 0)]):
        with pytest.raises(ValueError):
            WindowPlan(p, "bilinear", windows=windows)
    with pytest.raises(ValueError, match="chunk_rows"):
        WindowPlan(p, "bilinear")
    assert WindowPlan(p, "bilinear", windows=[(0, 0), (0, n)]) \
        .chunk_window(0) == (0, 0, 0)


def test_banded_rung_unchanged_by_windows():
    """The banded rung keeps its r0-aligned chunks: its canvas equals the
    resident one, chunk for chunk as before."""
    specs = [ImageSpec(400, 96), ImageSpec(100, 80, 6)]
    imgs = [rand(400, 96), rand(100, 80)]
    plan = plan_for(specs, mode="min", filter="lanczos3")
    out, _ = pipeline._run_banded(plan, imgs, 3, 16, "auto", CPU,
                                  pipeline._noop)
    assert np.array_equal(out, resident(plan, imgs))
    wp = WindowPlan(plan.placements[0], plan.filter, 16)
    assert wp.windows[0] == (0, 16) and wp.chunk == 16


# ------------------------------------------------------------ grid, server

def test_stitch_grid_under_space_mesh():
    """Grid columns shard with no code of their own: each column's
    pipeline.run takes the space-sharded branch."""
    imgs = [rand(180, 90), rand(150, 120), rand(160, 100), rand(140, 110)]
    opts = StitchOptions(gap=3, background=(5, 5, 5))
    got, m = api.stitch_grid(imgs, cols=2, options=opts, config=RuntimeConfig(
        device="cpu", mesh=cpu_mesh((1, 8))), return_metrics=True)
    assert m.strategy == "grid(space-sharded,space-sharded)", m.strategy
    single = api.stitch_grid(imgs, cols=2, options=opts,
                             config=RuntimeConfig(device="cpu"))
    assert np.array_equal(got, single)
    jax_out = jax_api.stitch_grid(
        imgs, cols=2, options=jax_config.StitchOptions(
            gap=3, background=(5, 5, 5)),
        config=jax_config.RuntimeConfig(mesh=jax_mesh.make_mesh((1, 8))))
    assert maxdiff(got, jax_out) <= 1
    specs = [ImageSpec(a.shape[1], a.shape[0]) for a in imgs]
    assert got.shape[:2] == (plan_grid(specs, 2, opts).canvas_h,
                             plan_grid(specs, 2, opts).canvas_w)


def test_http_grid_inherits_the_server_mesh():
    import base64
    import json
    import urllib.request

    from imagestitching_tpu_torch.imgio import codec
    from imagestitching_tpu_torch.serve.http import StitchHTTPServer

    imgs = [rand(50, 40), rand(60, 44), rand(50, 40), rand(40, 36)]
    payload = {"images": [base64.b64encode(codec.encode_bytes(a, "png"))
                          .decode() for a in imgs], "grid_cols": 2, "gap": 1}
    server = StitchServer(config=RuntimeConfig(device="cpu",
                                               mesh=cpu_mesh((1, 4))))
    get_logger().clear()
    with StitchHTTPServer(port=0, server=server) as srv:
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/stitch",
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            assert r.status == 200
    server.close()
    shards = [e["shards"] for e in get_logger().ring()
              if e["tag"] == "pipeline.space_sharded"]
    assert shards == [4, 4]


def test_server_mesh_with_default_engine():
    """use_mesh=True with config.mesh: 9 jobs (not a jobs multiple) pad
    with zero jobs to the next multiple; every job equals the plain
    server's bit for bit and the oracle within 1."""
    opts = StitchOptions(gap=2)
    jobs = [[rand(48, 32), rand(32, 40)] for _ in range(9)]
    with StitchServer(max_batch=8, max_wait_s=0.01, use_mesh=True,
                      config=RuntimeConfig(device="cpu",
                                           mesh=cpu_mesh(n=4))) as s, \
            StitchServer(max_batch=8, max_wait_s=0.01,
                         config=RuntimeConfig(device="cpu")) as plain:
        assert s.mesh.shape["jobs"] == 4
        futs = [s.submit(imgs, opts) for imgs in jobs]
        pfuts = [plain.submit(imgs, opts) for imgs in jobs]
        jplan = jax_plan_for([ImageSpec(48, 32), ImageSpec(32, 40)], gap=2)
        for imgs, f, pf in zip(jobs, futs, pfuts):
            got = f.result(timeout=30)
            assert np.array_equal(got, pf.result(timeout=30))
            assert maxdiff(got, oracle.stitch(jplan, imgs)) <= 1
        assert s.stats()["jobs"] == 9
        sizes = {b for per in s._compiled.values() for b, _ in per}
        assert all(b % 4 == 0 for b in sizes), sizes


def test_server_without_use_mesh_ignores_config_mesh():
    with StitchServer(config=RuntimeConfig(device="cpu",
                                           mesh=cpu_mesh(n=4))) as s:
        assert s.mesh is None and s._padded_batch(3) == 3


def test_warmup_under_jobs_mesh():
    with StitchServer(max_batch=16, max_wait_s=0.002, use_mesh=True,
                      config=RuntimeConfig(device="cpu",
                                           mesh=cpu_mesh())) as s:
        unit = s.mesh.shape["jobs"]
        info = s.warmup([(24, 32), (20, 28)], StitchOptions(gap=2),
                        batch_sizes=(1, 3))
        assert info["batches"] == [unit]
        assert s.stats()["warmups"] == len(info["batches"])
        imgs = [rand(32, 24), rand(28, 20)]
        out = s.submit(imgs, StitchOptions(gap=2)).result(timeout=30)
        want = oracle.stitch(jax_plan_for([ImageSpec(32, 24),
                                           ImageSpec(28, 20)], gap=2), imgs)
        assert maxdiff(out, want) <= 1


def test_warmup_clamps_to_mesh_rounded_cap(monkeypatch):
    with StitchServer(max_batch=16, max_wait_s=30.0, use_mesh=True,
                      config=RuntimeConfig(device="cpu",
                                           mesh=cpu_mesh())) as s:
        unit = s.mesh.shape["jobs"]
        assert unit == 8
        monkeypatch.setattr(s, "_batch_cap", lambda plan, ch: 10)
        assert s._effective_cap(None, 3) == 8
        info = s.warmup([(16, 16)], batch_sizes=(10,))
        assert info["batches"] == [8]


def test_server_batch_cap_multiplies_by_jobs():
    plan = plan_for([ImageSpec(48, 32), ImageSpec(32, 40)])
    per_job = tiler.resident_peak_bytes(plan, 3)
    cfg = dict(device="cpu", budget=MemoryBudget(hbm_bytes=3 * per_job))
    with StitchServer(config=RuntimeConfig(**cfg)) as plain, \
            StitchServer(use_mesh=True, config=RuntimeConfig(
                **cfg, mesh=cpu_mesh(n=4))) as meshed:
        assert plain._batch_cap(plan, 3) == 3
        assert meshed._batch_cap(plan, 3) == 12
        assert meshed._effective_cap(plan, 3) == 12
        assert [meshed._padded_batch(b) for b in (1, 4, 5)] == [4, 4, 8]

