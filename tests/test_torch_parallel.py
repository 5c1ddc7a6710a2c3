"""The port's ``parallel/`` on a 4-rank gloo cluster vs the JAX package's
4-device mesh.

Each module of ``parallel/`` gets one cluster: four processes, started from
this file (``python tests/test_torch_parallel.py <module> <port> <rank>
<world> <out>``), that import only the port, join a gloo world on
127.0.0.1 through ``parallel.initialize`` and run that module's cases of
``tests/test_parallel.py`` at its sizes (1024 splats, 128x64,
``tile_h=8, chunk_size=32, max_pairs_per_tile=1024``, SH1).  Rank 0 writes
the results; the tests hold them against the JAX package's sharded
functions on ``make_mesh(jax.devices()[:4])``, at tests/test_parallel.py's
tolerances.  The world of size 1 that a single card runs is tested here in
the test process itself.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

WORKER = __name__ == "__main__"
WORLD = 4
W, H = 128, 64
CAMERA = dict(eye=[0.0, 0.5, -3.0], target=[0, 0, 0], up=[0, 1, 0], fov_y_deg=45.0, width=W, height=H)
CONFIG = dict(tile_h=8, chunk_size=32, max_pairs_per_tile=1024)
SH_ORDER = 1
GRAD_FIELDS = ("means", "log_scales", "opacity_logits", "sh0")
TRAIN_LR = 5e-3
TRUNC_CAP_FRAC = 0.05
# tests/test_parallel.py's bars: images 1e-5 (all-gather), 3e-5 (culled);
# gradients 2e-6 (sharded), 3e-6 (strips), rtol 1e-4 + atol 1e-6 (culled).
IMAGE_ATOL = 1e-5
CULLED_ATOL = 3e-5
SHARDED_GRAD_ATOL = 2e-6
STRIP_GRAD_ATOL = 3e-6
CULLED_GRAD = dict(rtol=1e-4, atol=1e-6)
# Two SGD steps of lr 5e-3 on gradients within 2e-6 of JAX's: parameters
# within 1e-6 (lr x the gradient bar x 2 steps = 2e-8, with room for the
# loss's own rounding); losses to 1e-5 relative.
TRAIN_PARAM_ATOL = 1e-6
TRAIN_LOSS_RTOL = 1e-5


def squashed(g, asarray):
    """tests/test_parallel.py:248-258: the cloud squashed into the top of the
    frame, so strip 0 owns nearly all of it."""
    return g.__class__(
        means=g.means * asarray([0.25, 0.25, 0.25]) + asarray([0.0, 0.85, 0.0]),
        rotations=g.rotations, scales=g.scales * 0.5, opacities=g.opacities, base_color=g.base_color, sh=g.sh,
    )


# --------------------------------------------------------------------------
# The worker: one rank of the cluster.  Imports the port only.


def _worker(module: str, port: int, rank: int, world: int, out: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from unitygaussiansplatting_torch import parallel
    from unitygaussiansplatting_torch.models.camera import Camera
    from unitygaussiansplatting_torch.models.gaussians import Gaussians, RawGaussians
    from unitygaussiansplatting_torch.parallel.exchange import render_strips_culled_fn, send_capacity
    from unitygaussiansplatting_torch.parallel.mesh import shard_gaussians, splat_sharding
    from unitygaussiansplatting_torch.parallel.render_sharded import render_sharded_fn, train_step_sharded_fn
    from unitygaussiansplatting_torch.parallel.strips import render_strips_fn
    from unitygaussiansplatting_torch.utils.config import RasterizeConfig, RenderSettings
    from unitygaussiansplatting_torch.utils.convert import RAW_FIELDS
    from unitygaussiansplatting_torch.utils.synthetic import sphere_scene

    address = f"127.0.0.1:{port}"
    parallel.initialize(address, world, rank, device="cpu")
    mesh = parallel.make_pod_mesh(device="cpu")
    cam = Camera.look_at(**CAMERA)
    cfg, settings = RasterizeConfig(**CONFIG), RenderSettings(sh_order=SH_ORDER)
    kw = dict(settings=settings, config=cfg)
    res = {}

    def gathered(x):
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x.contiguous())
        return torch.cat(parts).numpy()

    def grads(fn, raw, target):
        params = [getattr(raw, f).clone().requires_grad_(True) for f in RAW_FIELDS]
        img = fn(RawGaussians(**dict(zip(RAW_FIELDS, params))).activate())
        img = img[0] if isinstance(img, tuple) else img
        loss = torch.mean(torch.square(img - target))
        return {f: gathered(g) for f, g in zip(RAW_FIELDS, torch.autograd.grad(loss, params))}

    def shard(g):
        return shard_gaussians(g, mesh)

    if module == "render_sharded":
        res["image"] = render_sharded_fn(mesh, cam, **kw)(shard(sphere_scene(n=1024, seed=0).activate())).numpy()
        step = train_step_sharded_fn(mesh, cam, lr=TRAIN_LR, **kw)
        raw, losses = shard(sphere_scene(n=512, seed=1)), []
        for _ in range(2):
            loss, raw = step(raw, torch.zeros((H, W, 4)))
            losses.append(float(loss))
        res["train_losses"] = np.asarray(losses)
        res.update({f"train_{f}": gathered(getattr(raw, f)) for f in RAW_FIELDS})
        target = torch.full((H, W, 4), 0.1)
        g = grads(render_sharded_fn(mesh, cam, **kw), shard(sphere_scene(n=512, seed=2)), target)
        res.update({f"grad_{f}": v for f, v in g.items()})
    elif module == "strips":
        res["image"] = render_strips_fn(mesh, cam, **kw)(shard(sphere_scene(n=1024, seed=3).activate())).numpy()
        g = grads(render_strips_fn(mesh, cam, **kw), shard(sphere_scene(n=512, seed=4)), torch.full((H, W, 4), 0.2))
        res.update({f"grad_{f}": v for f, v in g.items()})
        local = shard(sphere_scene(n=512, seed=6).activate())
        res["torch"] = render_strips_fn(mesh, cam, **kw)(local).numpy()
        res["cuda"] = render_strips_fn(mesh, cam, backend="cuda", **kw)(local).numpy()
        res["cuda_culled"] = render_strips_culled_fn(mesh, cam, backend="cuda", cap_frac=1.0, **kw)(local)[0].numpy()
    elif module == "exchange":
        img, demand = render_strips_culled_fn(mesh, cam, cap_frac=1.0, **kw)(shard(sphere_scene(n=1024, seed=4)
                                                                                .activate()))
        res["image"], res["demand"] = img.numpy(), demand.numpy()
        fn = render_strips_culled_fn(mesh, cam, cap_frac=1.0, **kw)
        g = grads(fn, shard(sphere_scene(n=512, seed=5)), torch.zeros((H, W, 4)))
        res.update({f"grad_{f}": v for f, v in g.items()})
        sq = shard(squashed(sphere_scene(n=512, seed=7).activate(), torch.tensor))
        for name, frac in (("trunc", TRUNC_CAP_FRAC), ("full", 1.0)):
            img, demand = render_strips_culled_fn(mesh, cam, cap_frac=frac, **kw)(sq)
            res[f"{name}_image"], res[f"{name}_demand"] = img.numpy(), demand.numpy()
        res["trunc_cap"] = np.asarray(send_capacity(512 // world, TRUNC_CAP_FRAC))
        img, demand = render_strips_culled_fn(mesh, cam, cap_frac=1.0, **kw)(shard(sphere_scene(n=1000, seed=2)
                                                                                .activate()))
        res["odd_image"], res["odd_demand"] = img.numpy(), demand.numpy()
    elif module == "multihost":
        n = 1024
        start, stop = parallel.process_splat_slice(n, mesh)
        res["slices"] = gathered(torch.tensor([[start, stop]]))
        try:
            parallel.process_splat_slice(n + 1, mesh)
            res["non_divisible_raised"] = np.asarray(False)
        except ValueError:
            res["non_divisible_raised"] = np.asarray(True)
        parallel.initialize(address, world, rank, device="cpu")  # the same world again: a no-op
        try:
            parallel.initialize(address, 2 * world, rank, device="cpu")
            res["late_raised"] = np.asarray(False)
        except RuntimeError:
            res["late_raised"] = np.asarray(True)
        g = sphere_scene(n=n, seed=3).activate()
        local = Gaussians(**{f: getattr(g, f)[start:stop].numpy() for f in ("means", "rotations", "scales",
                                                                             "opacities", "base_color", "sh")})
        g_local = parallel.global_gaussians_from_local(local, mesh, n)
        res["rows_equal"] = np.asarray(all(
            torch.equal(getattr(g_local, f), getattr(g, f)[splat_sharding(mesh, n)]) for f in ("means", "sh")))
        res["image"] = render_sharded_fn(mesh, cam, **kw)(g_local).numpy()
    else:
        raise ValueError(module)
    if rank == 0:
        np.savez(out, **res)
    dist.barrier()
    dist.destroy_process_group()


if WORKER:
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
    sys.exit(0)

# --------------------------------------------------------------------------
# The tests: the cluster's results against the JAX package's 4-device mesh.

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from unitygaussiansplatting_torch import parallel as tpar  # noqa: E402
from unitygaussiansplatting_tpu.models.camera import Camera as JaxCamera  # noqa: E402
from unitygaussiansplatting_tpu.models.renderer import render as jax_render  # noqa: E402
from unitygaussiansplatting_tpu.parallel.exchange import render_strips_culled_fn as jax_culled_fn  # noqa: E402
from unitygaussiansplatting_tpu.parallel.mesh import make_mesh, shard_gaussians  # noqa: E402
from unitygaussiansplatting_tpu.parallel.render_sharded import render_sharded_fn as jax_sharded_fn  # noqa: E402
from unitygaussiansplatting_tpu.parallel.render_sharded import train_step_sharded_fn as jax_train_fn  # noqa: E402
from unitygaussiansplatting_tpu.parallel.strips import render_strips_fn as jax_strips_fn  # noqa: E402
from unitygaussiansplatting_tpu.utils.config import RasterizeConfig, RenderSettings  # noqa: E402
from unitygaussiansplatting_tpu.utils.synthetic import sphere_scene  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
RAW_FIELDS = ("means", "rotations_wxyz", "log_scales", "opacity_logits", "sh0", "sh")
CLUSTER_TIMEOUT_S = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


_results = {}


def cluster(module: str) -> dict:
    """The results of ``module``'s cases on a fresh 4-rank gloo cluster (once
    per module)."""
    if module not in _results:
        out = Path(os.environ.get("TMPDIR", "/tmp")) / f"torch_parallel_{module}_{os.getpid()}.npz"
        env = {"PATH": os.environ.get("PATH", "/usr/bin:/bin"), "HOME": os.environ.get("HOME", "/tmp"),
               "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
        if "TMPDIR" in os.environ:
            env["TMPDIR"] = os.environ["TMPDIR"]
        port = _free_port()
        procs = [subprocess.Popen([sys.executable, __file__, module, str(port), str(r), str(WORLD), str(out)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=REPO)
                 for r in range(WORLD)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=CLUSTER_TIMEOUT_S)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        codes = [p.returncode for p in procs]
        assert codes == [0] * WORLD, f"{module} cluster exited {codes}:\n" + "\n".join(s[-3000:] for s in logs)
        with np.load(out) as f:
            _results[module] = dict(f)
        out.unlink()
    return _results[module]


@pytest.fixture(scope="module")
def jax_setup():
    assert len(jax.devices()) >= WORLD
    cam = JaxCamera.look_at(**CAMERA)
    return make_mesh(jax.devices()[:WORLD]), cam, dict(settings=RenderSettings(sh_order=SH_ORDER),
                                                       config=RasterizeConfig(**CONFIG))


def jax_grads(fn, raw, target):
    g = jax.jit(jax.grad(lambda r: jnp.mean(jnp.square(fn(r.activate()) - target))))(raw)
    return {f: np.asarray(getattr(g, f)) for f in RAW_FIELDS}


def test_render_sharded_matches_jax(jax_setup):
    mesh, cam, kw = jax_setup
    want = jax_sharded_fn(mesh, cam, **kw)(shard_gaussians(sphere_scene(n=1024, seed=0).activate(), mesh))
    np.testing.assert_allclose(cluster("render_sharded")["image"], np.asarray(want), rtol=0, atol=IMAGE_ATOL)


def test_train_step_sharded_matches_jax(jax_setup):
    mesh, cam, kw = jax_setup
    step = jax_train_fn(mesh, cam, lr=TRAIN_LR, **kw)
    raw, losses = shard_gaussians(sphere_scene(n=512, seed=1), mesh), []
    for _ in range(2):
        loss, raw = step(raw, jnp.zeros((H, W, 4), jnp.float32))
        losses.append(float(loss))
    got = cluster("render_sharded")
    np.testing.assert_allclose(got["train_losses"], losses, rtol=TRAIN_LOSS_RTOL)
    assert got["train_losses"][1] < got["train_losses"][0]
    for f in RAW_FIELDS:
        np.testing.assert_allclose(got[f"train_{f}"], np.asarray(getattr(raw, f)), rtol=0, atol=TRAIN_PARAM_ATOL,
                                   err_msg=f)


def test_sharded_grads_match_jax(jax_setup):
    mesh, cam, kw = jax_setup
    want = jax_grads(lambda g: jax_render(g, cam, **kw), sphere_scene(n=512, seed=2), 0.1)
    got = cluster("render_sharded")
    for f in ("means", "sh0"):
        np.testing.assert_allclose(got[f"grad_{f}"], want[f], rtol=0, atol=SHARDED_GRAD_ATOL, err_msg=f)


def test_strips_match_jax(jax_setup):
    mesh, cam, kw = jax_setup
    want = jax_strips_fn(mesh, cam, **kw)(shard_gaussians(sphere_scene(n=1024, seed=3).activate(), mesh))
    np.testing.assert_allclose(cluster("strips")["image"], np.asarray(want), rtol=0, atol=IMAGE_ATOL)


def test_strip_grads_match_jax(jax_setup):
    mesh, cam, kw = jax_setup
    fn = jax_strips_fn(mesh, cam, **kw)
    raw = shard_gaussians(sphere_scene(n=512, seed=4), mesh)
    want = jax_grads(fn, raw, 0.2)
    got = cluster("strips")
    for f in ("means", "sh0"):
        np.testing.assert_allclose(got[f"grad_{f}"], want[f], rtol=0, atol=STRIP_GRAD_ATOL, err_msg=f)


def test_strips_cuda_backend_matches_torch(jax_setup):
    # "cuda" on the CPU runs the kernels' plain versions; tests/test_parallel.py:
    # 282-303's bar for the multi-device paths on the fused pipeline.
    mesh, cam, kw = jax_setup
    got = cluster("strips")
    want = np.asarray(jax_strips_fn(mesh, cam, **kw)(shard_gaussians(sphere_scene(n=512, seed=6).activate(), mesh)))
    np.testing.assert_allclose(got["torch"], want, rtol=0, atol=IMAGE_ATOL)
    np.testing.assert_allclose(got["cuda"], got["torch"], rtol=0, atol=CULLED_ATOL)
    np.testing.assert_allclose(got["cuda_culled"], got["torch"], rtol=0, atol=CULLED_ATOL)


def test_culled_matches_jax(jax_setup):
    mesh, cam, kw = jax_setup
    img, demand = jax_culled_fn(mesh, cam, cap_frac=1.0, **kw)(
        shard_gaussians(sphere_scene(n=1024, seed=4).activate(), mesh))
    got = cluster("exchange")
    np.testing.assert_allclose(got["image"], np.asarray(img), rtol=0, atol=CULLED_ATOL)
    np.testing.assert_array_equal(got["demand"], np.asarray(demand))
    assert got["demand"].sum(axis=0).max() < 1024 * 0.6  # far below full replication


def test_culled_grads_match_jax(jax_setup):
    mesh, cam, kw = jax_setup
    fn = jax_culled_fn(mesh, cam, cap_frac=1.0, **kw)
    want = jax_grads(lambda g: fn(g)[0], shard_gaussians(sphere_scene(n=512, seed=5), mesh), 0.0)
    got = cluster("exchange")
    for f in GRAD_FIELDS:
        np.testing.assert_allclose(got[f"grad_{f}"], want[f], err_msg=f, **CULLED_GRAD)


def test_culled_truncation_is_exposed_per_src_dst(jax_setup):
    mesh, cam, kw = jax_setup
    g = shard_gaussians(squashed(sphere_scene(n=512, seed=7).activate(), jnp.asarray), mesh)
    got = cluster("exchange")
    cap = int(got["trunc_cap"])
    for name, frac in (("trunc", TRUNC_CAP_FRAC), ("full", 1.0)):
        img, demand = jax_culled_fn(mesh, cam, cap_frac=frac, **kw)(g)
        np.testing.assert_array_equal(got[f"{name}_demand"], np.asarray(demand), err_msg=name)
        np.testing.assert_allclose(got[f"{name}_image"], np.asarray(img), rtol=0, atol=CULLED_ATOL, err_msg=name)
    truncated = got["trunc_demand"] > cap
    srcs, dsts = np.nonzero(truncated)
    assert set(srcs) == set(range(WORLD)), srcs  # every source truncates toward the top strips
    assert dsts.max() < WORLD // 2, dsts
    assert not (got["full_demand"] > 512 // WORLD).any()
    assert np.abs(got["trunc_image"] - got["full_image"]).max() > 0.05  # not silent


def test_culled_odd_shard_size(jax_setup):
    # 1000 splats over 4 ranks: 250 a rank, not a multiple of 8.
    mesh, cam, kw = jax_setup
    img, demand = jax_culled_fn(mesh, cam, cap_frac=1.0, **kw)(
        shard_gaussians(sphere_scene(n=1000, seed=2).activate(), mesh))
    got = cluster("exchange")
    np.testing.assert_allclose(got["odd_image"], np.asarray(img), rtol=0, atol=CULLED_ATOL)
    np.testing.assert_array_equal(got["odd_demand"], np.asarray(demand))


def test_multihost_helpers_on_the_cluster(jax_setup):
    mesh, cam, kw = jax_setup
    got = cluster("multihost")
    np.testing.assert_array_equal(got["slices"], [[r * 256, (r + 1) * 256] for r in range(WORLD)])
    assert bool(got["non_divisible_raised"]) and bool(got["late_raised"]) and bool(got["rows_equal"])
    single = jax.jit(lambda g: jax_render(g, cam, **kw))(sphere_scene(n=1024, seed=3).activate())
    np.testing.assert_allclose(got["image"], np.asarray(single), rtol=0, atol=IMAGE_ATOL)


def test_world_of_one_in_process(monkeypatch):
    # No arguments and no cluster: a world of size 1 (what one card runs),
    # idempotent; a cluster's arguments afterwards raise; a cluster
    # environment that cannot be joined raises.
    import torch.distributed as dist

    from unitygaussiansplatting_torch.models.camera import Camera
    from unitygaussiansplatting_torch.models.renderer import render
    from unitygaussiansplatting_torch.parallel.exchange import render_strips_culled_fn
    from unitygaussiansplatting_torch.parallel.strips import render_strips_fn
    from unitygaussiansplatting_torch.utils import config as tcfg
    from unitygaussiansplatting_torch.utils.synthetic import sphere_scene as port_scene

    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE", "MASTER_ADDR",
                "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    if dist.is_initialized():
        pytest.fail("a process group is already initialized in the test process")
    monkeypatch.setenv("SLURM_NTASKS", "4")
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        tpar.initialize(device="cpu")
    monkeypatch.delenv("SLURM_NTASKS")
    tpar.initialize(device="cpu")
    try:
        assert dist.get_world_size() == 1
        tpar.initialize(device="cpu")  # idempotent
        with pytest.raises(RuntimeError, match="cannot join"):
            tpar.initialize("127.0.0.1:1", 4, 0, device="cpu")
        mesh = tpar.make_pod_mesh(device="cpu")
        assert tpar.process_splat_slice(1024, mesh) == (0, 1024)
        cam = Camera.look_at(**CAMERA)
        kw = dict(settings=tcfg.RenderSettings(sh_order=SH_ORDER), config=tcfg.RasterizeConfig(**CONFIG))
        g = port_scene(n=512, seed=6).activate()
        frame = render(g, cam, backend="cuda", device="cpu", **kw)
        # One rank: the strip is the frame padded to a multiple of tile_h.
        strips = render_strips_fn(mesh, cam, backend="cuda", **kw)(g)
        np.testing.assert_array_equal(strips.numpy(), frame.numpy())
        img, demand = render_strips_culled_fn(mesh, cam, backend="cuda", **kw)(g)
        np.testing.assert_array_equal(img.numpy(), frame.numpy())
        assert demand.shape == (1, 1)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_strips_keep_the_frames_compositing_order(backend):
    # A frame of 256 tiles leaves 23 depth bits, a strip of 64 tiles 24: a
    # strip binned at its own grid orders near-equal depths otherwise than
    # the frame.  render_strip keeps the frame's bits, so its 4 strips
    # stacked are the frame ("cuda": the kernels' plain versions on the CPU).
    from unitygaussiansplatting_torch.models.camera import Camera
    from unitygaussiansplatting_torch.models.renderer import render
    from unitygaussiansplatting_torch.ops.binning import bin_splats, depth_key_bits, tile_grid
    from unitygaussiansplatting_torch.ops.projection import project_splats
    from unitygaussiansplatting_torch.ops.rasterize_cuda import rasterize
    from unitygaussiansplatting_torch.ops.rasterize_tiles import rasterize_tiles_torch
    from unitygaussiansplatting_torch.parallel.strips import render_strip, strip_height
    from unitygaussiansplatting_torch.utils import config as tcfg
    from unitygaussiansplatting_torch.utils.synthetic import sphere_scene as port_scene

    w, h = 256, 128
    cam = Camera.look_at(CAMERA["eye"], CAMERA["target"], CAMERA["up"], CAMERA["fov_y_deg"], w, h)
    cfg = tcfg.RasterizeConfig(tile_h=8, tile_w=16, chunk_size=32)
    settings = tcfg.RenderSettings(sh_order=SH_ORDER)
    hs = strip_height(h, WORLD, cfg)
    assert depth_key_bits(tile_grid(w, h, cfg)[0] * tile_grid(w, h, cfg)[1]) == 23
    assert depth_key_bits(tile_grid(w, hs, cfg)[0] * tile_grid(w, hs, cfg)[1]) == 24
    g = port_scene(n=6000, seed=0).activate()
    frame = render(g, cam, settings, cfg, backend=backend, device="cpu")
    proj = project_splats(g, cam, settings)
    stacked = torch.cat([render_strip(proj, r, WORLD, cam, cfg, backend) for r in range(WORLD)])[:h]
    np.testing.assert_allclose(stacked.numpy(), frame.numpy(), rtol=0, atol=IMAGE_ATOL)

    own = []
    for r in range(WORLD):
        shifted = proj._replace(center=proj.center - torch.tensor([0.0, float(r * hs)]))
        if backend == "cuda":
            own.append(rasterize(shifted, w, hs, cfg)[0])
        else:
            own.append(rasterize_tiles_torch(shifted, bin_splats(shifted, w, hs, cfg), w, hs, cfg))
    assert float((torch.cat(own)[:h] - frame).abs().max()) > 1e-4  # the order matters on this scene
