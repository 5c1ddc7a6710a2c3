"""A viewer looking around a scene of several objects: one client asks the
program's ``models/viewer.ViewerSession.frame`` of a multi-object session
for a new pose every frame and waits for it (a synchronize), as ``viewer``
does for one cloud.

The scene is the configuration's ``objects``: object ``i`` is the float32
cloud ``scenes.outdoor_scene`` draws from seed ``object_seed(seed, i)``,
under the model matrix of its ``yaw_deg``, ``scale`` and ``position``, at
its ``render_order``.  The session renders them through the program's
``render_multi``.  The pair budget is the largest that
``suggest_pair_multiplier`` gives any object under its model over the
traffic's views.  The check: the frames of poses drawn from the seed, kept
as the window produced them, against ``reference/multi.py``, which renders
the same clouds object by object (so that one object's cloud is held at a
time) and composites them in its own order.
"""

from __future__ import annotations

import math
import random

import numpy as np
import torch

from .. import counts, poses, scenes
from ..reference import multi as ref_multi
from ..reference import render as ref
from .viewer import State, before_trace, pass_units, program_cameras, raster_config, release, run_unit, trace_units

UNIT = "frame"
__all__ = ["UNIT", "setup", "pass_units", "run_unit", "trace_units", "before_trace", "release", "reference"]


def object_seed(seed: int, i: int) -> int:
    """The seed of object ``i``'s cloud: five draws of one seed's scene differ."""
    return 16 * int(seed) + i


def model_matrix(obj: dict) -> np.ndarray:
    """(4, 4) float32 object->world matrix: scale, then the yaw about +y,
    then the move to ``position``."""
    a = math.radians(obj["yaw_deg"])
    m = np.eye(4, dtype=np.float64)
    m[:3, :3] = obj["scale"] * np.array([[math.cos(a), 0.0, math.sin(a)], [0.0, 1.0, 0.0],
                                         [-math.sin(a), 0.0, math.cos(a)]])
    m[:3, 3] = obj["position"]
    return m.astype(np.float32)


def setup(ctx) -> State:
    from unitygaussiansplatting_torch.models.gaussians import RawGaussians
    from unitygaussiansplatting_torch.models.renderer import suggest_pair_multiplier
    from unitygaussiansplatting_torch.models.viewer import SplatObject, ViewerSession
    from unitygaussiansplatting_torch.utils.config import RenderSettings

    cfg, dev = ctx.config, ctx.device
    clouds = []
    with torch.no_grad():
        for i in range(len(cfg["objects"])):
            clouds.append(RawGaussians(**scenes.outdoor_scene(cfg["n_splats"], object_seed(ctx.seed, i), dev))
                          .activate())
    ctx.mark("scenes")
    views = poses.ring(ctx.traffic)
    cams = program_cameras(cfg, views)
    settings = RenderSettings(sh_order=cfg["sh_degree"])
    models = [torch.from_numpy(model_matrix(o)) for o in cfg["objects"]]
    mult = max(suggest_pair_multiplier(g, cams, settings, raster_config(cfg, 4.0), model=m, device=dev)[0]
               for g, m in zip(clouds, models))
    ctx.mark("pair budget")
    scene = [SplatObject(g, model=m, render_order=o["render_order"])
             for g, m, o in zip(clouds, models, cfg["objects"])]
    del clouds
    session = ViewerSession(scene, cams[0], settings, raster_config(cfg, mult), backend="cuda", device=dev)
    del scene
    order = poses.pass_order(ctx.traffic, ctx.seed)
    sample = set(random.Random(ctx.seed).sample(range(len(views)), ctx.traffic["check_frames"]))
    st = State(session, [torch.from_numpy(v) for v in views], order, sample, {})
    with torch.no_grad():
        for pose in order[1::-1]:  # the window opens on order[0], which must not be the cached frame
            session.frame(view=st.views[pose])
    ctx.mark("warm-up frames")
    return st


def reference_frames(config: dict, traffic: dict, seed: int, device, frame_poses, dtype=torch.float32,
                     least_poses=()) -> tuple[dict, list]:
    """The reference's frame of each pose of ``frame_poses`` (in ``dtype``),
    and for each pose of ``least_poses`` the least seconds of each stage
    (``counts.frame_least``) summed over the objects: every object's frame
    is a projection, a binning, a K1 and an untile of its own."""
    ras = ref.Raster.from_config(config)
    views = poses.ring(traffic)
    models = [model_matrix(o) for o in config["objects"]]
    parts = {pose: [] for pose in frame_poses}
    least = [dict.fromkeys(("project", "bin", "k1", "untile"), 0.0) for _ in least_poses]
    for i in range(len(models)):
        raw = scenes.outdoor_scene(config["n_splats"], object_seed(seed, i), device)
        g = {k: v.to(dtype) for k, v in ref.activate(raw).items()}
        del raw
        for pose in frame_poses:
            parts[pose].append(ref_multi.render_object(g, views[pose], models[i], ras))
        for out, pose in zip(least, least_poses):
            work = ref.Work()
            ref_multi.render_object(g, views[pose], models[i], ras, work=work)
            for stage, s in counts.frame_least(config["n_splats"], work, ras.width, ras.height, ras.tile_w,
                                               ras.tile_h, ras.sh_order).items():
                out[stage] += s
        del g
    orders = [o["render_order"] for o in config["objects"]]
    frames = {}
    for pose, frame_parts in parts.items():
        frames[pose] = ref_multi.under([frame_parts[i] for i in ref_multi.object_order(views[pose], models, orders)])
    return frames, least


def reference(ctx, out: dict, traced):
    frames, least = reference_frames(ctx.config, ctx.traffic, ctx.seed, ctx.device, sorted(out["frames"]),
                                     least_poses=traced or ())
    err = 0.0
    for pose, img in out["frames"].items():
        err = max(err, float((img.to(ctx.device) - frames[pose]).abs().max()))
    checks = [("img_max_err", err, ctx.traffic["limits"]["img_max_err"])]
    return checks, (least if traced is not None else None)
