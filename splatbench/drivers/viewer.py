"""A viewer looking around a scene: one client asks the program's
``models/viewer.ViewerSession.frame`` for a new pose every frame and waits
for it (a synchronize), as a viewer presents a frame before the next.

The scene is the configuration's cloud, float32 or, with ``storage:
medium``, the Medium ``DeviceAsset`` that ``io/device_asset.encode_device``
makes of it (the float cloud is freed before the window, so the cell holds
what a viewer of the asset holds; the frame decodes it every time).  The
check: the frames of poses drawn from the seed, kept as the window produced
them, against ``reference.render`` of the same cloud (through the
reference's own Medium encode and decode for an asset).
"""

from __future__ import annotations

import dataclasses
import math
import random

import torch

from .. import counts, poses, scenes
from ..reference import asset as ref_asset
from ..reference import render as ref

UNIT = "frame"


def raster_config(config: dict, pair_multiplier: float):
    """The program's ``RasterizeConfig`` for the configuration's raster keys."""
    from unitygaussiansplatting_torch.utils.config import RasterizeConfig

    r = ref.Raster.from_config(config)
    return RasterizeConfig(tile_w=r.tile_w, tile_h=r.tile_h, chunk_size=r.chunk,
                           transmittance_eps=r.transmittance_eps, alpha_discard=r.alpha_discard,
                           alpha_max=r.alpha_max, quad_clip=r.quad_clip, pack_color_f16=r.color_f16,
                           pair_multiplier=pair_multiplier)


def program_cameras(config: dict, views):
    from unitygaussiansplatting_torch.models.camera import Camera

    return [Camera(view=torch.from_numpy(v), fov_y=math.radians(config["fov_y_deg"]), width=config["width"],
                   height=config["height"]) for v in views]


def pair_multiplier(scene, cams, config: dict, device) -> float:
    """The pair budget for the traffic's worst view, by the program's own
    ``suggest_pair_multiplier`` (its default slack, 1.2)."""
    from unitygaussiansplatting_torch.models.renderer import suggest_pair_multiplier
    from unitygaussiansplatting_torch.utils.config import RenderSettings

    mult, _ = suggest_pair_multiplier(scene, cams, RenderSettings(sh_order=config["sh_degree"]),
                                      raster_config(config, 4.0), device=device)
    return mult


def medium_formats(config: dict):
    from unitygaussiansplatting_torch.io import formats as F

    f = config["formats"]
    return dict(pos_format=F.VectorFormat[f["position"]], scale_format=F.VectorFormat[f["scale"]],
                color_format=F.ColorFormat[f["color"]], sh_format=F.SHFormat[f["sh"]])


@dataclasses.dataclass
class State:
    session: object
    views: list
    order: list
    sample: set
    kept: dict


def setup(ctx) -> State:
    from unitygaussiansplatting_torch.io.device_asset import encode_device
    from unitygaussiansplatting_torch.models.gaussians import RawGaussians
    from unitygaussiansplatting_torch.models.viewer import ViewerSession
    from unitygaussiansplatting_torch.utils.config import RenderSettings

    cfg, dev = ctx.config, ctx.device
    with torch.no_grad():
        scene = RawGaussians(**scenes.outdoor_scene(cfg["n_splats"], ctx.seed, dev)).activate()
        ctx.mark("scene")
        if cfg["storage"] == "medium":
            scene = encode_device(scene, device=dev, **medium_formats(cfg))
            ctx.mark("asset encoded")
    views = poses.ring(ctx.traffic)
    cams = program_cameras(cfg, views)
    mult = pair_multiplier(scene, cams, cfg, dev)
    ctx.mark("pair budget")
    session = ViewerSession(scene, cams[0], RenderSettings(sh_order=cfg["sh_degree"]), raster_config(cfg, mult),
                            backend="cuda", device=dev)
    order = poses.pass_order(ctx.traffic, ctx.seed)
    sample = set(random.Random(ctx.seed).sample(range(len(views)), ctx.traffic["check_frames"]))
    st = State(session, [torch.from_numpy(v) for v in views], order, sample, {})
    with torch.no_grad():
        for pose in order[1::-1]:  # the window opens on order[0], which must not be the cached frame
            session.frame(view=st.views[pose])
    ctx.mark("warm-up frames")
    return st


def pass_units(ctx, st: State) -> list:
    return st.order


def run_unit(ctx, st: State, pose) -> None:
    with torch.no_grad():
        img = st.session.frame(view=st.views[pose])
    if pose in st.sample and pose not in st.kept:
        st.kept[pose] = img


def trace_units(ctx, st: State) -> list:
    return list(ctx.traffic["trace_poses"])


def before_trace(ctx, st: State) -> None:
    st.session.invalidate()  # a traced frame must render, whatever the window showed last


def release(ctx, st: State) -> dict:
    kept = {pose: img.cpu() for pose, img in st.kept.items()}
    st.session = None
    st.kept.clear()
    return {"frames": kept}


def reference(ctx, out: dict, traced):
    cfg, dev = ctx.config, ctx.device
    ras = ref.Raster.from_config(cfg)
    views = poses.ring(ctx.traffic)
    raw = scenes.outdoor_scene(cfg["n_splats"], ctx.seed, dev)
    g = ref.activate(raw)
    del raw
    asset_bytes = None
    if cfg["storage"] == "medium":
        g = ref_asset.decode(ref_asset.encode(g))
        asset_bytes = ref_asset.asset_bytes(cfg["n_splats"])
    err = 0.0
    for pose, img in sorted(out["frames"].items()):
        want = ref.render(g, views[pose], ras)
        err = max(err, float((img.to(dev) - want).abs().max()))
        del want
    checks = [("img_max_err", err, ctx.traffic["limits"]["img_max_err"])]
    least = None
    if traced is not None:
        least = []
        for pose in traced:
            work = ref.Work()
            ref.render(g, views[pose], ras, work=work)
            least.append(counts.frame_least(cfg["n_splats"], work, ras.width, ras.height, ras.tile_w, ras.tile_h,
                                            ras.sh_order, asset_bytes))
    return checks, least
