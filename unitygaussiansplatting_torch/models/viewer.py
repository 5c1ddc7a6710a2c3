"""Interactive-viewer frame loop that reuses identical frames.

The reference amortizes sorting across frames with ``m_SortNthFrame``
(GaussianSplatRenderer.cs:238-239: sort every Nth frame and keep a stale
depth order in between).  That trick has no sound analog here: the pair
set and the compositing order come from one fused key sort
(``ops.pair_expand.bin_and_prepare``) whose sorted fields carry absolute
pixel geometry, so reusing any stale part reproduces the stale *image*, not
a fresh image in a stale order.

What frame coherence does buy is reuse that keeps the image exact: an idle
camera renders the same frame again, and a viewer spends most of its time
idle.  :class:`ViewerSession` keeps the last frame, keyed on the pose and
the display settings, and hands it back without touching the card; any
change of pose, settings or scene renders a fresh frame through
:func:`render`.

A session may also hold a scene of several objects (:class:`SplatObject`:
a cloud, its object->world matrix and its render order, one
``GaussianSplatRenderer`` of the reference each); a fresh frame of such a
scene renders through :func:`render_multi`, with the same memo.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.profiler import record_function

from ..utils.config import RasterizeConfig, RenderSettings
from ..utils.device import resolve_device
from .camera import Camera
from .renderer import render, render_multi


@dataclasses.dataclass(frozen=True)
class SplatObject:
    """One object of a viewer's scene: a cloud (``Gaussians`` or
    ``DeviceAsset``), its (4, 4) object->world ``model`` matrix (None: the
    identity) and its ``render_order`` (higher in front), as a
    ``GaussianSplatRenderer`` of the reference holds them
    (GaussianSplatRenderer.cs:215-251)."""

    gaussians: object
    model: torch.Tensor | None = None
    render_order: float = 0.0


@dataclasses.dataclass
class ViewerStats:
    frames: int = 0
    rendered: int = 0
    reused: int = 0


class ViewerSession:
    """Viewer-style frame loop with a one-frame memo.

    >>> sess = ViewerSession(gaussians, base_camera)
    >>> img = sess.frame(view=cam.view)                   # full render
    >>> img = sess.frame(view=cam.view)                   # cache hit, free
    >>> img = sess.frame(view=cam2.view, opacity_scale=2) # full render
    >>> scene = [SplatObject(g1), SplatObject(g2, model=m2, render_order=1.0)]
    >>> multi = ViewerSession(scene, base_camera)         # render_multi frames

    The memo's key is the float32 bytes of ``view``, ``splat_scale`` and
    ``opacity_scale``: reading a 4x4 view that lives on the card is one
    64-byte copy to the host, a synchronization, each frame.  A hit returns
    the same tensor object and launches nothing.  Frames render on
    ``device`` (CUDA unless told otherwise); ``backend`` defaults to
    ``"cuda"``, the JAX package's ``"pallas"``.

    ``gaussians`` is one cloud, rendered by :func:`render`, or a list of
    :class:`SplatObject`, rendered by :func:`render_multi` with the session's
    settings for every object.  The objects' model matrices are moved to
    ``device`` once, so that a frame uploads nothing but its view.
    """

    def __init__(
        self,
        gaussians,
        camera: Camera,
        settings: RenderSettings = RenderSettings(),
        config: RasterizeConfig = RasterizeConfig(),
        backend: str = "cuda",
        device=None,
    ):
        self._device = device
        self._g = self._scene(gaussians)
        self._camera = camera
        self._settings = settings
        self._config = config
        self._backend = backend
        self.stats = ViewerStats()
        self._cache_key: bytes | None = None
        self._cache_img: torch.Tensor | None = None

    def _scene(self, gaussians):
        """One cloud as it is; a list of objects with their model matrices
        as float32 on the session's device."""
        if not isinstance(gaussians, (list, tuple)):
            return gaussians
        dev = resolve_device(self._device)
        return [dataclasses.replace(o, model=None if o.model is None
                                    else torch.as_tensor(o.model, dtype=torch.float32).to(dev))
                for o in gaussians]

    @staticmethod
    def _key(view, splat_scale, opacity_scale) -> bytes:
        view = view.detach().to("cpu", torch.float32) if isinstance(view, torch.Tensor) else view
        return (
            np.asarray(view, np.float32).tobytes()
            + np.float32(splat_scale).tobytes()
            + np.float32(opacity_scale).tobytes()
        )

    def frame(self, view=None, splat_scale: float = 1.0, opacity_scale: float = 1.0) -> torch.Tensor:
        """Render (or reuse) the frame for this pose and display settings.

        The whole call, a memo hit too, is the ``splat_frame`` profiler range.
        """
        with record_function("splat_frame"):
            view = self._camera.view if view is None else view
            self.stats.frames += 1
            key = self._key(view, splat_scale, opacity_scale)
            if key == self._cache_key and self._cache_img is not None:
                self.stats.reused += 1
                return self._cache_img
            # The scales enter as float32, as the JAX package's traced scalars do.
            cam = dataclasses.replace(self._camera, view=torch.as_tensor(view, dtype=torch.float32))
            settings = dataclasses.replace(
                self._settings,
                splat_scale=float(np.float32(splat_scale)),
                opacity_scale=float(np.float32(opacity_scale)),
            )
            if isinstance(self._g, list):
                img = render_multi([o.gaussians for o in self._g], cam, [settings] * len(self._g), self._config,
                                   self._backend, render_order=[o.render_order for o in self._g],
                                   models=[o.model for o in self._g], device=self._device)
            else:
                img = render(self._g, cam, settings, self._config, self._backend, device=self._device)
            self.stats.rendered += 1
            self._cache_key = key
            self._cache_img = img
            return img

    def invalidate(self) -> None:
        """Drop the frame cache (call after editing the splat cloud)."""
        self._cache_key = None
        self._cache_img = None

    def update_gaussians(self, gaussians) -> None:
        """Swap the scene (edits/training step): one cloud or a list of
        :class:`SplatObject`; invalidates the cache."""
        self._g = self._scene(gaussians)
        self.invalidate()
