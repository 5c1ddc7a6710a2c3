"""Camera poses of a traffic mix: views on a horizontal ring, as 4x4
world->view matrices (right-handed, the camera looks down +Z, y up; the
port's and the reference's convention).  The harness makes them and hands
the same matrices to the program and to the reference."""

from __future__ import annotations

import math

import numpy as np


def look_at(eye, target, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """(4, 4) float32 world->view matrix of a camera at ``eye`` looking at
    ``target``."""
    eye, target, up = (np.asarray(v, np.float32) for v in (eye, target, up))
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(up, fwd)
    right = right / np.linalg.norm(right)
    rot = np.stack([right, np.cross(fwd, right), fwd])
    view = np.eye(4, dtype=np.float32)
    view[:3, :3] = rot
    view[:3, 3] = -rot @ eye
    return view


def ring(traffic: dict) -> list[np.ndarray]:
    """The traffic's ring of views, pose ``i`` at ``i * step_deg`` about the
    up axis from the ``start_eye`` direction (angle 0 is the eye at
    ``(0, height, -radius)``)."""
    r, h = traffic["radius"], traffic["height"]
    views = []
    for i in range(traffic["poses"]):
        a = math.radians(i * traffic["step_deg"])
        views.append(look_at([r * math.sin(a), h, -r * math.cos(a)], traffic["target"]))
    return views


def pass_order(traffic: dict, seed: int) -> list[int]:
    """One pass over the ring: every pose once, in ring order, from a start
    pose drawn from ``seed``.  Every seed gives the same set of poses."""
    n = traffic["poses"]
    start = int(seed) % n
    return [(start + i) % n for i in range(n)]
