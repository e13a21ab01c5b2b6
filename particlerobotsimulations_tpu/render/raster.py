"""Headless scene rasterizer.

Replaces the reference's OpenGL point-sprite renderer + immediate-mode scene
(/root/reference/render.cpp, shaders.cpp, main.cpp:387-461) with a headless
top-down orthographic rasterizer: accelerator hosts have no display, and the
top-down view is what the paper's figures show anyway (the reference's 3-D
camera is a presentation nicety).  Deviations are documented here:

* view: orthographic top-down; the camera maps to a square window centered
  on (camera_x, 0) with half-extent ``camera_y`` (the reference's eye height
  doubles as scene scale, main.cpp:849/868).
* bots: filled disks colored by the reference color law (ops/color.py);
  payload/dead bots black, exactly like updateCol_k.
* light: yellow disk of ``light_radius``; obstacles gray; centroid trail
  red dots of ``centroid_radius`` (colors from particlebot.cpp:131-140 and
  main.cpp:418-457).

A native C++ splatting path (native/libpbot_render.so, see render/native.py)
is used when built; this numpy fallback is exact but slower.
"""

from __future__ import annotations

import numpy as np

from ..config import SimParams
from . import native


def view_window(params: SimParams):
    """(cx, cy, half_extent) of the rendered world window."""
    return params.camera_x, 0.0, max(params.camera_y, 1.0)


BACKGROUND = np.array([25, 25, 30], np.uint8)
GROUND = np.array([60, 60, 70], np.uint8)
OBSTACLE = np.array([150, 150, 150], np.uint8)
LIGHT = np.array([255, 230, 60], np.uint8)
TRAIL = np.array([255, 0, 0], np.uint8)


def _splat_disks_numpy(img, xs, ys, rs, colors):
    """Paint filled disks (pixel coords, radius in pixels)."""
    h, w, _ = img.shape
    for x, y, r, col in zip(xs, ys, rs, colors):
        if r <= 0:
            continue
        x0, x1 = int(max(0, np.floor(x - r))), int(min(w - 1, np.ceil(x + r)))
        y0, y1 = int(max(0, np.floor(y - r))), int(min(h - 1, np.ceil(y + r)))
        if x1 < x0 or y1 < y0:
            continue
        yy, xx = np.mgrid[y0 : y1 + 1, x0 : x1 + 1]
        m = (xx - x) ** 2 + (yy - y) ** 2 <= r * r
        img[y0 : y1 + 1, x0 : x1 + 1][m] = col


def _splat(img, xs, ys, rs, colors):
    """Paint filled disks via the native library when available."""
    xs = np.ascontiguousarray(xs, np.float32)
    ys = np.ascontiguousarray(ys, np.float32)
    rs = np.ascontiguousarray(rs, np.float32)
    colors = np.ascontiguousarray(colors, np.uint8).reshape(-1, 3)
    if native.available():
        native.splat_disks(img, xs, ys, rs, colors)
    else:
        _splat_disks_numpy(img, xs, ys, rs, colors)


def render_frame(
    params: SimParams,
    pos: np.ndarray,          # (n, 2) active bots
    rad: np.ndarray,          # (n,)
    colors: np.ndarray,       # (n, 4) float RGBA in [0,1]
    centroid_trail: np.ndarray | None = None,  # (k, 2) world coords
    width: int = 960,
    height: int = 540,
) -> np.ndarray:
    """-> (height, width, 3) uint8 RGB frame."""
    cx, cy, half = view_window(params)
    # preserve aspect: half extent applies to the shorter axis
    sh = half * height / min(width, height)
    sw = half * width / min(width, height)
    scale = height / (2 * sh)

    def to_px(wx, wy):
        return (
            (np.asarray(wx) - (cx - sw)) * scale,
            (np.asarray(wy) - (cy - sh)) * scale,
        )

    img = np.empty((height, width, 3), np.uint8)
    img[:] = GROUND

    # obstacles
    for x1, x2, y1, y2 in params.rect_obstacles:
        px0, py0 = to_px(x1, y1)
        px1, py1 = to_px(x2, y2)
        # skip rects entirely outside the view: clipping both edges to the
        # same border would otherwise paint a 1-px stripe on the frame edge
        if max(px0, px1) < 0 or min(px0, px1) >= width:
            continue
        if max(py0, py1) < 0 or min(py0, py1) >= height:
            continue
        xa, xb = int(np.clip(px0, 0, width)), int(np.clip(px1, 0, width))
        ya, yb = int(np.clip(py0, 0, height)), int(np.clip(py1, 0, height))
        img[min(ya, yb) : max(ya, yb) + 1, min(xa, xb) : max(xa, xb) + 1] = OBSTACLE

    disks_x, disks_y, disks_r, disks_c = [], [], [], []
    for ox, oy, orad in params.circle_obstacles:
        px, py = to_px(ox, oy)
        disks_x.append(float(px))
        disks_y.append(float(py))
        disks_r.append(orad * scale)
        disks_c.append(OBSTACLE)

    # light
    lx, ly = to_px(params.light_x, params.light_y)
    disks_x.append(float(lx))
    disks_y.append(float(ly))
    disks_r.append(max(params.light_radius * scale, 2.0))
    disks_c.append(LIGHT)

    # centroid trail (reference: red dots, particlebot.cpp:131-140)
    if centroid_trail is not None and len(centroid_trail):
        tx, ty = to_px(centroid_trail[:, 0], centroid_trail[:, 1])
        r = max(params.centroid_radius * scale, 1.0)
        for x, y in zip(tx, ty):
            disks_x.append(float(x))
            disks_y.append(float(y))
            disks_r.append(r)
            disks_c.append(TRAIL)

    # bots
    bx, by = to_px(pos[:, 0], pos[:, 1])
    bcol = (np.clip(colors[:, :3], 0, 1) * 255).astype(np.uint8)
    disks_x.extend(bx.tolist())
    disks_y.extend(by.tolist())
    disks_r.extend((rad * scale).tolist())
    disks_c.extend(list(bcol))

    xs = np.asarray(disks_x, np.float32)
    ys = np.asarray(disks_y, np.float32)
    rs = np.asarray(disks_r, np.float32)
    cs = np.asarray(disks_c, np.uint8).reshape(-1, 3)

    if native.available():
        native.splat_disks(img, xs, ys, rs, cs)
    else:
        _splat_disks_numpy(img, xs, ys, rs, cs)
    # image y axis points down; world y up -> flip
    return img[::-1]
