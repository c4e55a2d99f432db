"""3D overlay sandwich: composite an externally rendered frame BETWEEN
scene layers — the runnable analog of the reference's raw-GL 3D demo
(/root/reference/examples/windy_3d_overlay.nim: GL pyramid drawn between
two figdraw passes). Here an overlay is any (H, W, 4) float array —
another JAX program's output, a plot, a video frame — composited
source-over at its zlevel boundary (FigRenderer.render_frame_with_overlays).

Renders a spinning shaded pyramid (tiny numpy rasterizer below) under a
translucent HUD layer, over a backdrop layer, and writes an animation
strip to out/overlay_3d_strip.png.

Run: python examples/overlay_3d.py            (GPU)
     JAX_PLATFORMS=cpu python examples/overlay_3d.py   (CPU)
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from figdraw_tpu import Fig, FigKind, fill, linear, rect, rgba, vec2
from figdraw_tpu.nodes import RenderList, new_renders
from figdraw_tpu.renderer import FigRenderer

W, H = 420, 300
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "out")


def rasterize_pyramid(w, h, t):
    """A minimal perspective rasterizer: 6 vertex-colored triangles (4
    sides + the base quad split in two) with a z-buffer, opaque over a
    dark clear color (the 'external 3D pass')."""
    verts = np.array([[-0.5, 0, -0.5], [0.5, 0, -0.5], [0.5, 0, 0.5],
                      [-0.5, 0, 0.5], [0.0, 0.8, 0.0]])
    colors = np.array([[1, 0.2, 0.2], [0.2, 1, 0.2], [0.2, 0.2, 1],
                       [1, 1, 0.2], [1, 0.2, 1.0]])
    tris = [(0, 1, 4), (1, 2, 4), (2, 3, 4), (3, 0, 4), (0, 1, 2), (2, 3, 0)]
    cy_, sy_ = np.cos(t), np.sin(t)
    rot = np.array([[cy_, 0, sy_], [0, 1, 0], [-sy_, 0, cy_]])
    v = verts @ rot.T
    eye = np.array([1.5, 1.2, 2.3])
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(fwd, [0, 1, 0]); right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    cam = (v - eye) @ np.stack([right, up, -fwd], axis=1)
    f = 1.0 / np.tan(np.radians(24))
    sx = (f * cam[:, 0] / -cam[:, 2] * h / w + 1) * 0.5 * w
    sy = (1 - f * cam[:, 1] / -cam[:, 2]) * 0.5 * h
    sz = -cam[:, 2]

    frame = np.empty((h, w, 4), np.float32)
    frame[..., :3] = (0.08, 0.10, 0.14)
    frame[..., 3] = 1.0
    zbuf = np.full((h, w), np.inf)
    yy, xx = np.mgrid[0:h, 0:w]
    px, py = xx + 0.5, yy + 0.5
    for ia, ib, ic in tris:
        area = ((sx[ib] - sx[ia]) * (sy[ic] - sy[ia])
                - (sy[ib] - sy[ia]) * (sx[ic] - sx[ia]))
        if abs(area) < 1e-12:
            continue
        w0 = ((sx[ib] - px) * (sy[ic] - py) - (sy[ib] - py) * (sx[ic] - px)) / area
        w1 = ((sx[ic] - px) * (sy[ia] - py) - (sy[ic] - py) * (sx[ia] - px)) / area
        w2 = 1.0 - w0 - w1
        z = w0 * sz[ia] + w1 * sz[ib] + w2 * sz[ic]
        hit = (w0 >= 0) & (w1 >= 0) & (w2 >= 0) & (z < zbuf)
        if not hit.any():
            continue
        for ch in range(3):
            attr = w0 * colors[ia, ch] + w1 * colors[ib, ch] + w2 * colors[ic, ch]
            frame[..., ch] = np.where(hit, attr, frame[..., ch])
        zbuf = np.where(hit, z, zbuf)
    return frame


def make_scene(w, h):
    """Backdrop below the overlay (zlevel -1), HUD above it (zlevel 0) —
    the overlay composites at boundary zlevel 0: after -1, before 0."""
    back = RenderList()
    back.add_root(Fig(kind=FigKind.nkRectangle, screen_box=rect(0, 0, w, h),
                      fill=linear(rgba(30, 34, 60, 255), rgba(8, 8, 16, 255))))
    hud = RenderList()
    hud.add_root(Fig(kind=FigKind.nkRectangle,
                     screen_box=rect(16, h - 72, w - 32, 56),
                     corners=(12, 12, 12, 12),
                     fill=fill(rgba(255, 255, 255, 48))))
    hud.add_root(Fig(kind=FigKind.nkRectangle,
                     screen_box=rect(24, h - 64, 150, 40),
                     corners=(8, 8, 8, 8),
                     fill=fill(rgba(70, 200, 140, 220))))
    r = new_renders()
    r.set_layer(-1, back)
    r.set_layer(0, hud)
    return r


def main():
    os.makedirs(OUT_DIR, exist_ok=True)
    from PIL import Image

    ren = FigRenderer(atlas_size=128, use_pallas=True)
    scene = make_scene(W, H)
    frames = []
    for i in range(6):
        pyramid = rasterize_pyramid(W, H, t=0.35 + i * 0.5)
        out = ren.render_frame_with_overlays(scene, vec2(W, H), {0: pyramid})
        frames.append((np.clip(np.asarray(out), 0, 1) * 255).astype(np.uint8))
    strip = np.concatenate(frames, axis=1)
    path = os.path.join(OUT_DIR, "overlay_3d_strip.png")
    Image.fromarray(strip).save(path)
    print("wrote", path, strip.shape)


if __name__ == "__main__":
    main()
