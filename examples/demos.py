"""Demo gallery: offscreen ports of the reference's flagship example programs.

Four demos, each writing PNG(s) into examples/out/:

  renderlist100   the animated 300-box shadow scene as a PNG frame sequence
                  (/root/reference/examples/*_renderlist_100.nim)
  msdf_star       a star rendered through one SDF atlas entry at many scales
                  and stroke styles (siwin_msdf_star.nim)
  borders         dashed/dotted rounded-rect border variants
                  (siwin_dashed_dotted_borders.nim, drawutils.nim:343-422)
  replace_image   a procedurally animated "canvas" streamed into the atlas
                  via replace_image — the video/live-canvas path
                  (siwin_replace_image.nim, imgutils.nim:563-584)

Run: python examples/demos.py [demo ...]   (JAX_PLATFORMS=cpu for CPU)
"""

import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from figdraw_tpu import (
    Fig, FigKind, FigRenderer, MsdfImageStyle, fill, new_renders, rect, rgba,
    vec2,
)
from figdraw_tpu.basics import StrokeCap
from figdraw_tpu.borders import (
    fig_dashed_rounded_rect_border, fig_dotted_rounded_rect_border,
)
from figdraw_tpu.resources import ImageMessageBus, put_image, replace_image
from figdraw_tpu.utils.sdfgen import sdf_from_coverage

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "out")


def _save(ren, name):
    from PIL import Image

    os.makedirs(OUT, exist_ok=True)
    path = os.path.join(OUT, name)
    Image.fromarray(ren.take_screenshot()).save(path)
    print("wrote", path)


def demo_renderlist100(frames: int = 8, w: int = 640, h: int = 360) -> None:
    """The 300-box animated shadow demo as a frame sequence — the scene the
    reference shows at "120 FPS" (renderlist_100_common.nim:38-251)."""
    from figdraw_tpu.scenes import make_render_tree_array

    ren = FigRenderer(atlas_size=256)
    for f in range(frames):
        scene = make_render_tree_array(float(w), float(h), frame=f * 3, copies=100)
        ren.render_frame(scene, vec2(w, h))
        _save(ren, f"renderlist100_{f:02d}.png")


def _star_coverage(size: int = 96, points: int = 5, ss: int = 4) -> np.ndarray:
    """Supersampled coverage of a 5-point star (the msdf_star source shape)."""
    from PIL import Image, ImageDraw

    n = size * ss
    cx = cy = n / 2.0
    outer = n * 0.47
    inner = outer * 0.42
    verts = []
    for i in range(points * 2):
        r = outer if i % 2 == 0 else inner
        a = -math.pi / 2.0 + i * math.pi / points
        verts.append((cx + r * math.cos(a), cy + r * math.sin(a)))
    img = Image.new("L", (n, n), 0)
    ImageDraw.Draw(img).polygon(verts, fill=255)
    cov = np.asarray(img, np.float32) / 255.0
    return cov.reshape(size, ss, size, ss).mean(axis=(1, 3))


def demo_msdf_star(w: int = 640, h: int = 400) -> None:
    """One small SDF atlas entry scaled to many sizes, filled and annular —
    the scalable-vector-shape path (siwin_msdf_star.nim)."""
    bus = ImageMessageBus()
    star = sdf_from_coverage(_star_coverage(), px_range=8.0, pad=6)
    put_image(9101, star, bus=bus)

    ren = FigRenderer(atlas_size=256)
    ren.ensure_image_message_subscription(bus)
    renders = new_renders()
    renders.add_root(0, Fig(kind=FigKind.nkRectangle, screen_box=rect(0, 0, w, h),
                            fill=fill(rgba(18, 22, 34, 255))))
    x = 16.0
    for i, size in enumerate((28, 48, 80, 128, 196)):
        hue = [rgba(255, 196, 40, 255), rgba(80, 200, 255, 255),
               rgba(255, 110, 150, 255), rgba(150, 255, 150, 255),
               rgba(240, 240, 255, 255)][i]
        renders.add_root(0, Fig(
            kind=FigKind.nkMsdfImage,
            screen_box=rect(x, h / 2.0 - size / 2.0, size, size),
            msdf_image=MsdfImageStyle(id=9101, fill=fill(hue), px_range=8.0,
                                      stroke_weight=0.0 if i % 2 == 0 else 2.5),
        ))
        x += size + 14.0
    ren.render_frame(renders, vec2(w, h))
    _save(ren, "msdf_star.png")


def demo_borders(w: int = 700, h: int = 460) -> None:
    """The dashed/dotted border gallery (siwin_dashed_dotted_borders.nim):
    four corner-radius variants with dash/dot/offset/cap combinations."""
    ren = FigRenderer(atlas_size=128)
    renders = new_renders()
    renders.add_root(0, Fig(kind=FigKind.nkRectangle, screen_box=rect(0, 0, w, h),
                            fill=fill(rgba(246, 248, 252, 255))))
    gap, iw, ih = 26.0, (w - 3 * 26.0) / 2.0, (h - 3 * 26.0) / 2.0
    boxes = [
        (rect(gap, gap, iw, ih), (24,) * 4, rgba(235, 243, 255, 255)),
        (rect(w - gap - iw, gap, iw, ih), (34,) * 4, rgba(235, 248, 241, 255)),
        (rect(gap, h - gap - ih, iw, ih), (8, 34, 12, 26),
         rgba(255, 239, 246, 255)),
        (rect(w - gap - iw, h - gap - ih, iw, ih), (32, 10, 32, 10),
         rgba(255, 248, 228, 255)),
    ]
    for box, corners, color in boxes:
        renders.add_root(0, Fig(kind=FigKind.nkRectangle, screen_box=box,
                                corners=corners, fill=fill(color)))
    renders.add_root(0, fig_dashed_rounded_rect_border(
        boxes[0][0], boxes[0][1], fill(rgba(32, 96, 210, 255)), weight=5.0,
        dash_length=18.0, gap_length=10.0))
    renders.add_root(0, fig_dotted_rounded_rect_border(
        boxes[1][0], boxes[1][1], fill(rgba(35, 145, 82, 255)), weight=7.0,
        gap_length=8.0))
    renders.add_root(0, fig_dashed_rounded_rect_border(
        boxes[2][0], boxes[2][1], fill(rgba(210, 57, 120, 255)), weight=6.0,
        dash_length=26.0, gap_length=12.0, offset=16.0, cap=StrokeCap.scRound))
    renders.add_root(0, fig_dotted_rounded_rect_border(
        boxes[3][0], boxes[3][1], fill(rgba(176, 116, 20, 255)), weight=9.0,
        gap_length=11.0, offset=7.0))
    ren.render_frame(renders, vec2(w, h))
    _save(ren, "borders.png")


def _canvas_frame(t: float, size: int = 96) -> np.ndarray:
    """Procedural animated frame (the Pixie canvas stand-in)."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    r = 0.5 + 0.5 * np.sin(6.0 * xx + t * 2.0)
    g = 0.5 + 0.5 * np.sin(6.0 * yy - t * 1.5)
    b = 0.5 + 0.5 * np.sin(4.0 * (xx + yy) + t)
    img = np.stack([r, g, b, np.ones_like(r)], axis=-1)
    return (img * 255).astype(np.uint8)


def demo_replace_image(frames: int = 6, w: int = 360, h: int = 240) -> None:
    """Streaming a live image into the atlas: replace_image updates the same
    slot per frame (same dims → in-place patch upload, not a repack) and the
    renderer ships only the changed texels (imgutils.nim:563-584 analog)."""
    bus = ImageMessageBus()
    put_image(9201, _canvas_frame(0.0), bus=bus)

    ren = FigRenderer(atlas_size=256)
    ren.ensure_image_message_subscription(bus)
    from figdraw_tpu import image_style

    renders = new_renders()
    renders.add_root(0, Fig(kind=FigKind.nkRectangle, screen_box=rect(0, 0, w, h),
                            fill=fill(rgba(30, 30, 36, 255))))
    renders.add_root(0, Fig(kind=FigKind.nkImage, screen_box=rect(30, 30, 96, 96),
                            image=image_style(9201)))
    renders.add_root(0, Fig(kind=FigKind.nkImage,
                            screen_box=rect(160, 50, 140, 140),
                            image=image_style(9201)))
    for f in range(frames):
        replace_image(9201, _canvas_frame(f * 0.7), bus=bus)
        ren.render_frame(renders, vec2(w, h))
        if f:
            assert ren.atlas_upload_bytes < ren.atlas.data.nbytes, \
                "stream frame should patch, not re-upload the atlas"
        _save(ren, f"replace_image_{f:02d}.png")


DEMOS = {
    "renderlist100": demo_renderlist100,
    "msdf_star": demo_msdf_star,
    "borders": demo_borders,
    "replace_image": demo_replace_image,
}

if __name__ == "__main__":
    names = sys.argv[1:] or list(DEMOS)
    for name in names:
        DEMOS[name]()
