"""Offscreen demo: render showcase scenes to PNG files.

The engine's "window" is a frame sink — screenshots and streams
(SURVEY.md §7: windowing is out of scope; takeScreenshot semantics are
kept). Run: python examples/demo_scene.py [outdir]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
from PIL import Image

from figdraw_tpu import *
from figdraw_tpu.nodes import RenderList, drawable_bezier, drawable_arc
from figdraw_tpu.scenes import make_render_tree


def showcase(w, h):
    lst = RenderList()
    lst.add_root(Fig(kind=FigKind.nkRectangle, screen_box=rect(0, 0, w, h),
                     fill=fill(rgba(245, 246, 250, 255))))
    # card with drop shadow + gradient + elliptical corners
    lst.add_root(Fig(
        kind=FigKind.nkRectangle, screen_box=rect(40, 40, 260, 160),
        corners=(24, 24, 24, 24), corner_radii_y=(12, 12, 12, 12),
        flags=NfEllipticalCorners,
        fill=linear(rgba(80, 120, 255, 255), rgba(160, 80, 255, 255),
                    rgba(255, 120, 180, 255), axis=fgaDiagTLBR),
        stroke=RenderStroke(weight=2, fill=fill(rgba(30, 30, 60, 255))),
        shadows=(RenderShadow(style=DropShadow, blur=18, spread=2, x=8, y=10,
                              fill=fill(rgba(20, 30, 90, 110))),),
    ))
    # clip group with rotated child
    clip = lst.add_root(Fig(
        kind=FigKind.nkRectangle, screen_box=rect(340, 40, 220, 160),
        corners=(30, 30, 30, 30), flags=NfClipContent,
        fill=fill(rgba(255, 255, 255, 255)),
    ))
    lst.add_child(clip, Fig(
        kind=FigKind.nkRectangle, screen_box=rect(360, 20, 180, 200),
        rotation=20.0, fill=fill(rgba(255, 170, 40, 200)),
    ))
    # bezier + arc strokes
    lst.add_root(Fig(
        kind=FigKind.nkDrawable, screen_box=rect(40, 240, 520, 120),
        draw_stroke=RenderStroke(weight=6, fill=fill(rgba(20, 140, 90, 255))),
        draw_ops=(
            drawable_bezier([vec2(0, 100), vec2(130, -40), vec2(260, 140),
                             vec2(390, 10)]),
            drawable_arc(vec2(470, 60), 48.0, 0.6, 4.2),
        ),
    ))
    # dashed + dotted borders
    lst.add_root(fig_dashed_rounded_rect_border(
        rect(600, 50, 140, 90), (16, 16, 16, 16),
        fill(rgba(200, 60, 60, 255)), weight=4, dash_length=14, gap_length=9))
    lst.add_root(fig_dotted_rounded_rect_border(
        rect(600, 170, 140, 90), (16, 16, 16, 16),
        fill(rgba(60, 60, 200, 255)), weight=5, gap_length=7))
    # backdrop blur panel
    lst.add_root(Fig(kind=FigKind.nkBackdropBlur, screen_box=rect(180, 120, 260, 150),
                     corners=(20, 20, 20, 20),
                     fill=fill(rgba(255, 255, 255, 60)),
                     backdrop_blur=BackdropBlurStyle(blur=12.0)))
    r = new_renders()
    r.set_layer(0, lst)
    return r


def text_scene(w, h):
    from figdraw_tpu.text.layout import typeset
    from figdraw_tpu.text.typefaces import FigFont, load_typeface

    tid = load_typeface("DejaVuSans")
    title = FigFont(typeface_id=tid, size=34)
    body = FigFont(typeface_id=tid, size=18, underline=True)
    layout = typeset(vec2(w - 80, h - 80), [
        (title, fill(rgba(20, 20, 40, 255)), "figdraw_tpu\n"),
        (body, fill(rgba(90, 40, 160, 255)),
         "SDF scene graphs rasterized by Pallas tile kernels."),
    ])
    lst = RenderList()
    lst.add_root(Fig(kind=FigKind.nkRectangle, screen_box=rect(0, 0, w, h),
                     fill=fill(rgba(252, 250, 245, 255))))
    lst.add_root(Fig(kind=FigKind.nkText, screen_box=rect(40, 40, w - 80, h - 80),
                     text_layout=layout))
    r = new_renders()
    r.set_layer(0, lst)
    return r


def main():
    outdir = sys.argv[1] if len(sys.argv) > 1 else "out"
    os.makedirs(outdir, exist_ok=True)
    ren = FigRenderer(atlas_size=512)
    for name, scene, size in [
        ("showcase", showcase(780, 400), (780, 400)),
        ("boxes300", make_render_tree(1280, 720, frame=12), (1280, 720)),
        ("text", text_scene(640, 240), (640, 240)),
    ]:
        ren.render_frame(scene, vec2(*size))
        img = ren.take_screenshot()
        path = os.path.join(outdir, f"{name}.png")
        Image.fromarray(img).save(path)
        print("wrote", path, img.shape)


if __name__ == "__main__":
    main()
