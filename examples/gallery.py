"""Feature gallery: one frame exercising the whole framework surface.

Rounded rects with gradients and shadows, clip + rect masks, backdrop blur,
drawables (beziers/arcs/dashed borders), images with mips, MSDF scalables,
shaped text (ligatures, bidi, Arabic), and an external overlay layer.
Writes gallery.png.

Run: python examples/gallery.py  (JAX_PLATFORMS=cpu for CPU)
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from figdraw_tpu import (
    Fig, FigFlags, FigKind, FigRenderer, RenderShadow, RenderStroke,
    ShadowStyle, fgaX, fgaY, fill, linear, new_renders, rect, rgba, vec2,
)
from figdraw_tpu.basics import StrokeCap, StrokeJoin
from figdraw_tpu.borders import fig_dashed_rounded_rect_border
from figdraw_tpu.nodes import drawable_arc, drawable_bezier, drawable_circle
from figdraw_tpu.resources import ImageMessageBus, put_image
from figdraw_tpu.text.layout import typeset
from figdraw_tpu.text.typefaces import FigFont, load_typeface
from figdraw_tpu.utils.sdfgen import sdf_from_coverage

W, H = 760, 520


def main() -> None:
    bus = ImageMessageBus()
    ren = FigRenderer(atlas_size=1024)
    ren.ensure_image_message_subscription(bus)

    # a mipmapped checker image + a generated SDF badge
    yy, xx = np.mgrid[0:64, 0:64]
    checker = np.where(((xx // 8 + yy // 8) % 2)[..., None],
                       np.array([240, 120, 40, 255], np.uint8),
                       np.array([40, 80, 200, 255], np.uint8))
    put_image(7001, checker.astype(np.uint8), bus=bus, mipmapped=True)
    ring = (((xx - 32) ** 2 + (yy - 32) ** 2 < 26 ** 2)
            & ((xx - 32) ** 2 + (yy - 32) ** 2 > 14 ** 2)).astype(np.float32)
    put_image(7002, sdf_from_coverage(ring, px_range=4.0, pad=4), bus=bus)
    ren.process_image_messages()

    tid = load_typeface("/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf")
    ink = fill(rgba(25, 28, 40, 255))
    renders = new_renders()
    renders.add_root(0, Fig(kind=FigKind.nkRectangle, screen_box=rect(0, 0, W, H),
                            fill=linear(rgba(244, 246, 252, 255),
                                        rgba(226, 232, 244, 255), axis=fgaY)))

    # card with gradient, stroke, drop shadow, rounded corners
    renders.add_root(0, Fig(
        kind=FigKind.nkRectangle, screen_box=rect(24, 24, 210, 130),
        corners=(16, 16, 16, 16),
        fill=linear(rgba(70, 130, 255, 255), rgba(170, 80, 255, 255), axis=fgaX),
        stroke=RenderStroke(weight=2.0, fill=fill(rgba(30, 30, 60, 255))),
        shadows=(RenderShadow(style=ShadowStyle.DropShadow, blur=14, spread=2,
                              x=4, y=8, fill=fill(rgba(40, 40, 90, 90))),),
    ))

    # clip mask: rotated stripes clipped to a rounded cell
    clip = renders.add_root(0, Fig(
        kind=FigKind.nkRectangle, screen_box=rect(260, 24, 150, 130),
        corners=(20, 20, 20, 20), flags=FigFlags.NfClipContent,
        fill=fill(rgba(255, 255, 255, 255)),
    ))
    for i in range(6):
        renders.add_child(0, clip, Fig(
            kind=FigKind.nkRectangle, screen_box=rect(240 + i * 32, 0, 14, 260),
            fill=fill(rgba(90 + i * 25, 140, 220 - i * 20, 230)), rotation=18.0,
        ))

    # backdrop blur pill over the stripes
    renders.add_root(0, Fig(
        kind=FigKind.nkBackdropBlur, screen_box=rect(282, 60, 106, 58),
        corners=(29, 29, 29, 29), fill=fill(rgba(255, 255, 255, 70)),
    ))

    # drawables: bezier ribbon, arc, circle, dashed border
    renders.add_root(0, Fig(
        kind=FigKind.nkDrawable, screen_box=rect(430, 24, 300, 130),
        draw_stroke=RenderStroke(weight=7.0, fill=linear(
            rgba(230, 90, 40, 255), rgba(240, 190, 60, 255), axis=fgaX),
            cap=StrokeCap.scRound, join=StrokeJoin.sjRound),
        draw_ops=(
            drawable_bezier([vec2(6, 110), vec2(80, -30), vec2(190, 150),
                             vec2(290, 20)]),
            drawable_arc(vec2(60, 80), 34.0, 0.6, 4.2),
        ),
    ))
    circle_fig = Fig(
        kind=FigKind.nkDrawable, screen_box=rect(430, 24, 300, 130),
        fill=fill(rgba(110, 200, 140, 160)),
        draw_stroke=RenderStroke(weight=3.0, fill=fill(rgba(20, 90, 50, 255))),
        draw_ops=(drawable_circle(vec2(240, 85), 30.0),),
    )
    renders.add_root(0, circle_fig)
    renders.add_root(0, fig_dashed_rounded_rect_border(
        rect(430, 24, 300, 130), (14, 14, 14, 14), fill(rgba(60, 70, 110, 180)),
        weight=2.0, dash_length=10.0, gap_length=7.0))

    # images: mipmapped checker at native + minified, SDF badge scaled up
    from figdraw_tpu import image_style
    renders.add_root(0, Fig(kind=FigKind.nkImage, screen_box=rect(30, 190, 64, 64),
                            image=image_style(7001)))
    renders.add_root(0, Fig(kind=FigKind.nkImage, screen_box=rect(106, 222, 32, 32),
                            image=image_style(7001)))
    from figdraw_tpu import MsdfImageStyle
    renders.add_root(0, Fig(
        kind=FigKind.nkMsdfImage, screen_box=rect(160, 180, 84, 84),
        msdf_image=MsdfImageStyle(id=7002, fill=fill(rgba(200, 60, 120, 255)),
                                  px_range=4.0),
    ))

    # text block: ligatures, kerning, bidi, arabic
    y = 300.0
    for text, size in (
        ("Offline waffle efficiency — AV To", 22),
        ("bidi: abc שלום 123 (חשוב) def", 20),
        ("البسملة: بِسْمِ اللَّهِ الرَّحْمَٰنِ الرَّحِيمِ", 22),
    ):
        f = FigFont(typeface_id=tid, size=float(size))
        arr = typeset(vec2(W - 60, 34), [(f, ink, text)])
        renders.add_root(1, Fig(kind=FigKind.nkText,
                                screen_box=rect(30, y, W - 60, 34),
                                text_layout=arr))
        y += 40.0

    # selection + underline demo
    f = FigFont(typeface_id=tid, size=20.0, underline=True)
    arr = typeset(vec2(W - 60, 30), [(f, fill(rgba(120, 40, 40, 255)),
                                      "selected & underlined")])
    renders.add_root(1, Fig(
        kind=FigKind.nkText, screen_box=rect(30, y, W - 60, 30),
        text_layout=arr, flags=FigFlags.NfSelectText, selection_range=(3, 10),
        fill=fill(rgba(120, 170, 255, 110)),
    ))

    # external overlay ribbon between z=1 and nothing above
    gy, gx = np.mgrid[0:H, 0:W].astype(np.float32)
    ribbon = np.zeros((H, W, 4), np.float32)
    band = np.exp(-(((gx + gy) - 1050.0) / 70.0) ** 2)
    ribbon[..., 0], ribbon[..., 1], ribbon[..., 2] = 0.15, 0.45, 1.0
    ribbon[..., 3] = 0.22 * band

    frame = np.asarray(
        ren.render_frame_with_overlays(renders, vec2(W, H), {2: ribbon})
    )
    from PIL import Image

    out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "gallery.png")
    Image.fromarray((np.clip(frame, 0, 1) * 255).astype(np.uint8)).save(out)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
