"""Layers + clip demo — windy/siwin_layers_clip, offscreen.

Re-derives /root/reference/examples/windy_layers_clip.nim (the scene of the
reference's tightest golden, trender_layers_clip.nim:76-172): multi-root
ZLevel layers stacked around a shared z=0 plane, two containers — one
clipping via a true rounded sub-clip mask, one via the rect-mask fast path —
each with buttons that overflow and get cut, plus under/over layers proving
the z-order composition. The same scene drives tests/test_golden_layers.py
bit-exactly against the reference PNG; this demo animates the overflow a
little and writes examples/out/layers_clip.png.

Run: JAX_PLATFORMS=cpu python examples/layers_clip.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from figdraw_tpu import (
    Fig, FigFlags, FigKind, FigRenderer, fill, new_renders, rect, rgba, vec2,
)

W, H = 900, 560
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "out")


def _rect_fig(box, color, z, clip=False, rect_mask=False, corners=10):
    flags = FigFlags(0)
    if clip:
        flags |= FigFlags.NfClipContent
    if rect_mask:
        flags |= FigFlags.NfRectMaskContent
    return Fig(kind=FigKind.nkRectangle, zlevel=z, screen_box=box,
               fill=fill(color), corners=(corners,) * 4, flags=flags)


def make_scene(w, h, slide):
    bg = rgba(255, 255, 255, 255)
    container = rgba(208, 208, 208, 255)
    button = rgba(43, 159, 234, 255)
    under = rgba(234, 96, 43, 255)
    over = rgba(80, 200, 120, 255)

    cw, ch = w * 0.30, w * 0.40
    cy = h * 0.10
    clx, crx = w * 0.03, w * 0.50
    bx = cw * 0.10 + slide  # animated: buttons slide deeper into overflow
    bw, bh = cw * 1.30, ch * 0.20
    by1, by2, by3 = ch * 0.15, ch * 0.45, ch * 0.75

    renders = new_renders()
    renders.add_root(-20, _rect_fig(rect(0, 0, w, h), bg, -20, corners=0))

    # z=0: two containers, true sub-clip left, rect-mask fast path right
    left = renders.add_root(0, _rect_fig(rect(clx, cy, cw, ch), container, 0,
                                         clip=True))
    right = renders.add_root(0, _rect_fig(rect(crx, cy, cw, ch), container, 0,
                                          rect_mask=True))
    renders.add_child(0, left,
                      _rect_fig(rect(clx + bx, cy + by2, bw, bh), button, 0))
    renders.add_child(0, right,
                      _rect_fig(rect(crx + bx, cy + by2, bw, bh), button, 0))

    # z=-5 layer renders UNDER the containers; z=+5 renders over everything
    renders.add_root(-5, _rect_fig(rect(clx + bx, cy + by3, bw, bh), under, -5))
    renders.add_root(-5, _rect_fig(rect(crx + bx, cy + by3, bw, bh), under, -5))
    renders.add_root(5, _rect_fig(rect(clx + bx, cy + by1, bw, bh), over, 5))
    renders.add_root(5, _rect_fig(rect(crx + bx, cy + by1, bw, bh), over, 5))
    return renders


def main():
    ren = FigRenderer(atlas_size=128, use_pallas=True)
    frame = None
    for step in range(3):  # small slide animation; last frame is written
        frame = ren.render_frame(make_scene(W, H, slide=6.0 * step),
                                 vec2(W, H),
                                 clear_color=rgba(255, 255, 255, 255))
    os.makedirs(OUT, exist_ok=True)
    out_path = os.path.join(OUT, "layers_clip.png")
    from PIL import Image
    arr = np.asarray(frame)
    Image.fromarray((np.clip(arr, 0, 1) * 255).astype(np.uint8)).save(out_path)
    print(f"wrote {out_path}")


if __name__ == "__main__":
    main()
