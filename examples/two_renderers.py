"""Two independent renderers demo — windy_two_windows, offscreen.

Re-derives /root/reference/examples/windy_two_windows.nim: two fully
independent render targets driven from one process — separate FigRenderer
instances (own atlas, own combo pools, own jit executor state), separate
scene graphs and palettes, different sizes and UI scales, rendered
interleaved for a few animation frames to prove nothing is shared
(windy_two_windows.nim DemoWindow: window+renderer+renders per target).
The offscreen analog of a second window is simply a second sink.
Writes examples/out/two_renderers_{a,b}.png.

Run: JAX_PLATFORMS=cpu python examples/two_renderers.py
"""

import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from figdraw_tpu import (
    Fig, FigKind, FigRenderer, RenderShadow, RenderStroke, ShadowStyle,
    fill, new_renders, rect, rgba, vec2,
)

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "out")


def make_scene(w, h, t, bg, card, accent):
    """The reference's panel+progress-bar scene, one palette per target."""
    renders = new_renders()
    root = renders.add_root(0, Fig(kind=FigKind.nkRectangle,
                                   screen_box=rect(0, 0, w, h), fill=fill(bg)))
    panel_w = min(420.0, max(220.0, w * 0.55))
    panel_h = min(280.0, max(170.0, h * 0.5))
    px, py = (w - panel_w) * 0.5, (h - panel_h) * 0.5
    renders.add_child(0, root, Fig(
        kind=FigKind.nkRectangle, screen_box=rect(px, py, panel_w, panel_h),
        fill=fill(card), corners=(18, 18, 18, 18),
        shadows=(RenderShadow(style=ShadowStyle.DropShadow, blur=18, x=0, y=8,
                              fill=fill(rgba(0, 0, 0, 70))),)))
    bar_w = panel_w * 0.75
    bar_x = px + (panel_w - bar_w) * 0.5
    bar_y = py + panel_h * 0.62
    renders.add_child(0, root, Fig(
        kind=FigKind.nkRectangle, screen_box=rect(bar_x, bar_y, bar_w, 26),
        fill=fill(rgba(0, 0, 0, 28)), corners=(13, 13, 13, 13)))
    frac = 0.5 + 0.5 * math.sin(t)
    renders.add_child(0, root, Fig(
        kind=FigKind.nkRectangle,
        screen_box=rect(bar_x, bar_y, max(26.0, bar_w * frac), 26),
        fill=fill(accent), corners=(13, 13, 13, 13)))
    # orbiting chip: per-target phase proves the scenes animate independently
    ox = px + panel_w * 0.5 + math.cos(t * 1.7) * panel_w * 0.32
    oy = py + panel_h * 0.32 + math.sin(t * 1.7) * panel_h * 0.18
    renders.add_child(0, root, Fig(
        kind=FigKind.nkRectangle, screen_box=rect(ox - 16, oy - 16, 32, 32),
        fill=fill(accent), corners=(16, 16, 16, 16),
        stroke=RenderStroke(weight=3.0, fill=fill(card))))
    return renders


def main():
    targets = [
        dict(name="a", w=640, h=420, phase=0.0,
             bg=rgba(24, 28, 44, 255), card=rgba(38, 44, 70, 255),
             accent=rgba(90, 200, 250, 255)),
        dict(name="b", w=520, h=360, phase=2.1,
             bg=rgba(248, 244, 236, 255), card=rgba(255, 255, 255, 255),
             accent=rgba(255, 120, 80, 255)),
    ]
    renderers = {t["name"]: FigRenderer(atlas_size=128, use_pallas=True)
                 for t in targets}
    frames = {}
    # interleave the two render loops, like the reference's single event loop
    # pumping both windows
    for step in range(4):
        for t in targets:
            ren = renderers[t["name"]]
            scene = make_scene(t["w"], t["h"], t["phase"] + step * 0.45,
                               t["bg"], t["card"], t["accent"])
            frames[t["name"]] = ren.render_frame(
                scene, vec2(t["w"], t["h"]), clear_color=t["bg"])
    os.makedirs(OUT, exist_ok=True)
    from PIL import Image
    for t in targets:
        arr = np.asarray(frames[t["name"]])
        path = os.path.join(OUT, f"two_renderers_{t['name']}.png")
        Image.fromarray((np.clip(arr, 0, 1) * 255).astype(np.uint8)).save(path)
        print(f"wrote {path}")


if __name__ == "__main__":
    main()
