"""Retained-scene dashboard — O(edited quads) frame updates.

A grid of gauge bars snapshots to device once; every frame edits just a few
bars in place (RenderListArray.set_box/set_solid_color) and patches only
their quad rows into the HBM-resident tape via renderer.update_scene — the
retained-mode answer to the reference's walk-everything-per-frame model
(figrender.nim's per-frame renderRoot). Writes
examples/out/retained_dashboard.gif plus the final frame PNG.

Run: python examples/retained_dashboard.py          (GPU)
     JAX_PLATFORMS=cpu python examples/retained_dashboard.py   (CPU)
"""

import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from figdraw_tpu import Fig, FigKind, fill, new_renders, rect, rgba, vec2
from figdraw_tpu.nodesarray import from_renders
from figdraw_tpu.renderer import FigRenderer

W, H = 480, 300
COLS, ROWS = 12, 5
FRAMES = 40
DIRTY_PER_FRAME = 6
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "out")


def level_color(t):
    return rgba(int(60 + 180 * t), int(200 - 120 * t), 90, 235)


def counter_fig(font, value):
    from figdraw_tpu.text.layout import typeset

    return Fig(kind=FigKind.nkText, screen_box=rect(8, 4, 200, 24),
               text_layout=typeset(vec2(200, 24), [(
                   font, fill(rgba(235, 240, 250, 255)), f"tick {value}")]))


def build(font):
    renders = new_renders()
    renders.add_root(0, Fig(kind=FigKind.nkRectangle,
                            screen_box=rect(0, 0, W, H),
                            fill=fill(rgba(18, 22, 30, 255))))
    cw, ch = W / COLS, H / ROWS
    bars = []
    for i in range(COLS * ROWS):
        r, c = divmod(i, COLS)
        x, base = c * cw + 5, (r + 1) * ch - 6
        t = (i * 0.37) % 1.0
        hgt = 8 + t * (ch - 22)
        # well + bar: the bar root is the retained unit
        renders.add_root(0, Fig(kind=FigKind.nkRectangle,
                                screen_box=rect(x, r * ch + 8, cw - 10, ch - 14),
                                corners=(4,) * 4,
                                fill=fill(rgba(32, 38, 50, 255))))
        bars.append(renders.add_root(0, Fig(
            kind=FigKind.nkRectangle,
            screen_box=rect(x + 3, base - hgt, cw - 16, hgt),
            corners=(3,) * 4, fill=fill(level_color(t)))))
    # drawn last so it overlays the grid
    label = renders.add_root(0, counter_fig(font, 0))
    return from_renders(renders), bars, label


def main():
    from figdraw_tpu.text.typefaces import FigFont, load_typeface

    os.makedirs(OUT, exist_ok=True)
    tid = load_typeface("/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf")
    font = FigFont(typeface_id=tid, size=14.0)
    arr, bars, label = build(font)
    lst = arr[0]
    ren = FigRenderer(atlas_size=256, use_pallas=True)
    # pre-ensure every digit so label updates never rebuild the atlas
    probe = new_renders()
    probe.add_root(0, counter_fig(font, 1234567890))
    ren._ensure_packed_glyphs(from_renders(probe))
    # reserve rows so the growing "tick N" label patches in place
    scene = ren.snapshot_scene(arr, vec2(W, H),
                               reserve={(0, label): 16})
    assert scene.spans is not None, "retained spans unavailable (no C++ walk?)"

    ch = H / ROWS
    frames = []
    for f in range(FRAMES):
        dirty = []
        for k in range(DIRTY_PER_FRAME):
            i = (f * DIRTY_PER_FRAME + k) % len(bars)
            b = bars[i]
            r, c = divmod(i, COLS)
            t = 0.5 + 0.5 * math.sin(0.4 * f + i * 0.7)
            hgt = 8 + t * (ch - 22)
            x, _y, w, _h = (float(v) for v in lst.nodes[b]["box"])
            base = (r + 1) * ch - 6
            lst.set_box(b, x, base - hgt, w, hgt)
            lst.set_solid_color(b, level_color(t))
            dirty.append((0, b))
        # count-changing label update: rides the same patch (row reserve)
        lst.set_node(label, counter_fig(font, f + 1))
        dirty.append((0, label))
        ren.update_scene(scene, arr, dirty)
        frames.append(np.asarray(
            (np.clip(ren.render_view(scene), 0, 1) * 255).round()
        ).astype(np.uint8))

    from PIL import Image

    imgs = [Image.fromarray(fr) for fr in frames]
    imgs[0].save(os.path.join(OUT, "retained_dashboard.gif"), save_all=True,
                 append_images=imgs[1:], duration=50, loop=0)
    Image.fromarray(frames[-1]).save(
        os.path.join(OUT, "retained_dashboard.png"))
    print("wrote", os.path.join(OUT, "retained_dashboard.gif"))


if __name__ == "__main__":
    main()
