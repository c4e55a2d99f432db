"""Offline animation export via FigRenderer.render_batch.

Renders a bouncing-cards animation in chunked single-dispatch batches (one
stacked upload + one lax.map program per chunk — the offline
rendering path; see docs/architecture.md "Batched offline rendering") and
writes out/animation.gif plus a film-strip PNG of every 4th frame.

Run: python examples/animation.py            (GPU)
     JAX_PLATFORMS=cpu python examples/animation.py   (CPU)
"""

import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from figdraw_tpu import (
    Fig, FigFlags, FigKind, fill, new_renders, rect, rgba, vec2,
)
from figdraw_tpu.basics import ShadowStyle
from figdraw_tpu.nodes import RenderShadow
from figdraw_tpu.nodesarray import from_renders
from figdraw_tpu.renderer import FigRenderer

W, H = 480, 270
FRAMES = 48
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "out")


def scene(f):
    t = f / FRAMES * 2 * math.pi
    renders = new_renders()
    renders.add_root(0, Fig(kind=FigKind.nkRectangle,
                            screen_box=rect(0, 0, W, H),
                            fill=fill(rgba(24, 26, 34, 255))))
    for i in range(9):
        ph = t + i * 0.7
        x = 30 + i * 46 + 12 * math.sin(ph * 2)
        y = 110 + 70 * math.sin(ph)
        card = renders.add_root(0, Fig(
            kind=FigKind.nkRectangle,
            screen_box=rect(x, y, 40, 54),
            corners=(8, 8, 8, 8), flags=FigFlags.NfClipContent,
            rotation=14 * math.sin(ph + 1.0),
            fill=fill(rgba(40 + i * 22, 120, 230 - i * 18, 235)),
            shadows=(RenderShadow(style=ShadowStyle.DropShadow, blur=10.0,
                                  x=0, y=5, fill=fill(rgba(0, 0, 0, 140))),),
        ))
        renders.add_child(0, card, Fig(
            kind=FigKind.nkRectangle, screen_box=rect(-10, 34, 70, 30),
            rotation=-18.0, fill=fill(rgba(255, 255, 255, 70)),
        ))
    # sweeping highlight bar
    renders.add_root(0, Fig(
        kind=FigKind.nkRectangle,
        screen_box=rect(40 + 320 * (0.5 + 0.5 * math.sin(t)), 16, 70, 28),
        corners=(14, 14, 14, 14),
        fill=fill(rgba(255, 210, 80, 200)),
    ))
    return from_renders(renders)


def main():
    os.makedirs(OUT_DIR, exist_ok=True)
    renderer = FigRenderer(atlas_size=128, use_pallas=True)
    # as_uint8 quantizes on device: the readback ships 4x fewer bytes
    frames = np.asarray(renderer.render_batch(
        (scene(f) for f in range(FRAMES)), vec2(W, H), as_uint8=True
    ))

    from PIL import Image

    imgs = [Image.fromarray(frames[f]) for f in range(FRAMES)]
    gif = os.path.join(OUT_DIR, "animation.gif")
    imgs[0].save(gif, save_all=True, append_images=imgs[1:], duration=33,
                 loop=0)

    strip = np.concatenate([frames[f] for f in range(0, FRAMES, 8)], axis=1)
    Image.fromarray(strip).save(os.path.join(OUT_DIR, "animation_strip.png"))
    print(f"wrote {gif} and animation_strip.png ({FRAMES} frames {W}x{H})")


if __name__ == "__main__":
    main()
