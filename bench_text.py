"""Text-heavy frame benchmark: 36 lines / ~2300 glyphs at 1200x800.

The reference's windy_text demo class of workload. Measures the production
path: cached typeset layouts, packed glyph rows, the native C++ walk and the
Pallas rasterizer with in-kernel 1:1 atlas sampling. Prints one JSON line.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

WARMUP = int(os.environ.get("FIGDRAW_BENCH_WARMUP", "5"))
FRAMES = int(os.environ.get("FIGDRAW_BENCH_FRAMES", "30"))
W, H = 1200, 800
LINES = 36


def build_scene(tid, ink, seed: int):
    from figdraw_tpu import Fig, FigKind, fill, new_renders, rect, rgba, vec2
    from figdraw_tpu.nodesarray import from_renders
    from figdraw_tpu.text.layout import typeset_cached
    from figdraw_tpu.text.typefaces import FigFont

    renders = new_renders()
    renders.add_root(0, Fig(kind=FigKind.nkRectangle, screen_box=rect(0, 0, W, H),
                            fill=fill(rgba(250, 250, 250, 255))))
    y = 4.0
    n = 0
    for row in range(LINES):
        f = FigFont(typeface_id=tid, size=15.0)
        arr = typeset_cached(vec2(W - 20, 22), [(
            f, ink,
            "The quick brown fox jumps over the lazy dog near the riverbank %d"
            % (seed + row),
        )])
        n += len(arr.arranged_glyphs)
        renders.add_root(0, Fig(kind=FigKind.nkText,
                                screen_box=rect(8, y, W - 20, 22),
                                text_layout=arr))
        y += 22.0
    return from_renders(renders), n


def main() -> None:
    from figdraw_tpu import FigRenderer, fill, rgba, vec2
    from figdraw_tpu.text.typefaces import load_typeface

    tid = load_typeface("/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf")
    ink = fill(rgba(20, 20, 30, 255))
    ren = FigRenderer(atlas_size=512)
    size = vec2(W, H)
    scene, n_glyphs = build_scene(tid, ink, 0)
    for _ in range(WARMUP):
        out = ren.render_frame(scene, size)
    out.block_until_ready()
    samples = []
    for _ in range(FRAMES):
        scene, _ = build_scene(tid, ink, 0)  # per-frame rebuild, cached layouts
        t0 = time.perf_counter()
        out = ren.render_frame(scene, size)
        out.block_until_ready()
        samples.append((time.perf_counter() - t0) * 1000.0)
    arr = np.asarray(samples)
    med = float(np.percentile(arr, 50))
    print(
        f"text bench: {LINES} lines, ~{n_glyphs} glyphs @ {W}x{H}: "
        f"med={med:.2f}ms p95={np.percentile(arr, 95):.2f}ms "
        f"fps={1000.0 / med:.1f}",
        file=sys.stderr,
    )
    print(json.dumps({
        "metric": "text_frame_1200x800_36lines",
        "value": round(med, 3),
        "unit": "ms",
        "vs_baseline": round(8.333 / med, 3),  # reference 120 FPS yardstick
    }))


if __name__ == "__main__":
    main()
