"""Benchmark: device-resident scene pan (snapshot_scene/render_view).

Scrolling the reference way re-walks the scene every tick; the device
camera keeps the flattened tape in device memory and per frame ships only a
(2,) f32 offset — executor.pan_rows shifts the quads inside the jitted
executor, so a pan frame costs pure kernel time: no scene build, no C++
walk, no tape upload.

Prints one JSON line per scale:
  {"metric": "camera_pan_<boxes>box", "value": ms/frame,
   "per_frame": ms/frame of the re-flatten loop, "speedup": x}

FIGDRAW_BENCH_COPIES scales like bench.py (100 = 300 boxes, 4000 = 28k
quads); FIGDRAW_BENCH_FRAMES (default 48) sets the sweep length.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

WIDTH = int(os.environ.get("FIGDRAW_BENCH_W", "1920"))
HEIGHT = int(os.environ.get("FIGDRAW_BENCH_H", "1080"))
FRAMES = int(os.environ.get("FIGDRAW_BENCH_FRAMES", "48"))
SCALES = tuple(
    int(v) for v in os.environ.get("FIGDRAW_BENCH_SCALES", "100,4000").split(",")
)


def run_one(copies):
    from figdraw_tpu import FigRenderer, vec2
    from figdraw_tpu.scenes import make_render_tree_array

    size = vec2(WIDTH, HEIGHT)
    cache = {}
    renderer = FigRenderer(atlas_size=256, use_pallas=True)

    def scene(f):
        return make_render_tree_array(WIDTH, HEIGHT, f, copies=copies,
                                      cache=cache)

    # re-flatten loop baseline (the scene is static: frame 0 every tick —
    # a scroll in the reference still pays the full walk per tick)
    renderer.render_frame(scene(0), size).block_until_ready()
    t0 = time.perf_counter()
    out = None
    for _ in range(FRAMES):
        out = renderer.render_frame(scene(0), size)
    out.block_until_ready()
    per_frame_ms = (time.perf_counter() - t0) * 1000.0 / FRAMES

    # camera loop: snapshot once, pan per frame
    snap = renderer.snapshot_scene(scene(0), size)
    renderer.render_view(snap, (1.0, 0.0)).block_until_ready()  # compile
    best = None
    for _rep in range(3):
        t0 = time.perf_counter()
        for f in range(FRAMES):
            out = renderer.render_view(snap, (f * 3.0, f * 1.0))
        out.block_until_ready()
        ms = (time.perf_counter() - t0) * 1000.0 / FRAMES
        best = ms if best is None else min(best, ms)

    # flythrough: the whole sweep as chunked single-dispatch batches — the
    # per-frame host->device traffic drops to one (N,2)+(N,) upload per chunk
    pans = [(f * 3.0, f * 1.0) for f in range(FRAMES)]
    zooms = [1.0 + 0.4 * (f / FRAMES) for f in range(FRAMES)]
    renderer.render_views(snap, pans, zooms, chunk=8).block_until_ready()
    fly = None
    for _rep in range(3):
        t0 = time.perf_counter()
        stack = renderer.render_views(snap, pans, zooms, chunk=8)
        stack.block_until_ready()
        ms = (time.perf_counter() - t0) * 1000.0 / FRAMES
        fly = ms if fly is None else min(fly, ms)

    print(json.dumps({
        "metric": f"camera_pan_{copies * 3}box",
        "value": round(best, 3),
        "unit": "ms",
        "per_frame": round(per_frame_ms, 3),
        "speedup": round(per_frame_ms / best, 2),
        "flythrough": round(fly, 3),
    }))
    print(f"  {copies * 3} boxes: pan {best:.3f} ms/frame "
          f"({1000.0 / best:.0f} fps) vs re-flatten {per_frame_ms:.3f} ms "
          f"({1000.0 / per_frame_ms:.0f} fps); flythrough {fly:.3f} ms/view",
          file=sys.stderr)


def main():
    for copies in SCALES:
        run_one(copies)


if __name__ == "__main__":
    main()
