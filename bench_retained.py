"""Benchmark: retained-scene updates (renderer.update_scene).

A UI frame usually edits a handful of widgets; the reference re-walks and
re-uploads the whole scene anyway. The retained path re-walks ONLY the dirty
roots' subtrees (native fd_flatten_layer_spans) and scatters their packed
rows into the device-resident tape (executor.get_patch_runner), so per-frame
host + wire cost is O(edited quads) — scene size stops mattering.

Prints one JSON line per scale:
  {"metric": "retained_update_<boxes>box", "value": ms/frame,
   "per_frame": ms/frame of the full render_frame loop, "speedup": x}

FIGDRAW_BENCH_SCALES like bench_camera (boxes = copies * 3);
FIGDRAW_BENCH_FRAMES (default 48) frames; FIGDRAW_BENCH_DIRTY (default 8)
roots edited per frame.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

WIDTH = int(os.environ.get("FIGDRAW_BENCH_W", "1920"))
HEIGHT = int(os.environ.get("FIGDRAW_BENCH_H", "1080"))
FRAMES = int(os.environ.get("FIGDRAW_BENCH_FRAMES", "48"))
DIRTY = int(os.environ.get("FIGDRAW_BENCH_DIRTY", "8"))
SCALES = tuple(
    int(v) for v in os.environ.get("FIGDRAW_BENCH_SCALES", "100,4000").split(",")
)


def build_grid(n_boxes):
    """One root per box (the retained unit), sized to a WIDTHxHEIGHT grid."""
    from figdraw_tpu import Fig, FigKind, fill, new_renders, rect, rgba
    from figdraw_tpu.nodesarray import from_renders

    renders = new_renders()
    renders.add_root(0, Fig(kind=FigKind.nkRectangle,
                            screen_box=rect(0, 0, WIDTH, HEIGHT),
                            fill=fill(rgba(24, 26, 34, 255))))
    cols = max(int((n_boxes * WIDTH / HEIGHT) ** 0.5), 1)
    rows = (n_boxes + cols - 1) // cols
    cw, ch = WIDTH / cols, HEIGHT / rows
    boxes = []
    for i in range(n_boxes):
        r, c = divmod(i, cols)
        boxes.append(renders.add_root(0, Fig(
            kind=FigKind.nkRectangle,
            screen_box=rect(c * cw + 2, r * ch + 2, cw - 4, ch - 4),
            corners=(4,) * 4, rotation=(i * 7) % 23 - 11,
            fill=fill(rgba((i * 37) % 255, (i * 91) % 255, 200, 155)))))
    return from_renders(renders), boxes


def run_one(copies):
    from figdraw_tpu import FigRenderer, rgba, vec2

    n_boxes = copies * 3
    size = vec2(WIDTH, HEIGHT)
    arr, boxes = build_grid(n_boxes)
    lst = arr[0]
    renderer = FigRenderer(atlas_size=256, use_pallas=True)

    def edit(f):
        for k in range(DIRTY):
            b = boxes[(f * DIRTY + k) % len(boxes)]
            row = lst.nodes[b]
            x, y, w, h = row["box"]
            lst.set_box(b, float(x), float((y + 3 + f) % HEIGHT), float(w),
                        float(h))
            lst.set_solid_color(b, rgba((b * 13 + f) % 255, 120, 220, 180))
        return [(0, boxes[(f * DIRTY + k) % len(boxes)])
                for k in range(DIRTY)]

    # full re-flatten loop baseline (edits applied, whole scene walked)
    renderer.render_frame(arr, size).block_until_ready()
    t0 = time.perf_counter()
    out = None
    for f in range(FRAMES):
        edit(f)
        out = renderer.render_frame(arr, size)
    out.block_until_ready()
    per_frame_ms = (time.perf_counter() - t0) * 1000.0 / FRAMES

    # retained loop: snapshot once, patch DIRTY roots per frame
    scene = renderer.snapshot_scene(arr, size)
    assert scene.spans is not None, "retained spans unavailable"
    dirty = edit(0)
    renderer.update_scene(scene, arr, dirty)
    renderer.render_view(scene).block_until_ready()  # compile
    best = None
    for _rep in range(3):
        t0 = time.perf_counter()
        for f in range(FRAMES):
            dirty = edit(f + 1)
            renderer.update_scene(scene, arr, dirty)
            out = renderer.render_view(scene)
        out.block_until_ready()
        ms = (time.perf_counter() - t0) * 1000.0 / FRAMES
        best = ms if best is None else min(best, ms)

    print(json.dumps({
        "metric": f"retained_update_{n_boxes}box",
        "value": round(best, 3),
        "unit": "ms",
        "per_frame": round(per_frame_ms, 3),
        "speedup": round(per_frame_ms / best, 2),
        "dirty_roots": DIRTY,
    }))
    print(f"  {n_boxes} boxes / {DIRTY} dirty: retained {best:.3f} ms/frame "
          f"({1000.0 / best:.0f} fps) vs re-flatten {per_frame_ms:.3f} ms "
          f"({1000.0 / per_frame_ms:.0f} fps)", file=sys.stderr)


def main():
    for copies in SCALES:
        run_one(copies)


if __name__ == "__main__":
    main()
