"""Benchmark: device-resident per-root animation (render_view's
root_transforms) vs the host re-flatten loop.

The reference's demo loop re-walks the whole scene every animation tick
(/root/reference/examples/renderlist_100_common.nim:38-251); round 4 made
that walk native C, and at 12000 boxes the host walk still dominates the
frame while the device idles (not measured on the GPU yet). The
affine-animation path snapshots the scene ONCE and per frame ships only a
(roots, 6) f32 table; executor.animate_rows moves every root inside the
jitted dispatch, so the per-frame host cost is the numpy phase math plus
one small upload — zero C walk, zero re-flatten.

The animated motion is the demo's own position/size phase math applied as
per-root affines (translate + scale about each box's base origin). Corner
radii and shadow falloff scale WITH each box instead of animating
independently (the affine contract — same class of motion, not a bitwise
demo replay; bit-exactness vs nkTransform-wrapped re-flattens is pinned by
tests/test_animview.py).

Prints one JSON line per scale:
  {"metric": "scene_anim_<boxes>box", "value": ms/frame,
   "per_frame": re-flatten ms/frame, "speedup": x}

FIGDRAW_BENCH_COPIES-style scales via FIGDRAW_BENCH_SCALES (100 = 300
boxes, 4000 = 12000 boxes); FIGDRAW_BENCH_FRAMES (default 48) per loop.
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


def _box_tracks(copies, frame):
    """The demo's position/size phase math for the 3*copies animated boxes
    (scenes._scene_animate_np rows 0-1), vectorized: returns (3, copies, 4)
    float64 x/y/w/h at `frame`."""
    from figdraw_tpu.scenes import (
        _SCENE_CLAMP_X, _SCENE_CLAMP_Y, _scene_anim_state, _scene_randoms,
    )

    t = frame * 0.02
    st = _scene_anim_state(copies)
    sin_ta = np.sin(t * st["sin_t"])[:, None]
    cos_ta = np.cos(t * st["sin_t"])[:, None]
    s = st["cos_of_sp"] * sin_ta + st["sin_of_sp"] * cos_ta
    cos_tc = np.cos(t * st["cos_t"])[:, None]
    sin_tc = np.sin(t * st["cos_t"])[:, None]
    c = st["cos_of_cp"] * cos_tc - st["sin_of_cp"] * sin_tc
    max_x = max(0.0, WIDTH - _SCENE_CLAMP_X)
    max_y = max(0.0, HEIGHT - _SCENE_CLAMP_Y)
    base_xs, base_ys = _scene_randoms(copies, max_x, max_y)
    off_x = np.clip(base_xs + s[0] * 20, 0.0, max_x)
    off_y = np.clip(base_ys + c[0] * 20, 0.0, max_y)
    pulse_w = 0.5 + 0.5 * s[1]
    pulse_h = 0.5 + 0.5 * c[1]
    out = np.empty((3, copies, 4))
    out[0, :, 0] = 60.0 + off_x
    out[0, :, 1] = 60.0 + off_y
    out[0, :, 2] = 160.0 + 100.0 * pulse_w
    out[0, :, 3] = 110.0 + 70.0 * pulse_h
    out[1, :, 0] = 320.0 + off_x
    out[1, :, 1] = 120.0 + off_y
    out[1, :, 2] = 160.0 + 100.0 * pulse_h
    out[1, :, 3] = 110.0 + 70.0 * pulse_w
    out[2, :, 0] = 180.0 + off_x
    out[2, :, 1] = 300.0 + off_y
    out[2, :, 2] = 160.0 + 100.0 * (1.0 - pulse_w)
    out[2, :, 3] = 110.0 + 70.0 * (1.0 - pulse_h)
    return out


def _anim_table(copies, base, frame, out):
    """(R, 6) bulk affine table in scene.anim_order slot order (= node idx
    order: the demo scene's roots are 0..n-1): per box scale about its base
    origin + translate to the frame-f position; all other roots identity."""
    cur = _box_tracks(copies, frame)
    sx = cur[..., 2] / base[..., 2]
    sy = cur[..., 3] / base[..., 3]
    # node idx of box (k, i) is 1 + 3*i + k
    rows = out[1 : 1 + 3 * copies].reshape(copies, 3, 6)
    rows[:, :, 0] = sx.T
    rows[:, :, 3] = sy.T
    rows[:, :, 4] = (cur[..., 0] - sx * base[..., 0]).T
    rows[:, :, 5] = (cur[..., 1] - sy * base[..., 1]).T
    return out


def run_one(copies):
    from figdraw_tpu import FigRenderer, vec2
    from figdraw_tpu.scenes import make_render_tree_array

    size = vec2(WIDTH, HEIGHT)
    cache = {}
    renderer = FigRenderer(atlas_size=256, use_pallas=True)

    def scene(f):
        return make_render_tree_array(WIDTH, HEIGHT, f, copies=copies,
                                      cache=cache)

    # baseline: the full animate + re-flatten loop (native fd_scene_animate
    # + C walk per frame — the reference way, host-bound at scale)
    renderer.render_frame(scene(0), size).block_until_ready()
    t0 = time.perf_counter()
    out = None
    for f in range(FRAMES):
        out = renderer.render_frame(scene(f), size)
    out.block_until_ready()
    per_frame_ms = (time.perf_counter() - t0) * 1000.0 / FRAMES

    # device animation: snapshot frame 0 once, per frame only the table
    snap = renderer.snapshot_scene(scene(0), size)
    n_roots = len(snap.animation_order())
    base = _box_tracks(copies, 0)
    table = np.zeros((n_roots, 6), np.float32)
    table[:, 0] = 1.0
    table[:, 3] = 1.0
    renderer.render_view(
        snap, root_transforms=_anim_table(copies, base, 1, table)
    ).block_until_ready()  # compile
    best = None
    for _rep in range(3):
        t0 = time.perf_counter()
        for f in range(FRAMES):
            out = renderer.render_view(
                snap, root_transforms=_anim_table(copies, base, f, table))
        out.block_until_ready()
        ms = (time.perf_counter() - t0) * 1000.0 / FRAMES
        best = ms if best is None else min(best, ms)

    print(json.dumps({
        "metric": f"scene_anim_{copies * 3}box",
        "value": round(best, 3),
        "unit": "ms",
        "per_frame": round(per_frame_ms, 3),
        "speedup": round(per_frame_ms / best, 2),
    }))
    print(f"  {copies * 3} boxes: device anim {best:.3f} ms/frame "
          f"({1000.0 / best:.0f} fps) vs animate+re-flatten "
          f"{per_frame_ms:.3f} ms ({1000.0 / per_frame_ms:.0f} fps)",
          file=sys.stderr)


def main():
    for copies in SCALES:
        run_one(copies)


if __name__ == "__main__":
    main()
