#!/usr/bin/env python3
"""Bring-up smoke test: the renderer's main path on one GPU.

    python chip_smoke.py           # one card: every phase below
    python chip_smoke.py --four    # four cards: the multi-device paths only

Phases (one card), each printed on its own line:

  0. device: JAX platform, device kind and count, the card's name and power
     limit from nvidia-smi, and whether the C++ walk built.
  1. kernels: compile both Triton kernels at real sizes (the tile
     rasterizer on the 300-box demo at 1920x1080, the megakernel on the
     180x6 clip table at 1200x800) and compare each with the plain XLA
     rasterizer (ops/raster_ref.py) on the card; memory_analysis() of the
     binning + kernel program at the densest scene.
  2. the 300-box demo through FigRenderer.render_frame at 1080p, at 1x and
     40x, against FigRenderer(use_pallas=False).
  3. the clip table through render_frame: must take the megakernel.
  4. 400 image panels at 1080p (numpy images through put_image; the atlas
     runs take the XLA windowed evaluator).
  5. device-side contracts: camera pan == re-flatten, update_scene ==
     fresh snapshot, render_batch == render_frame.
  6. timings: each kernel against its plain XLA version (median of 20
     frames after warm-up, each ending in block_until_ready).

Every difference is the max absolute difference of f32 RGBA in [0, 1]; a
Triton-vs-XLA difference may reach 1/255 (approximate transcendentals and
FMA contraction, same bound as ops/binning.py), a contract must be 0.0. Any
failed check or exception exits non-zero. The last line of stdout is one
JSON object naming the device; it is printed only when everything passed.

Without a GPU the script exits non-zero before any phase runs.
FIGDRAW_SMOKE_REHEARSE=1 runs every phase at toy sizes on any platform (the
CPU runs the kernels in interpret mode) and then exits 3: a rehearsal never
reports a result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REHEARSE = os.environ.get("FIGDRAW_SMOKE_REHEARSE") == "1"
KERNEL_TOL = 1.0 / 255.0
FRAMES = 5 if REHEARSE else 20


def say(msg: str) -> None:
    print(msg, flush=True)


class Checks:
    def __init__(self):
        self.failed = []

    def diff(self, name: str, got, want, limit: float) -> float:
        got = np.asarray(got, np.float32)
        want = np.asarray(want, np.float32)
        if got.shape != want.shape:
            self.failed.append(f"{name}: shape {got.shape} != {want.shape}")
            say(f"  {name}: shape {got.shape} != {want.shape} FAIL")
            return float("inf")
        d = float(np.abs(got - want).max()) if got.size else 0.0
        finite = bool(np.isfinite(got).all())
        ok = finite and d <= limit
        if not ok:
            self.failed.append(f"{name}: max diff {d!r} > {limit!r}")
        say(f"  {name}: max abs diff {d!r} (limit {limit!r}, "
            f"finite {finite}) {'ok' if ok else 'FAIL'}")
        return d

    def require(self, name: str, cond: bool, detail: str = "") -> None:
        if not cond:
            self.failed.append(f"{name}: {detail}")
        say(f"  {name}: {'ok' if cond else 'FAIL'} {detail}".rstrip())


def median_ms(fn, n: int = FRAMES, warm: int = 2) -> float:
    import jax

    for _ in range(warm):
        jax.block_until_ready(fn())
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def card_lines() -> str:
    """nvidia-smi's name and power limit of every card, as it prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def route(ren) -> str:
    return "triton" if ren.use_pallas else "xla"


# --- scenes ------------------------------------------------------------------


def demo(w, h, frame, copies, cache):
    from figdraw_tpu.scenes import make_render_tree_array

    return make_render_tree_array(w, h, frame, copies=copies, cache=cache)


def clip_table(w, h):
    from bench_clipmask import make_table_scene
    from figdraw_tpu.nodesarray import from_renders

    return from_renders(make_table_scene("subclip", w, h))


def nested_clips(w, h, depth):
    """A grid of cells, each a chain of `depth` nested clip nodes around an
    overflowing rotated child: depth + 1 mask planes live at once."""
    from figdraw_tpu import Fig, FigFlags, FigKind, fill, new_renders, rect, rgba
    from figdraw_tpu.nodesarray import from_renders

    renders = new_renders()
    renders.add_root(0, Fig(kind=FigKind.nkRectangle, screen_box=rect(0, 0, w, h),
                            fill=fill(rgba(248, 249, 251, 255))))
    cell_w, cell_h = 60, 44
    for cy in range(max(int(h // (cell_h + 6)), 1)):
        for cx in range(max(int(w // (cell_w + 6)), 1)):
            x, y = 4 + cx * (cell_w + 6), 4 + cy * (cell_h + 6)
            parent = None
            for d in range(depth):
                fig = Fig(kind=FigKind.nkRectangle,
                          screen_box=rect(x + 2 * d, y + 2 * d,
                                          cell_w - 4 * d, cell_h - 4 * d),
                          corners=(6,) * 4, flags=FigFlags.NfClipContent,
                          fill=fill(rgba(40 + 25 * d, 120, 220 - 20 * d, 200)))
                parent = (renders.add_root(0, fig) if parent is None
                          else renders.add_child(0, parent, fig))
            renders.add_child(0, parent, Fig(
                kind=FigKind.nkRectangle, screen_box=rect(x - 10, y + 10, cell_w + 20, 12),
                fill=fill(rgba(230, 80, 40, 180)), rotation=12.0))
    return from_renders(renders)


IMG_ID = 7001


def photo(edge: int = 64) -> np.ndarray:
    y, x = np.mgrid[0:edge, 0:edge]
    img = np.zeros((edge, edge, 4), np.uint8)
    img[..., 0] = (x * 255 / edge).astype(np.uint8)
    img[..., 1] = (y * 255 / edge).astype(np.uint8)
    img[..., 2] = ((x + y) * 127 / edge).astype(np.uint8)
    img[(x // 8 + y // 8) % 2 == 0, 2] = 220
    img[..., 3] = 255
    return img


def image_panels(n, w, h):
    """n panels: a rounded SDF box with a scaled image on top."""
    from figdraw_tpu import Fig, FigKind, fill, image_style, new_renders, rect, rgba
    from figdraw_tpu.nodesarray import from_renders

    rng = np.random.RandomState(777)
    renders = new_renders()
    renders.add_root(0, Fig(kind=FigKind.nkRectangle, screen_box=rect(0, 0, w, h),
                            fill=fill(rgba(30, 30, 30, 255))))
    for i in range(n):
        x = float(rng.uniform(0, max(w - 120, 1)))
        y = float(rng.uniform(0, max(h - 120, 1)))
        renders.add_root(0, Fig(kind=FigKind.nkRectangle,
                                screen_box=rect(x, y, 104, 104),
                                fill=fill(rgba(80, 80, 80, 255)), corners=(12,) * 4))
        s = (80, 40, 96)[i % 3]
        renders.add_root(0, Fig(kind=FigKind.nkImage, screen_box=rect(x + 12, y + 12, s, s),
                                image=image_style(IMG_ID)))
    return from_renders(renders)


def image_renderer(use_pallas):
    from figdraw_tpu import FigRenderer
    from figdraw_tpu.resources import ImageMessageBus, put_image

    ren = FigRenderer(atlas_size=256, use_pallas=use_pallas)
    bus = ImageMessageBus()
    ren.ensure_image_message_subscription(bus)
    put_image(IMG_ID, photo(), bus=bus)
    return ren


def grid_boxes(w, h, n, d=None):
    """n integer-coordinate rounded boxes: roots, or children of a camera
    transform root translating them by d."""
    from figdraw_tpu import Fig, FigKind, fill, new_renders, rect, rgba, vec2
    from figdraw_tpu.basics import TransformStyle
    from figdraw_tpu.geometry import Mat3
    from figdraw_tpu.nodesarray import from_renders

    renders = new_renders()
    if d is not None:
        tr = renders.add_root(0, Fig(
            kind=FigKind.nkTransform,
            transform=TransformStyle(translation=vec2(float(d[0]), float(d[1])),
                                     matrix=Mat3.scaling(1.0, 1.0))))
    cols = max(int(w // 40), 1)
    boxes = []
    for i in range(n):
        fig = Fig(kind=FigKind.nkRectangle,
                  screen_box=rect(6 + (i % cols) * 38,
                                  8 + ((i // cols) * 30) % max(h - 30, 1), 30, 22),
                  corners=(5,) * 4,
                  fill=fill(rgba(50 + (i * 8) % 200, (i * 37) % 255, 190, 150)))
        boxes.append(renders.add_root(0, fig) if d is None
                     else renders.add_child(0, tr, fig))
    return from_renders(renders), boxes


# --- one card ------------------------------------------------------------------


def padded_rows(fields, modes, count):
    """Quad rows padded to the renderer's bucket, as device arrays."""
    import jax.numpy as jnp

    from figdraw_tpu.ops.layout import QF_WIDTH, QI_WIDTH
    from figdraw_tpu.renderer import _bucket

    n = _bucket(max(count, 1))
    f = np.zeros((n, QF_WIDTH), np.float32)
    m = np.zeros((n, QI_WIDTH), np.int32)
    f[:count] = fields[:count]
    m[:count] = modes[:count]
    return jnp.asarray(f), jnp.asarray(m)


def one_card(checks: Checks, timings: dict) -> None:
    import jax
    import jax.numpy as jnp

    from figdraw_tpu import FigRenderer, executor as ex, vec2
    from figdraw_tpu.ops import raster_pallas as rp
    from figdraw_tpu.ops import raster_ref

    W, H = (256, 144) if REHEARSE else (1920, 1080)
    CW, CH = (240, 160) if REHEARSE else (1200, 800)
    DENSE = 40 if REHEARSE else 4000
    size, csize = vec2(W, H), vec2(CW, CH)
    flat = FigRenderer(atlas_size=256, use_pallas=False)

    # --- 1. kernels at real sizes against the plain XLA rasterizer ----------
    say(f"phase 1: Triton kernels vs raster_ref ({W}x{H} demo, {CW}x{CH} clip table)")
    kernel_inputs = {}
    for copies in (100, DENSE):
        tape = flat.flatten(demo(W, H, 3, copies, None), size)
        f, m = padded_rows(tape.fields, tape.modes, tape.count)
        cnt = jnp.int32(tape.count)
        ph, pw = rp.padded_size(H, W)
        pad = ((0, 0), (0, ph - H), (0, pw - W))
        planes = jnp.pad(jnp.ones((4, H, W), jnp.float32), pad)
        masks = jnp.pad(jnp.ones((1, H, W), jnp.float32), pad)
        bin_fn = jax.jit(lambda f, m: rp.prebin(f, jnp.int32(f.shape[0]), ph, pw, modes=m))
        ker_fn = jax.jit(lambda f, m, ti, tc, p, k, c: rp.draw_pass_planar_prebinned(
            f, m, 0, c, ti, tc, p, k))
        ref_fn = jax.jit(lambda f, m, c: raster_ref.draw_pass_frame(
            f, m, c, jnp.ones((H, W, 4), jnp.float32), jnp.ones((1, H, W), jnp.float32)))
        t0 = time.perf_counter()
        ti, tc = bin_fn(f, m)
        got = ker_fn(f, m, ti, tc, planes, masks, cnt)
        got.block_until_ready()
        say(f"  tile kernel, {tape.count} quads ({f.shape[0]} rows): "
            f"compiled and ran in {time.perf_counter() - t0:.1f} s")
        want = ref_fn(f, m, cnt)
        checks.diff(f"tile kernel vs raster_ref, {copies * 3} boxes",
                    jnp.transpose(got[:, :H, :W], (1, 2, 0)), want, KERNEL_TOL)
        kernel_inputs[copies] = (bin_fn, ker_fn, ref_fn, f, m, ti, tc, planes, masks, cnt)
        if copies == DENSE:
            full = jax.jit(lambda f, m, p, k, c: rp.draw_pass_planar(
                f, m, 0, c, p, k)).lower(f, m, planes, masks, cnt).compile()
            say(f"  memory_analysis, binning + tile kernel at {tape.count} quads: "
                f"{full.memory_analysis()}")

    def mega_parity(scene, label):
        """Compile the megakernel on a scene's target-baked tape and compare
        it with the plain version of the same frame: the rolled executor on
        raster_ref. Returns (timed fn, its args, mask planes)."""
        tape = flat.flatten(scene, csize)
        mf, mm = ex.pack_mega_modes(tape, tape.fields[: tape.count],
                                    tape.modes[: tape.count])
        rows = padded_rows(mf, mm, mf.shape[0])
        n_masks = tape.mask_count + 1
        ph, pw = rp.padded_size(CH, CW)
        fn = jax.jit(lambda f, m: rp.draw_pass_mega(
            f, m, jnp.ones((4, ph, pw), jnp.float32), n_masks))
        t0 = time.perf_counter()
        got = fn(*rows)
        got.block_until_ready()
        say(f"  megakernel, {label}: {mf.shape[0]} rows, {n_masks} mask planes, "
            f"compiled and ran in {time.perf_counter() - t0:.1f} s")
        say(f"  memory_analysis, binning + megakernel ({label}): "
            f"{fn.lower(*rows).compile().memory_analysis()}")
        want = flat._dispatch_execution(flat._plan_execution(tape))
        checks.diff(f"megakernel vs rolled raster_ref, {label}",
                    jnp.transpose(got[:, :CH, :CW], (1, 2, 0)), want, KERNEL_TOL)
        return fn, rows, n_masks

    mega_fn, mega_rows, _ = mega_parity(clip_table(CW, CH), "clip table")
    deep_fn, deep_rows, deep_masks = mega_parity(
        nested_clips(CW, CH, rp.MEGA_MAX_MASKS - 1), "nested clips")
    checks.require("nested clips fill the megakernel's plane budget",
                   deep_masks == rp.MEGA_MAX_MASKS,
                   f"({deep_masks} of {rp.MEGA_MAX_MASKS} planes)")

    # --- 2. the 300-box demo through render_frame --------------------------
    say(f"phase 2: 300-box demo through render_frame at {W}x{H}")
    for copies in (100, DENSE):
        cache_t, cache_x = {}, {}
        ren = FigRenderer(atlas_size=256)
        xla = FigRenderer(atlas_size=256, use_pallas=False)
        n_frames = 3 if copies == 100 else 2
        for fr in range(n_frames):
            got = ren.render_frame(demo(W, H, fr, copies, cache_t), size)
            want = xla.render_frame(demo(W, H, fr, copies, cache_x), size)
            checks.diff(f"{copies * 3} boxes frame {fr}: executor={ren.last_executor} "
                        f"route={route(ren)} vs {xla.last_executor}/{route(xla)}",
                        got, want, KERNEL_TOL)
        checks.require(f"{copies * 3} boxes took the Triton kernels", ren.use_pallas)

    # --- 3. the clip table through render_frame -----------------------------
    say(f"phase 3: clip table through render_frame at {CW}x{CH}")
    ren = FigRenderer(atlas_size=128)
    xla = FigRenderer(atlas_size=128, use_pallas=False)
    scene = clip_table(CW, CH)
    got = ren.render_frame(scene, csize)
    exec_t = ren.last_executor
    want = xla.render_frame(scene, csize)
    checks.diff(f"clip table: executor={exec_t} route={route(ren)} vs "
                f"{xla.last_executor}/{route(xla)}", got, want, KERNEL_TOL)
    checks.require("clip table took the megakernel", exec_t == "mega" and ren.use_pallas,
                   f"(took {exec_t}/{route(ren)})")

    # --- 4. image panels ---------------------------------------------------------
    n_img = 24 if REHEARSE else 400
    say(f"phase 4: {n_img} image panels at {W}x{H}")
    ren_i, xla_i = image_renderer(None), image_renderer(False)
    panels = image_panels(n_img, W, H)
    got = ren_i.render_frame(panels, size)
    want = xla_i.render_frame(panels, size)
    checks.diff(f"image panels: executor={ren_i.last_executor} route={route(ren_i)} "
                f"(atlas runs on XLA) vs {xla_i.last_executor}/{route(xla_i)}",
                got, want, KERNEL_TOL)

    # --- 5. device-side contracts ------------------------------------------------
    say("phase 5: device-side contracts")
    n_boxes = 60 if REHEARSE else 1500
    arr, _ = grid_boxes(W, H, n_boxes, (0, 0))
    cam = FigRenderer(atlas_size=64)
    ref = FigRenderer(atlas_size=64)
    snap = cam.snapshot_scene(arr, size)
    for d in ((0, 0), (17, -9), (-40, 23)):
        view = cam.render_view(snap, d)
        moved, _ = grid_boxes(W, H, n_boxes, d)
        checks.diff(f"camera pan {d} == re-flatten ({cam.last_executor}/{route(cam)})",
                    view, ref.render_frame(moved, size), 0.0)

    arr, boxes = grid_boxes(W, H, n_boxes)
    ret = FigRenderer(atlas_size=64)
    snap = ret.snapshot_scene(arr, size)
    ret.render_view(snap)
    lst = arr[0]
    lst.set_box(boxes[3], 60.0, 40.0, 44.0, 30.0)
    lst.set_rotation(boxes[7], 20.0)
    ret.update_scene(snap, arr, dirty=[(0, boxes[3]), (0, boxes[7])])
    patched = ret.render_view(snap)
    fresh = FigRenderer(atlas_size=64)
    checks.diff(f"update_scene == fresh snapshot ({ret.last_executor}/{route(ret)})",
                patched, fresh.render_view(fresh.snapshot_scene(arr, size)), 0.0)

    bat = FigRenderer(atlas_size=256)
    one = FigRenderer(atlas_size=256)
    scenes = [demo(W, H, fr, 100, None) for fr in range(4)]
    frames = bat.render_batch(scenes, size)
    for fr, sc in enumerate(scenes):
        checks.diff(f"render_batch frame {fr} == render_frame ({route(bat)})",
                    frames[fr], one.render_frame(sc, size), 0.0)

    # --- 6. timings: kernels against their plain versions ------------------------
    say(f"phase 6: timings, median of {FRAMES} frames after warm-up")
    for copies, (bin_fn, ker_fn, ref_fn, f, m, ti, tc, planes, masks, cnt) in kernel_inputs.items():
        key = f"{copies * 3}box_{W}x{H}"
        timings[f"tile_kernel_{key}"] = median_ms(lambda: ker_fn(f, m, ti, tc, planes, masks, cnt))
        timings[f"binning_{key}"] = median_ms(lambda: bin_fn(f, m))
        n_ref = FRAMES if copies == 100 else 3
        timings[f"raster_ref_{key}"] = median_ms(lambda: ref_fn(f, m, cnt), n=n_ref, warm=1)
    timings[f"megakernel_with_binning_clip_table_{CW}x{CH}"] = median_ms(
        lambda: mega_fn(*mega_rows))
    timings[f"megakernel_with_binning_{deep_masks}_planes_{CW}x{CH}"] = median_ms(
        lambda: deep_fn(*deep_rows))

    # end to end through the renderer's executors: host plan + upload + device
    cache_t, cache_x = {}, {}
    ren, xla = FigRenderer(atlas_size=256), FigRenderer(atlas_size=256, use_pallas=False)
    i = iter(range(10 ** 6))
    timings[f"render_frame_triton_300box_{W}x{H}"] = median_ms(
        lambda: ren.render_frame(demo(W, H, next(i) % 60, 100, cache_t), size))
    timings[f"render_frame_xla_300box_{W}x{H}"] = median_ms(
        lambda: xla.render_frame(demo(W, H, next(i) % 60, 100, cache_x), size))

    ren = FigRenderer(atlas_size=128)
    xla = FigRenderer(atlas_size=128, use_pallas=False)
    tape = ren.flatten(scene, csize)
    plan_mega = ren._plan_execution(tape)
    checks.require("clip-table plan chose the megakernel", plan_mega.mega_combo is not None)
    plan_rolled = ren._plan_execution(ren.flatten(scene, csize))
    plan_rolled.combo = plan_rolled.combo.copy()  # own the pooled buffer
    plan_rolled.mega_combo = None  # same frame on the rolled executor
    plan_xla = xla._plan_execution(xla.flatten(scene, csize))
    checks.diff("clip table: rolled/triton vs rolled/xla",
                ren._dispatch_execution(plan_rolled), xla._dispatch_execution(plan_xla),
                KERNEL_TOL)
    timings[f"clip_table_mega_triton_{CW}x{CH}"] = median_ms(
        lambda: ren._dispatch_execution(plan_mega))
    timings[f"clip_table_rolled_triton_{CW}x{CH}"] = median_ms(
        lambda: ren._dispatch_execution(plan_rolled))
    timings[f"clip_table_rolled_xla_{CW}x{CH}"] = median_ms(
        lambda: xla._dispatch_execution(plan_xla), n=min(FRAMES, 5), warm=1)
    timings[f"image_panels_{n_img}_triton_{W}x{H}"] = median_ms(
        lambda: ren_i.render_frame(panels, size))
    timings[f"image_panels_{n_img}_xla_{W}x{H}"] = median_ms(
        lambda: xla_i.render_frame(panels, size))
    for k, v in timings.items():
        say(f"  {k}: {v!r} ms")


# --- four cards ------------------------------------------------------------------


def four_cards(checks: Checks, timings: dict) -> None:
    import jax

    from figdraw_tpu import FigRenderer, vec2
    from figdraw_tpu.parallel.sharding import ShardedFigRenderer, default_mesh, frames_mesh

    n = len(jax.devices())
    checks.require("four devices", n == 4, f"(found {n})")
    W, H = (320, 180) if REHEARSE else (3840, 2160)
    size = vec2(W, H)
    say(f"phase 4x: row-sharded 300-box demo at {W}x{H} on a flat 1-D mesh of 4")
    sharded = ShardedFigRenderer(mesh=default_mesh(4), atlas_size=256)
    single = FigRenderer(atlas_size=256)
    for fr in range(2):
        got = sharded.render_frame(demo(W, H, fr, 100, None), size)
        want = single.render_frame(demo(W, H, fr, 100, None), size)
        checks.diff(f"sharded frame {fr} ({'triton' if sharded.use_pallas else 'xla'}) "
                    f"vs one card ({single.last_executor}/{route(single)})",
                    got, want, KERNEL_TOL)
    timings[f"sharded4_render_frame_300box_{W}x{H}"] = median_ms(
        lambda: sharded.render_frame(demo(W, H, 5, 100, None), size))
    timings[f"single_render_frame_300box_{W}x{H}"] = median_ms(
        lambda: single.render_frame(demo(W, H, 5, 100, None), size))

    BW, BH = (256, 144) if REHEARSE else (1920, 1080)
    bsize = vec2(BW, BH)
    say(f"phase 4x: render_batch on frames_mesh(4) at {BW}x{BH}")
    scenes = [demo(BW, BH, fr, 100, None) for fr in range(8)]
    bat = FigRenderer(atlas_size=256)
    frames = bat.render_batch(scenes, bsize, mesh=frames_mesh(4))
    one = FigRenderer(atlas_size=256)
    for fr, sc in enumerate(scenes):
        checks.diff(f"frames_mesh batch frame {fr} == render_frame ({route(bat)})",
                    frames[fr], one.render_frame(sc, bsize), 0.0)
    for k, v in timings.items():
        say(f"  {k}: {v!r} ms")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the multi-device paths, on four cards")
    args = ap.parse_args()

    import jax

    dev = jax.devices()[0]
    count = len(jax.devices())
    say(f"phase 0: platform={dev.platform} device_kind={dev.device_kind} count={count}")
    if dev.platform != "gpu" and not REHEARSE:
        say("no GPU found: nothing was measured")
        return 2
    if not REHEARSE:
        say(card_lines())

    from figdraw_tpu import native
    from figdraw_tpu.ops import raster_pallas as rp
    from figdraw_tpu.utils.jaxcache import cache_dir

    checks = Checks()
    checks.require("C++ walk built from native/*.cpp", native.available())
    say(f"  tile {rp.TILE_H}x{rp.TILE_W}, bins {rp.BIN_H}x{rp.BIN_W}, "
        f"num_warps {rp.NUM_WARPS}, compile cache {cache_dir()}")

    timings: dict = {}
    t0 = time.perf_counter()
    if args.four:
        four_cards(checks, timings)
    else:
        one_card(checks, timings)
    say(f"wall time {time.perf_counter() - t0:.1f} s")
    if checks.failed:
        for f in checks.failed:
            say(f"FAILED: {f}")
        return 1
    if REHEARSE:
        say("rehearsal finished: no result is reported")
        return 3
    say(card_lines())
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
