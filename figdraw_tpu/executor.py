"""Fused frame executor: one jitted device call per frame.

The tape's pass items (draw runs, mask clears, backdrop blurs) are unrolled
into a single jitted program keyed by the frame's static pass *structure* —
the device-side counterpart of the GL command stream: where the reference
issues one glDrawElements per flush plus blur/mask FBO switches
(glcontext.nim:643-714, 1788-1841, 1886-1949), we chain Pallas draw passes,
planar blurs and mask writes inside one XLA program so a frame costs exactly
one dispatch + one tape upload. Pass structures repeat across frames (the
scene graph's shape changes rarely), so the jit cache stays small.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import jax
import jax.numpy as jnp

from .ops import raster_pallas, raster_ref
from .ops.blur import backdrop_blur_planar

# structure items (static, hashable):
#   ("draw", target, uses_atlas, needs_backdrop)   target: -1 frame, else mask k
#   ("blur",)
#   ("clear_mask", k)
FRAME_TARGET = -1
ROLLED_THRESHOLD = 24  # structure items above this use the rolled executor


COMBO_EXTRA = 2  # i32 mode lanes bitcast into the last two f32 columns


def _meta_rows(n_draws: int, n_blurs: int, row_width: int) -> int:
    return max(1, -(-(2 * n_draws + n_blurs + 4) // row_width))


def fill_meta(meta, bounds, radii, clear_color):
    """The ONE writer of the combo meta-tail layout every executor decodes:
    bitcast (nd, 2) draw bounds, nb blur radii, then the clear color."""
    import numpy as np

    nd = len(bounds)
    nb = len(radii)
    if nd:
        meta[: 2 * nd] = (
            np.asarray(bounds, np.int32).view(np.float32).reshape(-1)
        )
    if nb:
        meta[2 * nd : 2 * nd + nb] = radii
    meta[2 * nd + nb : 2 * nd + nb + 4] = clear_color


def pack_tape_upload(fields, modes, bounds, radii, clear_color):
    """One host buffer per frame: quad fields + bitcast mode lanes + meta
    rows carrying draw-run bounds, blur radii and the clear color. A single
    host-to-device transfer replaces five."""
    import numpy as np

    n, width = fields.shape
    row_width = width + COMBO_EXTRA
    nd = bounds.shape[0]
    nb = radii.shape[0]
    rows = _meta_rows(nd, nb, row_width)
    combo = np.zeros((n + rows, row_width), dtype=np.float32)
    combo[:n, :width] = fields
    combo[:n, width : width + COMBO_EXTRA] = modes.view(np.float32)
    fill_meta(combo[n:].reshape(-1), bounds, radii, clear_color)
    return combo


def pack_tape_combo(tape, n_pad: int, bounds, radii, clear_color):
    """Pack a logical tape into the PACKED upload layout (ops/layout.py):
    one (n_pad + meta, PACKED_WIDTH) wire buffer the executors unpack on
    device. The python-walk twin of native fd_export_combo_packed."""
    import numpy as np

    from .ops.layout import PACKED_WIDTH, pack_fields_np

    nd = bounds.shape[0]
    nb = radii.shape[0]
    rows = _meta_rows(nd, nb, PACKED_WIDTH)
    c = tape.count
    combo = np.zeros((n_pad + rows, PACKED_WIDTH), dtype=np.float32)
    pack_fields_np(tape.fields[:c], tape.modes[:c], out=combo[:c])
    fill_meta(combo[n_pad:].reshape(-1), bounds, radii, clear_color)
    return combo


@lru_cache(maxsize=1)
def _u8_color_lut():
    # host-computed k/255.0f table embedded as a trace constant (numpy, NOT
    # a device array — caching a jnp value made inside a jit trace leaks
    # the tracer): an on-device division would let XLA rewrite /255 into
    # *(1/255), which is 1 ULP off the walk's own quantization and would
    # break bit-exact golden parity
    import numpy as np

    return np.arange(256, dtype=np.float32) / np.float32(255.0)


def unpack_combo_device(rows):
    """Inverse of the packed wire layout, inside jit: (N, PACKED_WIDTH)
    f32 rows -> ((N, 68) fields, (N, 2) i32 modes), bit-identical to the
    pre-pack tape (colors decode through the exact k/255 constant table)."""
    from .ops.layout import PACKED_MODES

    base = rows[:, :16]
    words = jax.lax.bitcast_convert_type(rows[:, 16:22], jnp.uint32)
    bytes_ = jnp.stack(
        [(words >> (8 * k)) & 0xFF for k in range(4)], axis=2
    )  # (N, 6, 4): word w byte k = logical color col 16 + 4w + k
    colors = jnp.asarray(_u8_color_lut())[bytes_.reshape(rows.shape[0], 24)]
    fields = jnp.concatenate([base, colors, rows[:, 22:50]], axis=1)
    modes = jax.lax.bitcast_convert_type(
        rows[:, PACKED_MODES : PACKED_MODES + 2], jnp.int32
    )
    return fields, modes


@lru_cache(maxsize=1)
def _atlas_mode_lut():
    import numpy as np

    from .ops.raster_pallas import ATLAS_BASE_MODES

    lut = np.zeros(128, bool)
    lut[list(ATLAS_BASE_MODES)] = True
    return lut


def tape_structure(tape, modes):
    """Static pass structure from a tape: (structure, bounds, radii,
    is_atlas_mode, is_backdrop_mode). `modes` is the (padded) i32 lane array;
    structure items are the hashable tuples get_frame_executor keys on."""
    import numpy as np

    from .ops.layout import QI_MODE
    from .tape import BlurItem, ClearMaskItem, DrawItem

    base_modes = (modes[:, QI_MODE] % 256) % 128  # strip fill + elliptical
    # LUT gather instead of np.isin (sort-based) — this runs per frame
    is_atlas_mode = _atlas_mode_lut()[base_modes]
    is_backdrop_mode = base_modes == 17

    structure = []
    bounds = []
    radii = []
    seen_blur = False
    for item in tape.items:
        if isinstance(item, ClearMaskItem):
            structure.append(("clear_mask", item.index))
        elif isinstance(item, BlurItem):
            structure.append(("blur",))
            radii.append(item.radius)
            seen_blur = True
        elif isinstance(item, DrawItem):
            if item.end <= item.start:
                continue
            uses_atlas = bool(is_atlas_mode[item.start : item.end].any())
            needs_backdrop = seen_blur and bool(
                is_backdrop_mode[item.start : item.end].any()
            )
            structure.append(("draw", item.target, uses_atlas, needs_backdrop))
            bounds.append((item.start, item.end))
    return structure, bounds, radii, is_atlas_mode, is_backdrop_mode


@lru_cache(maxsize=64)
def get_frame_executor(
    structure: Tuple,
    height: int,
    width: int,
    n_masks: int,
    use_pallas: bool,
    subpixel_positioning: bool,
    has_init_frame: bool,
    pixelate: bool = False,
):
    """Returns jitted run(combo, init_frame, atlas) -> (H, W, 4) frame.

    combo: pack_tape_upload's buffer; init_frame: (H, W, 4) previous frame
    (only read when has_init_frame, else a (1, 1, 4) dummy).
    """
    ph, pw = raster_pallas.padded_size(height, width)
    any_blur = any(item[0] == "blur" for item in structure)

    def to_hwc(planes):
        return jnp.transpose(planes, (1, 2, 0))

    def to_planes(hwc):
        return jnp.transpose(hwc, (2, 0, 1))

    n_draws = sum(1 for item in structure if item[0] == "draw")
    n_blurs = sum(1 for item in structure if item[0] == "blur")

    def run(combo, init_frame, atlas):
        from .ops.layout import PACKED_WIDTH

        rows = _meta_rows(n_draws, n_blurs, PACKED_WIDTH)
        fields, modes = unpack_combo_device(combo[:-rows])
        meta = combo[-rows:].reshape(-1)
        nd2 = max(2 * n_draws, 2)
        bounds = jax.lax.bitcast_convert_type(meta[:nd2], jnp.int32).reshape(-1, 2)
        radii = meta[2 * n_draws : 2 * n_draws + max(n_blurs, 1)]
        clear_color = meta[2 * n_draws + n_blurs : 2 * n_draws + n_blurs + 4]

        if has_init_frame:
            planes = to_planes(init_frame)
            planes = jnp.pad(
                planes, ((0, 0), (0, ph - height), (0, pw - width))
            )
        else:
            planes = jnp.broadcast_to(
                clear_color[:, None, None], (4, ph, pw)
            ).astype(jnp.float32)
        masks = jnp.zeros((n_masks, ph, pw), jnp.float32).at[0].set(1.0)
        backdrop = (
            jnp.zeros((4, ph, pw), jnp.float32) if any_blur else None
        )

        # ONE binning (argsort) serves every Pallas draw of the frame; runs
        # select their contiguous per-bin segments in-kernel. Occlusion
        # culling stays run-scoped via run_bounds (binning.bin_quads).
        draws = [it for it in structure if it[0] == "draw"]
        frame_draw_pos = [
            di_ for di_, item in enumerate(draws) if item[1] == FRAME_TARGET
        ]
        pallas_draws = use_pallas and any(
            not uses_atlas for _, _t, uses_atlas, _b in draws
        )
        tile_idx = tile_counts = None
        if pallas_draws:
            # occlusion culling only has work to do when frame-target draw
            # runs exist (mask-only Pallas frames skip the coverage tensors)
            rb = (
                bounds[jnp.asarray(frame_draw_pos, jnp.int32)]
                if frame_draw_pos else None
            )
            tile_idx, tile_counts = raster_pallas.prebin(
                fields, jnp.int32(fields.shape[0]), ph, pw,
                modes=modes if frame_draw_pos else None, run_bounds=rb,
                n_runs=len(frame_draw_pos),
            )

        di = 0
        bi = 0
        for item in structure:
            kind = item[0]
            if kind == "clear_mask":
                masks = masks.at[item[1]].set(0.0)
            elif kind == "blur":
                backdrop = backdrop_blur_planar(planes, radii[bi])
                bi += 1
            else:
                _, target, uses_atlas, needs_backdrop = item
                s = bounds[di, 0]
                e = bounds[di, 1]
                di += 1
                if target == FRAME_TARGET:
                    if use_pallas and not uses_atlas:
                        planes = raster_pallas.draw_pass_planar_prebinned(
                            fields, modes, s, e, tile_idx, tile_counts,
                            planes, masks,
                            backdrop if needs_backdrop else None,
                        )
                    else:
                        hwc = to_hwc(planes)
                        if uses_atlas and not needs_backdrop:
                            # glyph/image quads are tiny: evaluate each in a
                            # bbox window instead of the whole frame
                            hwc = raster_ref.draw_pass_frame_range_windowed(
                                fields, modes, s, e, hwc, masks, atlas=atlas,
                                subpixel_positioning=subpixel_positioning,
                                pixelate=pixelate,
                            )
                        else:
                            hwc = raster_ref.draw_pass_frame_range(
                                fields, modes, s, e, hwc, masks,
                                atlas=atlas if uses_atlas else None,
                                backdrop=to_hwc(backdrop) if needs_backdrop else None,
                                subpixel_positioning=subpixel_positioning,
                                pixelate=pixelate,
                            )
                        planes = to_planes(hwc)
                else:
                    if use_pallas and not uses_atlas:
                        # tiled mask write (the rolled executor's path) —
                        # mask shapes are SDF quads, so the whole-frame XLA
                        # pass per clip was pure waste
                        plane = raster_pallas.draw_pass_mask_prebinned(
                            fields, modes, s, e, tile_idx, tile_counts,
                            masks[target][None], masks,
                        )[0]
                    else:
                        plane = raster_ref.draw_pass_mask_range(
                            fields, modes, s, e, masks[target], masks,
                            atlas=atlas if uses_atlas else None,
                            subpixel_positioning=subpixel_positioning,
                            pixelate=pixelate,
                        )
                    masks = masks.at[target].set(plane)

        return to_hwc(planes)[:height, :width]

    return jax.jit(run)


# --- mega executor: the whole multi-pass frame as ONE Pallas kernel -------------
#
# For mask-heavy pure-SDF scenes the pass structure itself is the cost: the
# rolled loop launches one full-frame Pallas pass per draw run / mask write /
# clear. pack_mega_modes bakes each quad's target and the clear boundaries
# into the mode lane's high bits (raster_pallas.MEGA_* packing), and the
# megakernel walks each tile's quads once in tape order with the mask planes
# living in registers — constant device-memory traffic regardless of mask count.


def pack_mega_modes(tape, fields, modes):
    """Splice a tape into target-baked (fields, modes) arrays for the
    megakernel: draw-run quads get (target+1)<<16 added to the mode lane;
    each ClearMaskItem becomes a sentinel row with the clear bit.

    A clear of plane k only matters in tiles where plane k is read or written
    before its next clear — everywhere else its effect is never observed (a
    content quad reading an uncleared-but-unwritten plane sits outside its own
    clip's coverage, so either the next clear re-runs there or nothing reads
    the plane). The sentinel's bbox is therefore the union of those quads'
    bboxes, so clears bin only into the tiles their cell touches instead of
    all of them. Returns (fields, modes) un-padded; fully vectorized (this
    runs per frame)."""
    import numpy as np

    from .ops.layout import (
        QF_BBOX_X0, QF_BBOX_X1, QF_BBOX_Y0, QF_BBOX_Y1, QF_WIDTH, QI_WIDTH,
        QI_MASK, QI_MODE,
    )
    from .ops.raster_pallas import MEGA_CLEAR_BIT, MEGA_TARGET_SHIFT
    from .tape import ClearMaskItem, DrawItem

    n = fields.shape[0]
    # per-quad target from the draw runs (runs partition the tape in order);
    # clear positions = the tape index the clear precedes, in item order
    tgt = np.zeros(n, np.int32)  # encoded: 0 frame, k+1 mask plane k
    positions = []
    plane_list = []
    cursor = 0
    for item in tape.items:
        if isinstance(item, DrawItem):
            if item.end > item.start and item.target >= 0:
                tgt[item.start : item.end] = item.target + 1
            cursor = max(cursor, item.end)
        elif isinstance(item, ClearMaskItem):
            positions.append(cursor)
            plane_list.append(item.index)
    out_modes = modes.copy()
    out_modes[:, QI_MODE] += tgt << MEGA_TARGET_SHIFT
    if not positions:
        return fields, out_modes

    planes = np.asarray(plane_list, np.int32)
    positions = np.asarray(positions, np.int64)
    qmask = modes[:, QI_MASK]
    x0 = fields[:, QF_BBOX_X0]
    y0 = fields[:, QF_BBOX_Y0]
    x1 = fields[:, QF_BBOX_X1]
    y1 = fields[:, QF_BBOX_Y1]

    nc = positions.shape[0]
    cb = np.empty((nc, 4), np.float32)
    for k in np.unique(planes):
        rel = (tgt == k + 1) | (qmask == k)
        rx0 = np.where(rel, x0, np.float32(np.inf))
        ry0 = np.where(rel, y0, np.float32(np.inf))
        rx1 = np.where(rel, x1, np.float32(-np.inf))
        ry1 = np.where(rel, y1, np.float32(-np.inf))
        sel = planes == k
        # segments between consecutive clears of plane k (last runs to EOF);
        # reduceat returns x[start] for empty segments — overwritten below
        starts = positions[sel]
        idxs = np.nonzero(sel)[0]
        r_starts = np.minimum(starts, n - 1)
        mins_x = np.minimum.reduceat(rx0, r_starts)
        mins_y = np.minimum.reduceat(ry0, r_starts)
        maxs_x = np.maximum.reduceat(rx1, r_starts)
        maxs_y = np.maximum.reduceat(ry1, r_starts)
        seg_ends = np.append(starts[1:], n)
        empty = starts >= seg_ends
        mins_x[empty] = np.inf
        mins_y[empty] = np.inf
        maxs_x[empty] = -np.inf
        maxs_y[empty] = -np.inf
        cb[idxs, 0] = mins_x
        cb[idxs, 1] = mins_y
        cb[idxs, 2] = maxs_x
        cb[idxs, 3] = maxs_y
    # empty-union clears (plane never touched again) get a degenerate bbox
    dead = ~np.isfinite(cb).all(axis=1)
    cb[dead] = 0.0

    cf = np.zeros((nc, QF_WIDTH), np.float32)
    cf[:, QF_BBOX_X0] = cb[:, 0]
    cf[:, QF_BBOX_Y0] = cb[:, 1]
    cf[:, QF_BBOX_X1] = cb[:, 2]
    cf[:, QF_BBOX_Y1] = cb[:, 3]
    cm = np.zeros((nc, QI_WIDTH), np.int32)
    cm[:, QI_MODE] = MEGA_CLEAR_BIT + ((planes + 1) << MEGA_TARGET_SHIFT)

    out_f = np.insert(fields, positions, cf, axis=0)
    out_m = np.insert(out_modes, positions, cm, axis=0)
    return out_f, out_m


@lru_cache(maxsize=32)
def get_mega_executor(height: int, width: int, n_masks: int,
                      has_init_frame: bool):
    """Returns jitted run(combo, init_frame) -> (H, W, 4) frame; combo packs
    target-baked fields/modes (pack_mega_modes) with rolled-style meta."""
    ph, pw = raster_pallas.padded_size(height, width)

    def run(combo, init_frame):
        fields, modes = unpack_combo_device(combo[:-1])
        clear_color = combo[-1][0:4]

        if has_init_frame:
            planes = jnp.transpose(init_frame, (2, 0, 1))
            planes = jnp.pad(planes, ((0, 0), (0, ph - height), (0, pw - width)))
        else:
            planes = jnp.broadcast_to(
                clear_color[:, None, None], (4, ph, pw)
            ).astype(jnp.float32)
        planes = raster_pallas.draw_pass_mega(fields, modes, planes, n_masks)
        return jnp.transpose(planes, (1, 2, 0))[:height, :width]

    return jax.jit(run)


# --- rolled executor: pass-descriptor loop for mask-heavy scenes ----------------
#
# Scenes with hundreds of clip masks (e.g. the reference's clip benchmark: a
# table where every cell clips, windy_clip_mask_benchmark.nim) would unroll
# into thousands of XLA ops above. This variant is SURVEY.md §7's "generic
# multi-pass loop driven by a pass descriptor array": one lax.fori_loop over
# an item table with lax.switch on the item kind — compile cost is constant
# in scene complexity.

ITEM_NOOP = 0
ITEM_DRAW_SDF = 1
ITEM_DRAW_ATLAS = 2
ITEM_DRAW_SDF_BD = 3
ITEM_DRAW_MASK = 4
ITEM_BLUR = 5
ITEM_CLEAR_MASK = 6


def _item_bucket(n: int) -> int:
    b = 32
    while b < n:
        b *= 2
    return b


@lru_cache(maxsize=32)
def get_rolled_executor(
    height: int,
    width: int,
    n_masks: int,
    n_items: int,  # bucketed
    use_pallas: bool,
    subpixel_positioning: bool,
    has_init_frame: bool,
    pixelate: bool = False,
):
    """Returns jitted run(combo, items, radii, init_frame, atlas) -> frame.

    items: (n_items, 4) i32 [kind, target, start, end]; radii: (n_items,) f32.
    """
    ph, pw = raster_pallas.padded_size(height, width)

    def to_hwc(planes):
        return jnp.transpose(planes, (1, 2, 0))

    def to_planes(hwc):
        return jnp.transpose(hwc, (2, 0, 1))

    def run(combo, items, radii, init_frame, atlas):
        fields, modes = unpack_combo_device(combo[:-1])
        meta = combo[-1]
        clear_color = meta[0:4]  # rolled pack uses no bounds/radii slots

        if has_init_frame:
            planes = to_planes(init_frame)
            planes = jnp.pad(planes, ((0, 0), (0, ph - height), (0, pw - width)))
        else:
            planes = jnp.broadcast_to(
                clear_color[:, None, None], (4, ph, pw)
            ).astype(jnp.float32)
        masks = jnp.zeros((n_masks, ph, pw), jnp.float32).at[0].set(1.0)
        backdrop = jnp.zeros((4, ph, pw), jnp.float32)

        if use_pallas:
            # bin the whole tape ONCE; each draw item selects its contiguous
            # per-tile segment in-kernel (vs. an argsort per item)
            tile_idx, tile_counts = raster_pallas.prebin(
                fields, jnp.int32(fields.shape[0]), ph, pw,
            )

        def draw_frame_sdf(planes, masks, backdrop, target, s, e, radius):
            if use_pallas:
                out = raster_pallas.draw_pass_planar_prebinned(
                    fields, modes, s, e, tile_idx, tile_counts, planes, masks,
                )
            else:
                out = to_planes(
                    raster_ref.draw_pass_frame_range(
                        fields, modes, s, e, to_hwc(planes), masks,
                        subpixel_positioning=subpixel_positioning,
                        pixelate=pixelate,
                    )
                )
            return out, masks, backdrop

        def draw_frame_sdf_bd(planes, masks, backdrop, target, s, e, radius):
            if use_pallas:
                out = raster_pallas.draw_pass_planar_prebinned(
                    fields, modes, s, e, tile_idx, tile_counts, planes, masks,
                    backdrop,
                )
            else:
                out = to_planes(
                    raster_ref.draw_pass_frame_range(
                        fields, modes, s, e, to_hwc(planes), masks,
                        backdrop=to_hwc(backdrop),
                        subpixel_positioning=subpixel_positioning,
                        pixelate=pixelate,
                    )
                )
            return out, masks, backdrop

        def draw_frame_atlas(planes, masks, backdrop, target, s, e, radius):
            out = to_planes(
                raster_ref.draw_pass_frame_range_windowed(
                    fields, modes, s, e, to_hwc(planes), masks, atlas=atlas,
                    subpixel_positioning=subpixel_positioning,
                    pixelate=pixelate,
                )
            )
            return out, masks, backdrop

        def draw_mask(planes, masks, backdrop, target, s, e, radius):
            if use_pallas:
                plane = jax.lax.dynamic_index_in_dim(masks, target, 0, keepdims=True)
                plane = raster_pallas.draw_pass_mask_prebinned(
                    fields, modes, s, e, tile_idx, tile_counts, plane, masks,
                )[0]
            else:
                plane = jax.lax.dynamic_index_in_dim(masks, target, 0, keepdims=False)
                plane = raster_ref.draw_pass_mask_range(
                    fields, modes, s, e, plane, masks, atlas=atlas,
                    subpixel_positioning=subpixel_positioning,
                    pixelate=pixelate,
                )
            return planes, jax.lax.dynamic_update_index_in_dim(masks, plane, target, 0), backdrop

        def blur_item(planes, masks, backdrop, target, s, e, radius):
            return planes, masks, backdrop_blur_planar(planes, radius)

        def clear_mask(planes, masks, backdrop, target, s, e, radius):
            zero = jnp.zeros((ph, pw), jnp.float32)
            return planes, jax.lax.dynamic_update_index_in_dim(masks, zero, target, 0), backdrop

        def noop(planes, masks, backdrop, target, s, e, radius):
            return planes, masks, backdrop

        branches = [
            noop, draw_frame_sdf, draw_frame_atlas, draw_frame_sdf_bd,
            draw_mask, blur_item, clear_mask,
        ]

        def body(i, carry):
            planes, masks, backdrop = carry
            kind = items[i, 0]
            target = items[i, 1]
            s = items[i, 2]
            e = items[i, 3]
            radius = radii[i]
            return jax.lax.switch(
                kind,
                [
                    lambda pl_, mk, bd, fn=fn: fn(pl_, mk, bd, target, s, e, radius)
                    for fn in branches
                ],
                planes, masks, backdrop,
            )

        planes, masks, backdrop = jax.lax.fori_loop(
            0, n_items, body, (planes, masks, backdrop)
        )
        return to_hwc(planes)[:height, :width]

    return jax.jit(run)


# rect-mask screen→local row columns (ax, bx, tx, ay, by, ty) per combo
# layout: the PACKED wire layout (single-chip upload buffers) and the
# unpacked 70-wide layout (the sharded executors' replicated combos)
VIEW_RECT_COLS_PACKED = (42, 43, 44, 46, 47, 48)
VIEW_RECT_COLS_UNPACKED = (60, 61, 62, 64, 65, 66)


def view_rows(combo, d, z, n_quads: int,
              rect_cols=VIEW_RECT_COLS_PACKED):
    """Apply a screen-space camera (p' = z·p + d) to a PACKED upload buffer's
    quads inside jit — the device-camera op (no reference analog: GL re-walks
    the scene per scroll/zoom tick). Columns touched per live row (wire
    layout, ops/layout.py): origin (4,5) and bbox (6..9) map by z·x + d; the
    screen→uv inverse affine (0..3) scales by 1/z; the rect-mask fast path's
    screen→local rows (wire 42,43 / 46,47) scale by 1/z with translations
    re-derived (t' = t − M·d/z, wire cols 44/48) because its params/center
    are LOCAL-space. Uv affines, colors, sdf params/radii/factors and the
    mode lanes are all local-space (view-invariant) — zooming widens AA and
    shadow falloff on screen exactly like a GL scale transform does. Rows
    with an empty bbox (padding, disabled) and the meta tail (rows ≥
    n_quads — bitcast draw bounds that could alias a plausible bbox) are
    untouched.

    Bit-exactness: for integer d/z and integer scene coordinates the view
    reproduces the host walk of the transformed scene exactly (ceil snapping
    commutes with integer affine maps, and ×1.0 / ÷1.0 are IEEE-exact so
    z=1 degenerates to the pure pan); rotated rect-masks and fractional
    pans/zooms are float-rounding approximate (≤ 1 ULP in coordinates) and
    keep the baked vertex snapping, like GL transforming a recorded
    stream."""
    quads = combo[:n_quads]
    live = (quads[:, 8] > quads[:, 6]) & (quads[:, 9] > quads[:, 7])
    # touch ONLY the geometry columns: the packed color words (16..21)
    # and mode lanes (50,51) are bitcast integers — a whole-row `x + 0.0`
    # would canonicalize their NaN bit patterns and corrupt them
    ldx = jnp.where(live, d[0], 0.0)
    ldy = jnp.where(live, d[1], 0.0)
    lz = jnp.where(live, z, 1.0)
    linv = jnp.where(live, 1.0 / z, 1.0)
    ax, bx, tx, ay, by, ty = rect_cols
    out = quads
    for col in (0, 1, 2, 3, ax, bx, ay, by):
        out = out.at[:, col].multiply(linv)
    for col, comp in ((4, ldx), (6, ldx), (8, ldx), (5, ldy), (7, ldy),
                      (9, ldy)):
        out = out.at[:, col].set(quads[:, col] * lz + comp)
    out = out.at[:, tx].add(-(quads[:, ax] * ldx + quads[:, bx] * ldy) * linv)
    out = out.at[:, ty].add(-(quads[:, ay] * ldx + quads[:, by] * ldy) * linv)
    return jnp.concatenate([out, combo[n_quads:]], axis=0)


def animate_rows(combo, table, ridx, n_quads: int,
                 rect_cols=VIEW_RECT_COLS_PACKED):
    """Apply PER-ROOT scene-space affines p' = M·p + t to a device-resident
    combo inside jit — the generalization of view_rows from one whole-tape
    camera to an animation table: one (R+1, 6) f32 row
    (m00, m01, m10, m11, tx, ty) per animatable root (row R = identity) and
    one precomputed (n_quads,) i32 root-slot index per quad row (-1 = not in
    any root span: mega clear sentinels, the shared prologue, padding). Per
    frame only the table crosses the host→device link; the host C walk never
    runs (the reference re-walks the scene per animation tick,
    figrender.nim:1960-1995 — there is no GL analog of a tape-resident
    transform).

    Columns touched per animated live row (same set as view_rows): the
    screen→uv inverse affine (0..3) right-multiplies by M⁻¹; origin (4,5)
    maps by M·p + t; the bbox (6..9) becomes the AABB of the four mapped
    bbox corners — exact for axis-aligned M, conservative under rotation
    (safe: quad coverage is clipped to the uv unit square in eval_quad, so
    extra binned tiles contribute exactly-zero coverage); the rect-mask
    screen→local rows compose with M⁻¹ and re-derive their translations
    (local-space params/centers are animation-invariant). SDF params/radii,
    uv affines, colors and mode lanes are local-space and untouched — like
    the camera, scaling a root widens its AA/shadow falloff proportionally,
    exactly as a GL transform of a recorded vertex stream would.

    Bit-exactness contract (tests/test_animview.py): integer translations
    and power-of-two axis-aligned scales of integer axis-aligned roots
    reproduce a host re-flatten of the scene with each root wrapped in the
    equivalent nkTransform BIT-exactly (ceil snapping commutes with integer
    affine maps; pow-2 products/divisions are IEEE-exact). Rotations and
    fractional affines keep the baked vertex snapping and are
    float-rounding approximate. Rows outside every span, rows with an empty
    bbox (inert reserve rows, padding) and the meta tail are byte-untouched
    (per-column where-selects — their lanes may hold bitcast integers)."""
    quads = combo[:n_quads]
    live = (quads[:, 8] > quads[:, 6]) & (quads[:, 9] > quads[:, 7])
    aff = table[jnp.maximum(ridx, 0)]  # (n, 6)
    anim = live & (ridx >= 0)
    a, b = aff[:, 0], aff[:, 1]
    c, dd = aff[:, 2], aff[:, 3]
    tx, ty = aff[:, 4], aff[:, 5]
    det = a * dd - b * c
    ia = dd / det
    ib = -b / det
    ic = -c / det
    idd = a / det
    q = quads
    new = {}
    # INV' = INV @ M⁻¹   (u = INV·(p − org) ⇒ u' = INV·M⁻¹·(p' − (M·org + t)))
    new[0] = q[:, 0] * ia + q[:, 1] * ic
    new[1] = q[:, 0] * ib + q[:, 1] * idd
    new[2] = q[:, 2] * ia + q[:, 3] * ic
    new[3] = q[:, 2] * ib + q[:, 3] * idd
    # org' = M·org + t
    new[4] = a * q[:, 4] + b * q[:, 5] + tx
    new[5] = c * q[:, 4] + dd * q[:, 5] + ty
    # bbox: AABB of the four mapped corners (translation added after the
    # min/max so pure integer translations stay bit-exact: 1·x + 0·y = x)
    xs = (a * q[:, 6] + b * q[:, 7], a * q[:, 6] + b * q[:, 9],
          a * q[:, 8] + b * q[:, 7], a * q[:, 8] + b * q[:, 9])
    ys = (c * q[:, 6] + dd * q[:, 7], c * q[:, 6] + dd * q[:, 9],
          c * q[:, 8] + dd * q[:, 7], c * q[:, 8] + dd * q[:, 9])
    new[6] = jnp.minimum(jnp.minimum(xs[0], xs[1]),
                         jnp.minimum(xs[2], xs[3])) + tx
    new[8] = jnp.maximum(jnp.maximum(xs[0], xs[1]),
                         jnp.maximum(xs[2], xs[3])) + tx
    new[7] = jnp.minimum(jnp.minimum(ys[0], ys[1]),
                         jnp.minimum(ys[2], ys[3])) + ty
    new[9] = jnp.maximum(jnp.maximum(ys[0], ys[1]),
                         jnp.maximum(ys[2], ys[3])) + ty
    # rect-mask rows: local = mat·p + t_loc ⇒ mat' = mat·M⁻¹,
    # t' = t_loc − mat'·t (params/center are LOCAL-space)
    ax, bx, txc, ay, by, tyc = rect_cols
    mxa = q[:, ax] * ia + q[:, bx] * ic
    mxb = q[:, ax] * ib + q[:, bx] * idd
    mya = q[:, ay] * ia + q[:, by] * ic
    myb = q[:, ay] * ib + q[:, by] * idd
    new[ax], new[bx] = mxa, mxb
    new[ay], new[by] = mya, myb
    new[txc] = q[:, txc] - (mxa * tx + mxb * ty)
    new[tyc] = q[:, tyc] - (mya * tx + myb * ty)
    out = quads
    for col, val in new.items():
        out = out.at[:, col].set(jnp.where(anim, val, quads[:, col]))
    return jnp.concatenate([out, combo[n_quads:]], axis=0)


@lru_cache(maxsize=64)
def get_anim_view_runner(run, n_quads: int,
                         rect_cols=VIEW_RECT_COLS_PACKED):
    """Compose the per-root animation table with the camera and a cached
    single-frame executor: ONE jitted dispatch renders a device-resident
    tape under per-root affines + pan/zoom. Per frame only the (R+1, 6)
    table (and the (2,) pan + zoom scalar) travels; ridx is the scene's
    device-resident per-quad root-slot index."""

    @jax.jit
    def av(combo, table, ridx, d, z, *rest):
        return run(view_rows(animate_rows(combo, table, ridx, n_quads,
                                          rect_cols),
                             d, z, n_quads, rect_cols), *rest)

    return av


@lru_cache(maxsize=64)
def get_patch_anim_view_runner(run, n_quads: int, cap: int,
                               rect_cols=VIEW_RECT_COLS_PACKED):
    """Fused retained patch + per-root animation + camera view in ONE jitted
    dispatch: scatter the deferred patch rows into the resident combo
    (donated, in place in HBM), then render it under the animation table and
    the camera. Returns (frame, patched combo) — the patch lands in BASE
    scene space (animation is functional, applied per frame on top)."""

    def pav(combo, packed, table, ridx, d, z, *rest):
        w = combo.shape[1]
        idx = packed[:, w].astype(jnp.int32)
        combo = combo.at[idx].set(packed[:, :w])
        frame = run(view_rows(animate_rows(combo, table, ridx, n_quads,
                                           rect_cols),
                              d, z, n_quads, rect_cols), *rest)
        return frame, combo

    return jax.jit(pav, donate_argnums=(0,))


@lru_cache(maxsize=32)
def get_patch_runner(n_rows: int):
    """Scatter n_rows packed wire rows into a device-resident combo — the
    retained-scene patch (renderer.update_scene). The upload is ONE array:
    (n_rows, W+1) f32 with the target row index riding in the extra trailing
    column (exact as f32 — combos are far below 2^24 rows), so a patch costs
    a single host→device transfer. The combo is donated so the update happens in
    place in HBM. Padding duplicates the last (row, index) pair, an
    idempotent scatter."""

    def patch(combo, packed):
        w = combo.shape[1]
        idx = packed[:, w].astype(jnp.int32)
        return combo.at[idx].set(packed[:, :w])

    return jax.jit(patch, donate_argnums=(0,))


@lru_cache(maxsize=64)
def get_patch_view_runner(run, n_quads: int, cap: int,
                          rect_cols=VIEW_RECT_COLS_PACKED):
    """Fused retained patch + camera view: scatter the deferred patch rows
    into the resident combo AND render it under the camera in ONE jitted
    dispatch (one transfer per retained frame). Returns (frame, patched combo);
    the combo is donated so the patch lands in place in HBM."""

    def pv(combo, packed, d, z, *rest):
        w = combo.shape[1]
        idx = packed[:, w].astype(jnp.int32)
        combo = combo.at[idx].set(packed[:, :w])
        return run(view_rows(combo, d, z, n_quads, rect_cols), *rest), combo

    return jax.jit(pv, donate_argnums=(0,))


# damage-rect safety margin in px: covers the AA epsilon and pixel-center
# sampling; bboxes already bound every quad's full footprint (shadow spread
# included), so 2 px is generous
DAMAGE_PAD = 2.0
# distinct damage rects tracked per retained scene: scattered widget edits
# keep per-widget rects instead of inflating one union to near-full-frame
# (renderer._merge_damage greedily merges past this)
DAMAGE_RECTS = 4
# packed wire columns of the quad bbox (write_packed_quad_row copies
# fields[0:16] verbatim; ops/layout.py QF_BBOX_*)
_PACKED_BBOX_COLS = (6, 7, 8, 9)


@lru_cache(maxsize=64)
def get_partial_patch_view_runner(run, n_quads: int, cap: int,
                                  rect_cols=VIEW_RECT_COLS_PACKED):
    """Fused retained patch + camera view + DAMAGE-CLIPPED raster: scatter
    the deferred patch, drop every quad whose screen bbox misses every
    damage rect (empty-bbox rows bin into no tiles, so untouched tiles run
    an empty composite loop), render, and take the previous frame's pixels
    everywhere outside the rects. One dispatch; output is bit-identical to
    the full render because every pixel a changed quad can touch lies
    inside its root's rect (old + new bboxes generated it, padded by
    DAMAGE_PAD) and inside the rects the full ordered quad sublist
    recomposites from the clear color. rects: (DAMAGE_RECTS, 4) scene-space
    f32, unused slots inverted (x1 < x0 — no pixels, no quads). Caller
    guards: no blur/backdrop in the pass structure, no init frame, camera
    unchanged since the previous frame."""
    bb = jnp.asarray(_PACKED_BBOX_COLS)

    def ppv(combo, packed, rects, d, z, prev, *rest):
        w = combo.shape[1]
        idx = packed[:, w].astype(jnp.int32)
        combo = combo.at[idx].set(packed[:, :w])
        viewed = view_rows(combo, d, z, n_quads, rect_cols)
        rx0 = rects[:, 0] * z + d[0] - DAMAGE_PAD  # (R,)
        ry0 = rects[:, 1] * z + d[1] - DAMAGE_PAD
        rx1 = rects[:, 2] * z + d[0] + DAMAGE_PAD
        ry1 = rects[:, 3] * z + d[1] + DAMAGE_PAD
        q = viewed[:n_quads]
        keep = (
            (q[:, bb[0], None] <= rx1[None, :])
            & (q[:, bb[2], None] >= rx0[None, :])
            & (q[:, bb[1], None] <= ry1[None, :])
            & (q[:, bb[3], None] >= ry0[None, :])
        ).any(axis=1)
        empty = jnp.asarray([2e9, 2e9, -2e9, -2e9], jnp.float32)
        viewed = viewed.at[:n_quads, bb].set(
            jnp.where(keep[:, None], q[:, bb], empty))
        frame = run(viewed, *rest)
        h, wpx = frame.shape[0], frame.shape[1]
        cy = jax.lax.broadcasted_iota(jnp.float32, (h, wpx), 0) + 0.5
        cx = jax.lax.broadcasted_iota(jnp.float32, (h, wpx), 1) + 0.5
        inr = jnp.zeros((h, wpx), bool)
        for r in range(rects.shape[0]):
            inr |= ((cx >= rx0[r]) & (cx <= rx1[r])
                    & (cy >= ry0[r]) & (cy <= ry1[r]))
        return jnp.where(inr[..., None], frame, prev), combo

    return jax.jit(ppv, donate_argnums=(0,))


@lru_cache(maxsize=64)
def get_view_runner(run, n_quads: int, rect_cols=VIEW_RECT_COLS_PACKED):
    """Compose view_rows with a cached single-frame executor: ONE jitted
    dispatch renders a device-resident tape at a screen offset + zoom. The
    tape uploads once (renderer.snapshot_scene); per frame only the (2,)
    offset and the zoom scalar travel, so scroll/pan/zoom costs pure kernel
    time — no host walk, no tape upload. rect_cols selects the combo
    layout (packed single-chip wire vs the sharded executors' unpacked
    rows)."""

    @jax.jit
    def viewed(combo, d, z, *rest):
        return run(view_rows(combo, d, z, n_quads, rect_cols), *rest)

    return viewed


@lru_cache(maxsize=64)
def get_view_frame_fn(run, n_quads: int, rect_cols=VIEW_RECT_COLS_PACKED):
    """Per-view frame function with the camera params LEADING — the shape
    get_batch_runner / cached_frame_parallel_runner expect (first n_vary
    args vary per frame, the rest are constants): a whole flythrough of a
    device-resident scene becomes ONE upload of (N, 2) pans + (N,) zooms
    and one lax.map dispatch per chunk (renderer.render_views)."""

    def view_fn(d, z, combo, *rest):
        return run(view_rows(combo, d, z, n_quads, rect_cols), *rest)

    return view_fn


@lru_cache(maxsize=32)
def get_batch_runner(run, n_vary: int):
    """Batched frame dispatch: lax.map a single-frame executor over the
    leading frame axis of its first `n_vary` arguments (the per-frame
    upload buffers); the remaining arguments are frame-invariant.

    One host->device transfer and ONE device program then cover a whole
    chunk of frames — the offline/animation throughput path, where the
    per-frame fixed costs (transfer, dispatch) otherwise dominate
    (the reference has no analog: GL submits every frame individually).
    `run` must come from one of the lru_cached executor factories so the
    cache key is stable."""

    @jax.jit
    def batched(*args):
        vary = args[:n_vary]
        const = args[n_vary:]
        return jax.lax.map(lambda v: run(*v, *const), vary)

    return batched
