"""Tile binning: map quad AABBs to per-tile draw-ordered index lists.

The replacement for GL's hardware triangle binning. One XLA call:
a (T, N) intersection mask from the tape's bboxes, then a stable argsort per
tile so each tile sees only its quads, still in draw order (the ordered-alpha
requirement from SURVEY.md §7 "hard parts" #1).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .layout import (
    QF_AA, QF_BBOX_X0, QF_BBOX_X1, QF_BBOX_Y0, QF_BBOX_Y1, QF_COLOR0,
    QF_INV_B, QF_INV_C, QF_MID_COLOR, QF_PARAMS, QF_RADII, QF_RECT_PARAMS,
    QF_STOP_COLOR, QI_MASK, QI_MODE,
)

# Translucent-stack SATURATION culling engages only on dense tapes (padded
# row count >= this): small scenes — every golden — keep the exact
# opaque-only cull, so their output is untouched bit-for-bit.
SAT_MIN_QUADS = 4096
# Cull a quad when the stack above it transmits < 2^-11 (1/2048) of it:
# everything below such a point shifts the final color < 1/2048 per channel
# in total — half a display quantum, and an order below the 1/255
# pallas-vs-XLA parity bound (the XLA reference path does not bin).
LOG2_SAT_EPS = -11.0


@partial(jax.jit, static_argnames=("tiles_y", "tiles_x", "tile_h", "tile_w",
                                   "n_runs"))
def bin_quads(fields, start, end, tiles_y: int, tiles_x: int, tile_h: int, tile_w: int,
              y_offset=0.0, modes=None, run_bounds=None, n_runs: int = 0):
    """Returns (tile_idx (T, N) i32, tile_counts (T,) i32).

    tile_idx[t, :counts[t]] are indices of quads in [start, end) whose bbox
    intersects tile t, in draw order; the rest is padding. The [start, end)
    window lets one padded tape hold every draw run of a frame so the whole
    frame executes as a single device call. y_offset: global row of tile row
    0 — nonzero when binning one device's row band of a mesh-sharded frame.

    modes (optional, frame-target runs only): enables OPAQUE OCCLUSION — a
    quad whose fully-opaque interior covers a tile makes everything drawn
    earlier in that tile invisible under source-over blending, so the tile's
    list starts at the last such quad (SURVEY.md §7 hard-part 7: binning must
    cut the per-tile work, not just partition it). The cover test is
    conservative: mode 3 (ClipAA), min fill alpha = 1 (min over vertex +
    gradient mid/stop alphas — any fill mode's color is a convex combination
    of those), axis-aligned, no mask read, no rect-mask, and the tile inside
    the rounded-box interior shrunk by max corner radius + the AA half-width.
    Dense tapes (>= SAT_MIN_QUADS padded rows) additionally get TRANSLUCENT
    SATURATION: covers with constant alpha < 1 accumulate log-transmittance
    per tile, and quads whose above-stack transmits < 1/2048 are dropped —
    bounded (< 1/2048/channel, half a display quantum) instead of exact, so
    it never runs on small scenes where the goldens live.

    run_bounds (optional, with modes): (n_runs, 2) i32 [start, end) ranges of
    the frame-target draw runs when ONE binning serves a whole multi-run
    frame. Culling then stays run-scoped — a cover only truncates quads of
    its OWN run (a later run's cover must not erase quads a mid-frame
    backdrop blur already needs) and quads outside every listed run (mask
    writes) are never culled. n_runs must be the static row count.
    """
    n = fields.shape[0]
    x0 = fields[:, QF_BBOX_X0]
    y0 = fields[:, QF_BBOX_Y0]
    x1 = fields[:, QF_BBOX_X1]
    y1 = fields[:, QF_BBOX_Y1]

    ty = y_offset + jnp.arange(tiles_y, dtype=jnp.float32) * tile_h
    tx = jnp.arange(tiles_x, dtype=jnp.float32) * tile_w
    # tile t covers pixel centers [t0 + 0.5, t0 + tile - 0.5]
    tx0 = tx[None, :, None]  # (1, TX, 1)
    ty0 = ty[:, None, None]  # (TY, 1, 1)

    idx_range = jnp.arange(n)
    valid = (idx_range >= start) & (idx_range < end)
    hit_x = (x0[None, None, :] < tx0 + tile_w) & (x1[None, None, :] > tx0)
    hit_y = (y0[None, None, :] < ty0 + tile_h) & (y1[None, None, :] > ty0)
    mask = hit_x & hit_y & valid[None, None, :]  # (TY, TX, N)
    mask = mask.reshape(tiles_y * tiles_x, n)

    idx = jnp.arange(n, dtype=jnp.int32)
    if modes is not None:
        m = modes[:, QI_MODE]
        rest = m % 256  # mode + 128*elliptical (elliptical → rest >= 128)
        fill_mode = m // 256
        # per-pixel fill alpha is a convex combination of the four vertex
        # colors (+ mid/stop for gradient fill modes) — quad_eval.py:184-212
        # — so the min of those alphas lower-bounds the quad's alpha anywhere
        a_min = jnp.minimum(
            jnp.minimum(fields[:, QF_COLOR0 + 3], fields[:, QF_COLOR0 + 7]),
            jnp.minimum(fields[:, QF_COLOR0 + 11], fields[:, QF_COLOR0 + 15]),
        )
        a_min = jnp.where(
            fill_mode == 0,
            a_min,
            jnp.minimum(
                a_min,
                jnp.minimum(
                    fields[:, QF_MID_COLOR + 3], fields[:, QF_STOP_COLOR + 3]
                ),
            ),
        )
        radii = fields[:, QF_RADII : QF_RADII + 4]
        hx = fields[:, QF_PARAMS + 2]  # shape half-extents
        hy = fields[:, QF_PARAMS + 3]
        elliptical = rest >= 128
        # elliptical corners carry 12+12-bit packed (x, y) radii (negative =
        # circular, radius -v-1) — decode per corner (sdf.py:58-75) so the
        # per-axis interior inset is the max decoded radius on that axis
        circ_r = -radii - 1.0
        pk = jnp.where(radii >= 8388608.0, radii, jnp.floor(radii + 0.5))
        rx = jnp.where(radii < 0.0, circ_r,
                       jnp.mod(pk, 4096.0) * hx[:, None] / 4095.0)
        ry = jnp.where(radii < 0.0, circ_r,
                       jnp.floor(pk / 4096.0) * hy[:, None] / 4095.0)
        max_r = jnp.max(radii, axis=1)
        inset_x = jnp.where(elliptical, jnp.max(rx, axis=1), max_r)
        inset_y = jnp.where(elliptical, jnp.max(ry, axis=1), max_r)
        margin = 0.5 / jnp.maximum(fields[:, QF_AA], 1e-3) + 0.01
        ihx = hx - inset_x - margin
        ihy = hy - inset_y - margin
        radii_ok = jnp.where(
            elliptical,
            jnp.all((rx >= 0.0) & (ry >= 0.0), axis=1),
            jnp.all(radii >= 0.0, axis=1),
        )
        coverer = (
            (rest % 128 == 3)  # ClipAA, circular or elliptical corners
            & (modes[:, QI_MASK] == 0)
            & (fields[:, QF_INV_B] == 0.0)
            & (fields[:, QF_INV_C] == 0.0)
            & (fields[:, QF_RECT_PARAMS + 2] < 0.0)  # rect mask disabled
            & radii_ok
            & (ihx > 0.0)
            & (ihy > 0.0)
        )
        cx = (x0 + x1) * 0.5  # axis-aligned: bbox center == shape center
        cy = (y0 + y1) * 0.5
        cov_x = ((cx - ihx)[None, None, :] <= tx0 + 0.5) & (
            (cx + ihx)[None, None, :] >= tx0 + tile_w - 0.5
        )
        cov_y = ((cy - ihy)[None, None, :] <= ty0 + 0.5) & (
            (cy + ihy)[None, None, :] >= ty0 + tile_h - 0.5
        )
        covers_any = (
            (cov_x & cov_y).reshape(tiles_y * tiles_x, n)
            & coverer[None, :]
            & valid[None, :]
        )
        covers = covers_any & (a_min >= 1.0)[None, :]  # exact: opaque covers
        saturate = n >= SAT_MIN_QUADS
        if saturate:
            # translucent-stack SATURATION (dense tapes only): per tile,
            # suffix-sum the log2 transmittance of constant-alpha full
            # covers; a quad whose above-stack transmits < 2^LOG2_SAT_EPS
            # is invisible to within 1/2048 total and is dropped together
            # with everything below it — the 10-50x binning leverage of
            # SURVEY.md §7 hard-part 7 for stacked-translucent scenes
            lt = jnp.where(
                covers_any,
                jnp.log2(jnp.maximum(1.0 - a_min, 2.0 ** -24))[None, :],
                0.0,
            )
            suf = jnp.cumsum(lt[:, ::-1], axis=1)[:, ::-1]  # sum_{j>=i}
            above = suf - lt  # sum_{j>i}
        if run_bounds is None:
            last_cover = jnp.max(
                jnp.where(covers, idx[None, :], -1), axis=1, keepdims=True
            )
            mask = mask & (idx[None, :] >= last_cover)
            if saturate:
                # lt is zero outside [start, end) (valid gates covers_any),
                # so `above` is already windowed to this run
                mask = mask & (above >= LOG2_SAT_EPS)
        else:
            # run-scoped culling: per tile, the last cover WITHIN each run
            # bounds that run's quads only; quads outside every run keep -1
            thresh = jnp.full((tiles_y * tiles_x, n), -1, jnp.int32)
            keep_sat = None
            if saturate:
                # runs are contiguous, so for i in run r the within-run
                # above-stack is sum_{i<j<e_r} = above[i] - suf[e_r]
                suf_pad = jnp.concatenate(
                    [suf, jnp.zeros((suf.shape[0], 1), suf.dtype)], axis=1
                )
                keep_sat = jnp.ones_like(mask)
            for r in range(n_runs):
                s_r = run_bounds[r, 0]
                e_r = run_bounds[r, 1]
                in_r = (idx >= s_r) & (idx < e_r)
                last_r = jnp.max(
                    jnp.where(covers & in_r[None, :], idx[None, :], -1),
                    axis=1, keepdims=True,
                )
                thresh = jnp.where(in_r[None, :], last_r, thresh)
                if saturate:
                    above_r = above - jnp.take(suf_pad, e_r, axis=1)[:, None]
                    keep_sat = keep_sat & (
                        ~in_r[None, :] | (above_r >= LOG2_SAT_EPS)
                    )
            mask = mask & (idx[None, :] >= thresh)
            if keep_sat is not None:
                mask = mask & keep_sat

    keys = jnp.where(mask, idx, n + idx)  # intersecting first, draw order kept
    order = jnp.argsort(keys, axis=1).astype(jnp.int32)
    counts = mask.sum(axis=1).astype(jnp.int32)
    return order, counts
