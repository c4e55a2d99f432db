"""Tiled Pallas rasterizer (Triton route): per-tile ordered alpha compositing.

The performance path replacing ops/raster_ref.py's whole-frame quad loop —
the GPU analog of the GL fragment pipeline (SURVEY.md §7 step 3):

  1. bin_quads (XLA) maps quad AABBs to per-bin index lists in draw order
  2. one Pallas program per (TILE_H, TILE_W) block of the frame walks its
     bin's quads with `lax.fori_loop`, evaluates the SDF fragment math over
     the block and source-over blends in registers — an ordered loop, not a
     commutative reduce, preserving GL draw order
  3. only the final block color is written back, once per pass

Bins may be coarser than the program block (BIN_H x BIN_W): every program
of a bin reads the same index list and skips, with one scalar bbox test,
the quads that miss its own block. The tape, the modes and the index lists
stay in device memory and are read with scalar loads.

Atlas-sampling modes (0, 13-16) need gathers; the executors route runs
containing them through the XLA windowed evaluator (ops/raster_ref.py).

Frame layout inside the pass is channel-planar (4, H, W), so each plane of
a block is one contiguous 2-D tensor in registers.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from .binning import bin_quads
from .layout import QF_BBOX_X0, QF_BBOX_X1, QF_BBOX_Y0, QF_BBOX_Y1, QI_MASK, QI_MODE
from .quad_eval_planar import eval_quad_planar

# One program rasterizes a (TILE_H, TILE_W) block: Triton wants power-of-two
# block shapes, and the four f32 colour planes of the block are the loop
# carry, so the block must fit the register file with room to evaluate.
TILE_H = 32
TILE_W = 32
# Binning granularity (a multiple of the program block). The dense (T, N)
# argsort in bin_quads grows with the bin count, so bins stay coarser than
# the program block and several programs share one bin's list.
BIN_H = 64
BIN_W = 128
NUM_WARPS = 4
NUM_STAGES = 1

# modes that sample the atlas texture: sdfModeAtlas + the MSDF family
ATLAS_BASE_MODES = (0, 13, 14, 15, 16)


def _interpret(platform: str | None = None) -> bool:
    """Interpret mode on the CPU (the test path); compiled on the GPU."""
    platform = platform or jax.default_backend()
    if platform == "cpu":
        return True
    if platform == "gpu":
        return False
    raise RuntimeError(
        f"the Pallas rasterizer runs on 'gpu' (Triton) or 'cpu' (interpret "
        f"mode), not on {platform!r}; use FigRenderer(use_pallas=False)"
    )


def _compiler_params():
    return plt.CompilerParams(num_warps=NUM_WARPS, num_stages=NUM_STAGES)


def padded_size(height: int, width: int, bin_h: int = BIN_H,
                bin_w: int = BIN_W):
    """Frame size rounded up to whole bins (every bin holds whole blocks)."""
    return -(-height // bin_h) * bin_h, -(-width // bin_w) * bin_w


def _bin_of(ty, tx, sub_y: int, sub_x: int, bins_x: int):
    """Bin holding program block (ty, tx)."""
    return (ty // sub_y) * bins_x + tx // sub_x


def _lower_bound(tidx_ref, count, value):
    """First position in the bin's (ascending) valid index list with
    tidx >= value — scalar binary search over device memory."""

    def cond(c):
        lo, hi = c
        return lo < hi

    def body(c):
        lo, hi = c
        mid = (lo + hi) // 2
        v = tidx_ref[mid]
        return jax.lax.cond(
            v < value, lambda: (mid + 1, hi), lambda: (lo, mid)
        )

    lo, _hi = jax.lax.while_loop(cond, body, (jnp.int32(0), count))
    return lo


def _block_coords(row0, th: int, tw: int):
    """(x0, y0, px, py): the block's top-left corner in frame coordinates
    and its (th, tw) pixel-centre grids."""
    ty = pl.program_id(0)
    tx = pl.program_id(1)
    y0 = (row0 + ty * th).astype(jnp.float32)
    x0 = (tx * tw).astype(jnp.float32)
    iy = jax.lax.broadcasted_iota(jnp.int32, (th, tw), 0).astype(jnp.float32)
    ix = jax.lax.broadcasted_iota(jnp.int32, (th, tw), 1).astype(jnp.float32)
    return x0, y0, x0 + ix + 0.5, y0 + iy + 0.5


def _touches_block(fields_ref, qi, x0, y0, th: int, tw: int):
    """bin_quads's intersection test, at the granularity of one block."""
    return (
        (fields_ref[qi, QF_BBOX_X0] < x0 + tw)
        & (fields_ref[qi, QF_BBOX_X1] > x0)
        & (fields_ref[qi, QF_BBOX_Y0] < y0 + th)
        & (fields_ref[qi, QF_BBOX_Y1] > y0)
    )


def _mask_read(masks_ref, mask_i, fa):
    """fa times mask plane mask_i; plane 0 is all-ones (raster_ref's
    contract), so the common unmasked quad loads nothing."""
    return jax.lax.cond(
        mask_i == 0, lambda: fa, lambda: fa * masks_ref[mask_i]
    )


def _kernel(counts_ref, seg_ref, fields_ref, modes_ref, tidx_ref, frame_ref,
            masks_ref, *rest, sub_y: int, sub_x: int, bins_x: int,
            has_backdrop: bool, mask_target: bool = False):
    """seg_ref: (3,) [start, end, row0]: the [start, end) quad-id range of
    this draw run (or a range covering everything) plus the global row of
    block row 0 (nonzero when this kernel rasterizes one device's row band
    of a mesh-sharded frame). Within a bin the binned list is ascending,
    and a run's quads form a contiguous segment of it (runs partition the
    tape in draw order)."""
    rest = list(rest)
    backdrop_ref = rest.pop(0) if has_backdrop else None
    (out_ref,) = rest
    b = _bin_of(pl.program_id(0), pl.program_id(1), sub_y, sub_x, bins_x)
    count = counts_ref[b]
    j_lo = _lower_bound(tidx_ref, count, seg_ref[0])
    j_hi = _lower_bound(tidx_ref, count, seg_ref[1])

    th, tw = frame_ref.shape[1], frame_ref.shape[2]
    x0, y0, px, py = _block_coords(seg_ref[2], th, tw)

    if has_backdrop:
        bd = (backdrop_ref[0], backdrop_ref[1], backdrop_ref[2], backdrop_ref[3])
    else:
        bd = None

    def fetch(j):
        qi = tidx_ref[j]
        return qi, (lambda k: fields_ref[qi, k])

    if mask_target:
        # mask plane write: m = a^2 + m*(1-a), parent multiply via masks_ref
        # (glsl/mask.frag:233 through the GL blend)
        def body(j, m):
            qi, fget = fetch(j)

            def draw(m):
                _fr, _fg, _fb, fa = eval_quad_planar(
                    fget, modes_ref[qi, QI_MODE], px, py)
                fa = _mask_read(masks_ref, modes_ref[qi, QI_MASK], fa)
                return fa * fa + m * (1.0 - fa)

            return jax.lax.cond(_touches_block(fields_ref, qi, x0, y0, th, tw),
                                draw, lambda m: m, m)

        out_ref[0] = jax.lax.fori_loop(j_lo, j_hi, body, frame_ref[0])
        return

    # back-to-front source-over: the loop body carries only the
    # accumulation dependency
    def body(j, carry):
        qi, fget = fetch(j)

        def draw(carry):
            r, g, b, a = carry
            fr, fg, fb, fa = eval_quad_planar(
                fget, modes_ref[qi, QI_MODE], px, py, backdrop_planes=bd)
            fa = _mask_read(masks_ref, modes_ref[qi, QI_MASK], fa)
            inv = 1.0 - fa
            return (fr * fa + r * inv, fg * fa + g * inv, fb * fa + b * inv,
                    fa + a * inv)

        return jax.lax.cond(_touches_block(fields_ref, qi, x0, y0, th, tw),
                            draw, lambda c: c, carry)

    init = (frame_ref[0], frame_ref[1], frame_ref[2], frame_ref[3])
    r, g, b, a = jax.lax.fori_loop(j_lo, j_hi, body, init)
    out_ref[0] = r
    out_ref[1] = g
    out_ref[2] = b
    out_ref[3] = a


def _grid_specs(ph: int, pw: int, bin_h: int, bin_w: int, n: int):
    """Grid, block map and bin-row spec shared by both kernels."""
    th, tw = TILE_H, TILE_W
    assert bin_h % th == 0 and bin_w % tw == 0, (bin_h, bin_w)
    assert ph % bin_h == 0 and pw % bin_w == 0, (ph, pw, bin_h, bin_w)
    sub_y, sub_x = bin_h // th, bin_w // tw
    bins_x = pw // bin_w
    grid = (ph // th, pw // tw)

    def block_map(ty, tx):
        return (0, ty, tx)

    tidx_spec = pl.BlockSpec(
        (None, n), lambda ty, tx: (_bin_of(ty, tx, sub_y, sub_x, bins_x), 0))
    return grid, block_map, tidx_spec, (sub_y, sub_x, bins_x)


@functools.partial(
    jax.jit,
    static_argnames=("bin_h", "bin_w", "has_backdrop", "mask_target"),
)
def _raster_tiles(fields, modes, tile_idx, tile_counts, seg, frame_planes,
                  masks, backdrop_planes, bin_h: int, bin_w: int,
                  has_backdrop: bool, mask_target: bool = False):
    n = fields.shape[0]
    planes, ph, pw = frame_planes.shape
    n_masks = masks.shape[0]
    th, tw = TILE_H, TILE_W
    grid, block_map, tidx_spec, (sub_y, sub_x, bins_x) = _grid_specs(
        ph, pw, bin_h, bin_w, n)
    whole = pl.BlockSpec()
    in_specs = [
        whole,  # tile_counts
        whole,  # seg
        whole,  # fields
        whole,  # modes
        tidx_spec,  # this block's bin list
        pl.BlockSpec((planes, th, tw), block_map),  # target block
        pl.BlockSpec((n_masks, th, tw), block_map),  # mask blocks
    ]
    inputs = [tile_counts, seg, fields, modes, tile_idx, frame_planes, masks]
    if has_backdrop:
        in_specs.append(pl.BlockSpec((4, th, tw), block_map))
        inputs.append(backdrop_planes)

    kernel = functools.partial(
        _kernel, sub_y=sub_y, sub_x=sub_x, bins_x=bins_x,
        has_backdrop=has_backdrop, mask_target=mask_target,
    )
    return pl.pallas_call(
        kernel,
        grid=grid,
        in_specs=in_specs,
        out_specs=pl.BlockSpec((planes, th, tw), block_map),
        out_shape=jax.ShapeDtypeStruct(frame_planes.shape, jnp.float32),
        backend="triton",
        compiler_params=_compiler_params(),
        interpret=_interpret(),
        name="figdraw_tile_raster",
    )(*inputs)


def _row0(y_offset):
    return (
        jnp.int32(0) if y_offset is None
        else jnp.asarray(y_offset).astype(jnp.int32)
    )


def _seg3(start, end, y_offset):
    return jnp.stack([
        jnp.asarray(start).astype(jnp.int32),
        jnp.asarray(end).astype(jnp.int32),
        _row0(y_offset),
    ])


def draw_pass_planar(fields, modes, start, end, frame_planes, masks_p,
                     backdrop_planes=None, y_offset=None,
                     bin_h: int = BIN_H, bin_w: int = BIN_W):
    """Planar-layout draw pass over quads [start, end) — the building block
    the fused frame executor chains inside one jit.

    frame_planes: (4, PH, PW) f32 with PH, PW multiples of the bin size;
    masks_p: (K, PH, PW); backdrop_planes: (4, PH, PW) or None. y_offset:
    global row of frame_planes row 0 when row-sharded over a mesh.
    """
    ph, pw = frame_planes.shape[1], frame_planes.shape[2]
    row0 = _row0(y_offset)
    # modes enables opaque occlusion: every quad in this run targets the
    # frame, so a full-bin opaque quad truncates the bin's list
    tile_idx, tile_counts = bin_quads(
        fields, start, end, ph // bin_h, pw // bin_w, bin_h, bin_w,
        y_offset=row0.astype(jnp.float32), modes=modes,
    )
    seg = jnp.stack([jnp.int32(0), jnp.int32(2**30), row0])  # whole list
    return _raster_tiles(
        fields, modes, tile_idx, tile_counts, seg, frame_planes, masks_p,
        backdrop_planes, bin_h=bin_h, bin_w=bin_w,
        has_backdrop=backdrop_planes is not None,
    )


def prebin(fields, n_quads, ph: int, pw: int, y_offset=None,
           bin_h: int = BIN_H, bin_w: int = BIN_W, modes=None,
           run_bounds=None, n_runs: int = 0):
    """Bin the whole tape once; draw runs then select their contiguous
    per-bin segments in-kernel (runs partition the tape in draw order, and
    each bin's list is ascending). modes + run_bounds (n_runs static)
    enable run-scoped opaque-occlusion culling in the same single argsort
    (see binning.bin_quads)."""
    y0 = jnp.float32(0) if y_offset is None else y_offset.astype(jnp.float32)
    return bin_quads(
        fields, jnp.int32(0), n_quads, ph // bin_h, pw // bin_w, bin_h, bin_w,
        y_offset=y0, modes=modes, run_bounds=run_bounds, n_runs=n_runs,
    )


def draw_pass_planar_prebinned(fields, modes, start, end, tile_idx, tile_counts,
                               frame_planes, masks_p, backdrop_planes=None,
                               y_offset=None, bin_h: int = BIN_H,
                               bin_w: int = BIN_W):
    return _raster_tiles(
        fields, modes, tile_idx, tile_counts, _seg3(start, end, y_offset),
        frame_planes, masks_p, backdrop_planes, bin_h=bin_h, bin_w=bin_w,
        has_backdrop=backdrop_planes is not None,
    )


def draw_pass_mask_prebinned(fields, modes, start, end, tile_idx, tile_counts,
                             mask_plane, masks_p, y_offset=None,
                             bin_h: int = BIN_H, bin_w: int = BIN_W):
    """Binned mask-plane write (a^2 + m(1-a) blend); mask_plane: (1, PH, PW)."""
    return _raster_tiles(
        fields, modes, tile_idx, tile_counts, _seg3(start, end, y_offset),
        mask_plane, masks_p, None, bin_h=bin_h, bin_w=bin_w,
        has_backdrop=False, mask_target=True,
    )


# --- megakernel: the whole multi-pass frame as ONE tile walk ---------------------
#
# Mask-heavy scenes (one clip per table cell — the reference's
# windy_clip_mask_benchmark) cost one full-frame pass per draw run and per
# mask write in the rolled executor: ~3 passes per cell, each reading and
# writing every frame block. The megakernel removes the pass structure: the
# executor bakes each quad's TARGET (frame or mask plane k) and the
# clear-mask boundaries into the mode lane's high bits, and one kernel walks
# each block's binned quads once in tape order, holding the frame AND the
# mask planes in registers. Device-memory traffic is one frame read + one
# write, independent of how many masks the scene uses.
#
# Mode-lane packing (host side, executor.pack_mega_modes):
#   bits  0-11  sdf mode (mode + 128*elliptical + 256*fillMode, < 4096)
#   bit     12  clear-mask sentinel (fields row carries the cleared bbox)
#   bits 16+    target + 1 (0 = frame, k+1 = mask plane k)

MEGA_CLEAR_BIT = 1 << 12
MEGA_TARGET_SHIFT = 16
MEGA_MODE_MASK = 0xFFF
# Mask planes the megakernel carries in registers next to the four colour
# planes. Frames with more planes take the rolled executor, chosen by shape
# when the frame is planned (renderer._plan_execution, native.flatten_fast).
MEGA_MAX_MASKS = 8


def mega_fits(n_masks: int) -> bool:
    """Whether a frame with n_masks planes (incl. the all-pass plane 0)
    takes the megakernel."""
    return n_masks <= MEGA_MAX_MASKS


def _mega_kernel(counts_ref, seg_ref, fields_ref, modes_ref, tidx_ref,
                 frame_ref, out_ref, *, sub_y: int, sub_x: int, bins_x: int,
                 n_masks: int):
    b = _bin_of(pl.program_id(0), pl.program_id(1), sub_y, sub_x, bins_x)
    count = counts_ref[b]
    th, tw = frame_ref.shape[1], frame_ref.shape[2]
    x0, y0, px, py = _block_coords(seg_ref[0], th, tw)

    # mask planes live as n_masks SEPARATE (th, tw) registers in the carry:
    # n_masks is static, so plane selection is a lax.switch over the scalar
    # plane index — one branch executes
    ones = jnp.ones((th, tw), jnp.float32)
    zeros = jnp.zeros((th, tw), jnp.float32)
    masks0 = (ones,) + (zeros,) * (n_masks - 1)  # plane 0 = all-pass parent

    def _plane(masks, k):
        """masks[k] for a clamped scalar k (one switch branch executes)."""
        if n_masks == 1:
            return masks[0]
        k = jnp.clip(k, 0, n_masks - 1)
        return jax.lax.switch(k, [lambda m=m: m for m in masks])

    def _with_plane(masks, k, new):
        """masks with plane k replaced (k >= 1: plane 0 is never a target)."""
        if n_masks <= 1:
            return masks
        k = jnp.clip(k, 1, n_masks - 1)
        return jax.lax.switch(
            k - 1,
            [
                lambda i=i: tuple(
                    new if j == i + 1 else masks[j] for j in range(n_masks)
                )
                for i in range(n_masks - 1)
            ],
        )

    def body(j, carry):
        qi = tidx_ref[j]
        raw = modes_ref[qi, QI_MODE]
        tgt_enc = jax.lax.shift_right_logical(raw, MEGA_TARGET_SHIFT)
        is_clear = jax.lax.shift_right_logical(raw, 12) & 1
        mode = raw & MEGA_MODE_MASK
        mask_i = modes_ref[qi, QI_MASK]

        def clear_branch(c):
            r, g, b, a, *masks = c
            return (r, g, b, a) + _with_plane(tuple(masks), tgt_enc - 1, zeros)

        def draw_branch(c):
            r, g, b, a, *masks = c
            masks = tuple(masks)
            fr, fg, fb, fa = eval_quad_planar(
                lambda k: fields_ref[qi, k], mode, px, py)
            fa = fa * _plane(masks, mask_i)

            def to_frame(_):
                inv = 1.0 - fa
                return (fr * fa + r * inv, fg * fa + g * inv,
                        fb * fa + b * inv, fa + a * inv) + masks

            def to_mask(_):
                tk = tgt_enc - 1
                cur = _plane(masks, tk)
                new = fa * fa + cur * (1.0 - fa)  # mask.frag through GL blend
                return (r, g, b, a) + _with_plane(masks, tk, new)

            return jax.lax.cond(tgt_enc == 0, to_frame, to_mask, None)

        def step(c):
            return jax.lax.cond(is_clear == 1, clear_branch, draw_branch, c)

        return jax.lax.cond(_touches_block(fields_ref, qi, x0, y0, th, tw),
                            step, lambda c: c, carry)

    init = (frame_ref[0], frame_ref[1], frame_ref[2], frame_ref[3]) + masks0
    r, g, b, a, *_masks = jax.lax.fori_loop(jnp.int32(0), count, body, init)
    out_ref[0] = r
    out_ref[1] = g
    out_ref[2] = b
    out_ref[3] = a


@functools.partial(jax.jit, static_argnames=("n_masks", "bin_h", "bin_w"))
def _raster_mega(fields, modes, tile_idx, tile_counts, seg, frame_planes,
                 n_masks: int, bin_h: int, bin_w: int):
    n = fields.shape[0]
    _planes, ph, pw = frame_planes.shape
    grid, block_map, tidx_spec, (sub_y, sub_x, bins_x) = _grid_specs(
        ph, pw, bin_h, bin_w, n)
    whole = pl.BlockSpec()
    kernel = functools.partial(
        _mega_kernel, sub_y=sub_y, sub_x=sub_x, bins_x=bins_x,
        n_masks=n_masks,
    )
    return pl.pallas_call(
        kernel,
        grid=grid,
        in_specs=[
            whole, whole, whole, whole, tidx_spec,
            pl.BlockSpec((4, TILE_H, TILE_W), block_map),
        ],
        out_specs=pl.BlockSpec((4, TILE_H, TILE_W), block_map),
        out_shape=jax.ShapeDtypeStruct(frame_planes.shape, jnp.float32),
        backend="triton",
        compiler_params=_compiler_params(),
        interpret=_interpret(),
        name="figdraw_mega_raster",
    )(tile_counts, seg, fields, modes, tile_idx, frame_planes)


def draw_pass_mega(fields, modes, frame_planes, n_masks: int, y_offset=None,
                   bin_h: int = BIN_H, bin_w: int = BIN_W):
    """One-kernel whole frame over target-baked modes; frame_planes (4, PH, PW)."""
    if not mega_fits(n_masks):
        raise ValueError(
            f"{n_masks} mask planes exceed the megakernel's register budget "
            f"({MEGA_MAX_MASKS}); plan the frame on the rolled executor")
    ph, pw = frame_planes.shape[1], frame_planes.shape[2]
    tile_idx, tile_counts = prebin(
        fields, jnp.int32(fields.shape[0]), ph, pw, y_offset=y_offset,
        bin_h=bin_h, bin_w=bin_w,
    )
    return _raster_mega(
        fields, modes, tile_idx, tile_counts, _row0(y_offset)[None],
        frame_planes, n_masks=n_masks, bin_h=bin_h, bin_w=bin_w,
    )


def draw_pass_frame(fields, modes, count, frame, masks, backdrop=None):
    """(H, W, 4)-layout convenience wrapper around draw_pass_planar: pads
    the frame to whole bins, rasterizes, crops."""
    height, width = frame.shape[0], frame.shape[1]
    ph, pw = padded_size(height, width)
    pad = ((0, 0), (0, ph - height), (0, pw - width))

    frame_planes = jnp.pad(jnp.transpose(frame, (2, 0, 1)), pad)
    masks_p = jnp.pad(masks, pad)
    backdrop_planes = (
        None if backdrop is None
        else jnp.pad(jnp.transpose(backdrop, (2, 0, 1)), pad)
    )
    out = draw_pass_planar(
        fields, modes, jnp.int32(0), count, frame_planes, masks_p, backdrop_planes
    )
    return jnp.transpose(out[:, :height, :width], (1, 2, 0))
