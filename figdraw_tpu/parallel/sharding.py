"""Multi-chip scale-out: tile-space sharding of the rasterizer over a Mesh.

The reference has no distributed axis (SURVEY.md §2.9); this renderer's
scale-out is framebuffer decomposition: shard frame rows across devices with
`shard_map`, broadcast the (small) quad tape, and let every device rasterize
its own rows. No collectives are needed in the draw pass — each row band is
independent — so the whole frame scales with the device count until the
tape broadcast dominates. Backdrop blur's vertical pass is the one
cross-band dependency; the sharded executor handles it with a halo exchange
via jax.lax.ppermute (neighbor rows only, 2×64 px per boundary). The mesh is
flat and 1-D: on one host the GPUs reach each other over NVLink at the same
rate, so no device order is better than another.
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from jax import shard_map

from ..ops import raster_ref
from ..ops.blur import _blur_axis

ROWS_AXIS = "rows"


def make_sharded_draw_pass(mesh: Mesh, subpixel_positioning: bool = False):
    """Returns a jitted draw pass with the frame row-sharded over `mesh`.

    Signature: (fields, modes, count, frame, masks, backdrop) -> frame,
    where frame/masks/backdrop are globally (H, W, 4) / (K, H, W) / (H, W, 4)
    with H divisible by the mesh axis size.
    """

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(
            P(),  # fields (replicated)
            P(),  # modes
            P(),  # count
            P(ROWS_AXIS, None, None),  # frame rows
            P(None, ROWS_AXIS, None),  # masks rows
            P(ROWS_AXIS, None, None),  # backdrop rows
        ),
        out_specs=P(ROWS_AXIS, None, None),
        check_vma=False,
    )
    def draw(fields, modes, count, frame, masks, backdrop):
        local_h = frame.shape[0]
        row0 = jax.lax.axis_index(ROWS_AXIS) * local_h
        return raster_ref.draw_pass_frame(
            fields,
            modes,
            count,
            frame,
            masks,
            atlas=None,
            backdrop=backdrop,
            subpixel_positioning=subpixel_positioning,
            y_offset=row0.astype(jnp.float32),
        )

    return jax.jit(draw)


def make_sharded_blur(mesh: Mesh, max_radius: float = 64.0):
    """Row-sharded separable backdrop blur with a ppermute halo exchange.

    The horizontal pass is embarrassingly row-parallel; the vertical pass
    needs up to ceil(radius) = 64 rows of halo from each neighbor
    (blur.frag:12 clamps the radius to 64, so the halo bound is static).
    """
    halo = int(max_radius) + 1  # +1: linear tap interpolation reads floor(x)+1
    axis_size = mesh.shape[ROWS_AXIS]

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(ROWS_AXIS, None, None), P()),
        out_specs=P(ROWS_AXIS, None, None),
        check_vma=False,
    )
    def blur(frame, radius):
        local = _blur_axis(frame, radius, axis=1)  # horizontal, local
        local_h = local.shape[0]
        idx = jax.lax.axis_index(ROWS_AXIS)
        if halo >= local_h:
            # bands shorter than the blur reach: gather all rows, blur, take
            # our band back (small frames only — 1080p/8 bands are 135 rows)
            gathered = jax.lax.all_gather(local, ROWS_AXIS, axis=0, tiled=True)
            blurred = _blur_axis(gathered, radius, axis=0)
            return jax.lax.dynamic_slice_in_dim(blurred, idx * local_h, local_h, 0)
        # halo exchange: receive the last `halo` rows of the upper neighbor and
        # the first `halo` rows of the lower neighbor
        up = [(i, (i + 1) % axis_size) for i in range(axis_size)]
        down = [(i, (i - 1) % axis_size) for i in range(axis_size)]
        from_above = jax.lax.ppermute(local[-halo:], ROWS_AXIS, up)
        from_below = jax.lax.ppermute(local[:halo], ROWS_AXIS, down)
        # clamp-to-edge at the global boundary: replicate own edge rows
        top_pad = jnp.where(idx == 0, jnp.repeat(local[:1], halo, axis=0), from_above)
        bot_pad = jnp.where(
            idx == axis_size - 1, jnp.repeat(local[-1:], halo, axis=0), from_below
        )
        extended = jnp.concatenate([top_pad, local, bot_pad], axis=0)
        blurred = _blur_axis(extended, radius, axis=0)
        return blurred[halo:-halo]

    return jax.jit(blur)


def default_mesh(n_devices: Optional[int] = None) -> Mesh:
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    import numpy as np

    return Mesh(np.array(devices), (ROWS_AXIS,))


# --- sharded fused executor ------------------------------------------------------
#
# The multi-device PERFORMANCE path: the whole frame — Pallas band
# rasterization, mask-plane writes, halo-exchange backdrop blur, windowed
# atlas draws — runs inside ONE jitted shard_map. One replicated tape upload
# (executor.pack_tape_upload), one dispatch per frame, each device owning a
# contiguous row band.
#
# Band geometry: each device's band is padded to a multiple of the shard bin
# height — one program block (raster_pallas.TILE_H) — so padding stays under
# one block row per band. Rows past the true frame height render normally
# and are cropped off.

BLUR_HALO = 65  # radius clamp 64 (blur.frag:12) + 1 for the linear tap lerp


def _band_geometry(mesh: Mesh, height: int, width: int):
    """(n, bin_h, bin_w, band rows, global padded rows, padded width)."""
    from ..ops import raster_pallas

    n = mesh.shape[ROWS_AXIS]
    bh = raster_pallas.TILE_H
    bw = raster_pallas.BIN_W
    band = -(-height // n)
    pband = max(-(-band // bh) * bh, bh)
    gh = pband * n
    pw = -(-width // bw) * bw
    return n, bh, bw, pband, gh, pw


def _banded_blur_planar(local, radius, axis_size: int, halo: int = BLUR_HALO):
    """Separable backdrop blur on a channel-planar (4, h, w) row band inside a
    shard_map body: horizontal pass is band-local; the vertical pass reads up
    to `halo` rows from each neighbor via jax.lax.ppermute (clamp-to-edge at
    the global boundary by replicating own edge rows)."""
    local = _blur_axis(local, radius, axis=2)
    if axis_size == 1:
        return _blur_axis(local, radius, axis=1)
    local_h = local.shape[1]
    idx = jax.lax.axis_index(ROWS_AXIS)
    if halo >= local_h:
        # bands shorter than the blur reach: gather all rows, blur, slice back
        gathered = jax.lax.all_gather(local, ROWS_AXIS, axis=1, tiled=True)
        blurred = _blur_axis(gathered, radius, axis=1)
        return jax.lax.dynamic_slice_in_dim(blurred, idx * local_h, local_h, 1)
    up = [(i, (i + 1) % axis_size) for i in range(axis_size)]
    down = [(i, (i - 1) % axis_size) for i in range(axis_size)]
    from_above = jax.lax.ppermute(local[:, -halo:], ROWS_AXIS, up)
    from_below = jax.lax.ppermute(local[:, :halo], ROWS_AXIS, down)
    top = jnp.where(idx == 0, jnp.repeat(local[:, :1], halo, axis=1), from_above)
    bot = jnp.where(
        idx == axis_size - 1, jnp.repeat(local[:, -1:], halo, axis=1), from_below
    )
    extended = jnp.concatenate([top, local, bot], axis=1)
    return _blur_axis(extended, radius, axis=1)[:, halo:-halo]


@lru_cache(maxsize=32)
def get_sharded_frame_executor(
    mesh: Mesh,
    structure: tuple,
    height: int,
    width: int,
    n_masks: int,
    use_pallas: bool,
    subpixel_positioning: bool,
    has_init_frame: bool,
    pixelate: bool = False,
):
    """Mesh-sharded analog of executor.get_frame_executor.

    Returns (run, (gh, pw)): run(combo, init_frame, atlas) -> (gh, pw, 4)
    global frame; crop to [:height, :width]. combo and atlas are replicated;
    init_frame must be (gh, pw, 4) when has_init_frame (row-sharded), else a
    (1, 1, 4) dummy (replicated)."""
    from .. import executor as ex
    from ..ops import raster_pallas
    from ..ops.layout import QF_WIDTH

    n_dev, th, tw, pband, gh, pw = _band_geometry(mesh, height, width)
    n_draws = sum(1 for item in structure if item[0] == "draw")
    n_blurs = sum(1 for item in structure if item[0] == "blur")
    any_blur = n_blurs > 0

    def to_hwc(p):
        return jnp.transpose(p, (1, 2, 0))

    def to_planes(h):
        return jnp.transpose(h, (2, 0, 1))

    def run_local(combo, init_frame, atlas):
        rows = ex._meta_rows(n_draws, n_blurs, QF_WIDTH + ex.COMBO_EXTRA)
        fields = combo[:-rows, :QF_WIDTH]
        modes = jax.lax.bitcast_convert_type(
            combo[:-rows, QF_WIDTH : QF_WIDTH + ex.COMBO_EXTRA], jnp.int32
        )
        meta = combo[-rows:].reshape(-1)
        nd2 = max(2 * n_draws, 2)
        bounds = jax.lax.bitcast_convert_type(meta[:nd2], jnp.int32).reshape(-1, 2)
        radii = meta[2 * n_draws : 2 * n_draws + max(n_blurs, 1)]
        clear_color = meta[2 * n_draws + n_blurs : 2 * n_draws + n_blurs + 4]

        row0 = jax.lax.axis_index(ROWS_AXIS).astype(jnp.int32) * pband
        y_off = row0.astype(jnp.float32)
        if has_init_frame:
            planes = to_planes(init_frame)
        else:
            planes = jnp.broadcast_to(
                clear_color[:, None, None], (4, pband, pw)
            ).astype(jnp.float32)
        masks = jnp.zeros((n_masks, pband, pw), jnp.float32).at[0].set(1.0)
        backdrop = jnp.zeros((4, pband, pw), jnp.float32) if any_blur else None

        if use_pallas:
            # bin the whole tape once per band; runs select their segments.
            # run-scoped occlusion culling, same as the single-device executor
            frame_draw_pos = [
                di_ for di_, item in enumerate(
                    [it for it in structure if it[0] == "draw"]
                )
                if item[1] == ex.FRAME_TARGET
            ]
            rb = (
                bounds[jnp.asarray(frame_draw_pos, jnp.int32)]
                if frame_draw_pos else None
            )
            tile_idx, tile_counts = raster_pallas.prebin(
                fields, jnp.int32(fields.shape[0]), pband, pw,
                y_offset=row0, bin_h=th, bin_w=tw,
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
                backdrop = _banded_blur_planar(planes, radii[bi], n_dev)
                bi += 1
            else:
                _, target, uses_atlas, needs_backdrop = item
                s = bounds[di, 0]
                e = bounds[di, 1]
                di += 1
                if target == ex.FRAME_TARGET:
                    if use_pallas and not uses_atlas:
                        planes = raster_pallas.draw_pass_planar_prebinned(
                            fields, modes, s, e, tile_idx, tile_counts,
                            planes, masks,
                            backdrop if needs_backdrop else None,
                            y_offset=row0, bin_h=th, bin_w=tw,
                        )
                    else:
                        hwc = to_hwc(planes)
                        if uses_atlas and not needs_backdrop:
                            hwc = raster_ref.draw_pass_frame_range_windowed(
                                fields, modes, s, e, hwc, masks, atlas=atlas,
                                subpixel_positioning=subpixel_positioning,
                                pixelate=pixelate, y_offset=y_off,
                            )
                        else:
                            hwc = raster_ref.draw_pass_frame_range(
                                fields, modes, s, e, hwc, masks,
                                atlas=atlas if uses_atlas else None,
                                backdrop=to_hwc(backdrop) if needs_backdrop else None,
                                subpixel_positioning=subpixel_positioning,
                                pixelate=pixelate, y_offset=y_off,
                            )
                        planes = to_planes(hwc)
                else:
                    if use_pallas and not uses_atlas:
                        plane = raster_pallas.draw_pass_mask_prebinned(
                            fields, modes, s, e, tile_idx, tile_counts,
                            masks[target][None], masks,
                            y_offset=row0, bin_h=th, bin_w=tw,
                        )[0]
                    else:
                        plane = raster_ref.draw_pass_mask_range(
                            fields, modes, s, e, masks[target], masks,
                            atlas=atlas if uses_atlas else None,
                            subpixel_positioning=subpixel_positioning,
                            pixelate=pixelate, y_offset=y_off,
                        )
                    masks = masks.at[target].set(plane)
        return to_hwc(planes)

    init_spec = P(ROWS_AXIS, None, None) if has_init_frame else P()
    sharded = shard_map(
        run_local,
        mesh=mesh,
        in_specs=(P(), init_spec, P()),
        out_specs=P(ROWS_AXIS, None, None),
        check_vma=False,
    )
    return jax.jit(sharded), (gh, pw)


@lru_cache(maxsize=32)
def get_sharded_mega_executor(
    mesh: Mesh, height: int, width: int, n_masks: int, has_init_frame: bool,
):
    """Mesh-sharded megakernel (executor.get_mega_executor): ONE Pallas tile
    walk per row band over target-baked modes. Returns (run, (gh, pw))."""
    from .. import executor as ex
    from ..ops import raster_pallas
    from ..ops.layout import QF_WIDTH

    n_dev, th, tw, pband, gh, pw = _band_geometry(mesh, height, width)

    def run_local(combo, init_frame):
        fields = combo[:-1, :QF_WIDTH]
        modes = jax.lax.bitcast_convert_type(
            combo[:-1, QF_WIDTH : QF_WIDTH + ex.COMBO_EXTRA], jnp.int32
        )
        clear_color = combo[-1][0:4]
        row0 = jax.lax.axis_index(ROWS_AXIS).astype(jnp.int32) * pband
        if has_init_frame:
            planes = jnp.transpose(init_frame, (2, 0, 1))
        else:
            planes = jnp.broadcast_to(
                clear_color[:, None, None], (4, pband, pw)
            ).astype(jnp.float32)
        planes = raster_pallas.draw_pass_mega(
            fields, modes, planes, n_masks,
            y_offset=row0, bin_h=th, bin_w=tw,
        )
        return jnp.transpose(planes, (1, 2, 0))

    init_spec = P(ROWS_AXIS, None, None) if has_init_frame else P()
    sharded = shard_map(
        run_local,
        mesh=mesh,
        in_specs=(P(), init_spec),
        out_specs=P(ROWS_AXIS, None, None),
        check_vma=False,
    )
    return jax.jit(sharded), (gh, pw)


class ShardedFigRenderer:
    """Multi-device frame renderer: the framebuffer row-sharded over a Mesh.

    The host flatten is unchanged (the quad tape is small and replicated);
    each device rasterizes its row band through the SAME performance stack as
    the single-device renderer — Pallas tile kernels (or the megakernel for
    mask-heavy pure-SDF scenes), one packed tape upload, the whole pass chain
    in one jitted shard_map — with backdrop blur exchanging halo rows between
    neighbouring bands. Scales the reference's pixel-parallel fragment work
    across devices — the axis the reference's single-GPU design never had
    (SURVEY.md §2.9).
    """

    def __init__(
        self,
        mesh: Optional[Mesh] = None,
        atlas_size: int = 256,
        use_pallas: Optional[bool] = None,
        pixel_scale: float = 1.0,
    ):
        from ..renderer import FigRenderer

        self.mesh = mesh if mesh is not None else default_mesh()
        self.n = self.mesh.shape[ROWS_AXIS]
        # reuse the single-chip renderer for flattening + atlas management
        self._flattener = FigRenderer(
            atlas_size=atlas_size, use_pallas=False, pixel_scale=pixel_scale
        )
        if use_pallas is None:
            from .. import config

            override = config.runtime_backend_override()
            use_pallas = (
                override if override is not None
                else jax.default_backend() == "gpu"
            )
        self.use_pallas = use_pallas
        self.last_frame = None
        self._last_padded = None

    def process_image_messages(self) -> None:
        self._flattener.process_image_messages()

    def _init_frame(self, gh: int, pw: int, has_init_frame: bool):
        if not has_init_frame:
            return jnp.zeros((1, 1, 4), jnp.float32)
        lp = self._last_padded
        if lp is not None and lp.shape == (gh, pw, 4):
            return lp
        return jnp.zeros((gh, pw, 4), jnp.float32)

    def render_frame(self, renders, frame_size, clear_main=True,
                     clear_color=(1.0, 1.0, 1.0, 1.0)):
        """Flatten on host, rasterize row-sharded; returns global (H, W, 4)."""
        from ..basics import scaled
        from ..colors import as_color

        fs = scaled(frame_size)
        self._flattener.process_image_messages()
        tape = self._flattener.flatten(renders, fs, clear_main,
                                       as_color(clear_color))
        frame = self.execute(tape)
        self._flattener.publish_atlas_usage()
        return frame

    def execute(self, tape) -> jnp.ndarray:
        """Runs the whole tape as ONE sharded device call — the multi-chip
        twin of FigRenderer.execute. Split into _plan (host packing + path
        choice) and _dispatch (device) like the single-chip execute."""
        return self._dispatch(self._plan(tape))

    def _plan(self, tape):
        """Host half: pad the tape, decide mega vs pass-chain, and pack the
        upload combos — the sharded twin of FigRenderer._plan_execution."""
        import numpy as np
        from types import SimpleNamespace

        from .. import executor as ex
        from ..ops.layout import QF_WIDTH, QI_WIDTH
        from ..renderer import ROLLED_THRESHOLD, _bucket

        width = int(round(tape.frame_size[0]))
        height = int(round(tape.frame_size[1]))
        n_masks = tape.mask_count + 1

        n = _bucket(max(tape.count, 1))
        fields = np.zeros((n, QF_WIDTH), dtype=np.float32)
        modes = np.zeros((n, QI_WIDTH), dtype=np.int32)
        fields[: tape.count] = tape.fields[: tape.count]
        modes[: tape.count] = tape.modes[: tape.count]

        from ..ops.raster_pallas import mega_fits

        structure, bounds, radii, is_atlas_mode, is_backdrop_mode = (
            ex.tape_structure(tape, modes)
        )
        seen_blur = any(item[0] == "blur" for item in structure)
        has_init_frame = tape.clear_color is None
        clear = np.asarray(tape.clear_color or (0, 0, 0, 0), dtype=np.float32)

        # same choice by shape as FigRenderer._plan_execution
        mega = (
            len(structure) > ROLLED_THRESHOLD
            and self.use_pallas
            and not seen_blur
            and not bool(is_atlas_mode[: tape.count].any())
            and not bool(is_backdrop_mode[: tape.count].any())
            and mega_fits(n_masks)
        )
        mega_combo = None
        if mega:
            mf, mm = ex.pack_mega_modes(
                tape, fields[: tape.count], modes[: tape.count]
            )
            nm = _bucket(max(mf.shape[0], 1))
            mega_fields = np.zeros((nm, QF_WIDTH), dtype=np.float32)
            mega_modes = np.zeros((nm, QI_WIDTH), dtype=np.int32)
            mega_fields[: mf.shape[0]] = mf
            mega_modes[: mm.shape[0]] = mm
            mega_combo = ex.pack_tape_upload(
                mega_fields, mega_modes, np.zeros((0, 2), np.int32),
                np.zeros((0,), np.float32), clear,
            )
        return SimpleNamespace(
            height=height, width=width, n_masks=n_masks,
            structure=structure, has_init_frame=has_init_frame, clear=clear,
            n_pad=n, fields=fields, modes=modes,
            bounds=np.asarray(bounds, dtype=np.int32).reshape(-1, 2),
            radii=np.asarray(radii, dtype=np.float32),
            mega=mega, mega_combo=mega_combo,
            combo=None,
        )

    def _frame_combo(self, plan):
        """Pass-chain upload combo, packed lazily (the mega path never needs
        it unless it downgrades)."""
        if plan.combo is None:
            from .. import executor as ex

            plan.combo = ex.pack_tape_upload(
                plan.fields, plan.modes, plan.bounds, plan.radii, plan.clear
            )
        return plan.combo

    def _dispatch(self, plan) -> jnp.ndarray:
        """Device half: upload the plan's combo and run the sharded executor
        the plan chose."""
        if plan.mega:
            run, (gh, pw) = get_sharded_mega_executor(
                self.mesh, plan.height, plan.width, plan.n_masks,
                plan.has_init_frame,
            )
            frame = run(
                jnp.asarray(plan.mega_combo),
                self._init_frame(gh, pw, plan.has_init_frame),
            )
        else:
            run, (gh, pw) = get_sharded_frame_executor(
                self.mesh, tuple(plan.structure), plan.height, plan.width,
                plan.n_masks, self.use_pallas,
                self._flattener.text_subpixel_positioning,
                plan.has_init_frame, self._flattener.pixelate,
            )
            frame = run(
                jnp.asarray(self._frame_combo(plan)),
                self._init_frame(gh, pw, plan.has_init_frame),
                self._flattener._device_atlas(),
            )
        self._last_padded = frame
        self.last_frame = frame[: plan.height, : plan.width]
        return self.last_frame

    # --- device-resident scenes on the mesh ---------------------------------

    def snapshot_scene(self, renders, frame_size, clear_main=True,
                       clear_color=(1.0, 1.0, 1.0, 1.0), reserve=None,
                       animate=False):
        """Flatten once (saturation cull OFF — panning can reveal culled
        quads) and park the replicated combo on the mesh; render_view then
        scrolls/zooms it row-sharded across devices for pure kernel cost —
        the multi-device twin of FigRenderer.snapshot_scene (incl. the
        retained-scene spans and per-root row reserves)."""
        from ..basics import scaled
        from ..colors import as_color
        from ..renderer import DeviceScene

        fs = scaled(frame_size)
        self._flattener.process_image_messages()
        tape = self._flattener.flatten(
            renders, fs, clear_main, as_color(clear_color), cull=False,
            record_spans=True, reserve=reserve,
        )
        plan = self._plan(tape)
        if animate and tape.mask_count:
            # the mega export interleaves clear sentinel rows when plane
            # masks exist, breaking the tape-row ↔ combo-row mapping the
            # animation table needs — stay on the frame executor
            plan.mega = False
        if plan.mega:
            kind = "mega"
            combo = plan.mega_combo
            n_quads = combo.shape[0] - 1  # one meta row (clear color)
        else:
            kind = "frame"
            combo = self._frame_combo(plan)
            n_quads = plan.n_pad
        scene = DeviceScene(
            kind=kind, plan=plan, combo_dev=jnp.asarray(combo),
            n_quads=n_quads, n_pad=plan.n_pad,
        )
        # retained-scene patch state (update_scene) — same mapping guard as
        # the single-chip snapshot: mega interleaves clear sentinel rows
        # when plane masks exist
        if getattr(tape, "root_spans", None) and not (
            kind == "mega" and tape.mask_count
        ):
            from ..renderer import _patchable_spans

            scene.spans = _patchable_spans(tape)
            # animation keeps the UNfiltered spans (clip cells move their
            # mask-plane quads along; only patches need the filter)
            scene.anim_spans = dict(tape.root_spans)
        scene.atlas_generation = self._flattener.atlas.generation
        scene.snap_args = (frame_size, clear_main, clear_color, reserve,
                           animate)
        return scene

    def update_scene(self, scene, renders, dirty=None):
        """Patch a mesh-resident DeviceScene in place after in-place edits
        to `renders` — the sharded twin of FigRenderer.update_scene: dirty
        roots' subtrees re-walk in the scratch context and their UNPACKED
        combo rows (fields + bitcast mode lanes, the sharded wire layout)
        scatter into the replicated device combo as one upload. Unsupported
        edits re-snapshot (same semantics as single-chip)."""
        patched = self._try_patch_scene(scene, renders, dirty)
        if patched:
            return scene
        frame_size, clear_main, clear_color, reserve, animate = scene.snap_args
        fresh = self.snapshot_scene(renders, frame_size, clear_main,
                                    clear_color, reserve=reserve,
                                    animate=animate)
        from ..renderer import DeviceScene

        for slot in DeviceScene.__slots__:
            setattr(scene, slot, getattr(fresh, slot))
        return scene

    def _try_patch_scene(self, scene, renders, dirty) -> bool:
        import numpy as np

        from ..ops.layout import QF_WIDTH
        from ..renderer import _patch_device_scene

        plan = scene.plan

        def old_bboxes(idx):
            return plan.fields[idx][:, 6:10].copy()

        def apply_mirrors(idx, rows):
            # the plan keeps logical fields/modes (the lazy pass-chain
            # combo packs from them) plus any packed combos
            plan.fields[idx] = rows[:, :QF_WIDTH]
            plan.modes[idx] = rows[:, QF_WIDTH:].view(np.int32)
            if plan.combo is not None:
                plan.combo[idx] = rows
            if plan.mega_combo is not None:
                plan.mega_combo[idx] = rows

        return _patch_device_scene(
            self._flattener, scene, renders, dirty, layout="unpacked",
            old_bboxes=old_bboxes, apply_mirrors=apply_mirrors,
        )

    def render_view(self, scene, pan=(0.0, 0.0), zoom: float = 1.0,
                    root_transforms=None):
        """One row-sharded frame of a device-resident scene under the camera
        p' = zoom·p + pan. Same bit-exactness contract as the single-chip
        render_view (view_rows runs on the replicated combo before the
        shard_map splits row bands); the combo layout here is the unpacked
        70-wide one, so the rect-mask columns differ
        (executor.VIEW_RECT_COLS_UNPACKED). root_transforms animates the
        replicated combo with the per-root affine table exactly like
        FigRenderer.render_view — the table applies BEFORE the shard_map
        splits row bands, so sharded animation is bit-exact vs single-chip
        (tests/test_sharded_perf.py)."""
        import numpy as np

        from .. import executor as ex
        from ..renderer import (
            FigRenderer, _anim_table, _patch_staging,
        )

        plan = scene.plan
        cam = (float(pan[0]), float(pan[1]), float(zoom), self.use_pallas,
               scene.kind)
        d = jnp.asarray(np.asarray(pan, dtype=np.float32).reshape(2))
        z = jnp.float32(zoom)
        run, rest = self._view_executor(scene)
        if root_transforms is not None:
            table = jnp.asarray(_anim_table(scene, root_transforms))
            ridx = scene.anim_ridx_dev
            if scene.pending_patch is not None:
                packed = _patch_staging(*scene.pending_patch)
                pav = ex.get_patch_anim_view_runner(
                    run, scene.n_quads, packed.shape[0],
                    ex.VIEW_RECT_COLS_UNPACKED,
                )
                frame, scene.combo_dev = pav(
                    scene.combo_dev, jnp.asarray(packed), table, ridx,
                    d, z, *rest,
                )
                scene.pending_patch = None
            else:
                av = ex.get_anim_view_runner(
                    run, scene.n_quads, ex.VIEW_RECT_COLS_UNPACKED
                )
                frame = av(scene.combo_dev, table, ridx, d, z, *rest)
            scene.pending_damage = None
            scene.last_cam = None
            scene.last_view_frame = None
            self._last_padded = frame
            self.last_frame = frame[: plan.height, : plan.width]
            return self.last_frame
        if scene.pending_patch is not None and FigRenderer._partial_ok(
            scene, cam
        ):
            # damage-clipped, same contract as single-device: the select
            # runs on the PADDED sharded frame (prev is padded too)
            packed = _patch_staging(*scene.pending_patch)
            ppv = ex.get_partial_patch_view_runner(
                run, scene.n_quads, packed.shape[0],
                ex.VIEW_RECT_COLS_UNPACKED,
            )
            from ..renderer import _damage_rects

            frame, scene.combo_dev = ppv(
                scene.combo_dev, jnp.asarray(packed),
                jnp.asarray(_damage_rects(scene.pending_damage)),
                d, z, scene.last_view_frame, *rest,
            )
            scene.pending_patch = None
        elif scene.pending_patch is not None:
            packed = _patch_staging(*scene.pending_patch)
            pv = ex.get_patch_view_runner(
                run, scene.n_quads, packed.shape[0],
                ex.VIEW_RECT_COLS_UNPACKED,
            )
            frame, scene.combo_dev = pv(
                scene.combo_dev, jnp.asarray(packed), d, z, *rest,
            )
            scene.pending_patch = None
        else:
            viewed = ex.get_view_runner(
                run, scene.n_quads, ex.VIEW_RECT_COLS_UNPACKED
            )
            frame = viewed(scene.combo_dev, d, z, *rest)
        scene.pending_damage = None
        scene.last_cam = cam
        scene.last_view_frame = frame  # padded: the partial-render source
        self._last_padded = frame
        self.last_frame = frame[: plan.height, : plan.width]
        return self.last_frame

    def _view_executor(self, scene):
        """(run, rest) for a mesh-resident scene — the sharded executor
        matching the snapshot's path and its view-invariant arguments."""
        plan = scene.plan
        if scene.kind == "mega":
            run, (gh, pw) = get_sharded_mega_executor(
                self.mesh, plan.height, plan.width, plan.n_masks,
                plan.has_init_frame,
            )
            rest = (self._init_frame(gh, pw, plan.has_init_frame),)
        else:
            run, (gh, pw) = get_sharded_frame_executor(
                self.mesh, tuple(plan.structure), plan.height, plan.width,
                plan.n_masks, self.use_pallas,
                self._flattener.text_subpixel_positioning,
                plan.has_init_frame, self._flattener.pixelate,
            )
            rest = (
                self._init_frame(gh, pw, plan.has_init_frame),
                self._flattener._device_atlas(),
            )
        return run, rest

    def render_views(self, scene, pans, zooms=1.0, chunk: int = 0,
                     as_uint8: bool = False):
        """Row-sharded flythrough: the camera path renders as chunked
        lax.map dispatches over the sharded executor — every view still
        spans all devices' row bands, and the whole path's host→device
        traffic is the (N, 2) pans + (N,) zooms arrays. Bit-exact vs the
        render_view loop (clear snapshots; clear_main=False snapshots fall
        back to the sequential loop to keep chained-composite semantics)."""
        import numpy as np

        from .. import executor as ex
        from ..renderer import FigRenderer, _frames_to_u8

        FigRenderer._flush_scene_patch(scene)
        plan = scene.plan
        ds = np.ascontiguousarray(
            np.asarray(pans, dtype=np.float32).reshape(-1, 2))
        n = ds.shape[0]
        zarr = np.asarray(zooms, dtype=np.float32)
        zs = (np.full((n,), float(zarr), np.float32) if zarr.ndim == 0
              else zarr.reshape(n).copy())
        if chunk <= 0:
            from ..config import batch_chunk

            chunk = batch_chunk()
        if plan.has_init_frame:
            frames = [self.render_view(scene, d, zoom=float(z))
                      for d, z in zip(ds, zs)]
            out = (jnp.stack(frames) if frames else jnp.zeros(
                (0, plan.height, plan.width, 4), jnp.float32))
            return _frames_to_u8(out) if as_uint8 else out
        run, rest = self._view_executor(scene)
        view_fn = ex.get_view_frame_fn(
            run, scene.n_quads, ex.VIEW_RECT_COLS_UNPACKED
        )
        batched = ex.get_batch_runner(view_fn, 2)
        parts = []
        for s in range(0, n, chunk):
            k = min(chunk, n - s)
            target = 1 << max(k - 1, 0).bit_length()
            idx = np.minimum(np.arange(target), k - 1)
            out = batched(jnp.asarray(ds[s : s + k][idx]),
                          jnp.asarray(zs[s : s + k][idx]),
                          scene.combo_dev, *rest)
            parts.append(out[:k, : plan.height, : plan.width])
        out = parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=0)
        if n:
            self.last_frame = out[-1]
        return _frames_to_u8(out) if as_uint8 else out


# --- frame-parallel offline rendering ---------------------------------------------
#
# The second parallel axis: where the row-sharded executor splits ONE frame
# across devices, the frame-parallel runner gives each device WHOLE frames of
# a render_batch chunk — offline animation/thumbnail farms are embarrassingly
# parallel, so throughput scales ~linearly with mesh size and no collective
# ever runs (the reference's GL loop has neither axis).

FRAMES_AXIS = "frames"


def frames_mesh(n_devices: Optional[int] = None) -> Mesh:
    """A 1-D mesh over the frame axis for FigRenderer.render_batch(mesh=...)."""
    import numpy as np

    devices = jax.devices()
    if n_devices is not None:
        devices = devices[: n_devices]
    return Mesh(np.array(devices), (FRAMES_AXIS,))


def get_frame_parallel_runner(run, n_vary: int, mesh: Mesh):
    """shard_map analog of executor.get_batch_runner: the stacked per-frame
    buffers (first `n_vary` args) shard along the frame axis, the remaining
    args replicate, and each device lax.maps the single-frame executor over
    its local frames. The frame axis must be a multiple of the mesh size
    (render_batch pads per-device counts to a pow2)."""
    n = mesh.devices.size

    @jax.jit
    def batched(*args):
        vary = args[:n_vary]
        const = args[n_vary:]

        def local(*a):
            lv = a[:n_vary]
            lc = a[n_vary:]
            return jax.lax.map(lambda v: run(*v, *lc), lv)

        body = shard_map(
            local,
            mesh=mesh,
            in_specs=tuple(P(FRAMES_AXIS) for _ in vary)
            + tuple(P() for _ in const),
            out_specs=P(FRAMES_AXIS),
            check_vma=False,
        )
        return body(*vary, *const)

    return batched


_FRAME_PARALLEL_CACHE = {}


def cached_frame_parallel_runner(run, n_vary: int, mesh: Mesh):
    key = (run, n_vary, tuple(map(id, mesh.devices.flat)), mesh.axis_names)
    got = _FRAME_PARALLEL_CACHE.get(key)
    if got is None:
        got = get_frame_parallel_runner(run, n_vary, mesh)
        _FRAME_PARALLEL_CACHE[key] = got
    return got
