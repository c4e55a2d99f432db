"""FigRenderer: runs each frame on the device.

Equivalent of the reference's FigRenderer + GL context execution
(/root/reference/src/figdraw/figrender.nim:1960-1995): walks the scene into a
quad tape (tape.py), then executes the tape's pass items as a short sequence
of jitted device calls — draw passes (frame or mask targets), mask clears and
backdrop-blur events. Quad counts are padded to bucketed capacities so jit
signatures stay stable across frames (SURVEY.md §7 "bucketed static shapes").
"""

from __future__ import annotations

import functools

from dataclasses import dataclass
from typing import Dict, Hashable, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from .atlas import Atlas, AtlasEntryMeta
from .backend import DEFAULT_SDF_AA_FACTOR
from .colors import Color
from .geometry import Vec2
from .nodes import Renders
from .render import render_root
from .tape import FRAME_TARGET, Tape, TapeBackend

# pow2 plus 1.5x-pow2 steps above 2048: the upload buffer is padded to the
# bucket, so the coarse pow2 ladder wasted up to ~2x transfer bytes (10439
# culled quads rode a 16384 buffer). More buckets = more jit signatures, but
# each compiles once and the persistent cache keeps them.
QUAD_BUCKETS = (64, 128, 256, 512, 1024, 2048, 3072, 4096, 6144, 8192,
                12288, 16384, 24576, 32768, 49152, 65536)

WHITE_IMAGE_KEY = "__figdraw_white__"
from .executor import ROLLED_THRESHOLD  # noqa: E402

EMPTY_BOUNDS = np.zeros((0, 2), np.int32)
EMPTY_RADII = np.zeros((0,), np.float32)


class _ExecPlan:
    """Host-side half of a frame execution: the packed upload buffer(s),
    derived pass structure and executor parameters — everything execute()
    computes before the device dispatch. render_batch() stacks the varying
    arrays of many same-structure plans into one dispatch."""

    __slots__ = (
        "height", "width", "n_masks", "has_init_frame",
        "structure", "bounds", "radii", "combo",
        "mega_combo", "rolled", "_rolled_args",
    )

    def __init__(self, **kw):
        self._rolled_args = None
        for k, v in kw.items():
            setattr(self, k, v)

    def rolled_args(self):
        """(items_arr, radii_arr, bucket) for the rolled executor — built
        lazily (the mega path never needs them) and memoized."""
        if self._rolled_args is None:
            self._rolled_args = _build_rolled_items(
                self.structure, self.bounds, self.radii
            )
        return self._rolled_args


class DeviceScene:
    """A flattened scene resident in device memory (renderer.snapshot_scene):
    render_view() draws it at any screen offset without re-walking the scene
    — only a (2,) f32 pan crosses the host→device link per frame.
    renderer.update_scene() patches edited roots' quad rows in place
    (retained scenes)."""

    __slots__ = ("kind", "plan", "combo_dev", "n_quads", "n_pad",
                 "items_dev", "radii_dev",
                 # retained-scene update state (renderer.update_scene):
                 # per-root tape row spans, the atlas generation the rows
                 # were packed against, the snapshot call's arguments for
                 # the re-snapshot fallback, a deferred patch upload (fused
                 # into the next render_view dispatch), the scene-space
                 # damage rect accumulated since the last rendered frame,
                 # and that frame + its camera (the partial-render sources)
                 "spans", "atlas_generation", "snap_args", "pending_patch",
                 "pending_damage", "last_cam", "last_view_frame",
                 # device-resident animation state (render_view's
                 # root_transforms): UNfiltered per-root spans (mask-writing
                 # roots animate fine — only the patch path needs the
                 # structure filter), the sorted key order defining table
                 # slots, key → slot, the device-resident per-quad slot
                 # index, and the identity-filled host table template
                 "anim_spans", "anim_order", "anim_slot", "anim_ridx_dev",
                 "anim_template")

    def __init__(self, kind, plan, combo_dev, n_quads, n_pad):
        self.kind = kind
        self.plan = plan
        self.combo_dev = combo_dev
        self.n_quads = n_quads
        self.n_pad = n_pad
        self.items_dev = None
        self.radii_dev = None
        self.spans = None
        self.atlas_generation = 0
        self.snap_args = None
        self.pending_patch = None
        self.pending_damage = None
        self.last_cam = None
        self.last_view_frame = None
        self.anim_spans = None
        self.anim_order = None
        self.anim_slot = None
        self.anim_ridx_dev = None
        self.anim_template = None

    def animation_order(self):
        """The (zlevel, root_node_idx) keys in table-slot order for
        render_view's bulk (R, 6) root_transforms array; None when the
        snapshot has no per-root row mapping (snapshot with animate=True
        to guarantee one)."""
        return _anim_state(self)


def _build_rolled_items(structure, bounds, radii):
    """Flatten the pass structure into the rolled executor's item table:
    (bucket, 4) i32 rows + (bucket,) f32 blur radii."""
    from . import executor as ex

    item_rows = []
    item_radii = []
    di = 0
    bi = 0
    for item in structure:
        kind = item[0]
        if kind == "clear_mask":
            item_rows.append((ex.ITEM_CLEAR_MASK, item[1], 0, 0))
            item_radii.append(0.0)
        elif kind == "blur":
            item_rows.append((ex.ITEM_BLUR, 0, 0, 0))
            item_radii.append(radii[bi])
            bi += 1
        else:
            _, target, uses_atlas, needs_backdrop = item
            s, e = bounds[di]
            di += 1
            if target == FRAME_TARGET:
                k = (
                    ex.ITEM_DRAW_ATLAS
                    if uses_atlas
                    else (ex.ITEM_DRAW_SDF_BD if needs_backdrop else ex.ITEM_DRAW_SDF)
                )
                item_rows.append((k, 0, s, e))
            else:
                item_rows.append((ex.ITEM_DRAW_MASK, target, s, e))
            item_radii.append(0.0)
    bucket = ex._item_bucket(len(item_rows))
    items_arr = np.zeros((bucket, 4), dtype=np.int32)
    radii_arr = np.zeros((bucket,), dtype=np.float32)
    items_arr[: len(item_rows)] = item_rows
    radii_arr[: len(item_radii)] = item_radii
    return items_arr, radii_arr, bucket


@dataclass
class AtlasUsage:
    """Atlas occupancy snapshot (figbackend.nim:72-89)."""

    snapshot_id: int = 0
    generation: int = 0
    rebuild_count: int = 0
    atlas_size: int = 0
    atlas_area: int = 0
    used_area: int = 0
    packed_area: int = 0
    entry_count: int = 0
    image_count: int = 0
    glyph_count: int = 0
    generated_count: int = 0
    unknown_count: int = 0

    @property
    def used_ratio(self) -> float:
        return self.used_area / self.atlas_area if self.atlas_area > 0 else 0.0

    @property
    def packed_ratio(self) -> float:
        return self.packed_area / self.atlas_area if self.atlas_area > 0 else 0.0


_atlas_usage_lock = __import__("threading").Lock()
_last_atlas_usage = AtlasUsage()
_next_snapshot_id = 0


def atlas_usage_snapshot() -> AtlasUsage:
    """Cheap cross-thread last-published snapshot (figbackend.nim:347-353)."""
    with _atlas_usage_lock:
        return _last_atlas_usage


@functools.partial(jax.jit, donate_argnums=0)
def _atlas_patch(atlas, patch, y, x):
    return jax.lax.dynamic_update_slice(atlas, patch, (y, x, 0))


def _patch_staging(rows, idx):
    """Bucket-padded (cap, W+1) staging array for a retained patch: the
    target row index rides a trailing f32 column (exact — combos are far
    below 2^24 rows) so the upload is ONE host→device transfer; padding
    duplicates the last (row, index) pair, an idempotent scatter."""
    cap = _bucket(int(idx.size))
    w = rows.shape[1]
    packed = np.empty((cap, w + 1), np.float32)
    packed[: idx.size, :w] = rows
    packed[: idx.size, w] = idx
    if cap > idx.size:
        packed[idx.size:] = packed[idx.size - 1]
    return packed


def _damage_rects(rects):
    """The partial runner's static (DAMAGE_RECTS, 4) f32 rect array; unused
    slots inverted (no pixels, no quads)."""
    from . import executor as ex

    out = np.full((ex.DAMAGE_RECTS, 4), [2e9, 2e9, -2e9, -2e9], np.float32)
    for i, r in enumerate(rects):
        out[i] = r
    return out


def _merge_damage(rects, rect):
    """Append a damage rect, greedily merging the min-area-growth pair once
    past executor.DAMAGE_RECTS slots (the partial runner's static rect
    count)."""
    from . import executor as ex

    rects = [] if rects is None else list(rects)
    rects.append(rect)
    while len(rects) > ex.DAMAGE_RECTS:
        best = None
        for i in range(len(rects)):
            for j in range(i + 1, len(rects)):
                a, b = rects[i], rects[j]
                u = (min(a[0], b[0]), min(a[1], b[1]),
                     max(a[2], b[2]), max(a[3], b[3]))
                grow = ((u[2] - u[0]) * (u[3] - u[1])
                        - (a[2] - a[0]) * (a[3] - a[1])
                        - (b[2] - b[0]) * (b[3] - b[1]))
                if best is None or grow < best[0]:
                    best = (grow, i, j, u)
        _, i, j, u = best
        rects[i] = u
        del rects[j]
    return rects


def _patchable_spans(tape):
    """tape.root_spans filtered to roots whose rows have NO plane-mask
    involvement (no mask-targeted draw rows, no mask-reading rows): the
    patch path replaces rows but keeps the snapshot's items/structure, so a
    clip-structure change inside a span (e.g. set_node removing
    NfClipContent) with a coincidentally equal quad count would silently
    mis-target — such roots always re-snapshot instead."""
    spans = tape.root_spans
    if not spans:
        return spans
    if not tape.mask_count:
        return spans
    from .tape import DrawItem

    bad = np.zeros(tape.count, bool)
    for item in tape.items:
        if isinstance(item, DrawItem) and item.target >= 0:
            bad[item.start : item.end] = True
    bad |= tape.modes[: tape.count, 1] != 0
    return {
        key: (qs, qe)
        for key, (qs, qe) in spans.items()
        if not bad[qs:qe].any()
    }


def _anim_state(scene):
    """Lazily build a DeviceScene's animation-table state: the sorted
    root-key order (= table slot order), key → slot, the per-quad slot
    index (device-resident, -1 for rows outside every span) and the
    identity-filled host table template. None when the snapshot has no
    usable row mapping (mega layout with interleaved clear sentinels)."""
    if scene.anim_spans is None:
        return None
    if scene.anim_order is None:
        scene.anim_order = sorted(scene.anim_spans)
        scene.anim_slot = {k: i for i, k in enumerate(scene.anim_order)}
        tmpl = np.zeros((len(scene.anim_order) + 1, 6), np.float32)
        tmpl[:, 0] = 1.0
        tmpl[:, 3] = 1.0
        scene.anim_template = tmpl
    if scene.anim_ridx_dev is None:
        ridx = np.full(scene.n_quads, -1, np.int32)
        for i, key in enumerate(scene.anim_order):
            qs, qe = scene.anim_spans[key]
            ridx[qs:qe] = i
        scene.anim_ridx_dev = jnp.asarray(ridx)
    return scene.anim_order


def _affine6(tr):
    """Normalize one transform spec to the animation-table row
    (m00, m01, m10, m11, tx, ty) meaning p' = M·p + t: a geometry.Mat3
    (its translation IS t), a flat 6-sequence in table order, or a nested
    2x3 [[a, b, tx], [c, d, ty]]."""
    from .geometry import Mat3

    if isinstance(tr, Mat3):
        return (tr.a, tr.b, tr.c, tr.d, tr.tx, tr.ty)
    arr = np.asarray(tr, np.float32)
    if arr.shape == (2, 3):
        return (arr[0, 0], arr[0, 1], arr[1, 0], arr[1, 1],
                arr[0, 2], arr[1, 2])
    if arr.shape == (6,):
        return arr
    raise ValueError(
        "root transform must be a Mat3, a (6,) row "
        "(m00, m01, m10, m11, tx, ty) or a 2x3 affine"
    )


def _anim_table(scene, root_transforms):
    """Build the (R+1, 6) f32 animation table for executor.animate_rows.
    root_transforms: {root_key: transform} with update_scene's key
    convention (bare int = layer 0), or a bulk (R, 6) array in
    scene.anim_order slot order (the zero-Python-loop path for
    thousands-of-roots animation)."""
    order = _anim_state(scene)
    if order is None:
        # anim_spans goes missing for two distinct reasons; diagnose the
        # right one (re-snapshotting with animate=True only fixes the
        # mega-sentinel case — telling a Python-walk user to do it is a
        # dead end)
        if scene.kind == "mega":
            raise ValueError(
                "scene is not animatable: a mega-path snapshot with clip "
                "masks interleaves clear sentinel rows, so tape rows do "
                "not map 1:1 onto combo rows. Snapshot with animate=True "
                "to force an animatable (non-mega) layout."
            )
        raise ValueError(
            "scene is not animatable: the snapshot recorded no per-root "
            "row spans. Spans come from the native C walk only — pass the "
            "scene as a RendersArray (nodesarray.from_renders) and make "
            "sure the native flattener built (figdraw_tpu.native"
            ".available()); an empty scene has no roots to animate."
        )
    n = len(order)
    if not isinstance(root_transforms, dict):
        arr = np.asarray(root_transforms, np.float32)
        if arr.shape != (n, 6):
            raise ValueError(
                f"bulk animation table must be ({n}, 6) f32 rows "
                "(m00, m01, m10, m11, tx, ty) in scene.anim_order slot order"
            )
        table = np.empty((n + 1, 6), np.float32)
        table[:n] = arr
        table[n] = scene.anim_template[n]
        return table
    table = scene.anim_template.copy()
    for key, tr in root_transforms.items():
        k = (0, key) if isinstance(key, int) else (int(key[0]), int(key[1]))
        slot = scene.anim_slot.get(k)
        if slot is None:
            raise KeyError(
                f"root {k} has no recorded span in this snapshot "
                "(keys are (zlevel, root_node_idx) or bare layer-0 ints; "
                "see scene.anim_order)"
            )
        table[slot] = _affine6(tr)
    return table


def _patch_device_scene(flat, scene, renders, dirty, layout,
                        old_bboxes, apply_mirrors) -> bool:
    """Shared fast path of update_scene for the single-chip and sharded
    renderers: validate, re-walk the dirty roots in the scratch context,
    accumulate the damage rect, patch the host mirrors, and stage the rows
    as a DEFERRED device patch (fused into the next render_view dispatch;
    back-to-back updates merge on host, newest row per index winning).
    False = the caller must re-snapshot.

    flat: the flattening FigRenderer (atlas/text/glyph state). layout: the
    scene's wire layout for native.walk_roots_packed. old_bboxes(idx)/
    apply_mirrors(idx, rows): read pre-patch bboxes / write the host
    mirrors (called in that order)."""
    from . import native
    from .basics import fig_ui_scale
    from .nodesarray import RendersArray

    if (
        dirty is None
        or scene.spans is None
        or scene.snap_args is None
        or not isinstance(renders, RendersArray)
    ):
        return False
    dirty = [(0, d) if isinstance(d, int) else (int(d[0]), int(d[1]))
             for d in dirty]
    if not dirty:
        return True  # nothing changed
    old_spans = []
    for key in dirty:
        span = scene.spans.get(key)
        if span is None:
            return False
        old_spans.append(span)
    # ensure first: new glyphs can grow the atlas, and rows packed against
    # a stale generation must re-snapshot
    flat._ensure_packed_glyphs(renders)
    if scene.atlas_generation != flat.atlas.generation:
        return False
    out = native.walk_roots_packed(
        renders,
        dirty,
        fig_ui_scale(),
        flat._pixel_scale,
        flat.aa_factor,
        atlas_entries=flat._atlas_pack(),
        atlas_size=flat.atlas.size,
        white_uv=flat._white_uv(),
        text_config=flat._text_config(),
        glyph_offsets=flat._glyph_offsets_pack(),
        # mega rows carry no atlas runs by construction; the other layouts
        # read the atlas through items, so patched rows may sample it as
        # long as the generation matches (checked)
        allow_atlas=scene.kind != "mega",
        layout=layout,
    )
    if out is None:
        return False
    rows, new_spans = out
    total = 0
    for (os_, oe), (ns, ne) in zip(old_spans, new_spans):
        if ne - ns > oe - os_:
            return False  # grew beyond the span (+ any reserve)
        total += oe - os_
    idx = np.concatenate(
        [np.arange(s, e, dtype=np.int32) for s, e in old_spans]
    ) if old_spans else np.empty(0, np.int32)
    if idx.size == 0:
        return True  # dirty roots emit no quads (e.g. all invisible)
    if total != rows.shape[0]:
        # shrunken subtrees (fewer quads than the reserved span): fill the
        # tail with inert rows — exact blending identities, never binned —
        # so count-CHANGING edits stay on the patch path
        filled = np.empty((total, rows.shape[1]), np.float32)
        off = 0
        for (os_, oe), (ns, ne) in zip(old_spans, new_spans):
            m = ne - ns
            filled[off : off + m] = rows[ns:ne]
            pad = (oe - os_) - m
            if pad:
                filled[off + m : off + m + pad] = native.inert_quad_rows(
                    pad, layout)
            off += oe - os_
        rows = filled
    assert rows.shape[0] == idx.size
    # scene-space damage rects, ONE PER DIRTY ROOT: the union of that
    # root's OLD and NEW row bboxes (every pixel its changed quads could
    # touch), accumulated until a rendered frame covers them (the
    # partial-render sources; scattered edits keep per-widget rects
    # instead of one near-full-frame union). Bbox columns sit at 6..9 in
    # BOTH wire layouts; inert rows carry inverted bboxes and are skipped.
    obb = old_bboxes(idx)
    off = 0
    for os_, oe in old_spans:
        m = oe - os_
        bbs = np.concatenate([obb[off : off + m], rows[off : off + m, 6:10]])
        valid = bbs[:, 2] >= bbs[:, 0]
        if valid.any():
            v = bbs[valid]
            scene.pending_damage = _merge_damage(
                scene.pending_damage,
                (float(v[:, 0].min()), float(v[:, 1].min()),
                 float(v[:, 2].max()), float(v[:, 3].max())),
            )
        off += m
    apply_mirrors(idx, rows)
    if scene.pending_patch is not None:
        # merge on host instead of flushing a standalone upload: the newest
        # row wins per index (plain concat is unsafe — XLA scatter order
        # for duplicate indices is unspecified)
        old_rows, old_idx = scene.pending_patch
        keep = ~np.isin(old_idx, idx)
        rows = np.concatenate([old_rows[keep], rows])
        idx = np.concatenate([old_idx[keep], idx])
    scene.pending_patch = (rows, idx)
    return True


@jax.jit
def _blend_overlay(frame, overlay):
    """Source-over an external straight-alpha layer (GL blend convention,
    glcontext.nim blend state)."""
    a = overlay[..., 3:4]
    rgb = overlay[..., :3] * a + frame[..., :3] * (1.0 - a)
    al = overlay[..., 3] + frame[..., 3] * (1.0 - overlay[..., 3])
    return jnp.concatenate([rgb, al[..., None]], axis=-1)


def _bucket(n: int) -> int:
    for b in QUAD_BUCKETS:
        if n <= b:
            return b
    return ((n + QUAD_BUCKETS[-1] - 1) // QUAD_BUCKETS[-1]) * QUAD_BUCKETS[-1]


class FigRenderer:
    """Renders `Renders` scenes to RGBA frames on the device.

    use_pallas: route draw passes through the tiled Pallas rasterizer
    (Triton on the GPU, interpret mode on the CPU) instead of the XLA
    reference path. None picks the kernels on a GPU and XLA elsewhere,
    unless FIGDRAW_BACKEND / FIGDRAW_FORCE_XLA says otherwise. A kernel that
    fails to trace or compile raises.
    """

    def __init__(
        self,
        atlas_size: int = 512,
        atlas_margin: int = 4,
        pixel_scale: float = 1.0,
        use_pallas: Optional[bool] = None,
        pixelate: bool = False,
    ):
        # newContext(atlasSize, atlasMargin, maxQuads, pixelate, pixelScale)
        # parity (glcontext.nim:255); maxQuads has no analog — quad capacity
        # buckets dynamically instead of the GL u16-index quadLimit
        self.atlas = Atlas(size=atlas_size, margin=atlas_margin)
        # white texel for drawFilledQuad (glcontext.nim:966-973)
        self.atlas.put_image(
            WHITE_IMAGE_KEY,
            np.ones((4, 4, 4), dtype=np.float32),
            AtlasEntryMeta(kind="generated"),
        )
        self._pixel_scale = float(pixel_scale)
        self._atlas_device = None
        self._atlas_generation = -1
        from . import config

        if use_pallas is None:
            override = config.runtime_backend_override()
            if override is not None:
                use_pallas = override
            else:
                use_pallas = jax.default_backend() == "gpu"
        self.use_pallas = use_pallas
        from .utils.jaxcache import enable_compilation_cache

        enable_compilation_cache()
        self.aa_factor = DEFAULT_SDF_AA_FACTOR
        self.pixelate = pixelate  # GL_NEAREST atlas sampling (pixel-art)
        self.text_lcd_filtering = config.runtime_text_lcd_filtering_requested()
        self.text_subpixel_positioning = (
            config.runtime_text_subpixel_positioning_requested()
        )
        self.text_subpixel_glyph_variants = (
            config.runtime_text_subpixel_glyph_variants_requested()
        )
        self.last_frame = None  # device (H, W, 4) f32 of the last render
        # executor form of the last device call: "mega", "rolled", "unrolled"
        self.last_executor = None
        self._one_frame_written = False
        self._subscription = None
        self._bus = None
        self._image_owners: Dict[Hashable, set] = {}
        self._font_owners: Dict[Hashable, set] = {}
        self._glyph_offsets: Dict[Hashable, Tuple[float, float]] = {}
        # id(glyph block) -> (block ref, (config, atlas version) stamp);
        # see _ensure_packed_glyphs
        self._ensured_glyph_blocks: Dict[int, Tuple] = {}
        self._render_thread_id: Optional[int] = None
        # async frame pipeline (render_frame_async): one worker thread doing
        # upload+dispatch, deque of buffer-release futures (max 2 in flight)
        self._pipe = None
        self._async_released = __import__("collections").deque()

    def _assert_render_thread(self) -> None:
        """Runtime analog of the reference's compile-time thread-effect tags
        ({.forbids: [AppMainThreadEff].}, shared.nim:22-35): the render path
        is single-owner; cross-thread traffic goes through the message bus.
        Set FIGDRAW_NO_THREAD_GUARD=1 to disable."""
        import os
        import threading

        if os.environ.get("FIGDRAW_NO_THREAD_GUARD") == "1":
            return
        tid = threading.get_ident()
        if self._render_thread_id is None:
            self._render_thread_id = tid
        elif self._render_thread_id != tid:
            raise RuntimeError(
                "FigRenderer render path used from two threads; publish "
                "resources through the image message bus instead "
                "(figdraw_tpu.resources), or set FIGDRAW_NO_THREAD_GUARD=1"
            )

    def _load_glyph(self, key, glyph, lcd: bool, variant: int) -> bool:
        """Cold-miss glyph generation straight into the atlas
        (figrender.nim:477-491)."""
        from .text.glyphs import generate_glyph
        from .text.typefaces import get_fig_font

        result = generate_glyph(glyph.font_id, glyph.glyph_id, lcd, variant)
        if result is None:
            return False
        img, offset = result
        self.atlas.put_image(
            key,
            img,
            AtlasEntryMeta(
                kind="glyph",
                font_id=glyph.font_id,
                typeface_id=get_fig_font(glyph.font_id).typeface_id,
            ),
        )
        self._glyph_offsets[key] = offset
        return True

    # --- resource message pump (figrender.nim:1841-1944) ------------------------

    def ensure_image_message_subscription(self, bus=None) -> None:
        from .resources import default_bus

        if bus is None:
            if self._subscription is not None:
                return  # keep whatever bus we're already on
            bus = default_bus
        if self._subscription is None or self._bus is not bus:
            self._bus = bus
            self._subscription = bus.subscribe()

    def process_image_messages(self) -> None:
        """Drains the bus and applies put/replace/clear/retain/release to the
        atlas with staleness checks."""
        from .resources import ImageMsgKind

        self.ensure_image_message_subscription()
        bus = self._bus
        for msg in self._subscription.drain():
            kind = msg.kind
            if kind in (ImageMsgKind.PutImage, ImageMsgKind.ReplaceImage):
                if not bus.message_current(msg) or msg.image is None:
                    continue
                # update in place when dimensions match, else repack
                # (figbackend.nim:369-389); mip chains always repack
                if msg.mipmapped:
                    self.atlas.remove(msg.id)
                    self.atlas.put_image(
                        msg.id, msg.image,
                        AtlasEntryMeta(kind="image", image_id=msg.id),
                        mipmapped=True,
                        mips=msg.mips,
                    )
                else:
                    self.atlas.update_image(msg.id, msg.image)
                    self.atlas.meta[msg.id] = AtlasEntryMeta(kind="image", image_id=msg.id)
            elif kind == ImageMsgKind.PutGlyph:
                if msg.image is None or msg.id in self.atlas:
                    continue
                self.atlas.put_image(
                    msg.id,
                    msg.image,
                    AtlasEntryMeta(
                        kind="glyph", font_id=msg.font_id, typeface_id=msg.typeface_id
                    ),
                )
            elif kind == ImageMsgKind.ClearImage:
                self.atlas.remove(msg.id)
            elif kind == ImageMsgKind.ClearImages:
                for i in msg.ids:
                    self.atlas.remove(i)
            elif kind == ImageMsgKind.ClearImageCache:
                self.atlas.clear()
            elif kind == ImageMsgKind.ClearFontGlyphs:
                self._clear_glyphs(lambda m: m.font_id == msg.font_id)
            elif kind == ImageMsgKind.ClearTypefaceGlyphs:
                self._clear_glyphs(lambda m: m.typeface_id == msg.typeface_id)
            elif kind == ImageMsgKind.RetainImage:
                self._image_owners.setdefault(msg.id, set()).add(msg.owner_token)
            elif kind == ImageMsgKind.ReleaseImage:
                owners = self._image_owners.get(msg.id)
                if owners is not None:
                    owners.discard(msg.owner_token)
                    if not owners:
                        self._image_owners.pop(msg.id, None)
                if msg.final_release:
                    self.atlas.remove(msg.id)
            elif kind == ImageMsgKind.RetainFont:
                self._font_owners.setdefault(msg.font_id, set()).add(msg.owner_token)
            elif kind == ImageMsgKind.ReleaseFont:
                owners = self._font_owners.get(msg.font_id)
                if owners is not None:
                    owners.discard(msg.owner_token)
                    if not owners:
                        self._font_owners.pop(msg.font_id, None)
                if msg.final_release:
                    self._clear_glyphs(lambda m: m.font_id == msg.font_id)

    def _clear_glyphs(self, pred) -> None:
        keys = [
            k for k, m in self.atlas.meta.items() if m.kind == "glyph" and pred(m)
        ]
        for k in keys:
            self.atlas.remove(k)

    # --- atlas usage observability ------------------------------------------------

    def atlas_usage(self) -> "AtlasUsage":
        usage = AtlasUsage(
            generation=self.atlas.generation,
            rebuild_count=self.atlas.rebuild_count,
            atlas_size=self.atlas.size,
            atlas_area=self.atlas.size * self.atlas.size,
            used_area=self.atlas.used_area(),
            packed_area=max(self.atlas.packed_area(), self.atlas.used_area()),
            entry_count=len(self.atlas.entries),
        )
        for key in self.atlas.entries:
            meta = self.atlas.meta.get(key)
            if meta is None:
                usage.unknown_count += 1
            elif meta.kind == "image":
                usage.image_count += 1
            elif meta.kind == "glyph":
                usage.glyph_count += 1
            else:
                usage.generated_count += 1
        if usage.atlas_area > 0:
            usage.used_area = min(usage.used_area, usage.atlas_area)
            usage.packed_area = min(usage.packed_area, usage.atlas_area)
        return usage

    def publish_atlas_usage(self) -> None:
        global _last_atlas_usage, _next_snapshot_id
        usage = self.atlas_usage()
        with _atlas_usage_lock:
            _next_snapshot_id += 1
            usage.snapshot_id = _next_snapshot_id
            _last_atlas_usage = usage

    # --- atlas management -----------------------------------------------------

    _dummy_init = None

    def _dummy_init_frame(self):
        if FigRenderer._dummy_init is None:
            FigRenderer._dummy_init = jnp.zeros((1, 1, 4), jnp.float32)
        return FigRenderer._dummy_init

    def _white_uv(self) -> Tuple[float, float]:
        if WHITE_IMAGE_KEY not in self.atlas.entries:
            # ClearImageCache wipes every atlas image including the white
            # texel filled-quad joins sample — restore it (glcontext.nim
            # re-creates it on every atlas reset, :634-641)
            self.atlas.put_image(
                WHITE_IMAGE_KEY,
                np.ones((4, 4, 4), dtype=np.float32),
                AtlasEntryMeta(kind="generated"),
            )
        x, y, w, h = self.atlas.entries[WHITE_IMAGE_KEY]
        return (x + w / 2.0, y + h / 2.0)

    def _text_config(self):
        return (
            self.text_lcd_filtering,
            self.text_subpixel_positioning,
            self.text_subpixel_positioning and self.text_subpixel_glyph_variants,
        )

    def _ensure_packed_glyphs(self, renders) -> None:
        """Rasterize any glyphs the packed text rows reference that are not
        in the atlas yet — the cold-miss hook the Python walk runs lazily
        (figrender.nim:477-491), vectorized over GLYPH_DTYPE rows so the C++
        walk only ever sees warm keys.

        Glyph blocks are cached per arrangement (nodesarray.pack_text), so
        their identity is stable across frames even when the scene array is
        rebuilt; each block is scanned once per (text config, ui scale,
        atlas entries version) instead of every frame — retained and
        rebuilt-with-cached-layouts scenes skip the hash scan entirely."""
        from types import SimpleNamespace

        from .basics import fig_ui_scale

        lcd, subpixel, variants_on = self._text_config()
        ui = fig_ui_scale()
        entries = self.atlas.entries
        config_key = (lcd, variants_on, ui, self.atlas.entries_version,
                      self.atlas.size)
        cache = self._ensured_glyph_blocks
        pending = []
        for _lvl, lst in renders.sorted_pairs():
            for block in lst.glyph_rows:
                if block.ndim == 0 or block.shape[0] == 0:
                    continue
                marker = cache.get(id(block))
                if (marker is not None and marker[0] is block
                        and marker[1] == config_key):
                    continue
                pending.append(block)
        if not pending:
            return
        glyphs = np.concatenate([np.atleast_1d(b) for b in pending])
        n = glyphs.shape[0]
        if variants_on:
            gx = glyphs["x"] * ui + glyphs["img_ox"]
            frac = np.clip(gx - np.floor(gx), 0.0, 0.999)
            variant = np.minimum((frac * 10.0).astype(np.int64), 9)
        else:
            variant = np.zeros(n, np.int64)
        # vectorized text/glyphs.py glyph_hash
        h = np.full(n, 0xCBF29CE484222325, np.uint64)
        prime = np.uint64(0x100000001B3)
        for v in (
            np.full(n, 2344, np.uint64),
            glyphs["font_id"].astype(np.uint64),
            glyphs["glyph_id"].astype(np.uint64),
            np.full(n, int(lcd), np.uint64),
            variant.astype(np.uint64),
        ):
            h = (h ^ v) * prime
        keys = (h & np.uint64(0x7FFFFFFFFFFFFFFF)).astype(np.int64)
        uniq, first = np.unique(keys, return_index=True)
        for k, i in zip(uniq.tolist(), first.tolist()):
            if k in entries:
                continue
            g = glyphs[i]
            self._load_glyph(
                k,
                SimpleNamespace(font_id=int(g["font_id"]),
                                glyph_id=int(g["glyph_id"])),
                lcd,
                int(variant[i]),
            )
        # stamp with the post-load entries version so our own uploads don't
        # immediately invalidate the markers; bound the table so frame loops
        # that typeset WITHOUT layout caching (fresh arrangements every
        # frame) don't grow it without limit
        if len(cache) > 4096:
            cache.clear()
        stamp = (lcd, variants_on, ui, self.atlas.entries_version,
                 self.atlas.size)
        for block in pending:
            cache[id(block)] = (block, stamp)

    def _atlas_pack(self):
        """Prepacked fd_set_atlas arrays, cached by atlas entries version."""
        from . import native

        version = (self.atlas.entries_version, self.atlas.size)
        cached = getattr(self, "_atlas_pack_cache", None)
        if cached is None or cached[0] != version:
            cached = (
                version,
                native.pack_atlas_entries(self.atlas.entries, self.atlas.size),
            )
            self._atlas_pack_cache = cached
        return cached[1]

    def _glyph_offsets_pack(self):
        """Sorted (keys, offsets) arrays for fd_set_glyph_offsets, cached by
        the offsets-table size (entries are only ever added)."""
        n = len(self._glyph_offsets)
        cached = getattr(self, "_glyph_pack_cache", None)
        if cached is None or cached[0] != n:
            if n:
                keys = np.fromiter(self._glyph_offsets.keys(), dtype=np.int64,
                                   count=n)
                order = np.argsort(keys)
                keys = np.ascontiguousarray(keys[order])
                offs = np.asarray(list(self._glyph_offsets.values()),
                                  dtype=np.float32)
                offs = np.ascontiguousarray(offs[order])
                cached = (n, (keys, offs))
            else:
                cached = (0, None)
            self._glyph_pack_cache = cached
        return cached[1]

    def _device_atlas(self):
        """Device copy of the atlas. Small changes upload only their region
        (the glTexSubImage2D analog: host ships the patch, the device splices
        it with dynamic_update_slice) — a streamed video frame costs its own
        bytes, not the whole atlas."""
        atlas = self.atlas
        if atlas.full_dirty or self._atlas_device is None:
            self._atlas_device = jnp.asarray(atlas.data)
            self.atlas_upload_bytes = atlas.data.nbytes
            atlas.full_dirty = False
            atlas.dirty = False
            atlas.dirty_rects.clear()
            return self._atlas_device
        if atlas.dirty and atlas.dirty_rects:
            rects = atlas.dirty_rects
            patched = sum(w * h for (_x, _y, w, h) in rects)
            if patched * 4 >= atlas.data.size:  # not worth patching
                self._atlas_device = jnp.asarray(atlas.data)
                self.atlas_upload_bytes = atlas.data.nbytes
            else:
                dev = self._atlas_device
                total = 0
                for (x, y, w, h) in rects:
                    patch = jnp.asarray(
                        np.ascontiguousarray(atlas.data[y : y + h, x : x + w])
                    )
                    dev = _atlas_patch(dev, patch, y, x)
                    total += patch.nbytes
                self._atlas_device = dev
                self.atlas_upload_bytes = total
            atlas.dirty = False
            atlas.dirty_rects.clear()
        return self._atlas_device

    def rebuild_image_atlas(self, minimum_size: int = 0) -> None:
        """Reset + grow the atlas, then replay live content from the bus
        (figbackend.nim:202-207 noteAtlasRebuilt → replayImageMessages)."""
        self.atlas.reset(minimum_size)
        self._glyph_offsets.clear()
        if self._bus is not None and self._subscription is not None:
            self._bus.replay_to(self._subscription)
            self.process_image_messages()

    def put_image(self, key: Hashable, img, kind: str = "image") -> None:
        self.atlas.put_image(key, img, AtlasEntryMeta(kind=kind))

    def update_image(self, key: Hashable, img) -> None:
        self.atlas.update_image(key, img)

    def remove_image(self, key: Hashable) -> None:
        self.atlas.remove(key)

    def contains_image(self, key: Hashable) -> bool:
        return key in self.atlas

    # --- flatten --------------------------------------------------------------

    def flatten(
        self,
        renders,
        frame_size: Vec2,
        clear_main: bool = True,
        clear_color: Color = Color(1.0, 1.0, 1.0, 1.0),
        cull: bool = True,
        record_spans: bool = False,
        reserve=None,
    ) -> Tape:
        """Walk the scene into a quad tape (host side, no device work).

        Accepts `Renders` (Python walk) or `RendersArray` (native C++ walk —
        ~50x faster; see native/flatten.cpp). record_spans=True (native walk
        only, requires cull=False) fills tape.root_spans for retained-scene
        patching (update_scene); reserve (a (lvl, root_idx) → n dict) pads
        those roots' spans with n inert rows so count-changing edits patch
        in place."""
        from .colors import as_color
        from .nodesarray import RendersArray

        clear_color = as_color(clear_color)

        cc = (
            (clear_color.r, clear_color.g, clear_color.b, clear_color.a)
            if clear_main
            else None
        )
        if isinstance(renders, RendersArray):
            from . import native
            from .basics import fig_ui_scale

            self._ensure_packed_glyphs(renders)
            tape = native.flatten_renders_array(
                renders,
                frame_size.x,
                frame_size.y,
                fig_ui_scale(),
                self._pixel_scale,
                self.aa_factor,
                cc,
                atlas_entries=self._atlas_pack(),
                atlas_size=self.atlas.size,
                white_uv=self._white_uv(),
                text_config=self._text_config(),
                glyph_offsets=self._glyph_offsets_pack(),
                bucket=_bucket,
                pool_owner=id(self),
                cull=cull,
                record_spans=record_spans,
                reserve=reserve,
            )
            if tape is not None:
                return tape
            # no toolchain or unsupported node kinds → Python walk
            from .nodesarray import to_renders

            renders = to_renders(renders)
        backend = TapeBackend(white_uv=self._white_uv())
        backend.entries = self.atlas.entries
        backend.atlas_size = self.atlas.size
        backend.glyph_offsets = self._glyph_offsets
        backend.glyph_loader = self._load_glyph
        backend.aa_factor = self.aa_factor
        backend.set_text_lcd_filtering_enabled(self.text_lcd_filtering)
        backend.set_text_subpixel_positioning_enabled(self.text_subpixel_positioning)
        backend.set_text_subpixel_glyph_variants_enabled(
            self.text_subpixel_glyph_variants
        )
        backend.begin_frame(frame_size, clear_main, clear_color)
        backend.save_transform()
        backend.scale(self._pixel_scale)
        render_root(backend, renders)
        backend.restore_transform()
        backend.end_frame()
        return backend.finish()

    # --- execute ---------------------------------------------------------------

    def execute(self, tape: Tape) -> jnp.ndarray:
        """Runs the whole tape as ONE jitted device call (executor.py)."""
        return self._dispatch_execution(self._plan_execution(tape))

    def _plan_execution(self, tape: Tape) -> _ExecPlan:
        """Everything execute() does before touching the device: derive the
        pass structure, pack the upload buffer(s), pick the executor."""
        from .executor import tape_structure

        width = int(round(tape.frame_size[0]))
        height = int(round(tape.frame_size[1]))
        n_masks = tape.mask_count + 1

        cache = tape.structure_cache
        if cache is not None:
            # native export already derived the pass structure from the C++
            # item flag bits — skip the per-frame mode-lane scan
            structure, bounds, radii, any_atlas, any_backdrop = cache
        else:
            structure, bounds, radii, is_atlas_mode, is_backdrop_mode = (
                tape_structure(tape, tape.modes_lanes())
            )
            any_atlas = bool(is_atlas_mode[: tape.count].any())
            any_backdrop = bool(is_backdrop_mode[: tape.count].any())
        seen_blur = any(item[0] == "blur" for item in structure)
        rolled_pre = len(structure) > ROLLED_THRESHOLD

        from . import executor as ex

        clear = np.asarray(tape.clear_color or (0, 0, 0, 0), dtype=np.float32)

        # one upload buffer per frame, padded to the bucket, with the tape's
        # quads copied in ONCE: fields/modes below are views into it (the old
        # path padded into fresh arrays and then copied them again into the
        # combo — two 2 MB allocations per 3000-box frame). The rolled path
        # carries draw bounds in its items array, so its meta is just the
        # clear color. Native-walk tapes arrive ALREADY in this layout
        # (native._export_tape_combo): the C++ export wrote the quad rows
        # into the buffer and the meta tail is filled, so nothing is copied.
        n = _bucket(max(tape.count, 1))
        if (
            tape.combo is not None
            and tape.combo_rolled == rolled_pre
            and tape.combo_quads == n
        ):
            combo = tape.combo
        elif rolled_pre:
            combo = ex.pack_tape_combo(tape, n, EMPTY_BOUNDS, EMPTY_RADII, clear)
        else:
            combo = ex.pack_tape_combo(
                tape, n,
                np.asarray(bounds, dtype=np.int32).reshape(-1, 2),
                np.asarray(radii, dtype=np.float32), clear,
            )
        has_init_frame = tape.clear_color is None
        rolled = rolled_pre  # mask-heavy: constant compile cost

        # mask-heavy pure-SDF scenes: bake targets into the mode lane and run
        # the whole frame as ONE Pallas kernel (executor.get_mega_executor) —
        # constant device-memory traffic instead of a full-frame pass per
        # item. The choice is made here, by shape: atlas-bearing scenes
        # (glyph/image runs need gathers), blurs, backdrops and more mask
        # planes than the kernel carries in registers take the rolled
        # executor.
        from .ops.raster_pallas import mega_fits

        mega = (
            rolled
            and self.use_pallas
            and not seen_blur
            and not any_atlas
            and not any_backdrop
            and mega_fits(n_masks)
        )
        mega_combo = None
        if mega:
            # the mega combo is packed from LOGICAL fields (pack_tape_upload
            # is 70-wide)
            mf, mm = ex.pack_mega_modes(
                tape, tape.fields[: tape.count],
                tape.modes_lanes()[: tape.count],
            )
            from .ops.layout import PACKED_WIDTH, pack_fields_np

            nm = _bucket(max(mf.shape[0], 1))
            # packed wire rows + one meta row carrying the clear color
            mega_combo = np.zeros((nm + 1, PACKED_WIDTH), dtype=np.float32)
            pack_fields_np(mf, mm, out=mega_combo[: mf.shape[0]])
            mega_combo[-1, :4] = clear

        return _ExecPlan(
            height=height, width=width, n_masks=n_masks,
            has_init_frame=has_init_frame, structure=structure,
            bounds=bounds, radii=radii, combo=combo,
            mega_combo=mega_combo, rolled=rolled,
        )

    def _resolve_init_frame(self, plan: _ExecPlan) -> jnp.ndarray:
        if plan.has_init_frame:
            if self.last_frame is not None and self.last_frame.shape[:2] == (
                plan.height,
                plan.width,
            ):
                return self.last_frame
            return jnp.zeros((plan.height, plan.width, 4), jnp.float32)
        return self._dummy_init_frame()

    def _dispatch_execution(self, plan: _ExecPlan) -> jnp.ndarray:
        """Device half of execute(): upload the plan's buffers and run the
        executor the plan chose."""
        from . import executor as ex

        height, width = plan.height, plan.width
        init_frame = self._resolve_init_frame(plan)
        if plan.mega_combo is not None:
            self.last_executor = "mega"
            run = ex.get_mega_executor(
                height, width, plan.n_masks, plan.has_init_frame)
            frame = run(jnp.asarray(plan.mega_combo), init_frame)
        elif plan.rolled:
            self.last_executor = "rolled"
            items_arr, radii_arr, bucket = plan.rolled_args()
            run = ex.get_rolled_executor(
                height, width, plan.n_masks, bucket, self.use_pallas,
                self.text_subpixel_positioning, plan.has_init_frame,
                self.pixelate,
            )
            frame = run(
                jnp.asarray(plan.combo), jnp.asarray(items_arr),
                jnp.asarray(radii_arr), init_frame, self._device_atlas(),
            )
        else:
            self.last_executor = "unrolled"
            run = ex.get_frame_executor(
                tuple(plan.structure), height, width, plan.n_masks,
                self.use_pallas, self.text_subpixel_positioning,
                plan.has_init_frame, self.pixelate,
            )
            frame = run(jnp.asarray(plan.combo), init_frame,
                        self._device_atlas())
        self.last_frame = frame
        return frame

    # --- high level -----------------------------------------------------------

    def render_frame(
        self,
        renders: Renders,
        frame_size: Vec2,
        clear_main: bool = True,
        clear_color: Color = Color(1.0, 1.0, 1.0, 1.0),
    ) -> jnp.ndarray:
        """Full frame: flatten on host, rasterize on device
        (figrender.nim:1960-1995)."""
        from .basics import scaled
        from .colors import as_color

        from .utils.perf import perf

        clear_color = as_color(clear_color)
        fs = scaled(frame_size)
        if fs.x <= 0 or fs.y <= 0:
            return self.last_frame
        self._assert_render_thread()
        self.drain_async()  # sync frames never overlap in-flight async ones
        with perf("frame"):
            with perf("messages"):
                self.process_image_messages()
            from .nodesarray import RendersArray

            frame = None
            tape = None
            if self.use_pallas and isinstance(renders, RendersArray):
                with perf("mega"):
                    frame, tape = self._render_native_fast(
                        renders, fs, clear_main, clear_color
                    )
            if frame is None:
                if tape is None:
                    with perf("flatten"):
                        tape = self.flatten(renders, fs, clear_main, clear_color)
                with perf("execute"):
                    frame = self.execute(tape)
            self.publish_atlas_usage()
        self._maybe_write_one_frame()
        return frame

    def render_frame_async(
        self,
        renders: Renders,
        frame_size: Vec2,
        clear_main: bool = True,
        clear_color: Color = Color(1.0, 1.0, 1.0, 1.0),
    ):
        """Pipelined frame: flatten NOW on the calling thread, then upload +
        dispatch on the renderer's single pipeline thread so the NEXT frame's
        host flatten overlaps this frame's device work. Returns a
        `concurrent.futures.Future` resolving to the frame array (call
        `.result().block_until_ready()` to synchronize).

        Rationale: the host->device upload of the tape blocks the caller,
        so a sequential loop serializes [flatten | upload | kernel] even
        though the kernel dispatch itself is async. The reference's GL loop
        gets the same overlap for free from the GL command queue
        (figrender.nim:1960-1995 swap pacing).

        At most TWO frames are in flight — the native combo pool ping-pongs
        two upload buffers (native.py), so frame N+2's flatten must wait for
        frame N's buffer to be consumed."""
        import concurrent.futures

        from .basics import scaled
        from .colors import as_color

        if self._pipe is None:
            self._pipe = concurrent.futures.ThreadPoolExecutor(
                1, thread_name_prefix="figdraw-pipe"
            )
        self._assert_render_thread()
        clear_color = as_color(clear_color)
        fs = scaled(frame_size)
        done = concurrent.futures.Future()
        if fs.x <= 0 or fs.y <= 0:
            done.set_result(self.last_frame)
            return done
        # cap in-flight frames at 2: wait until the N-2 frame's buffer is free
        while len(self._async_released) >= 2:
            self._async_released.popleft().result()
        self.process_image_messages()
        tape = self.flatten(renders, fs, clear_main, clear_color)
        released = concurrent.futures.Future()

        def job():
            try:
                frame = self.execute(tape)
                # the CPU backend's jnp.asarray may ALIAS the numpy combo
                # buffer (zero-copy) and read it lazily, so the buffer is
                # only provably consumed once the frame is computed; on the
                # GPU the upload copy is synchronous and this wait just
                # orders frames (they serialize on one device anyway)
                frame.block_until_ready()
                released.set_result(None)
                self.publish_atlas_usage()
                return frame
            except BaseException as exc:
                if not released.done():
                    released.set_result(None)
                raise exc

        fut = self._pipe.submit(job)
        self._async_released.append(released)
        return fut

    def drain_async(self) -> None:
        """Block until every in-flight async frame's tape buffer is free —
        called before any synchronous render/flatten follows async ones."""
        while self._async_released:
            self._async_released.popleft().result()

    # --- device-resident scenes: pan without re-flattening -----------------

    def snapshot_scene(
        self,
        renders,
        frame_size: Vec2,
        clear_main: bool = True,
        clear_color: Color = Color(1.0, 1.0, 1.0, 1.0),
        reserve=None,
        animate: bool = False,
    ) -> "DeviceScene":
        """Flatten once and park the tape ON DEVICE; render_view() then
        draws it at any screen offset for pure kernel cost — per frame only
        a (2,) f32 offset crosses the host→device link. The device-resident
        scroll/zoom-pan path: where GL re-walks the scene every scroll tick
        (figrender.nim:1960-1995), the tape is data and translation is a
        40-column device op (executor.pan_rows).

        The snapshot flattens with the saturation cull OFF — the cull is
        clamped to the snapshot viewport and panning could reveal culled
        quads (native.flatten_renders_array cull flag). Scene edits after
        the snapshot are not seen; use update_scene (in-place patch) or take
        a new snapshot. reserve ((lvl, root_idx) → n): pad those roots'
        spans with n inert rows so count-CHANGING edits (growing text
        labels) can still patch in place up to the reserve.

        animate=True guarantees render_view's root_transforms works: a
        clip-mask-bearing scene that would take the mega layout (whose
        interleaved clear sentinel rows break the tape-row ↔ combo-row
        mapping) stays on the rolled executor instead."""
        from .basics import scaled
        from .colors import as_color

        clear_color = as_color(clear_color)
        fs = scaled(frame_size)
        self._assert_render_thread()
        self.drain_async()
        self.process_image_messages()
        tape = self.flatten(renders, fs, clear_main, clear_color, cull=False,
                            record_spans=True, reserve=reserve)
        plan = self._plan_execution(tape)
        # own the upload buffer: plan.combo may be a pooled native view and
        # a DeviceScene outlives the pool's two-flatten ping-pong (on the
        # CPU backend jnp.asarray may even alias the numpy buffer)
        plan.combo = plan.combo.copy()
        n_pad = _bucket(max(tape.count, 1))
        if animate and tape.mask_count:
            # the mega export would interleave clear sentinel rows and break
            # the tape-row ↔ combo-row mapping animation needs
            plan.mega_combo = None
        if plan.mega_combo is not None and self.use_pallas:
            kind = "mega"
            combo = plan.mega_combo
            n_quads = combo.shape[0] - 1  # one meta row (clear color)
        else:
            kind = "rolled" if plan.rolled else "unrolled"
            combo = plan.combo
            n_quads = n_pad
        scene = DeviceScene(
            kind=kind,
            plan=plan,
            combo_dev=jnp.asarray(combo),
            n_quads=n_quads,
            n_pad=n_pad,
        )
        # retained-scene patch state: spans map tape rows 1:1 onto combo
        # quad rows only when the mega export interleaves no clear
        # sentinels (tape.mask_count > 0; plan.n_masks is clamped to ≥1 for
        # the executor's plane allocation) — other scenes keep spans for
        # the non-mega layouts, where quad rows always sit at [0, count)
        if getattr(tape, "root_spans", None) and not (
            kind == "mega" and tape.mask_count
        ):
            scene.spans = _patchable_spans(tape)
            # animation keeps the UNfiltered spans: moving a clip cell must
            # move its mask-plane quads too (only the patch path needs the
            # structure filter)
            scene.anim_spans = dict(tape.root_spans)
        scene.atlas_generation = self.atlas.generation
        scene.snap_args = (frame_size, clear_main, clear_color, reserve,
                           animate)
        return scene

    def update_scene(
        self, scene: "DeviceScene", renders, dirty=None
    ) -> "DeviceScene":
        """Patch a DeviceScene in place after in-place edits to `renders`
        (the same RendersArray the snapshot flattened) — the retained-scene
        path: where render_frame re-walks and re-uploads everything, this
        re-walks ONLY the dirty roots' subtrees (native
        fd_flatten_layer_spans spans) and scatters their packed rows into
        the device-resident combo, so per-frame host + wire cost is
        O(edited quads), not O(scene).

        dirty: iterable of (lvl, root_node_idx) — the layer key and the
        add_root node index of each root whose subtree changed — or bare
        ints meaning layer 0. Supported edits keep the subtree's quad count
        and pass structure: geometry, rotation, fills, corners, shadow
        parameters, stroke values. Anything else — structural edits, new
        mask planes, blur/backdrop in a dirty root, an atlas rebuild,
        dirty=None — falls back to a full re-snapshot (same result, full
        cost). Always returns `scene` (patched or re-snapshotted in place).
        """
        self._assert_render_thread()
        patched = self._try_patch_scene(scene, renders, dirty)
        if patched:
            return scene
        frame_size, clear_main, clear_color, reserve, animate = scene.snap_args
        fresh = self.snapshot_scene(renders, frame_size, clear_main,
                                    clear_color, reserve=reserve,
                                    animate=animate)
        for slot in DeviceScene.__slots__:
            setattr(scene, slot, getattr(fresh, slot))
        return scene

    def _try_patch_scene(self, scene, renders, dirty) -> bool:
        """The fast path of update_scene: False = caller must re-snapshot."""
        plan = scene.plan

        def old_bboxes(idx):
            return plan.combo[idx][:, 6:10].copy()

        def apply_mirrors(idx, rows):
            # host mirrors stay exact so the Pallas→XLA downgrade path and
            # any re-plan see the patched scene
            plan.combo[idx] = rows
            if plan.mega_combo is not None:
                plan.mega_combo[idx] = rows

        return _patch_device_scene(
            self, scene, renders, dirty,
            layout="packed",
            old_bboxes=old_bboxes,
            apply_mirrors=apply_mirrors,
        )

    @staticmethod
    def _flush_scene_patch(scene) -> None:
        """Apply a deferred retained patch standalone (render paths that
        don't go through the fused patch+view runner)."""
        from . import executor as ex

        if scene.pending_patch is None:
            return
        rows, idx = scene.pending_patch
        packed = _patch_staging(rows, idx)
        runner = ex.get_patch_runner(packed.shape[0])
        scene.combo_dev = runner(scene.combo_dev, jnp.asarray(packed))
        scene.pending_patch = None

    def render_view(
        self, scene: "DeviceScene", pan=(0.0, 0.0), zoom: float = 1.0,
        root_transforms=None,
    ) -> jnp.ndarray:
        """One frame of a device-resident scene under a screen-space camera
        p' = zoom·p + pan (zoom > 0).

        Bit-exact vs re-flattening the transformed scene (an nkTransform
        wrapping the roots) for integer pans/zooms of integer-coordinate
        scenes — ceil snapping commutes with integer affine maps; fractional
        views shift the baked AA smoothly without re-snapping — the same
        semantics as GL transforming a recorded vertex stream
        (tests/test_camera.py pins both). Like a GL scale transform, zoom
        widens AA/shadow falloff proportionally (SDF params are local-space)
        and leaves backdrop-blur radii in screen pixels.

        root_transforms animates the scene WITHOUT any host re-walk: per
        frame only a (roots, 6) affine table crosses the link and
        executor.animate_rows applies p' = M·p + t per root span inside the
        jitted dispatch — a dict {root_key: Mat3 | (6,) | 2x3} with
        update_scene's key convention, or a bulk (R, 6) array in
        scene.anim_order slot order. Transforms are ABSOLUTE from the
        snapshot's base geometry (no drift); the camera composes on top
        (p'' = zoom·(M·p + t) + pan). Same bit-exactness contract as the
        camera, per root (tests/test_animview.py); non-affine edits
        (corner radii, shadow params, fills) go through update_scene as
        before. Raises ValueError for snapshots without a per-root row
        mapping — snapshot with animate=True to guarantee one."""
        from . import executor as ex

        # the camera key carries the executor identity too: a caller that
        # switches use_pallas between frames must not get a stale Pallas
        # frame mixed with XLA in-rect pixels
        cam = (float(pan[0]), float(pan[1]), float(zoom), self.use_pallas,
               scene.kind)
        d = jnp.asarray(np.asarray(pan, dtype=np.float32).reshape(2))
        z = jnp.float32(zoom)
        if root_transforms is not None:
            table = jnp.asarray(_anim_table(scene, root_transforms))
            ridx = scene.anim_ridx_dev
            run, rest = self._view_executor(scene)
            if scene.pending_patch is not None:
                # fused patch + animate + view: the deferred retained
                # update lands in BASE scene space, animation applies
                # functionally on top, one dispatch total
                packed = _patch_staging(*scene.pending_patch)
                pav = ex.get_patch_anim_view_runner(
                    run, scene.n_quads, packed.shape[0],
                )
                frame, scene.combo_dev = pav(
                    scene.combo_dev, jnp.asarray(packed), table, ridx,
                    d, z, *rest,
                )
                scene.pending_patch = None
            else:
                av = ex.get_anim_view_runner(run, scene.n_quads)
                frame = av(scene.combo_dev, table, ridx, d, z, *rest)
            # an animated frame is NOT a partial-render source: quads moved
            # without damage tracking
            scene.pending_damage = None
            scene.last_cam = None
            scene.last_view_frame = None
            self.last_frame = frame
            return frame
        run, rest = self._view_executor(scene)
        if scene.pending_patch is not None and self._partial_ok(scene, cam):
            # damage-clipped fused render: quads outside the edits'
            # old+new bboxes drop out of binning and the previous
            # frame's pixels pass through outside the rect — bit-equal
            # to the full render (executor.get_partial_patch_view_runner)
            packed = _patch_staging(*scene.pending_patch)
            ppv = ex.get_partial_patch_view_runner(
                run, scene.n_quads, packed.shape[0]
            )
            frame, scene.combo_dev = ppv(
                scene.combo_dev, jnp.asarray(packed),
                jnp.asarray(_damage_rects(scene.pending_damage)),
                d, z, scene.last_view_frame, *rest,
            )
            scene.pending_patch = None
        elif scene.pending_patch is not None:
            # fused patch+view: the deferred retained update and the
            # frame render share one dispatch
            packed = _patch_staging(*scene.pending_patch)
            pv = ex.get_patch_view_runner(
                run, scene.n_quads, packed.shape[0]
            )
            frame, scene.combo_dev = pv(
                scene.combo_dev, jnp.asarray(packed), d, z, *rest,
            )
            scene.pending_patch = None
        else:
            viewed = ex.get_view_runner(run, scene.n_quads)
            frame = viewed(scene.combo_dev, d, z, *rest)
        scene.pending_damage = None
        scene.last_cam = cam
        scene.last_view_frame = frame
        self.last_frame = frame
        return frame

    @staticmethod
    def _partial_ok(scene, cam) -> bool:
        """Damage-clipped rendering is sound when the previous frame exists
        under the SAME camera, the pass structure has no blur/backdrop
        (their halos read pixels outside the damage rect), and the scene
        composites from the clear color (no init frame)."""
        if (not scene.pending_damage or scene.last_view_frame is None
                or scene.last_cam != cam or scene.plan.has_init_frame):
            return False
        for item in scene.plan.structure:
            # blur/backdrop halos read pixels outside the rect. Atlas draws
            # (the XLA windowed-gather evaluator) are SAFE with dropped
            # quads: an empty bbox clamps the window to the frame corner,
            # where the quad's true coverage is either zero (its real bbox
            # is disjoint from the rect, so rect pixels get the fa=0
            # blending identity) or lands outside the rect (discarded by
            # the final select).
            if item[0] == "blur" or (item[0] == "draw" and item[3]):
                return False
        return True

    def _view_executor(self, scene: "DeviceScene"):
        """(run, rest) for a device-resident scene: the cached single-frame
        executor matching the snapshot's path and its frame-invariant
        arguments."""
        from . import executor as ex

        plan = scene.plan
        init_frame = self._resolve_init_frame(plan)
        self.last_executor = scene.kind
        if scene.kind == "mega":
            run = ex.get_mega_executor(
                plan.height, plan.width, plan.n_masks, plan.has_init_frame,
            )
            rest = (init_frame,)
        elif scene.kind == "rolled":
            items_arr, radii_arr, bucket = plan.rolled_args()
            run = ex.get_rolled_executor(
                plan.height, plan.width, plan.n_masks, bucket,
                self.use_pallas, self.text_subpixel_positioning,
                plan.has_init_frame, self.pixelate,
            )
            if scene.items_dev is None:
                scene.items_dev = jnp.asarray(items_arr)
                scene.radii_dev = jnp.asarray(radii_arr)
            rest = (scene.items_dev, scene.radii_dev, init_frame,
                    self._device_atlas())
        else:
            run = ex.get_frame_executor(
                tuple(plan.structure), plan.height, plan.width, plan.n_masks,
                self.use_pallas, self.text_subpixel_positioning,
                plan.has_init_frame, self.pixelate,
            )
            rest = (init_frame, self._device_atlas())
        return run, rest

    def render_views(
        self,
        scene: "DeviceScene",
        pans,
        zooms=1.0,
        chunk: int = 0,
        as_uint8: bool = False,
        mesh=None,
    ) -> jnp.ndarray:
        """A flythrough of a device-resident scene: render a sequence of
        camera views as chunked single-dispatch batches. The tape is already
        on device, so a whole animation's host→device traffic is ONE (N, 2)
        pan array + (N,) zooms — the throughput version of render_view,
        composing the camera op with render_batch's chunked lax.map dispatch
        (no reference analog: GL re-walks the scene per tick and submits
        every frame individually).

        `zooms` may be a scalar or a per-view sequence. `chunk`/`as_uint8`/
        `mesh` behave exactly like render_batch's (pow-2 padded chunks, ONE
        dispatch each; device-side u8 quantization; frame-parallel mesh
        sharding of each chunk). Returns (N, H, W, 4) f32 (or u8) in view
        order; bit-exact vs the render_view loop (tests/test_camera.py)."""
        from . import executor as ex

        ds = np.ascontiguousarray(
            np.asarray(pans, dtype=np.float32).reshape(-1, 2))
        n = ds.shape[0]
        zarr = np.asarray(zooms, dtype=np.float32)
        zs = (np.full((n,), float(zarr), np.float32) if zarr.ndim == 0
              else zarr.reshape(n).copy())
        if chunk <= 0:
            from .config import batch_chunk

            chunk = batch_chunk()
        self._assert_render_thread()
        self.drain_async()
        self._flush_scene_patch(scene)
        if scene.plan.has_init_frame:
            # clear_main=False snapshots chain views onto last_frame — keep
            # the loop's sequential-composite semantics (same rule as
            # render_batch's has_init_frame exclusion)
            frames = [self.render_view(scene, d, zoom=float(z))
                      for d, z in zip(ds, zs)]
            out = (jnp.stack(frames) if frames else jnp.zeros(
                (0, scene.plan.height, scene.plan.width, 4), jnp.float32))
            return _frames_to_u8(out) if as_uint8 else out
        run, rest = self._view_executor(scene)
        rect_cols = ex.VIEW_RECT_COLS_PACKED
        view_fn = ex.get_view_frame_fn(run, scene.n_quads, rect_cols)
        n_dev = int(mesh.devices.size) if mesh is not None else 1
        limit = chunk * n_dev
        parts = []
        for s in range(0, n, limit):
            k = min(limit, n - s)
            per_dev = -(-k // n_dev)
            per_dev = min(chunk, 1 << max(per_dev - 1, 0).bit_length())
            target = max(per_dev * n_dev, k)
            idx = np.minimum(np.arange(target), k - 1)  # repeat last view
            dsc = jnp.asarray(ds[s : s + k][idx])
            zsc = jnp.asarray(zs[s : s + k][idx])
            if mesh is not None:
                from .parallel.sharding import cached_frame_parallel_runner

                batched = cached_frame_parallel_runner(view_fn, 2, mesh)
            else:
                batched = ex.get_batch_runner(view_fn, 2)
            out = batched(dsc, zsc, scene.combo_dev, *rest)
            parts.append(out[:k])
        out = parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=0)
        if n:
            self.last_frame = out[-1]
        if as_uint8:
            return _frames_to_u8(out)
        return out

    # --- batched offline rendering -----------------------------------------

    def render_batch(
        self,
        scenes,
        frame_size: Vec2,
        clear_color: Color = Color(1.0, 1.0, 1.0, 1.0),
        chunk: int = 0,
        as_uint8: bool = False,
        mesh=None,
    ) -> jnp.ndarray:
        """Render a sequence of scenes as chunked single-dispatch batches —
        the offline/animation throughput path (no reference analog: GL
        submits every frame individually).

        Consecutive frames whose pass structure matches are stacked so each
        chunk travels to the device as ONE host→device transfer and runs as
        ONE jitted lax.map program (executor.get_batch_runner), amortizing
        the per-frame fixed costs (transfer + dispatch) that dominate
        small/medium frames. Frames whose structure differs are
        rendered through the normal single-frame dispatch in order, so the
        result never depends on the scenes actually matching.

        Every frame clears (no compositing onto the previous frame — that
        would chain frames sequentially); the atlas is snapshotted once per
        chunk flush, so image updates land at chunk granularity. Returns an
        (F, H, W, 4) float32 device array in scene order.

        `chunk` (default FIGDRAW_BATCH_CHUNK or 8) bounds frames per
        dispatch; short groups pad the frame axis to the next power of two
        (one jit signature per pow2 ≤ chunk) and slice the padding off.

        `as_uint8` quantizes frames to RGBA u8 ON DEVICE with exactly
        take_screenshot's rounding — for export workflows the device→host
        readback is the next bottleneck, and u8 frames are 4x smaller than
        f32.

        `mesh` (a 1-D jax.sharding.Mesh, e.g. parallel.sharding.frames_mesh())
        shards each chunk's frame axis across devices: every device renders
        whole frames, no collectives — offline rendering is embarrassingly
        parallel, so throughput scales ~linearly with mesh size. The chunk
        budget multiplies by the mesh size (chunk frames PER DEVICE).
        """
        from .basics import scaled
        from .colors import as_color

        if chunk <= 0:
            from .config import batch_chunk

            chunk = batch_chunk()
        clear_color = as_color(clear_color)
        fs = scaled(frame_size)
        self._assert_render_thread()
        self.drain_async()

        limit = chunk * (int(mesh.devices.size) if mesh is not None else 1)
        parts = []  # (F_i, H, W, 4) device arrays, in scene order
        group = None  # (key, [vary tuples], [plans])

        def flush():
            nonlocal group
            if group is None:
                return
            key, varies, plans = group
            group = None
            if len(plans) == 1 and mesh is None:
                parts.append(self._dispatch_execution(plans[0])[None])
                return
            parts.append(self._dispatch_batch(key, varies, plans, chunk, mesh))

        for renders in scenes:
            self.process_image_messages()
            tape = self.flatten(renders, fs, True, clear_color)
            plan = self._plan_execution(tape)
            key, vary = self._batch_signature(plan)
            if key is None:
                flush()
                parts.append(self._dispatch_execution(plan)[None])
                continue
            if group is not None and (
                group[0] != key or len(group[2]) >= limit
            ):
                flush()
            if group is None:
                group = (key, [], [])
            group[1].append(vary)
            group[2].append(plan)
        flush()
        self.publish_atlas_usage()
        if not parts:
            return jnp.zeros(
                (0, int(round(fs.y)), int(round(fs.x)), 4), jnp.float32
            )
        out = parts[0] if len(parts) == 1 else jnp.concatenate(parts, axis=0)
        self.last_frame = out[-1]
        self._maybe_write_one_frame()
        if as_uint8:
            return _frames_to_u8(out)
        return out

    def _batch_signature(self, plan: _ExecPlan):
        """(group key, per-frame varying buffers) for a plan, or (None, None)
        when the frame cannot batch (composites onto the previous frame).
        Copies pooled upload buffers: the native combo pool ping-pongs two
        buffers per renderer, and a batch holds more frames in flight."""
        if plan.has_init_frame:
            return None, None
        gen = self.atlas.generation  # rebuilds reposition entries: new group
        if plan.mega_combo is not None:
            # mega_combo is freshly packed (owned)
            key = (
                "mega", plan.height, plan.width, plan.n_masks,
                plan.mega_combo.shape, gen,
            )
            return key, (plan.mega_combo,)
        if plan.rolled:
            items_arr, radii_arr, bucket = plan.rolled_args()
            key = (
                "rolled", plan.height, plan.width, plan.n_masks,
                bucket, plan.combo.shape, gen,
            )
            return key, (plan.combo.copy(), items_arr, radii_arr)
        key = (
            "unrolled", tuple(plan.structure), plan.height, plan.width,
            plan.n_masks, plan.combo.shape, gen,
        )
        return key, (plan.combo.copy(),)

    def _dispatch_batch(self, key, varies, plans, chunk: int,
                        mesh=None) -> jnp.ndarray:
        """Stack a group's varying buffers along a new frame axis, pad to
        the next power of two ≤ chunk (per device when a mesh shards the
        frame axis), and run the batched executor."""
        from . import executor as ex

        plan = plans[0]
        f = len(plans)
        n_dev = int(mesh.devices.size) if mesh is not None else 1
        per_dev = -(-f // n_dev)
        per_dev = min(chunk, 1 << max(per_dev - 1, 0).bit_length())
        target = max(per_dev * n_dev, f)  # f > chunk*n_dev never happens
        pad = target - f
        stacks = []
        for i in range(len(varies[0])):
            arrs = [v[i] for v in varies]
            if pad:
                arrs = arrs + [arrs[-1]] * pad
            stacks.append(jnp.asarray(np.stack(arrs)))
        init_frame = self._dummy_init_frame()
        if key[0] == "mega":
            run = ex.get_mega_executor(
                plan.height, plan.width, plan.n_masks, False)
            const = (init_frame,)
        elif key[0] == "rolled":
            bucket = plan.rolled_args()[2]
            run = ex.get_rolled_executor(
                plan.height, plan.width, plan.n_masks, bucket,
                self.use_pallas, self.text_subpixel_positioning, False,
                self.pixelate,
            )
            const = (init_frame, self._device_atlas())
        else:
            run = ex.get_frame_executor(
                tuple(plan.structure), plan.height, plan.width,
                plan.n_masks, self.use_pallas,
                self.text_subpixel_positioning, False, self.pixelate,
            )
            const = (init_frame, self._device_atlas())
        if mesh is not None:
            from .parallel.sharding import cached_frame_parallel_runner

            batched = cached_frame_parallel_runner(run, len(stacks), mesh)
        else:
            batched = ex.get_batch_runner(run, len(stacks))
        out = batched(*stacks, *const)
        return out[:f] if pad else out

    def _maybe_write_one_frame(self) -> None:
        """FIGDRAW_TEST_ONE_FRAME: write the first frame as a PNG (the
        reference's -d:testOneFrame screenshot hook, figrender.nim:1997-2002)."""
        if self._one_frame_written:
            return
        from .config import test_one_frame_path

        path = test_one_frame_path()
        if not path:
            self._one_frame_written = True
            return
        from PIL import Image

        Image.fromarray(self.take_screenshot()).save(path)
        self._one_frame_written = True

    def _render_native_fast(self, renders, fs, clear_main, clear_color):
        """Mask-heavy fast path: C++ walk → megakernel combo → ONE Pallas
        kernel, skipping Tape construction and Python packing entirely.
        Returns (frame, None) on success, (None, tape) when the scene took
        the tape export instead, (None, None) when the native walk is
        unavailable (the Python walk runs)."""
        from . import native
        from . import executor as ex
        from .basics import fig_ui_scale

        self._ensure_packed_glyphs(renders)
        result = native.flatten_fast(
            renders,
            fs.x,
            fs.y,
            fig_ui_scale(),
            self._pixel_scale,
            self.aa_factor,
            (
                (clear_color.r, clear_color.g, clear_color.b, clear_color.a)
                if clear_main
                else None
            ),
            atlas_entries=self._atlas_pack(),
            atlas_size=self.atlas.size,
            white_uv=self._white_uv(),
            min_items=ROLLED_THRESHOLD,
            bucket=_bucket,
            text_config=self._text_config(),
            glyph_offsets=self._glyph_offsets_pack(),
            pool_owner=id(self),
        )
        if result is None:
            return None, None
        if result[0] == "tape":
            return None, result[1]
        _, combo, mask_count = result
        width = int(round(fs.x))
        height = int(round(fs.y))
        has_init_frame = not clear_main
        if has_init_frame:
            if self.last_frame is not None and self.last_frame.shape[:2] == (
                height, width,
            ):
                init_frame = self.last_frame
            else:
                init_frame = jnp.zeros((height, width, 4), jnp.float32)
            # pooled buffer: a previous clearing frame may have left its
            # clear color in the meta row — this frame starts from init_frame
            combo[-1, 0:4] = 0.0
        else:
            combo[-1, 0:4] = (
                clear_color.r, clear_color.g, clear_color.b, clear_color.a,
            )
            init_frame = self._dummy_init_frame()
        frame = ex.get_mega_executor(
            height, width, mask_count + 1, has_init_frame
        )(jnp.asarray(combo), init_frame)
        self.last_executor = "mega"
        self.last_frame = frame
        return frame, None

    def render_frame_with_overlays(
        self,
        renders,
        frame_size: Vec2,
        overlays,
        clear_main: bool = True,
        clear_color: Color = Color(1.0, 1.0, 1.0, 1.0),
    ) -> jnp.ndarray:
        """Composite externally produced full-frame images between scene
        layers — this renderer's mapping of the reference's 3D-overlay GL
        sandwich (tests/trender_3d_overlay.nim draws raw GL between figdraw
        passes; here an overlay is any (H, W, 4) float array — another JAX
        program's output, a plot, a video frame).

        overlays: {zlevel: array}; each composites source-over AFTER all
        scene layers with zlevel < that key and BEFORE layers >= it."""
        if not overlays:
            return self.render_frame(renders, frame_size, clear_main, clear_color)
        boundaries = sorted(overlays)
        groups: list = [[] for _ in range(len(boundaries) + 1)]
        for lvl, lst in renders.sorted_pairs():
            gi = 0
            while gi < len(boundaries) and lvl >= boundaries[gi]:
                gi += 1
            groups[gi].append((lvl, lst))

        make_empty = type(renders)
        frame = None
        first = True
        for gi, group in enumerate(groups):
            if group:
                sub = make_empty()
                for lvl, lst in group:
                    sub.set_layer(lvl, lst)
                frame = self.render_frame(
                    sub, frame_size,
                    clear_main=clear_main if first else False,
                    clear_color=clear_color,
                )
                first = False
            elif first:
                # nothing below the first overlay: start from the clear color
                from .basics import scaled

                fs = scaled(frame_size)
                h, w = int(round(fs.y)), int(round(fs.x))
                frame = jnp.broadcast_to(
                    jnp.asarray(
                        [clear_color.r, clear_color.g, clear_color.b, clear_color.a],
                        jnp.float32,
                    ),
                    (h, w, 4),
                )
                self.last_frame = frame
                first = False
            if gi < len(boundaries):
                overlay = jnp.asarray(overlays[boundaries[gi]], jnp.float32)
                assert overlay.shape == frame.shape, (
                    f"overlay {overlay.shape} must match the frame {frame.shape}"
                )
                frame = _blend_overlay(frame, overlay)
                self.last_frame = frame
        return frame

    def take_screenshot(self, frame=None, frame_rect=None) -> np.ndarray:
        """Rendered frame as uint8 RGBA (readPixels analog,
        glcontext.nim:2094-2135). frame_rect: optional (x, y, w, h) crop in
        pixels, clamped to the frame like the GL readback."""
        if frame is None:
            frame = self.last_frame
        arr = np.asarray(frame)
        if frame_rect is not None:
            x, y, w, h = (int(round(v)) for v in frame_rect)
            x = max(0, min(x, arr.shape[1]))
            y = max(0, min(y, arr.shape[0]))
            arr = arr[y : y + max(h, 0), x : x + max(w, 0)]
        return np.clip(np.round(arr * 255.0), 0, 255).astype(np.uint8)


@jax.jit
def _frames_to_u8(frames: jnp.ndarray) -> jnp.ndarray:
    """Device-side RGBA u8 quantization, bit-identical to take_screenshot's
    host readback (round-half-to-even, like np.round)."""
    return jnp.clip(jnp.round(frames * 255.0), 0, 255).astype(jnp.uint8)


def new_fig_renderer(atlas_size: int = 512, pixel_scale: float = 1.0) -> FigRenderer:
    return FigRenderer(atlas_size=atlas_size, pixel_scale=pixel_scale)
