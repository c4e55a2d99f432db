"""ctypes bridge to the native flattener (native/flatten.cpp).

Builds libfigdraw_flatten.so on first use with g++ (no external deps) and
exposes flatten_renders_array(), producing the same Tape as the Python walk
— verified structurally identical by tests/test_native_flatten.py.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading
from typing import Optional

import numpy as np

from .nodesarray import FIG_DTYPE, GLYPH_DTYPE, OP_DTYPE, TRECT_DTYPE, RendersArray
from .ops.layout import QF_WIDTH
from .tape import BlurItem, ClearMaskItem, DrawItem, Tape

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_REPO_ROOT, "native", "flatten.cpp")
_LIB_DIR = os.path.join(_REPO_ROOT, "native", "build")
_LIB = os.path.join(_LIB_DIR, "libfigdraw_flatten.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def _build() -> None:
    os.makedirs(_LIB_DIR, exist_ok=True)
    # -ffp-contract=off: the walk and the scene animator are pinned
    # BIT-identical to their numpy twins; numpy never fuses multiply-add,
    # so FMA contraction (this host has FMA) must be off for parity.
    cmd = ["g++", "-O3", "-march=native", "-ffp-contract=off", "-pthread",
           "-shared", "-fPIC", "-std=c++17", "-o", _LIB, _SRC]
    subprocess.run(cmd, check=True, capture_output=True)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        try:
            if not os.path.exists(_LIB) or os.path.getmtime(_LIB) < os.path.getmtime(_SRC):
                _build()
            lib = ctypes.CDLL(_LIB)
        except Exception as exc:  # no toolchain → Python walk keeps working
            print(f"figdraw_tpu: native flattener unavailable ({exc})", file=sys.stderr)
            _load_failed = True
            return None

        lib.fd_create.restype = ctypes.c_void_p
        lib.fd_create.argtypes = [ctypes.c_float, ctypes.c_float, ctypes.c_float]
        lib.fd_destroy.argtypes = [ctypes.c_void_p]
        lib.fd_reset.argtypes = [
            ctypes.c_void_p, ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ]
        lib.fd_flatten_layer.argtypes = [
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_int,
            ctypes.c_void_p,
            ctypes.c_int,
        ]
        lib.fd_flatten_layer_spans.argtypes = [
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_int,
            ctypes.c_void_p,
            ctypes.c_int,
            ctypes.c_void_p,
        ]
        lib.fd_pad_rows.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.fd_set_geometry.argtypes = [
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_int,
            ctypes.c_void_p,
            ctypes.c_int,
        ]
        lib.fd_set_white_uv.argtypes = [
            ctypes.c_void_p,
            ctypes.c_double,
            ctypes.c_double,
        ]
        lib.fd_set_text_geometry.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int,
        ]
        lib.fd_set_text_config.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.fd_set_glyph_offsets.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ]
        lib.fd_set_atlas.argtypes = [
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_int,
            ctypes.c_float,
        ]
        lib.fd_quad_count.argtypes = [ctypes.c_void_p]
        lib.fd_quad_count.restype = ctypes.c_int
        lib.fd_item_count.argtypes = [ctypes.c_void_p]
        lib.fd_item_count.restype = ctypes.c_int
        lib.fd_mask_count.argtypes = [ctypes.c_void_p]
        lib.fd_mask_count.restype = ctypes.c_int
        lib.fd_clear_count.argtypes = [ctypes.c_void_p]
        lib.fd_clear_count.restype = ctypes.c_int
        lib.fd_fig_struct_size.restype = ctypes.c_int
        lib.fd_export.argtypes = [
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_int,
            ctypes.c_void_p,
            ctypes.c_int,
        ]
        lib.fd_export.restype = ctypes.c_int
        lib.fd_export_items.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ]
        lib.fd_export_items.restype = ctypes.c_int
        lib.fd_export_combo.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ]
        lib.fd_export_combo.restype = ctypes.c_int
        lib.fd_export_combo_packed.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ]
        lib.fd_export_combo_packed.restype = ctypes.c_int
        lib.fd_tape_info.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.fd_cull_saturated.argtypes = [
            ctypes.c_void_p, ctypes.c_float, ctypes.c_float,
        ]
        lib.fd_cull_saturated.restype = ctypes.c_int
        lib.fd_export_mega.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ]
        lib.fd_export_mega.restype = ctypes.c_int
        lib.fd_export_mega_packed.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ]
        lib.fd_export_mega_packed.restype = ctypes.c_int
        # scene-building API (native_bindings.nim analog)
        lib.fd_renders_new.restype = ctypes.c_void_p
        lib.fd_renders_free.argtypes = [ctypes.c_void_p]
        lib.fd_renders_add_root.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.fd_renders_add_root.restype = ctypes.c_int
        lib.fd_renders_add_child.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.fd_renders_add_child.restype = ctypes.c_int
        lib.fd_renders_op_count.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.fd_renders_op_count.restype = ctypes.c_int
        lib.fd_renders_add_op.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int,
        ]
        lib.fd_renders_add_op.restype = ctypes.c_int
        lib.fd_renders_glyph_count.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.fd_renders_glyph_count.restype = ctypes.c_int
        lib.fd_renders_trect_count.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.fd_renders_trect_count.restype = ctypes.c_int
        lib.fd_renders_add_text.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int,
        ]
        lib.fd_renders_add_text.restype = ctypes.c_int
        lib.fd_flatten_renders.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        # retained editing over the C ABI (figdraw_flatten.h recipe)
        lib.fd_renders_root_count.argtypes = [ctypes.c_void_p]
        lib.fd_renders_root_count.restype = ctypes.c_int
        lib.fd_renders_set_fig.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.fd_renders_set_fig.restype = ctypes.c_int
        lib.fd_flatten_renders_spans.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int,
        ]
        lib.fd_flatten_renders_spans.restype = ctypes.c_int
        lib.fd_flatten_renders_root.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ]
        lib.fd_flatten_renders_root.restype = ctypes.c_int
        lib.fd_fill_solid.argtypes = [
            ctypes.c_void_p, ctypes.c_uint8, ctypes.c_uint8,
            ctypes.c_uint8, ctypes.c_uint8,
        ]
        lib.fd_fill_linear2.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ]
        lib.fd_fill_linear3.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_uint8,
        ]
        lib.fd_scene_animate.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_double, ctypes.c_double,
            ctypes.c_double, ctypes.c_double,
            ctypes.c_int32, ctypes.c_int32,
        ] + [ctypes.c_void_p] * 8
        lib.fd_scene_animate.restype = ctypes.c_int

        expected = lib.fd_fig_struct_size()
        assert expected == FIG_DTYPE.itemsize, (
            f"FIG_DTYPE ({FIG_DTYPE.itemsize} B) out of sync with native Fig "
            f"({expected} B)"
        )
        lib.fd_op_struct_size.restype = ctypes.c_int
        op_expected = lib.fd_op_struct_size()
        assert op_expected == OP_DTYPE.itemsize, (
            f"OP_DTYPE ({OP_DTYPE.itemsize} B) out of sync with native DrawOp "
            f"({op_expected} B)"
        )
        lib.fd_glyph_struct_size.restype = ctypes.c_int
        assert lib.fd_glyph_struct_size() == GLYPH_DTYPE.itemsize, (
            f"GLYPH_DTYPE ({GLYPH_DTYPE.itemsize} B) out of sync with native "
            f"GlyphRow ({lib.fd_glyph_struct_size()} B)"
        )
        lib.fd_trect_struct_size.restype = ctypes.c_int
        assert lib.fd_trect_struct_size() == TRECT_DTYPE.itemsize, (
            f"TRECT_DTYPE ({TRECT_DTYPE.itemsize} B) out of sync with native "
            f"TextRect ({lib.fd_trect_struct_size()} B)"
        )
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


# Cached ctypes pointers. numpy's arr.ctypes.data_as() rebuilds the ctypes
# interface object on every call (~5 us on the bench host; the hot flatten
# path makes ~11 such calls per frame). Every array on that path is stable
# across frames (pooled combo buffers, the renderer's atlas/glyph packs, the
# per-list walk cache below), so the pointer is computed once per array
# object. The cache retains the array (so its id can't be recycled while the
# entry lives) and is dropped wholesale past a bound.
_ptr_cache: dict = {}


def _ptr(arr: np.ndarray) -> ctypes.c_void_p:
    key = id(arr)
    ent = _ptr_cache.get(key)
    if ent is None or ent[0] is not arr:
        if len(_ptr_cache) > 2048:
            _ptr_cache.clear()
        _ptr_cache[key] = ent = (arr, ctypes.c_void_p(arr.ctypes.data))
    return ent[1]


def _layer_arrays(lst):
    """Contiguous walk arrays for one render list, cached on the list object
    so retained scenes (in-place column animation) skip the per-frame
    list→array conversions and contiguity checks. Invalidated by any count
    change or a nodes-buffer regrow; in-place field writes keep the same
    buffers and need no invalidation."""
    ver = (lst.count, len(lst.root_ids), len(lst.ops_rows),
           len(lst.glyph_rows))
    cached = getattr(lst, "_walk_cache", None)
    if cached is not None and cached[0] == ver and cached[1] is lst.nodes:
        return cached[2]
    nodes = np.ascontiguousarray(lst.nodes[: lst.count])
    roots = np.asarray(lst.root_ids, dtype=np.int32)
    ops, points = lst.ops_view()
    ops = np.ascontiguousarray(ops)
    points = np.ascontiguousarray(points)
    glyphs, trects = lst.text_view()
    glyphs = np.ascontiguousarray(glyphs)
    trects = np.ascontiguousarray(trects)
    arrays = (nodes, roots, ops, points, glyphs, trects)
    try:
        lst._walk_cache = (ver, lst.nodes, arrays)
    except AttributeError:  # slotted/foreign list types: just don't cache
        pass
    return arrays


def pack_atlas_entries(entries: dict, atlas_size: int):
    """Sorted (id, level) parallel arrays for fd_set_atlas. Integer keys are
    level-0 entries; (id, level) tuple keys are mips; other keys (glyph
    hashes are ints too, fine; string keys like the white texel) are skipped
    only if non-integer."""
    rows = []
    for key, rect in entries.items():
        if isinstance(key, tuple) and len(key) == 2 and isinstance(key[0], int):
            rows.append((key[0], key[1], rect))
        elif isinstance(key, int):
            rows.append((key, 0, rect))
    rows.sort(key=lambda r: (r[0], r[1]))
    n = len(rows)
    ids = np.asarray([r[0] for r in rows], dtype=np.int64)
    levels = np.asarray([r[1] for r in rows], dtype=np.int32)
    rects = np.asarray([r[2] for r in rows], dtype=np.float32).reshape(n, 4) if n else np.zeros((0, 4), np.float32)
    return ids, levels, rects


def _set_walk_config(lib, ctx, atlas_entries, atlas_size, white_uv,
                     text_config, glyph_offsets) -> None:
    """Frame-invariant walk-context setup shared by _run_walk and the
    retained-scene scratch walk (walk_roots_packed)."""
    lib.fd_set_text_config(
        ctx, int(text_config[0]), int(text_config[1]), int(text_config[2])
    )
    if glyph_offsets:
        if isinstance(glyph_offsets, tuple):
            keys, offs = glyph_offsets
        else:
            keys = np.fromiter(glyph_offsets.keys(), dtype=np.int64,
                               count=len(glyph_offsets))
            order = np.argsort(keys)
            keys = np.ascontiguousarray(keys[order])
            offs = np.asarray(list(glyph_offsets.values()), dtype=np.float32)
            offs = np.ascontiguousarray(offs[order])
        lib.fd_set_glyph_offsets(ctx, _ptr(keys), _ptr(offs), keys.shape[0])
    if atlas_entries:
        if isinstance(atlas_entries, tuple):
            ids, levels, rects = atlas_entries
        else:
            ids, levels, rects = pack_atlas_entries(atlas_entries, atlas_size)
        lib.fd_set_atlas(
            ctx, _ptr(ids), _ptr(levels), _ptr(rects), ids.shape[0],
            ctypes.c_float(float(atlas_size)),
        )
    lib.fd_set_white_uv(
        ctx, ctypes.c_double(white_uv[0]), ctypes.c_double(white_uv[1])
    )


def _run_walk(lib, ctx, renders, atlas_entries, atlas_size, white_uv,
              text_config=(False, False, False), glyph_offsets=None,
              spans_out=None, reserves=None) -> None:
    """Shared context setup + layer walk for the export variants.
    atlas_entries: the entries dict, or a prepacked (ids, levels, rects)
    tuple from pack_atlas_entries (renderer caches it by atlas version).
    spans_out: optional dict filled with (lvl, root_node_idx) → (qs, qe)
    per-root tape row spans (forces the serial walk — the retained-scene
    snapshot contract, renderer.update_scene). reserves: optional
    (lvl, root_node_idx) → n dict; each such root's span is padded with n
    INERT rows (fd_pad_rows) so count-changing edits can patch in place."""
    _set_walk_config(lib, ctx, atlas_entries, atlas_size, white_uv,
                     text_config, glyph_offsets)
    for _lvl, lst in renders.sorted_pairs():
        nodes, roots, ops, points, glyphs, trects = _layer_arrays(lst)
        lib.fd_set_geometry(
            ctx, _ptr(ops), ops.shape[0], _ptr(points), points.shape[0]
        )
        lib.fd_set_text_geometry(
            ctx, _ptr(glyphs), glyphs.shape[0], _ptr(trects), trects.shape[0]
        )
        if spans_out is None:
            lib.fd_flatten_layer(
                ctx, _ptr(nodes), nodes.shape[0], _ptr(roots), roots.shape[0]
            )
        elif reserves and any(
            (_lvl, int(r)) in reserves for r in roots
        ):
            # per-root calls so reserved roots can pad in place (serial on
            # the same ctx: runs stay open, mask numbering stays global —
            # byte-identical to the one-call walk apart from the pads)
            one = np.empty((1, 2), np.int32)
            for pos in range(roots.shape[0]):
                rid = int(roots[pos])
                lib.fd_flatten_layer_spans(
                    ctx, _ptr(nodes), nodes.shape[0],
                    roots[pos : pos + 1].ctypes.data_as(ctypes.c_void_p), 1,
                    one.ctypes.data_as(ctypes.c_void_p),
                )
                pad = int(reserves.get((_lvl, rid), 0))
                if pad > 0:
                    lib.fd_pad_rows(ctx, pad)
                spans_out[(_lvl, rid)] = (int(one[0, 0]),
                                          int(one[0, 1]) + pad)
        else:
            spans = np.empty((roots.shape[0], 2), np.int32)
            lib.fd_flatten_layer_spans(
                ctx, _ptr(nodes), nodes.shape[0], _ptr(roots),
                roots.shape[0], spans.ctypes.data_as(ctypes.c_void_p),
            )
            for pos in range(roots.shape[0]):
                spans_out[(_lvl, int(roots[pos]))] = (
                    int(spans[pos, 0]), int(spans[pos, 1])
                )


_HOST_CULL = os.environ.get("FIGDRAW_HOST_CULL", "1") != "0"


def _host_cull(lib, ctx, frame_w, frame_h, pixel_scale) -> int:
    """Translucent-saturation compaction of dense tapes before export
    (fd_cull_saturated; binning.py's SAT tier run host-side so the per-frame
    upload shrinks too). No-op under 4096 quads or FIGDRAW_HOST_CULL=0."""
    if not _HOST_CULL:
        return 0
    return lib.fd_cull_saturated(
        ctx,
        ctypes.c_float(frame_w * pixel_scale),
        ctypes.c_float(frame_h * pixel_scale),
    )


def _export_tape(lib, ctx, frame_w, frame_h, clear_color) -> Tape:
    n_quads = lib.fd_quad_count(ctx)
    n_items = lib.fd_item_count(ctx)
    tape = Tape(capacity=max(n_quads, 1))
    items = np.zeros((max(n_items, 1), 5), dtype=np.int32)
    rc = lib.fd_export(
        ctx,
        tape.fields.ctypes.data_as(ctypes.c_void_p),
        tape.modes.ctypes.data_as(ctypes.c_void_p),
        tape.fields.shape[0],
        items.ctypes.data_as(ctypes.c_void_p),
        items.shape[0],
    )
    assert rc == n_quads
    tape.count = n_quads
    tape.mask_count = lib.fd_mask_count(ctx)
    tape.frame_size = (frame_w, frame_h)
    tape.clear_color = clear_color
    for i in range(n_items):
        kind, target, start, end, rbits = items[i]
        kind &= 0xFF  # draw items carry atlas/backdrop flag bits 8/9
        if kind == 0:
            tape.items.append(DrawItem(target=int(target), start=int(start), end=int(end)))
        elif kind == 1:
            tape.items.append(
                BlurItem(radius=float(np.int32(rbits).view(np.float32)))
            )
        else:
            tape.items.append(ClearMaskItem(index=int(target)))
    return tape


_tls = threading.local()


def _acquire_ctx(lib, ui_scale, pixel_scale, aa_factor):
    """Thread-local reusable walk context.

    fd_reset keeps the C++ tape vectors' capacity across frames, so
    steady-state frames do no heap growth — the reference's "few or no
    allocations per frame" target (README.md:7). Thread-local because a Ctx
    is single-walker state (the renderer's thread guard already serializes
    per-renderer use)."""
    ctx = getattr(_tls, "ctx", None)
    if ctx is None:
        ctx = lib.fd_create(
            ctypes.c_float(ui_scale), ctypes.c_float(pixel_scale),
            ctypes.c_float(aa_factor),
        )
        _tls.ctx = ctx
    else:
        lib.fd_reset(
            ctx, ctypes.c_float(ui_scale), ctypes.c_float(pixel_scale),
            ctypes.c_float(aa_factor),
        )
    return ctx


# Ping-pong combo buffer pool: zeroing a fresh ~9 MB buffer per frame costs
# ~1 ms at the 30k-quad scale. Quad rows [0, count) are fully rewritten by
# fd_export_combo/fd_export_mega and the meta tail by fill_meta; stale rows in
# [count, bucket) are never read (binning masks indices >= count and every
# consumer bounds by tape.count), so reuse is safe. TWO buffers per
# (ctx, shape) keep the PREVIOUS frame's tape views valid while the current
# frame is exported (flatten → execute → flatten pipelining).
_combo_pool: dict = {}


def _pooled_combo(ctx, shape, owner=None) -> np.ndarray:
    # owner (the renderer's id) keys the ping-pong per renderer: two
    # renderers on one thread share the walk ctx but must not share upload
    # buffers — with the async frame pipeline a peer's in-flight frame may
    # still be reading its buffer when this renderer flattens twice
    key = (owner, ctx.value if hasattr(ctx, "value") else int(ctx), shape)
    entry = _combo_pool.get(key)
    if entry is None:
        entry = [np.zeros(shape, np.float32), np.zeros(shape, np.float32), 0]
        _combo_pool[key] = entry
    entry[2] ^= 1
    return entry[entry[2]]


def _export_tape_combo(lib, ctx, frame_w, frame_h, clear_color, bucket,
                       pool_owner=None) -> Tape:
    """Export straight into the executor's PACKED upload layout: ONE
    zeroed (bucket(count) + meta_rows, 52) wire buffer, quad rows written
    by C++ (fd_export_combo_packed — colors ride as u8x4 words), meta tail
    (draw bounds / blur radii / clear color — executor._meta_rows layout)
    filled here. renderer.execute uploads the buffer as-is and unpacks on
    device; the Tape's logical fields/modes materialize lazily."""
    from .executor import ROLLED_THRESHOLD, _meta_rows
    from .ops.layout import PACKED_WIDTH

    n_quads = lib.fd_quad_count(ctx)
    n_items = lib.fd_item_count(ctx)
    items = np.zeros((max(n_items, 1), 5), dtype=np.int32)
    rc = lib.fd_export_items(ctx, items.ctypes.data_as(ctypes.c_void_p),
                             items.shape[0])
    assert rc == n_items

    tape = Tape(capacity=1)
    tape.count = n_quads
    tape.mask_count = lib.fd_mask_count(ctx)
    tape.frame_size = (frame_w, frame_h)
    tape.clear_color = clear_color
    draws = []
    radii = []
    structure = []  # executor.tape_structure built from the C++ flag bits
    seen_blur = False
    any_atlas = False
    any_backdrop = False
    for i in range(n_items):
        word, target, start, end, rbits = items[i]
        kind = word & 0xFF
        if kind == 0:
            tape.items.append(DrawItem(target=int(target), start=int(start),
                                       end=int(end)))
            if end > start:
                uses_atlas = bool(word & 0x100)
                has_backdrop = bool(word & 0x200)
                any_atlas |= uses_atlas
                any_backdrop |= has_backdrop
                structure.append(("draw", int(target), uses_atlas,
                                  seen_blur and has_backdrop))
                draws.append((int(start), int(end)))
        elif kind == 1:
            r = float(np.int32(rbits).view(np.float32))
            tape.items.append(BlurItem(radius=r))
            radii.append(r)
            seen_blur = True
            structure.append(("blur",))
        else:
            tape.items.append(ClearMaskItem(index=int(target)))
            structure.append(("clear_mask", int(target)))
    structure_len = len(structure)
    tape.structure_cache = (structure, draws, radii, any_atlas, any_backdrop)

    rolled = structure_len > ROLLED_THRESHOLD
    row_width = PACKED_WIDTH
    n_pad = bucket(max(n_quads, 1))
    nd = 0 if rolled else len(draws)
    nb = 0 if rolled else len(radii)
    rows = _meta_rows(nd, nb, row_width)
    combo = _pooled_combo(ctx, (n_pad + rows, row_width), owner=pool_owner)
    rc = lib.fd_export_combo_packed(ctx, _ptr(combo), n_pad, row_width)
    assert rc == n_quads
    from .executor import fill_meta

    fill_meta(
        combo[n_pad:].reshape(-1),
        draws if not rolled else [],
        radii if not rolled else [],
        clear_color or (0.0, 0.0, 0.0, 0.0),
    )
    tape.combo = combo
    tape.combo_rolled = rolled
    tape.combo_quads = n_pad
    # logical fields/modes materialize lazily from the packed buffer
    tape.fields = None
    tape.modes = None
    return tape


def flatten_fast(
    renders: RendersArray,
    frame_w: float,
    frame_h: float,
    ui_scale: float,
    pixel_scale: float,
    aa_factor: float,
    clear_color,
    atlas_entries: Optional[dict] = None,
    atlas_size: int = 1,
    white_uv=(0.0, 0.0),
    min_items: int = 24,
    bucket=None,
    text_config=(False, False, False),
    glyph_offsets=None,
    pool_owner=None,
):
    """One C++ walk, best export for the scene:

    ("mega", combo, mask_count) — mask-heavy pure-SDF scene exported straight
    to the megakernel combo buffer (rows+1, 70) f32 with a zero meta row; no
    Tape objects, no Python packing.
    ("tape", tape) — everything else (light scenes, blur/atlas/backdrop).
    None — native path unavailable or unsupported node kinds."""
    lib = _load()
    if lib is None or not renders.all_native_kinds():
        return None
    from .ops.layout import PACKED_WIDTH

    row_width = PACKED_WIDTH
    ctx = _acquire_ctx(lib, ui_scale, pixel_scale, aa_factor)
    _run_walk(lib, ctx, renders, atlas_entries, atlas_size, white_uv,
              text_config, glyph_offsets)
    _host_cull(lib, ctx, frame_w, frame_h, pixel_scale)
    info = np.zeros(4, np.int32)
    lib.fd_tape_info(ctx, info.ctypes.data_as(ctypes.c_void_p))
    n_quads, n_items, mask_count, flags = (int(v) for v in info)
    from .ops.raster_pallas import mega_fits

    # mask planes beyond the megakernel's register budget take the tape
    # export (rolled executor) — chosen by shape, before any upload
    if n_items > min_items and flags == 0 and mega_fits(mask_count + 1):
        # tight row bound: quads + clear sentinels (draw/blur items never
        # add rows) — bucketing on n_items oversized mask-heavy uploads
        cap = (bucket or (lambda v: v))(n_quads + lib.fd_clear_count(ctx))
        # pooled upload buffer (+1 meta row the caller fills): C++ zeroes
        # the padding rows, so ping-pong reuse never leaks a prior frame
        combo = _pooled_combo(ctx, (cap + 1, row_width), owner=pool_owner)
        rows = lib.fd_export_mega_packed(ctx, _ptr(combo), cap, row_width)
        if rows >= 0:
            return "mega", combo, mask_count
    if bucket is not None:
        return "tape", _export_tape_combo(lib, ctx, frame_w, frame_h,
                                          clear_color, bucket,
                                          pool_owner=pool_owner)
    return "tape", _export_tape(lib, ctx, frame_w, frame_h, clear_color)


def flatten_renders_array(
    renders: RendersArray,
    frame_w: float,
    frame_h: float,
    ui_scale: float,
    pixel_scale: float,
    aa_factor: float,
    clear_color,
    atlas_entries: Optional[dict] = None,
    atlas_size: int = 1,
    white_uv=(0.0, 0.0),
    text_config=(False, False, False),
    glyph_offsets=None,
    bucket=None,
    pool_owner=None,
    cull: bool = True,
    record_spans: bool = False,
    reserve=None,
) -> Optional[Tape]:
    """Runs the native walk over all layers in ZLevel order; returns a Tape or
    None when the native path is unavailable/unsupported. With `bucket` (the
    renderer's quad-bucket function) the tape is exported straight into the
    upload-combo layout (_export_tape_combo). cull=False skips the
    saturation cull — it is clamped to the snapshot viewport, so tapes that
    will be panned on device (renderer.snapshot_scene) must keep every
    quad. record_spans=True additionally fills tape.root_spans with
    (lvl, root_node_idx) → (qs, qe) per-root tape row ranges (serial walk;
    the retained-scene update contract) — spans index PRE-cull rows, so it
    requires cull=False."""
    lib = _load()
    if lib is None:
        return None
    if not renders.all_native_kinds():
        return None

    ctx = _acquire_ctx(lib, ui_scale, pixel_scale, aa_factor)
    spans_out = {} if record_spans else None
    _run_walk(lib, ctx, renders, atlas_entries, atlas_size, white_uv,
              text_config, glyph_offsets, spans_out=spans_out,
              reserves=reserve)
    if cull:
        assert spans_out is None, "root spans index pre-cull rows"
        _host_cull(lib, ctx, frame_w, frame_h, pixel_scale)
    if bucket is not None:
        tape = _export_tape_combo(lib, ctx, frame_w, frame_h, clear_color,
                                  bucket, pool_owner=pool_owner)
    else:
        tape = _export_tape(lib, ctx, frame_w, frame_h, clear_color)
    tape.root_spans = spans_out
    return tape


def inert_quad_rows(n: int, layout: str = "packed") -> np.ndarray:
    """n inert wire rows — the Python twin of fd_pad_rows (bit-identical;
    tests/test_retained.py pins the parity): empty bbox (never binned), an
    inverse affine putting every pixel far outside the uv unit square
    (coverage exactly 0 — the blending identity). The retained patch path
    fills shrunken reserved spans with these."""
    from .ops.layout import (
        PACKED_WIDTH, QF_BBOX_X0, QF_BBOX_X1, QF_BBOX_Y0, QF_BBOX_Y1,
        QF_INV_A, QF_ORG_X, QF_ORG_Y, QF_WIDTH,
    )

    fields = np.zeros((max(n, 1), QF_WIDTH), np.float32)
    fields[:, QF_INV_A] = 1.0
    fields[:, QF_ORG_X] = 2e9
    fields[:, QF_ORG_Y] = 2e9
    fields[:, QF_BBOX_X0] = 2e9
    fields[:, QF_BBOX_Y0] = 2e9
    fields[:, QF_BBOX_X1] = -2e9
    fields[:, QF_BBOX_Y1] = -2e9
    modes = np.zeros((max(n, 1), 2), np.int32)
    modes[:, 0] = 3  # fd_pad_rows' packed_mode
    if layout == "unpacked":
        rows = np.concatenate([fields, modes.view(np.float32)], axis=1)
        return rows[:n]
    from .ops.layout import pack_fields_np

    out = np.zeros((max(n, 1), PACKED_WIDTH), np.float32)
    pack_fields_np(fields, modes, out=out)
    return out[:n]


def _acquire_scratch_ctx(lib, ui_scale, pixel_scale, aa_factor):
    """Dedicated retained-scene patch context: never shares tape state or
    the combo-buffer ping-pong pool with the frame walker's _tls.ctx, so a
    patch between frames cannot invalidate in-flight tape views."""
    ctx = getattr(_tls, "patch_ctx", None)
    if ctx is None:
        ctx = lib.fd_create(
            ctypes.c_float(ui_scale), ctypes.c_float(pixel_scale),
            ctypes.c_float(aa_factor),
        )
        _tls.patch_ctx = ctx
    else:
        lib.fd_reset(
            ctx, ctypes.c_float(ui_scale), ctypes.c_float(pixel_scale),
            ctypes.c_float(aa_factor),
        )
    return ctx


def walk_roots_packed(
    renders,
    dirty,
    ui_scale,
    pixel_scale,
    aa_factor,
    atlas_entries=None,
    atlas_size=1,
    white_uv=(0.0, 0.0),
    text_config=(False, False, False),
    glyph_offsets=None,
    allow_atlas=False,
    layout="packed",
):
    """Re-walk SELECTED roots serially in a scratch context and export their
    quads as wire rows (the retained-scene patch path;
    renderer.update_scene / ShardedFigRenderer.update_scene).

    dirty: sequence of (lvl, root_node_idx). Returns (rows, spans) — rows a
    (n, PACKED_WIDTH) f32 array ("packed" layout) or (n, QF_WIDTH + 2)
    fields+bitcast-mode-lanes array ("unpacked", the sharded combo layout)
    of the dirty roots' quads in walk order, and spans a list of (qs, qe)
    into rows aligned with `dirty` — or None when patching is unsupported:
    native lib missing, non-native node kinds, a missing layer, plane masks
    allocated (global numbering), blur/backdrop pass splits, or atlas
    sampling without allow_atlas."""
    lib = _load()
    if lib is None or not renders.all_native_kinds():
        return None
    from .ops.layout import PACKED_WIDTH

    ctx = _acquire_scratch_ctx(lib, ui_scale, pixel_scale, aa_factor)
    _set_walk_config(lib, ctx, atlas_entries, atlas_size, white_uv,
                     text_config, glyph_offsets)
    dirty = list(dirty)
    spans: list = []
    i = 0
    while i < len(dirty):
        lvl = dirty[i][0]
        j = i
        while j < len(dirty) and dirty[j][0] == lvl:
            j += 1
        lst = renders.layers.get(lvl)
        if lst is None:
            return None
        nodes, _roots, ops, points, glyphs, trects = _layer_arrays(lst)
        lib.fd_set_geometry(
            ctx, _ptr(ops), ops.shape[0], _ptr(points), points.shape[0]
        )
        lib.fd_set_text_geometry(
            ctx, _ptr(glyphs), glyphs.shape[0], _ptr(trects), trects.shape[0]
        )
        roots = np.asarray([d[1] for d in dirty[i:j]], dtype=np.int32)
        out = np.empty((roots.shape[0], 2), np.int32)
        lib.fd_flatten_layer_spans(
            ctx, _ptr(nodes), nodes.shape[0], _ptr(roots), roots.shape[0],
            out.ctypes.data_as(ctypes.c_void_p),
        )
        spans.extend((int(s), int(e)) for s, e in out)
        i = j
    info = np.zeros(4, np.int32)
    lib.fd_tape_info(ctx, info.ctypes.data_as(ctypes.c_void_p))
    n_quads, _n_items, mask_count, flags = (int(v) for v in info)
    # per-row content only: plane masks renumber globally, blur/backdrop
    # items split the pass structure — the caller re-snapshots instead
    if mask_count or (flags & 1) or (flags & 4):
        return None
    if (flags & 2) and not allow_atlas:
        return None
    if layout == "unpacked":
        from .ops.layout import QF_WIDTH, QI_WIDTH

        fields = np.empty((max(n_quads, 1), QF_WIDTH), dtype=np.float32)
        modes = np.empty((max(n_quads, 1), QI_WIDTH), dtype=np.int32)
        items = np.empty((max(_n_items, 1), 5), dtype=np.int32)
        rc = lib.fd_export(ctx, _ptr(fields), _ptr(modes), fields.shape[0],
                           _ptr(items), items.shape[0])
        if rc != n_quads:
            return None
        rows = np.concatenate(
            [fields[:n_quads], modes[:n_quads].view(np.float32)], axis=1
        )
        return rows, spans
    rows = np.empty((max(n_quads, 1), PACKED_WIDTH), dtype=np.float32)
    rc = lib.fd_export_combo_packed(ctx, _ptr(rows), rows.shape[0],
                                    PACKED_WIDTH)
    if rc != n_quads:
        return None
    return rows[:n_quads], spans


def scene_animate(nodes: np.ndarray, w: float, h: float, frame: int,
                  copies: int, base_xs: np.ndarray, base_ys: np.ndarray,
                  tables: dict) -> bool:
    """C twin of scenes._scene_animate_np: writes the 300-box demo scene's
    frame-dependent columns into the FIG_DTYPE `nodes` array in place,
    bit-identical to the numpy animator (tests/test_scenes_native.py pins
    it). `tables` is the _scene_anim_state dict (contiguous f64 phase
    tables). Returns False when the native library is unavailable — the
    caller falls back to numpy."""
    lib = _load()
    if lib is None:
        return False
    # the clamp bounds travel from scenes.py (the single source of truth)
    # instead of being duplicated as constants in the C animator
    from .scenes import _SCENE_CLAMP_X, _SCENE_CLAMP_Y

    rc = lib.fd_scene_animate(
        _ptr(nodes), nodes.shape[0], float(w), float(h),
        float(_SCENE_CLAMP_X), float(_SCENE_CLAMP_Y), int(frame),
        int(copies), _ptr(base_xs), _ptr(base_ys),
        _ptr(tables["sin_of_sp"]), _ptr(tables["cos_of_sp"]),
        _ptr(tables["sin_of_cp"]), _ptr(tables["cos_of_cp"]),
        _ptr(tables["sin_t"]), _ptr(tables["cos_t"]))
    return rc == 0
