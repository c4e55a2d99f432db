"""Structure-of-arrays scene storage for the native flattener.

The reference keeps Fig as a flat 256-byte POD in a contiguous seq
(fignodes.nim:94-97) precisely so the render walk is cache-friendly; this
build mirrors that with a NumPy structured array (FIG_DTYPE) that the
C++ flattener (native/flatten.cpp) walks directly — zero per-frame
marshalling between Python objects and native code.

`RenderListArray` offers the same add_root/add_child surface as RenderList
for hot paths that build scenes straight into the array; `from_render_list`
converts the object form (slower, for compat).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .basics import FigFlags, FigKind
from .fill import Fill, FillKind
from .nodes import Fig, RenderList, Renders

MAX_SHADOWS = 4

FILL_DTYPE = np.dtype(
    [
        ("kind", np.uint8),
        ("axis", np.uint8),
        ("midpos", np.uint8),
        ("_pad", np.uint8),
        ("c0", np.uint8, 4),  # solid color / gradient start
        ("c1", np.uint8, 4),  # gradient mid (linear3) / stop (linear2)
        ("c2", np.uint8, 4),  # gradient stop (linear3)
    ]
)

SHADOW_DTYPE = np.dtype(
    [
        ("style", np.uint8),
        ("_pad", np.uint8, 3),
        ("blur", np.float32),
        ("spread", np.float32),
        ("x", np.float32),
        ("y", np.float32),
        ("fill", FILL_DTYPE),
    ]
)

FIG_DTYPE = np.dtype(
    [
        ("kind", np.uint8),
        ("zlevel", np.int8),
        ("flags", np.uint16),
        ("parent", np.int16),
        ("child_count", np.int16),
        ("box", np.float32, 4),
        ("rotation", np.float32),
        ("fill", FILL_DTYPE),
        ("corners", np.uint16, 4),
        ("corners_y", np.uint16, 4),
        ("stroke_weight", np.float32),
        ("stroke_fill", FILL_DTYPE),
        ("shadows", SHADOW_DTYPE, MAX_SHADOWS),
        ("blur", np.float32),
        ("tx", np.float32),
        ("ty", np.float32),
        ("use_matrix", np.uint8),
        ("_pad2", np.uint8, 3),
        ("matrix", np.float32, 6),
        # nkImage / nkMsdfImage / nkMtsdfImage payload
        ("image_id", np.int64),
        ("px_range", np.float32),
        ("sd_threshold", np.float32),
        ("msdf_stroke", np.float32),
        ("image_fill", FILL_DTYPE),
        # nkDrawable payload: ops live in the layer's side arrays
        ("ops_start", np.int32),
        ("ops_count", np.int32),
        ("draw_weight", np.float32),
        ("draw_cap", np.uint8),
        ("draw_join", np.uint8),
        ("draw_steps", np.uint16),
        ("draw_aa", np.float32),
        ("draw_stroke_fill", FILL_DTYPE),
        # nkText payload: glyphs + selection/decoration rects in side arrays
        ("glyphs_start", np.int32),
        ("glyphs_count", np.int32),
        ("trects_start", np.int32),
        ("trects_count", np.int32),
    ]
)

# nkText side-array rows: placed glyph (logical pen x/y from the arrangement,
# physical raster image offset, tint) and pre-computed selection/decoration
# rects (text/glyphs.py draw_text_layout emission order: selections,
# decorations, then glyphs). Coordinates stay f64 so the C++ walk reproduces
# the Python walk bit-for-bit.
GLYPH_DTYPE = np.dtype(
    [
        ("font_id", np.int64),
        ("glyph_id", np.int32),
        ("fill", FILL_DTYPE),
        ("x", np.float64),
        ("y", np.float64),
        ("img_ox", np.float64),
        ("img_oy", np.float64),
    ]
)

TRECT_DTYPE = np.dtype(
    [
        ("x", np.float64),
        ("y", np.float64),
        ("w", np.float64),
        ("h", np.float64),
        ("fill", FILL_DTYPE),
    ]
)

# DrawableOp side-array row: kind + fixed payload; bezier control points live
# in the points buffer referenced by (p_start, p_count).
OP_DTYPE = np.dtype(
    [
        ("kind", np.uint8),
        ("_pad", np.uint8, 3),
        ("p_start", np.int32),
        ("p_count", np.int32),
        ("steps", np.uint16),
        ("_pad2", np.uint16),
        ("data", np.float32, 8),  # line: ax ay bx by | circle: cx cy r |
        # rect: x y w h + corners packed in data[4..7] | arc: cx cy r a0 sweep
        # | ellipse: cx cy rx ry
    ]
)

# node kinds the native flattener handles; others force the Python walk
NATIVE_KINDS = frozenset(
    {
        int(FigKind.nkFrame),
        int(FigKind.nkRectangle),
        int(FigKind.nkBackdropBlur),
        int(FigKind.nkTransform),
        int(FigKind.nkScrollBar),
        int(FigKind.nkImage),
        int(FigKind.nkMsdfImage),
        int(FigKind.nkMtsdfImage),
        int(FigKind.nkDrawable),
        int(FigKind.nkText),
    }
)

# uint8-indexed membership LUT for the per-frame all_native_kinds check
_NATIVE_KIND_LUT = np.zeros(256, bool)
_NATIVE_KIND_LUT[list(NATIVE_KINDS)] = True


def pack_fill(out, f: Fill) -> None:
    if f.kind == FillKind.flColor:
        out["kind"] = 0
        out["c0"] = f.color.as_tuple()
    elif f.kind == FillKind.flLinear2:
        out["kind"] = 1
        out["axis"] = int(f.lin2.axis)
        out["c0"] = f.lin2.start.as_tuple()
        out["c1"] = f.lin2.stop.as_tuple()
    else:
        out["kind"] = 2
        out["axis"] = int(f.lin3.axis)
        out["midpos"] = f.lin3.mid_pos
        out["c0"] = f.lin3.start.as_tuple()
        out["c1"] = f.lin3.mid.as_tuple()
        out["c2"] = f.lin3.stop.as_tuple()


def pack_ops(row, node: Fig, ops_rows: list, points_rows: list) -> None:
    """Encode a drawable node's op list into the layer side arrays."""
    from .nodes import DrawableKind

    row["ops_start"] = len(ops_rows)
    row["ops_count"] = len(node.draw_ops)
    row["draw_weight"] = node.draw_stroke.weight
    row["draw_cap"] = int(node.draw_stroke.cap)
    row["draw_join"] = int(node.draw_stroke.join)
    row["draw_steps"] = node.draw_steps
    row["draw_aa"] = node.draw_aa
    pack_fill(row["draw_stroke_fill"], node.draw_stroke.fill)
    for op in node.draw_ops:
        r = np.zeros((), dtype=OP_DTYPE)
        r["kind"] = int(op.kind)
        if op.kind == DrawableKind.dkLine:
            r["data"][0:4] = (op.a.x, op.a.y, op.b.x, op.b.y)
        elif op.kind == DrawableKind.dkCircle:
            r["data"][0:3] = (op.center.x, op.center.y, op.radius)
        elif op.kind == DrawableKind.dkRectangle:
            r["data"][0:4] = (op.box.x, op.box.y, op.box.w, op.box.h)
            r["data"][4:8] = [float(c) for c in op.corners]
        elif op.kind == DrawableKind.dkBezier:
            r["p_start"] = len(points_rows)
            r["p_count"] = len(op.controls)
            r["steps"] = op.steps
            points_rows.extend((p.x, p.y) for p in op.controls)
        elif op.kind == DrawableKind.dkArc:
            r["data"][0:5] = (
                op.arc_center.x, op.arc_center.y, op.arc_radius,
                op.start_angle, op.sweep_angle,
            )
            r["steps"] = op.arc_steps
        elif op.kind == DrawableKind.dkEllipse:
            r["data"][0:4] = (
                op.ellipse_center.x, op.ellipse_center.y,
                op.ellipse_radii.x, op.ellipse_radii.y,
            )
        ops_rows.append(r)


def _row_total(blocks: list) -> int:
    return sum(b.shape[0] if b.ndim else 1 for b in blocks)


def _merge_structured(rows: list, dtype) -> np.ndarray:
    """Merge a list of same-dtype structured blocks/rows into one array by
    RAW BYTE copy. np.concatenate/np.stack on structured dtypes run field
    promotion per block (~0.9 ms for a 36-block text frame, 13x the
    memcpy) — and the views rebuild per frame on rebuilt scenes."""
    if not rows:
        return np.zeros(0, dtype=dtype)
    blocks = [np.atleast_1d(b) for b in rows]
    total = sum(b.shape[0] for b in blocks)
    out = np.empty(total, dtype=dtype)
    out_b = out.view(np.uint8)
    isz = dtype.itemsize
    off = 0
    for b in blocks:
        nb = b.shape[0] * isz
        out_b[off : off + nb] = np.ascontiguousarray(b).view(np.uint8)
        off += nb
    return out


def pack_text(row, node: Fig, glyph_rows: list, trect_rows: list,
              glyph_total: int = -1) -> int:
    """Pre-compute the text node's draw list (text/glyphs.py draw_text_layout):
    selection bands + underline/strikethrough rects into trects, placed
    glyphs into glyph rows. Logical (pre-ui-scale) coordinates; the flattener
    applies scaling, invertY and subpixel policy.

    glyph_total: running row count of glyph_rows (pass -1 to recount);
    returns the updated total so callers with many text nodes stay O(1) per
    node instead of re-summing every block."""
    from .fill import fill_alpha_max
    from .geometry import rect as _rect

    layout = node.text_layout
    # NOTE: the decoration loop below binds its own `start, stop` span range;
    # the running total must live under a distinct name
    g_start = _row_total(glyph_rows) if glyph_total < 0 else glyph_total
    row["glyphs_start"] = g_start
    row["trects_start"] = len(trect_rows)
    if layout is None:
        return g_start

    sel_a, sel_b = node.selection_range
    if (
        FigFlags.NfSelectText in node.flags
        and fill_alpha_max(node.fill) > 0
        and sel_a <= sel_b
    ):
        for selection in layout.selection_rects_for((sel_a, sel_b)):
            if selection.h > 0:
                r = np.zeros((), dtype=TRECT_DTYPE)
                r["x"], r["y"] = selection.x, selection.y
                r["w"], r["h"] = max(selection.w, 1.0), selection.h
                pack_fill(r["fill"], node.fill)
                trect_rows.append(r)

    # decorations + glyph block depend only on the (immutable) arrangement —
    # cache them on it so retained layouts pack as an append, not a walk
    cached = getattr(layout, "_fig_pack_cache", None)
    if cached is not None:
        deco_rows, glyph_block = cached
        trect_rows.extend(deco_rows)
        added = 0
        if glyph_block is not None:
            glyph_rows.append(glyph_block)
            added = int(glyph_block.shape[0])
        row["glyphs_count"] = added
        row["trects_count"] = len(trect_rows) - int(row["trects_start"])
        return g_start + added

    deco_rows = []
    # decorations (figrender.nim:370-415 band math, done here once)
    for span_index, (ss, se) in enumerate(layout.spans):
        if span_index >= len(layout.fonts):
            break
        gf = layout.fonts[span_index]
        if not (gf.underline or gf.strikethrough):
            continue
        color = (
            layout.span_colors[span_index]
            if span_index < len(layout.span_colors)
            else None
        )
        if color is None:
            continue
        thickness = max(round(gf.size / 16.0), 1.0)
        for line_s, line_e in layout.lines:
            start, stop = max(ss, line_s), min(se, line_e)
            if start > stop:
                continue
            min_x = min_y = float("inf")
            max_x = max_y = float("-inf")
            for gi in range(start, stop + 1):
                gr = layout.glyph_rect(gi)
                min_x, max_x = min(min_x, gr.x), max(max_x, gr.x + gr.w)
                min_y, max_y = min(min_y, gr.y), max(max_y, gr.y + gr.h)
            if not (min_x < max_x and min_y < max_y):
                continue
            bands = []
            if gf.underline:
                bands.append(_rect(min_x, max_y - thickness * 1.5,
                                   max_x - min_x, thickness))
            if gf.strikethrough:
                bands.append(_rect(
                    min_x, min_y + (max_y - min_y) * 0.5 - thickness * 0.5,
                    max_x - min_x, thickness,
                ))
            for band in bands:
                if band.w <= 0 or band.h <= 0:
                    continue
                r = np.zeros((), dtype=TRECT_DTYPE)
                r["x"], r["y"], r["w"], r["h"] = band.x, band.y, band.w, band.h
                pack_fill(r["fill"], color)
                deco_rows.append(r)
    trect_rows.extend(deco_rows)

    drawn = [g for g in layout.arranged_glyphs if not g.is_whitespace]
    if drawn:
        block = np.zeros(len(drawn), dtype=GLYPH_DTYPE)
        block["font_id"] = [g.font_id for g in drawn]
        block["glyph_id"] = [g.glyph_id for g in drawn]
        # pack the span FILL itself (solid or gradient) — glyph quads take
        # gradientColors vertex mapping like every other quad
        # (figrender.nim:494: drawImage(..., glyph.fill.gradientColors()))
        packed_fills = {}
        black = np.zeros((), dtype=FILL_DTYPE)
        black["c0"] = (0, 0, 0, 255)
        for i, g in enumerate(drawn):
            f = g.fill
            if f is None:
                block["fill"][i] = black
                continue
            key = id(f)
            p = packed_fills.get(key)
            if p is None:
                p = np.zeros((), dtype=FILL_DTYPE)
                pack_fill(p, f)
                packed_fills[key] = p
            block["fill"][i] = p
        block["x"] = [g.pos.x + g.offset.x for g in drawn]
        block["y"] = [g.pos.y + g.offset.y for g in drawn]
        block["img_ox"] = [g.image_offset.x for g in drawn]
        block["img_oy"] = [g.image_offset.y for g in drawn]
        glyph_rows.append(block)
    layout._fig_pack_cache = (deco_rows, block if drawn else None)

    added = len(drawn)
    row["glyphs_count"] = added
    row["trects_count"] = len(trect_rows) - int(row["trects_start"])
    return g_start + added


def pack_fig(row, node: Fig, ops_rows: list = None, points_rows: list = None) -> None:
    row["kind"] = int(node.kind)
    row["zlevel"] = node.zlevel
    row["flags"] = int(node.flags)
    row["parent"] = node.parent
    row["child_count"] = node.child_count
    row["box"] = (node.screen_box.x, node.screen_box.y, node.screen_box.w, node.screen_box.h)
    row["rotation"] = node.rotation
    pack_fill(row["fill"], node.fill)
    row["corners"] = node.corners
    row["corners_y"] = node.corner_radii_y
    row["stroke_weight"] = node.stroke.weight
    pack_fill(row["stroke_fill"], node.stroke.fill)
    for i, sh in enumerate(node.shadows[:MAX_SHADOWS]):
        srow = row["shadows"][i]
        srow["style"] = int(sh.style)
        srow["blur"] = sh.blur
        srow["spread"] = sh.spread
        srow["x"] = sh.x
        srow["y"] = sh.y
        pack_fill(srow["fill"], sh.fill)
    row["blur"] = node.backdrop_blur.blur
    row["tx"] = node.transform.translation.x
    row["ty"] = node.transform.translation.y
    if node.transform.use_matrix:
        m = node.transform.matrix
        row["use_matrix"] = 1
        row["matrix"] = (m.a, m.b, m.tx, m.c, m.d, m.ty)
    if node.kind == FigKind.nkImage:
        row["image_id"] = node.image.id
        pack_fill(row["image_fill"], node.image.fill)
    elif node.kind in (FigKind.nkMsdfImage, FigKind.nkMtsdfImage):
        style = (
            node.msdf_image if node.kind == FigKind.nkMsdfImage else node.mtsdf_image
        )
        row["image_id"] = style.id
        row["px_range"] = style.px_range
        row["sd_threshold"] = style.sd_threshold
        row["msdf_stroke"] = style.stroke_weight
        pack_fill(row["image_fill"], style.fill)
    elif node.kind == FigKind.nkDrawable and ops_rows is not None:
        pack_ops(row, node, ops_rows, points_rows)


class RenderListArray:
    """Numpy-backed RenderList with the O(1) mutation subset."""

    def __init__(self, capacity: int = 64):
        self.nodes = np.zeros(capacity, dtype=FIG_DTYPE)
        self.count = 0
        self.root_ids: list[int] = []
        self.ops_rows: list = []
        self.points_rows: list = []
        self.glyph_rows: list = []
        self.trect_rows: list = []
        self.text_objects: dict = {}  # row idx → (layout, selection_range)
        self.glyph_total = 0  # running _row_total(glyph_rows)
        self._ops_cache = None
        self._text_cache = None

    def ops_view(self):
        """(ops array, points array) for the native walk."""
        if self._ops_cache is None or self._ops_cache[0] != len(self.ops_rows):
            ops = _merge_structured(self.ops_rows, OP_DTYPE)
            pts = (
                np.asarray(self.points_rows, dtype=np.float32).reshape(-1, 2)
                if self.points_rows
                else np.zeros((0, 2), dtype=np.float32)
            )
            self._ops_cache = (len(self.ops_rows), ops, pts)
        return self._ops_cache[1], self._ops_cache[2]

    def text_view(self):
        """(glyphs array, trects array) for the native walk. glyph_rows holds
        one block array per text node; trect_rows holds 0-d rows.

        The glyph blocks merge as RAW BYTES into one preallocated array:
        np.concatenate on structured dtypes runs field promotion per block
        (~0.9 ms for a 36-label frame — measured 13x slower than the
        memcpy), and this runs per frame on rebuilt scenes."""
        if self._text_cache is None or self._text_cache[0] != len(self.glyph_rows):
            glyphs = _merge_structured(self.glyph_rows, GLYPH_DTYPE)
            trects = _merge_structured(self.trect_rows, TRECT_DTYPE)
            self._text_cache = (len(self.glyph_rows), glyphs, trects)
        return self._text_cache[1], self._text_cache[2]

    def _pack(self, i: int, node: Fig) -> None:
        pack_fig(self.nodes[i], node, self.ops_rows, self.points_rows)
        if node.kind == FigKind.nkText:
            self.glyph_total = pack_text(
                self.nodes[i], node, self.glyph_rows, self.trect_rows,
                glyph_total=self.glyph_total,
            )
            self.text_objects[i] = (node.text_layout, node.selection_range)

    def _grow(self) -> None:
        new = np.zeros(self.nodes.shape[0] * 2, dtype=FIG_DTYPE)
        new[: self.count] = self.nodes[: self.count]
        self.nodes = new

    def _alloc(self) -> int:
        if self.count == self.nodes.shape[0]:
            self._grow()
        i = self.count
        self.count += 1
        return i

    def add_root(self, node: Fig) -> int:
        i = self._alloc()
        self._pack(i, node)
        self.nodes[i]["parent"] = -1
        self.nodes[i]["child_count"] = 0
        self.root_ids.append(i)
        return i

    def add_child(self, parent_idx: int, node: Fig) -> int:
        i = self._alloc()
        self._pack(i, node)
        self.nodes[i]["parent"] = parent_idx
        self.nodes[i]["child_count"] = 0
        self.nodes[parent_idx]["child_count"] += 1
        return i

    def add_root_raw(self) -> int:
        """Allocate a zeroed root row for direct field writes."""
        i = self._alloc()
        self.nodes[i]["parent"] = -1
        self.root_ids.append(i)
        return i

    # --- retained-scene in-place edits --------------------------------------
    # These write FIG columns directly (no repack, no buffer churn) so the
    # native walk's cached arrays stay valid; pair with
    # renderer.update_scene(scene, renders, dirty=[(lvl, root_idx), ...]) to
    # patch only the edited roots' quad rows on device.

    def set_box(self, i: int, x: float, y: float, w: float, h: float) -> None:
        self.nodes[i]["box"] = (x, y, w, h)

    def set_rotation(self, i: int, degrees: float) -> None:
        self.nodes[i]["rotation"] = degrees

    def set_fill(self, i: int, f) -> None:
        pack_fill(self.nodes[i]["fill"], f)

    def set_stroke_fill(self, i: int, f) -> None:
        pack_fill(self.nodes[i]["stroke_fill"], f)

    def set_solid_color(self, i: int, color) -> None:
        """Recolor a solid fill without rebuilding the Fill object."""
        self.nodes[i]["fill"]["kind"] = 0
        self.nodes[i]["fill"]["c0"] = color.as_tuple()

    def set_corners(self, i: int, radii) -> None:
        self.nodes[i]["corners"] = radii

    def set_transform_offset(self, i: int, tx: float, ty: float) -> None:
        """Move an nkTransform node (offset mode)."""
        self.nodes[i]["tx"] = tx
        self.nodes[i]["ty"] = ty

    def set_node(self, i: int, node) -> None:
        """Repack a node wholesale (text content changes, fill-kind swaps —
        anything the column setters can't express), preserving its tree
        links. A text repack appends a fresh glyph block (the old one stays
        orphaned — bounded by how often labels change between snapshots);
        pair with renderer.snapshot_scene(reserve=...) so count-changing
        text still patches in place."""
        parent = int(self.nodes[i]["parent"])
        child_count = int(self.nodes[i]["child_count"])
        self._pack(i, node)
        self.nodes[i]["parent"] = parent
        self.nodes[i]["child_count"] = child_count

    def view(self) -> np.ndarray:
        return self.nodes[: self.count]

    def all_native_kinds(self) -> bool:
        kinds = self.view()["kind"]
        # LUT gather instead of np.isin (sort-based): this runs per frame on
        # the native fast path and was ~0.2 ms of a 1.4 ms headline frame
        return bool(_NATIVE_KIND_LUT[kinds].all())


def from_render_list(lst: RenderList) -> RenderListArray:
    arr = RenderListArray(capacity=max(len(lst.nodes), 1))
    arr.count = len(lst.nodes)
    for i, node in enumerate(lst.nodes):
        arr._pack(i, node)
    arr.root_ids = list(lst.root_ids)
    return arr


def unpack_fill(row) -> Fill:
    from .colors import ColorRGBA
    from .fill import FillGradientAxis, Linear2, Linear3

    kind = int(row["kind"])
    if kind == 0:
        return Fill(kind=FillKind.flColor, color=ColorRGBA(*(int(v) for v in row["c0"])))
    if kind == 1:
        return Fill(
            kind=FillKind.flLinear2,
            lin2=Linear2(
                axis=FillGradientAxis(int(row["axis"])),
                start=ColorRGBA(*(int(v) for v in row["c0"])),
                stop=ColorRGBA(*(int(v) for v in row["c1"])),
            ),
        )
    return Fill(
        kind=FillKind.flLinear3,
        lin3=Linear3(
            axis=FillGradientAxis(int(row["axis"])),
            start=ColorRGBA(*(int(v) for v in row["c0"])),
            mid=ColorRGBA(*(int(v) for v in row["c1"])),
            stop=ColorRGBA(*(int(v) for v in row["c2"])),
            mid_pos=int(row["midpos"]),
        ),
    )


def _unpack_ops(row, ops, points):
    from .geometry import Rect, Vec2
    from .nodes import DrawableKind, DrawableOp

    out = []
    start = int(row["ops_start"])
    for i in range(start, start + int(row["ops_count"])):
        r = ops[i]
        kind = DrawableKind(int(r["kind"]))
        d = r["data"]
        if kind == DrawableKind.dkLine:
            out.append(DrawableOp(kind=kind, a=Vec2(float(d[0]), float(d[1])),
                                  b=Vec2(float(d[2]), float(d[3]))))
        elif kind == DrawableKind.dkCircle:
            out.append(DrawableOp(kind=kind, center=Vec2(float(d[0]), float(d[1])),
                                  radius=float(d[2])))
        elif kind == DrawableKind.dkRectangle:
            out.append(DrawableOp(
                kind=kind, box=Rect(*(float(v) for v in d[0:4])),
                corners=tuple(int(v) for v in d[4:8])))
        elif kind == DrawableKind.dkBezier:
            ps = int(r["p_start"])
            ctrl = tuple(
                Vec2(float(points[j][0]), float(points[j][1]))
                for j in range(ps, ps + int(r["p_count"]))
            )
            out.append(DrawableOp(kind=kind, controls=ctrl, steps=int(r["steps"])))
        elif kind == DrawableKind.dkArc:
            out.append(DrawableOp(
                kind=kind, arc_center=Vec2(float(d[0]), float(d[1])),
                arc_radius=float(d[2]), start_angle=float(d[3]),
                sweep_angle=float(d[4]), arc_steps=int(r["steps"])))
        elif kind == DrawableKind.dkEllipse:
            out.append(DrawableOp(
                kind=kind, ellipse_center=Vec2(float(d[0]), float(d[1])),
                ellipse_radii=Vec2(float(d[2]), float(d[3]))))
    return tuple(out)


def unpack_fig(row, ops=None, points=None, text=None) -> Fig:
    from .basics import (
        BackdropBlurStyle,
        RenderShadow,
        RenderStroke,
        ShadowStyle,
        StrokeCap,
        StrokeJoin,
        TransformStyle,
    )
    from .geometry import Mat3, Rect, Vec2

    shadows = []
    for srow in row["shadows"]:
        if int(srow["style"]) == 0:
            continue
        shadows.append(
            RenderShadow(
                style=ShadowStyle(int(srow["style"])),
                blur=float(srow["blur"]),
                spread=float(srow["spread"]),
                x=float(srow["x"]),
                y=float(srow["y"]),
                fill=unpack_fill(srow["fill"]),
            )
        )
    matrix = None
    if int(row["use_matrix"]):
        m = row["matrix"]
        matrix = Mat3(*(float(v) for v in m))
    from .basics import ImageStyle, MsdfImageStyle

    kind = FigKind(int(row["kind"]))
    image = ImageStyle()
    msdf_image = MsdfImageStyle()
    mtsdf_image = MsdfImageStyle()
    if kind == FigKind.nkImage:
        image = ImageStyle(id=int(row["image_id"]), fill=unpack_fill(row["image_fill"]))
    elif kind in (FigKind.nkMsdfImage, FigKind.nkMtsdfImage):
        style = MsdfImageStyle(
            id=int(row["image_id"]),
            fill=unpack_fill(row["image_fill"]),
            px_range=float(row["px_range"]),
            sd_threshold=float(row["sd_threshold"]),
            stroke_weight=float(row["msdf_stroke"]),
        )
        if kind == FigKind.nkMsdfImage:
            msdf_image = style
        else:
            mtsdf_image = style
    return Fig(
        kind=FigKind(int(row["kind"])),
        zlevel=int(row["zlevel"]),
        flags=FigFlags(int(row["flags"])),
        parent=int(row["parent"]),
        child_count=int(row["child_count"]),
        screen_box=Rect(*(float(v) for v in row["box"])),
        rotation=float(row["rotation"]),
        fill=unpack_fill(row["fill"]),
        corners=tuple(int(v) for v in row["corners"]),
        corner_radii_y=tuple(int(v) for v in row["corners_y"]),
        stroke=RenderStroke(
            weight=float(row["stroke_weight"]), fill=unpack_fill(row["stroke_fill"])
        ),
        shadows=tuple(shadows),
        backdrop_blur=BackdropBlurStyle(blur=float(row["blur"])),
        transform=TransformStyle(
            translation=Vec2(float(row["tx"]), float(row["ty"])), matrix=matrix
        ),
        image=image,
        msdf_image=msdf_image,
        mtsdf_image=mtsdf_image,
        draw_ops=(
            _unpack_ops(row, ops, points)
            if kind == FigKind.nkDrawable and ops is not None
            else ()
        ),
        draw_stroke=(
            RenderStroke(
                weight=float(row["draw_weight"]),
                fill=unpack_fill(row["draw_stroke_fill"]),
                cap=StrokeCap(int(row["draw_cap"])),
                join=StrokeJoin(int(row["draw_join"])),
            )
            if kind == FigKind.nkDrawable
            else RenderStroke()
        ),
        draw_steps=int(row["draw_steps"]),
        draw_aa=float(row["draw_aa"]),
        text_layout=text[0] if text is not None else None,
        selection_range=text[1] if text is not None else (0, -1),
    )


class RendersArray:
    """ZLevel → RenderListArray layer table."""

    def __init__(self):
        self.layers: dict[int, RenderListArray] = {}

    def __getitem__(self, lvl: int) -> RenderListArray:
        if lvl not in self.layers:
            self.layers[lvl] = RenderListArray()
        return self.layers[lvl]

    def set_layer(self, lvl: int, lst: RenderListArray) -> None:
        self.layers[lvl] = lst

    def sorted_pairs(self):
        return sorted(self.layers.items(), key=lambda kv: kv[0])

    def all_native_kinds(self) -> bool:
        return all(lst.all_native_kinds() for lst in self.layers.values())


def from_renders(renders: Renders) -> RendersArray:
    out = RendersArray()
    for lvl, lst in renders.pairs():
        out.set_layer(lvl, from_render_list(lst))
    return out


def to_renders(arr: RendersArray) -> Renders:
    """Reconstruct the object form (Python-walk fallback; also quantizes
    coordinates through f32 exactly like the array storage)."""
    out = Renders()
    for lvl, lst in arr.sorted_pairs():
        ops, points = lst.ops_view()
        rl = RenderList()
        rl.nodes = [
            unpack_fig(lst.nodes[i], ops, points, lst.text_objects.get(i))
            for i in range(lst.count)
        ]
        rl.root_ids = list(lst.root_ids)
        out.set_layer(lvl, rl)
    return out
