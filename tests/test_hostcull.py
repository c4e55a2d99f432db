"""Host-side translucent-saturation compaction (native/flatten.cpp
fd_cull_saturated): dense tapes drop quads invisible under saturated
translucent stacks BEFORE export, so the per-frame upload shrinks (about
9 MB of tape per frame at the 40x demo scale).

The C++ decisions are pinned against a straight-line numpy reference that
mirrors the kernel-side tier in figdraw_tpu/ops/binning.py."""

import numpy as np
import pytest

from figdraw_tpu import Fig, FigKind, fill, new_renders, rect, rgba, vec2
from figdraw_tpu import native
from figdraw_tpu.nodes import RenderList
from figdraw_tpu.nodesarray import from_renders, to_renders
from figdraw_tpu.renderer import FigRenderer

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native flattener not built"
)

CELL_H, CELL_W = 32, 128
LOG2_EPS = -11.0
MIN_QUADS = 4096

# layout offsets (ops/layout.py)
BBOX, COLOR0, MID, STOP = 6, 16, 32, 36
PARAMS, RADII, AA, RECT = 40, 44, 50, 52
INV_B, INV_C = 1, 2


def numpy_cull(fields, modes, items, px_w, px_h):
    """Reference of fd_cull_saturated: returns (fields, modes, items) with
    saturated quads dropped. Mirrors the C++ float32 math and visit order."""
    count = fields.shape[0]
    if count < MIN_QUADS:
        return fields, modes, items
    cw = int((px_w + CELL_W - 1) // CELL_W)
    ch = int((px_h + CELL_H - 1) // CELL_H)
    drop = np.zeros(count, bool)
    f32 = np.float32
    for it in items:
        if not hasattr(it, "start") or getattr(it, "target", 0) != -1:
            continue
        trans = np.zeros((ch, cw), np.float32)
        for q in range(it.end - 1, it.start - 1, -1):
            f = fields[q]
            mo = modes[q]
            bx0, by0, bx1, by1 = f[BBOX : BBOX + 4]
            cx0 = max(0, int(np.floor(bx0 / CELL_W)))
            cx1 = min(cw - 1, int(np.ceil(bx1 / CELL_W)) - 1)
            cy0 = max(0, int(np.floor(by0 / CELL_H)))
            cy1 = min(ch - 1, int(np.ceil(by1 / CELL_H)) - 1)
            if cx0 <= cx1 and cy0 <= cy1:
                if (trans[cy0 : cy1 + 1, cx0 : cx1 + 1] < LOG2_EPS).all():
                    drop[q] = True
                    continue
            rest = mo[0] % 256
            fill_mode = mo[0] // 256
            if rest % 128 != 3 or mo[1] != 0:
                continue
            if f[INV_B] != 0.0 or f[INV_C] != 0.0:
                continue
            if f[RECT + 2] >= 0.0:
                continue
            ell = rest >= 128
            hx, hy = f[PARAMS + 2], f[PARAMS + 3]
            inset_x = inset_y = f32(0.0)
            ok = True
            for k in range(4):
                v = f[RADII + k]
                if ell:
                    if v < 0.0:
                        rx = ry = f32(-v - 1.0)
                    else:
                        pk = v if v >= 8388608.0 else f32(np.floor(v + f32(0.5)))
                        rx = f32(np.fmod(pk, f32(4096.0)) * hx / f32(4095.0))
                        ry = f32(np.floor(pk / f32(4096.0)) * hy / f32(4095.0))
                    if rx < 0.0 or ry < 0.0:
                        ok = False
                        break
                else:
                    if v < 0.0:
                        ok = False
                        break
                    rx = ry = v
                inset_x = max(inset_x, rx)
                inset_y = max(inset_y, ry)
            if not ok:
                continue
            margin = f32(f32(0.5) / max(f[AA], f32(1e-3)) + f32(0.01))
            ihx = f32(hx - inset_x - margin)
            ihy = f32(hy - inset_y - margin)
            if ihx <= 0.0 or ihy <= 0.0:
                continue
            amin = min(f[COLOR0 + 3], f[COLOR0 + 7], f[COLOR0 + 11],
                       f[COLOR0 + 15])
            if fill_mode != 0:
                amin = min(amin, f[MID + 3], f[STOP + 3])
            lt = f32(np.log2(max(f32(1.0 - amin), f32(2.0 ** -24))))
            ccx = f32((bx0 + bx1) * f32(0.5))
            ccy = f32((by0 + by1) * f32(0.5))
            for cy in range(cy0, cy1 + 1):
                t0y = f32(cy * CELL_H)
                if not (ccy - ihy <= t0y + 0.5 and
                        ccy + ihy >= t0y + CELL_H - 0.5):
                    continue
                for cx in range(cx0, cx1 + 1):
                    t0x = f32(cx * CELL_W)
                    if (ccx - ihx <= t0x + 0.5 and
                            ccx + ihx >= t0x + CELL_W - 0.5):
                        trans[cy, cx] += lt
    if not drop.any():
        return fields, modes, items
    pre = np.concatenate([[0], np.cumsum(drop.astype(np.int32))])
    keep = ~drop
    new_items = []
    for it in items:
        if hasattr(it, "start"):
            s = it.start - pre[it.start]
            e = it.end - pre[it.end]
            if e <= s:
                continue
            it = type(it)(target=it.target, start=int(s), end=int(e))
        new_items.append(it)
    return fields[keep], modes[keep], new_items


def _dense_stack_scene(n_boxes, w, h):
    lst = RenderList()
    for i in range(n_boxes):
        lst.add_root(Fig(kind=FigKind.nkRectangle,
                         screen_box=rect(-20.0 + (i % 7), -20.0 + (i % 11),
                                         w + 40.0, h + 40.0),
                         corners=(3,) * 4,
                         fill=fill(rgba((i * 37) % 255, (i * 91) % 255,
                                        (i * 53) % 255, 155))))
    r = new_renders()
    r.set_layer(0, lst)
    return r


def test_native_cull_matches_numpy_reference():
    """The C++ drop decisions + compaction equal the numpy reference applied
    to the (identical, uncompacted) Python-walk tape."""
    r = _dense_stack_scene(4200, 256, 128)
    arr = from_renders(r)

    ren = FigRenderer(atlas_size=64, use_pallas=False)
    culled = ren.flatten(arr, vec2(256, 128))

    ren2 = FigRenderer(atlas_size=64, use_pallas=False)
    py_tape = ren2.flatten(to_renders(arr), vec2(256, 128))
    assert py_tape.count >= MIN_QUADS > culled.count

    rf, rm, ritems = numpy_cull(
        np.asarray(py_tape.fields[: py_tape.count]),
        np.asarray(py_tape.modes[: py_tape.count]),
        py_tape.items, 256.0, 128.0,
    )
    assert culled.count == rf.shape[0]
    np.testing.assert_array_equal(
        np.asarray(culled.fields[: culled.count]), rf)
    np.testing.assert_array_equal(np.asarray(culled.modes[: culled.count]), rm)
    draws = [(it.target, it.start, it.end)
             for it in culled.items if hasattr(it, "start")]
    ref_draws = [(it.target, it.start, it.end)
                 for it in ritems if hasattr(it, "start")]
    assert draws == ref_draws


def test_cull_preserves_pixels_within_bound():
    """Culled vs FIGDRAW_HOST_CULL-disabled render of a deep translucent
    stack: differs by at most one display quantum (bound: 1/2048/channel)."""
    r = _dense_stack_scene(4200, 256, 128)
    arr = from_renders(r)
    size = vec2(256, 128)

    ren = FigRenderer(atlas_size=64, use_pallas=False)
    culled_frame = np.asarray(ren.render_frame(arr, size))

    old = native._HOST_CULL
    native._HOST_CULL = False
    try:
        ren2 = FigRenderer(atlas_size=64, use_pallas=False)
        full_frame = np.asarray(ren2.render_frame(arr, size))
    finally:
        native._HOST_CULL = old
    u8 = lambda x: (np.clip(x, 0, 1) * 255).round().astype(np.int32)
    assert np.abs(u8(culled_frame) - u8(full_frame)).max() <= 1


def test_small_scenes_untouched():
    """Below MIN_QUADS the cull must not change the tape at all (goldens and
    every parity test live here)."""
    r = _dense_stack_scene(200, 256, 128)
    arr = from_renders(r)
    ren = FigRenderer(atlas_size=64, use_pallas=False)
    t1 = ren.flatten(arr, vec2(256, 128))

    old = native._HOST_CULL
    native._HOST_CULL = False
    try:
        ren2 = FigRenderer(atlas_size=64, use_pallas=False)
        t0 = ren2.flatten(arr, vec2(256, 128))
    finally:
        native._HOST_CULL = old
    assert t0.count == t1.count
    np.testing.assert_array_equal(np.asarray(t0.fields[: t0.count]),
                                  np.asarray(t1.fields[: t1.count]))
