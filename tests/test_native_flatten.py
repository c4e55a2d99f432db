"""Native C++ flattener parity: bit-identical tape vs the Python walk."""

import numpy as np
import pytest

from figdraw_tpu import vec2
from figdraw_tpu.nodesarray import from_renders
from figdraw_tpu.renderer import FigRenderer
from figdraw_tpu.scenes import make_render_tree
from figdraw_tpu import native
from figdraw_tpu.tape import BlurItem, ClearMaskItem, DrawItem

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native flattener not built"
)


def flatten_both(renders, w, h):
    from figdraw_tpu.nodesarray import to_renders

    ren = FigRenderer(atlas_size=64, use_pallas=False)
    arr = from_renders(renders)
    # round-trip the python-walk scene through the array so both sides see
    # identical f32-quantized coordinates
    py_tape = ren.flatten(to_renders(arr), vec2(w, h))
    native_tape = ren.flatten(arr, vec2(w, h))
    return py_tape, native_tape


def assert_tapes_equal(a, b):
    assert a.count == b.count
    assert a.mask_count == b.mask_count
    fa = a.fields[: a.count]
    fb = b.fields[: b.count]
    if not np.array_equal(fa, fb):
        bad = np.argwhere(fa != fb)
        q, col = bad[0]
        raise AssertionError(
            f"field mismatch at quad {q} col {col}: {fa[q, col]} vs {fb[q, col]} "
            f"({len(bad)} total diffs)"
        )
    assert np.array_equal(a.modes[: a.count], b.modes[: b.count])
    assert len(a.items) == len(b.items)
    for ia, ib in zip(a.items, b.items):
        assert type(ia) is type(ib)
        if isinstance(ia, DrawItem):
            assert (ia.target, ia.start, ia.end) == (ib.target, ib.start, ib.end)
        elif isinstance(ia, BlurItem):
            assert abs(ia.radius - ib.radius) < 1e-6
        else:
            assert ia.index == ib.index


def test_native_matches_python_on_benchmark_scene():
    renders = make_render_tree(640.0, 480.0, frame=3, copies=8)
    py_tape, native_tape = flatten_both(renders, 640, 480)
    assert py_tape.count > 50
    assert_tapes_equal(py_tape, native_tape)


def test_native_matches_python_masks_and_transforms():
    from figdraw_tpu import (
        Fig,
        FigFlags,
        FigKind,
        RenderStroke,
        TransformStyle,
        fill,
        new_renders,
        rect,
        rgba,
    )
    from figdraw_tpu.geometry import Mat3

    renders = new_renders()
    clip = renders.add_root(0, Fig(
        kind=FigKind.nkRectangle, screen_box=rect(10, 10, 100, 80),
        corners=(9, 9, 9, 9), flags=FigFlags.NfClipContent,
        fill=fill(rgba(200, 200, 200, 255)),
    ))
    renders.add_child(0, clip, Fig(
        kind=FigKind.nkRectangle, screen_box=rect(0, 0, 300, 300),
        fill=fill(rgba(255, 0, 0, 128)),
    ))
    rm = renders.add_root(0, Fig(
        kind=FigKind.nkRectangle, screen_box=rect(40, 30, 90, 70),
        corners=(5, 5, 5, 5), flags=FigFlags.NfRectMaskContent,
        fill=fill(rgba(0, 0, 200, 200)),
    ))
    renders.add_child(0, rm, Fig(
        kind=FigKind.nkRectangle, screen_box=rect(0, 0, 300, 300),
        fill=fill(rgba(0, 255, 0, 100)),
        rotation=15.0,
    ))
    tr = renders.add_root(0, Fig(
        kind=FigKind.nkTransform,
        transform=TransformStyle(translation=vec2(7.0, -3.0), matrix=Mat3.scaling(1.5, 0.75)),
    ))
    renders.add_child(0, tr, Fig(
        kind=FigKind.nkRectangle, screen_box=rect(20, 20, 40, 40),
        stroke=RenderStroke(weight=3.0, fill=fill(rgba(0, 0, 0, 255))),
        fill=fill(rgba(255, 255, 0, 255)),
    ))
    py_tape, native_tape = flatten_both(renders, 200, 150)
    assert py_tape.mask_count >= 1
    assert_tapes_equal(py_tape, native_tape)


def test_native_ui_scale():
    from figdraw_tpu import set_fig_ui_scale, fig_ui_scale

    old = fig_ui_scale()
    set_fig_ui_scale(2.0)
    try:
        renders = make_render_tree(320.0, 240.0, frame=1, copies=3)
        py_tape, native_tape = flatten_both(renders, 320, 240)
        assert_tapes_equal(py_tape, native_tape)
    finally:
        set_fig_ui_scale(old)


def test_all_kinds_native_and_rejection_path():
    """Every FigKind flattens natively now; the gate still rejects rows with
    unknown kind values (forward compatibility)."""
    from figdraw_tpu import Fig, FigKind, new_renders, rect
    from figdraw_tpu.nodesarray import NATIVE_KINDS

    assert {int(k) for k in FigKind} <= NATIVE_KINDS
    renders = new_renders()
    renders.add_root(0, Fig(kind=FigKind.nkRectangle, screen_box=rect(0, 0, 4, 4)))
    arr = from_renders(renders)
    arr.layers[0].nodes[0]["kind"] = 99  # not a FigKind
    assert not arr.all_native_kinds()


def _drawable_fig(ops, weight=3.0, cap=None, join=None, stroke_rgba=(20, 40, 200, 255),
                  box=None, **kw):
    from figdraw_tpu import Fig, FigKind, RenderStroke, fill, rect, rgba
    from figdraw_tpu.basics import StrokeCap, StrokeJoin

    stroke = RenderStroke(
        weight=weight,
        fill=fill(rgba(*stroke_rgba)),
        cap=cap if cap is not None else StrokeCap.scAuto,
        join=join if join is not None else StrokeJoin.sjAuto,
    )
    return Fig(
        kind=FigKind.nkDrawable,
        screen_box=box if box is not None else rect(10, 10, 200, 150),
        draw_ops=tuple(ops),
        draw_stroke=stroke,
        **kw,
    )


def test_native_drawable_lines_and_shapes_parity():
    """Lines (all caps), circle, rect, ellipse through the native walk."""
    from figdraw_tpu import fill, new_renders, rect, rgba
    from figdraw_tpu.basics import StrokeCap
    from figdraw_tpu.nodes import (
        drawable_circle, drawable_ellipse, drawable_line, drawable_rect,
    )

    renders = new_renders()
    for i, cap in enumerate(
        [StrokeCap.scAuto, StrokeCap.scRound, StrokeCap.scButt, StrokeCap.scSquare]
    ):
        renders.add_root(0, _drawable_fig(
            [drawable_line(vec2(5 + i * 3, 7), vec2(90, 60 + i * 9))], cap=cap,
        ))
    shapes = _drawable_fig(
        [
            drawable_circle(vec2(40, 40), 17.25),
            drawable_rect(rect(70, 20, 50, 34), corners=(4, 4, 4, 4)),
            drawable_ellipse(vec2(60, 100), vec2(30, 18)),
        ],
        weight=2.0,
    )
    shapes.fill = fill(rgba(230, 120, 40, 180))
    renders.add_root(0, shapes)
    # rotated drawable exercises the transform stack around line quads
    rot = _drawable_fig([drawable_line(vec2(0, 0), vec2(80, 20))])
    rot.rotation = 30.0
    renders.add_root(0, rot)
    py_tape, native_tape = flatten_both(renders, 320, 240)
    assert py_tape.count >= 10
    assert_tapes_equal(py_tape, native_tape)


def test_native_drawable_bezier_arc_parity():
    """Adaptive + fixed bezier spans, joins (bevel/miter filled quads), arcs."""
    from figdraw_tpu import fill, rgba, new_renders
    from figdraw_tpu.basics import StrokeCap, StrokeJoin
    from figdraw_tpu.fill import FillGradientAxis, linear
    from figdraw_tpu.nodes import drawable_arc, drawable_bezier

    renders = new_renders()
    quad = [vec2(5, 120), vec2(70, -40), vec2(150, 110)]
    cubic = [vec2(0, 0), vec2(40, 130), vec2(110, -60), vec2(160, 70)]
    # 3-point quadratic SDF path (adaptive), auto caps
    renders.add_root(0, _drawable_fig([drawable_bezier(quad)]))
    # cubic adaptive with bevel and miter joins → filled white-uv quads
    renders.add_root(0, _drawable_fig(
        [drawable_bezier(cubic)], cap=StrokeCap.scButt, join=StrokeJoin.sjBevel,
    ))
    renders.add_root(0, _drawable_fig(
        [drawable_bezier(cubic)], cap=StrokeCap.scSquare, join=StrokeJoin.sjMiter,
    ))
    # fixed span count via op steps and via node draw_steps
    renders.add_root(0, _drawable_fig([drawable_bezier(cubic, steps=5)]))
    renders.add_root(0, _drawable_fig([drawable_bezier(cubic)], draw_steps=3))
    # 2-control-point bezier → polyline segment path
    renders.add_root(0, _drawable_fig(
        [drawable_bezier([vec2(4, 4), vec2(120, 90)])], join=StrokeJoin.sjMiter,
    ))
    # flat quadratic degenerates to a line
    renders.add_root(0, _drawable_fig(
        [drawable_bezier([vec2(0, 0), vec2(50, 25), vec2(100, 50)])],
    ))
    # arcs: adaptive and fixed, round + non-round joins
    renders.add_root(0, _drawable_fig(
        [drawable_arc(vec2(80, 80), 45.0, 0.4, 4.0)],
    ))
    renders.add_root(0, _drawable_fig(
        [drawable_arc(vec2(80, 80), 45.0, -0.3, -2.5, steps=4)],
        cap=StrokeCap.scButt, join=StrokeJoin.sjBevel,
    ))
    # gradient strokes on the bezier SDF path: 2-stop and 3-stop (mid/stop)
    from figdraw_tpu import RenderStroke

    g2 = _drawable_fig([drawable_bezier(quad)])
    g2.draw_stroke = RenderStroke(weight=3.0, fill=linear(
        rgba(255, 0, 0, 255), rgba(0, 0, 255, 255), axis=FillGradientAxis.fgaY,
    ))
    renders.add_root(0, g2)
    g3 = _drawable_fig([drawable_bezier(quad)])
    g3.draw_stroke = RenderStroke(weight=3.0, fill=linear(
        rgba(255, 0, 0, 255), rgba(0, 255, 0, 255), rgba(0, 0, 255, 255),
        mid_pos=80,
    ))
    renders.add_root(0, g3)
    # per-node AA override
    renders.add_root(0, _drawable_fig([drawable_bezier(quad)], draw_aa=2.0))
    py_tape, native_tape = flatten_both(renders, 320, 240)
    assert py_tape.count >= 40
    assert_tapes_equal(py_tape, native_tape)


def test_native_image_and_msdf_parity():
    """Image + MSDF nodes through the native walk == Python walk."""
    import numpy as np

    from figdraw_tpu import (
        Fig, FigFlags, FigKind, MsdfImageStyle, fill, image_style, new_renders,
        rect, rgba,
    )
    from figdraw_tpu.nodesarray import to_renders
    from figdraw_tpu.resources import ImageMessageBus, put_image

    bus = ImageMessageBus()
    ren = FigRenderer(atlas_size=128, use_pallas=False)
    ren.ensure_image_message_subscription(bus)
    img = np.zeros((16, 16, 4), np.uint8)
    img[:8] = (255, 0, 0, 255)
    img[8:] = (0, 0, 255, 255)
    put_image(321, img, bus=bus, mipmapped=True)
    sdf = (np.ones((16, 16, 4)) * 0.6).astype(np.float32)
    put_image(654, sdf, bus=bus)
    ren.process_image_messages()

    renders = new_renders()
    lst = renders[0]
    lst.add_root(Fig(kind=FigKind.nkRectangle, screen_box=rect(0, 0, 120, 90),
                     fill=fill(rgba(255, 255, 255, 255))))
    lst.add_root(Fig(kind=FigKind.nkImage, screen_box=rect(8, 8, 32, 32),
                     image=image_style(321)))
    lst.add_root(Fig(kind=FigKind.nkImage, screen_box=rect(48, 8, 32, 32),
                     flags=FigFlags.NfInvertY, image=image_style(321)))
    # minified draw hits the mip-select path (exact pow-2: single quad)
    lst.add_root(Fig(kind=FigKind.nkImage, screen_box=rect(88, 8, 4, 4),
                     image=image_style(321)))
    # fractional minification hits the TRILINEAR blend pass (scale 1.6:
    # a second level-1 quad with u8-quantized fractional alpha)
    lst.add_root(Fig(kind=FigKind.nkImage, screen_box=rect(96, 8, 10, 10),
                     image=image_style(321)))
    lst.add_root(Fig(kind=FigKind.nkMsdfImage, screen_box=rect(8, 48, 32, 32),
                     msdf_image=MsdfImageStyle(id=654, fill=fill(rgba(0, 0, 0, 255)),
                                               px_range=4.0)))
    lst.add_root(Fig(kind=FigKind.nkMtsdfImage, screen_box=rect(48, 48, 32, 32),
                     mtsdf_image=MsdfImageStyle(id=654, fill=fill(rgba(0, 0, 0, 255)),
                                                px_range=4.0, stroke_weight=2.0)))

    arr = from_renders(renders)
    assert arr.all_native_kinds()
    py_tape = ren.flatten(to_renders(arr), vec2(120, 90))
    native_tape = ren.flatten(arr, vec2(120, 90))
    assert_tapes_equal(py_tape, native_tape)


def test_native_text_parity():
    """nkText through the C++ walk == Python walk bit-for-bit: glyph quads,
    underline decoration, selection bands, invertY, RTL layouts."""
    from figdraw_tpu import FigFlags, fill, rgba
    from figdraw_tpu.nodesarray import to_renders
    from figdraw_tpu.text.layout import typeset
    from figdraw_tpu.text.typefaces import FigFont, load_typeface

    tid = load_typeface("/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf")
    ink = fill(rgba(20, 20, 30, 255))

    from figdraw_tpu import Fig, FigKind, new_renders, rect

    renders = new_renders()
    renders.add_root(0, Fig(kind=FigKind.nkRectangle, screen_box=rect(0, 0, 300, 120),
                            fill=fill(rgba(250, 250, 250, 255))))
    f = FigFont(typeface_id=tid, size=18.0, underline=True)
    arr1 = typeset(vec2(280, 24), [(f, ink, "Efficient AV text")])
    renders.add_root(0, Fig(kind=FigKind.nkText, screen_box=rect(10, 8, 280, 24),
                            text_layout=arr1))
    f2 = FigFont(typeface_id=tid, size=18.0)
    arr2 = typeset(vec2(280, 24), [(f2, fill(rgba(180, 30, 30, 255)), "sel שלום")])
    renders.add_root(0, Fig(kind=FigKind.nkText, screen_box=rect(10, 40, 280, 24),
                            text_layout=arr2, flags=FigFlags.NfSelectText,
                            selection_range=(1, 5),
                            fill=fill(rgba(90, 150, 255, 120))))
    arr3 = typeset(vec2(280, 24), [(f2, ink, "inverted")])
    renders.add_root(0, Fig(kind=FigKind.nkText, screen_box=rect(10, 72, 280, 24),
                            text_layout=arr3, flags=FigFlags.NfInvertY))

    ren = FigRenderer(atlas_size=512, use_pallas=False)
    arr = from_renders(renders)
    # python walk first warms the glyph atlas; native pre-pass covers the rest
    py_tape = ren.flatten(to_renders(arr), vec2(300, 120))
    native_tape = ren.flatten(arr, vec2(300, 120))
    assert py_tape.count > 20
    assert_tapes_equal(py_tape, native_tape)


def test_native_text_cold_start():
    """The glyph pre-pass rasterizes everything the packed rows reference, so
    a fresh renderer renders text natively with no Python-walk warmup."""
    from figdraw_tpu import Fig, FigKind, fill, new_renders, rect, rgba
    from figdraw_tpu.nodesarray import to_renders
    from figdraw_tpu.text.layout import typeset
    from figdraw_tpu.text.typefaces import FigFont, load_typeface

    tid = load_typeface("/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf")
    f = FigFont(typeface_id=tid, size=20.0)
    renders = new_renders()
    arr_l = typeset(vec2(200, 28), [(f, fill(rgba(0, 0, 0, 255)), "Cold start!")])
    renders.add_root(0, Fig(kind=FigKind.nkText, screen_box=rect(4, 4, 200, 28),
                            text_layout=arr_l))
    arr = from_renders(renders)

    ren_native = FigRenderer(atlas_size=512, use_pallas=False)
    ren_native.render_frame(arr, vec2(220, 40))
    native_png = ren_native.take_screenshot()
    ren_py = FigRenderer(atlas_size=512, use_pallas=False)
    ren_py.render_frame(to_renders(arr), vec2(220, 40))
    py_png = ren_py.take_screenshot()
    assert np.array_equal(native_png, py_png)
    assert (native_png[..., :3] < 100).any()  # glyphs actually drawn


def test_native_structure_cache_matches_tape_structure():
    """The pass structure the C++ export derives from its item flag bits
    (tape.structure_cache) must equal what executor.tape_structure computes
    from the mode lanes — renderer.execute trusts the cache without
    rescanning (native.py item_kind_word bits 8/9)."""
    from figdraw_tpu import executor as ex
    from figdraw_tpu.scenes import make_render_tree

    ren = FigRenderer(atlas_size=64, use_pallas=False)
    arr = from_renders(make_render_tree(640.0, 480.0, frame=3, copies=8))
    tape = ren.flatten(arr, vec2(640, 480))
    assert tape.structure_cache is not None
    structure, bounds, radii, any_atlas, any_backdrop = tape.structure_cache
    s2, b2, r2, is_atlas, is_bd = ex.tape_structure(tape, tape.modes_lanes())
    assert structure == s2
    assert [tuple(b) for b in bounds] == [tuple(b) for b in b2]
    assert radii == r2
    assert any_atlas == bool(is_atlas[: tape.count].any())
    assert any_backdrop == bool(is_bd[: tape.count].any())


def test_native_structure_cache_atlas_and_masks():
    """Flag-bit coverage for the cases the 300-box scene misses: atlas
    (text) draw items and clear-mask/blur ordering."""
    from figdraw_tpu import (
        Fig, FigFlags, FigKind, executor as ex, fill, new_renders, rect, rgba,
    )
    from figdraw_tpu.text.layout import typeset
    from figdraw_tpu.text.typefaces import FigFont, load_typeface

    tid = load_typeface("/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf")
    f = FigFont(typeface_id=tid, size=16.0)
    renders = new_renders()
    ci = renders.add_root(0, Fig(kind=FigKind.nkRectangle,
                                 screen_box=rect(4, 4, 120, 60),
                                 fill=fill(rgba(240, 240, 240, 255)),
                                 corners=(6,) * 4,
                                 flags=FigFlags.NfClipContent))
    arr_l = typeset(vec2(110, 24), [(f, fill(rgba(0, 0, 0, 255)), "atlas")])
    renders.add_child(0, ci, Fig(kind=FigKind.nkText,
                                 screen_box=rect(8, 8, 110, 24),
                                 text_layout=arr_l))
    arr = from_renders(renders)
    ren = FigRenderer(atlas_size=512, use_pallas=False)
    tape = ren.flatten(arr, vec2(140, 80))
    assert tape.structure_cache is not None
    structure, bounds, radii, any_atlas, any_backdrop = tape.structure_cache
    s2, b2, r2, is_atlas, is_bd = ex.tape_structure(tape, tape.modes_lanes())
    assert structure == s2
    assert [tuple(b) for b in bounds] == [tuple(b) for b in b2]
    assert any_atlas and any_atlas == bool(is_atlas[: tape.count].any())
    assert any_backdrop == bool(is_bd[: tape.count].any())
    # the clip produced mask items; at least one draw item samples the atlas
    kinds = [s[0] for s in structure]
    assert "clear_mask" in kinds
    assert any(s[0] == "draw" and s[2] for s in structure)


