"""Rasterizer correctness: analytic checks + pallas-vs-reference parity.

The XLA reference rasterizer is validated analytically against the GL
semantics (blend math, SDF coverage, gradients, shadows), then the Pallas
tile kernel must match the reference bit-for-bit-ish (same math, different
tiling) on the same tapes.
"""

import numpy as np
import pytest

from figdraw_tpu import (
    Fig,
    FigFlags,
    FigKind,
    FigRenderer,
    RenderStroke,
    RenderShadow,
    ShadowStyle,
    fill,
    linear,
    fgaX,
    new_renders,
    rect,
    rgba,
    vec2,
)
from figdraw_tpu.nodes import RenderList, drawable_bezier, drawable_circle, drawable_line
from figdraw_tpu.nodesarray import from_renders


def render_scene(lst, w=96, h=64, use_pallas=False):
    r = new_renders()
    r.set_layer(0, lst)
    ren = FigRenderer(atlas_size=64, use_pallas=use_pallas)
    ren.render_frame(r, vec2(w, h))
    return ren.take_screenshot().astype(np.float32)


def simple_scene():
    lst = RenderList()
    lst.add_root(
        Fig(kind=FigKind.nkRectangle, screen_box=rect(8, 8, 50, 30),
            fill=fill(rgba(255, 0, 0, 255)), corners=(6, 6, 6, 6),
            stroke=RenderStroke(weight=3.0, fill=fill(rgba(0, 0, 0, 255)))))
    lst.add_root(
        Fig(kind=FigKind.nkRectangle, screen_box=rect(30, 16, 50, 30),
            fill=linear(rgba(0, 255, 0, 155), rgba(0, 0, 255, 155), axis=fgaX)))
    lst.add_root(
        Fig(kind=FigKind.nkRectangle, screen_box=rect(20, 30, 40, 24),
            corners=(10, 10, 10, 10), corner_radii_y=(5, 5, 5, 5),
            flags=FigFlags.NfEllipticalCorners,
            fill=fill(rgba(255, 180, 20, 200))))
    return lst


def shadow_scene():
    lst = RenderList()
    lst.add_root(
        Fig(kind=FigKind.nkRectangle, screen_box=rect(20, 14, 40, 26),
            corners=(8, 8, 8, 8), fill=fill(rgba(40, 180, 90, 255)),
            shadows=(RenderShadow(style=ShadowStyle.DropShadow, blur=8.0,
                                  spread=4.0, x=5.0, y=5.0,
                                  fill=fill(rgba(0, 0, 0, 155))),)))
    lst.add_root(
        Fig(kind=FigKind.nkRectangle, screen_box=rect(45, 28, 40, 26),
            fill=fill(rgba(60, 90, 220, 255)),
            shadows=(RenderShadow(style=ShadowStyle.InnerShadow, blur=6.0,
                                  spread=3.0, x=3.0, y=3.0,
                                  fill=fill(rgba(0, 0, 0, 200))),)))
    return lst


def drawable_scene():
    lst = RenderList()
    lst.add_root(
        Fig(kind=FigKind.nkDrawable, screen_box=rect(0, 0, 96, 64),
            fill=fill(rgba(255, 0, 0, 255)),
            draw_stroke=RenderStroke(weight=4.0, fill=fill(rgba(0, 0, 200, 255))),
            draw_ops=(
                drawable_line(vec2(10, 10), vec2(80, 20)),
                drawable_circle(vec2(30, 40), 12.0),
                drawable_bezier([vec2(10, 55), vec2(48, 25), vec2(88, 55)]),
            )))
    return lst


def test_background_clear():
    img = render_scene(RenderList())
    assert np.all(img == 255)


def test_solid_rect_coverage_and_blend():
    img = render_scene(simple_scene())
    # deep inside red rect, left of gradient: pure red
    assert np.array_equal(img[20, 15], [255, 0, 0, 255])
    # gradient over white at right side: alpha 155/255 blue-ish mix
    px = img[20, 75]
    assert px[2] > px[1] > px[0]  # blue dominant


def test_gradient_midpoint_math():
    img = render_scene(simple_scene())
    # gradient rect spans x 30..80; at pixel center x+0.5, u=(x+0.5-30)/50
    # x=65, y=20 lies over plain white background (red rect ends at x=58)
    x = 65
    u = (x + 0.5 - 30) / 50.0
    a = 155 / 255.0
    g = round(255 * (1 - u))
    b = round(255 * u)
    src = np.array([0, g * 1.0, b * 1.0, 155.0])
    dst = np.array([255.0, 255, 255, 255])
    exp_rgb = src[:3] * a + dst[:3] * (1 - a)
    exp_a = 155 + 255 * (1 - a)
    got = img[20, x]
    assert np.allclose(got[:3], np.round(exp_rgb), atol=1.5)
    assert abs(got[3] - round(exp_a)) <= 1


def test_rounded_corner_cut():
    img = render_scene(simple_scene())
    # the red rect corner at (8,8) with radius 6: pixel (9,9) is outside the arc
    assert img[9, 9, 0] > 200  # mostly white/blend, not stroke black
    # dead corner (8.5, 8.5): dist to center (14,14) ≈ 7.78 > 6 → background
    assert np.all(img[8, 8] >= 250)


def test_drop_and_inner_shadow_profiles():
    img = render_scene(shadow_scene())
    # shadow darkens area right+below of the green rect, beyond its edge
    shadow_px = img[44, 66]  # below-right of rect (20..60 x, 14..40 y)
    assert shadow_px[0] < 255  # darkened
    # inner shadow darkens the blue rect's top-left interior edge more than center
    inner_edge = img[30, 47]
    center = img[40, 65]
    assert inner_edge[2] < center[2] or inner_edge[0] < center[0]


def test_zlevel_order():
    r = new_renders()
    a = RenderList()
    a.add_root(Fig(kind=FigKind.nkRectangle, screen_box=rect(10, 10, 40, 40),
                   fill=fill(rgba(255, 0, 0, 255))))
    b = RenderList()
    b.add_root(Fig(kind=FigKind.nkRectangle, screen_box=rect(20, 20, 40, 40),
                   fill=fill(rgba(0, 0, 255, 255))))
    # insert higher zlevel first — draw order must still be ascending zlevel
    r.set_layer(1, b)
    r.set_layer(0, a)
    ren = FigRenderer(atlas_size=64, use_pallas=False)
    ren.render_frame(r, vec2(80, 80))
    img = ren.take_screenshot()
    assert np.array_equal(img[40, 40], [0, 0, 255, 255])  # blue on top
    assert np.array_equal(img[15, 15], [255, 0, 0, 255])


@pytest.mark.parametrize("scene_fn", [simple_scene, shadow_scene, drawable_scene])
def test_pallas_matches_reference(scene_fn):
    ref = render_scene(scene_fn(), use_pallas=False)
    pal = render_scene(scene_fn(), use_pallas=True)
    diff = np.abs(ref - pal)
    assert diff.max() <= 1.0, f"max diff {diff.max()} at {np.unravel_index(diff.argmax(), diff.shape)}"


def test_clip_mask():
    lst = RenderList()
    parent = lst.add_root(
        Fig(kind=FigKind.nkRectangle, screen_box=rect(10, 10, 40, 30),
            corners=(12, 12, 12, 12), flags=FigFlags.NfClipContent,
            fill=fill(rgba(200, 200, 200, 255))))
    lst.add_child(parent, Fig(kind=FigKind.nkRectangle,
                              screen_box=rect(0, 0, 96, 64),
                              fill=fill(rgba(255, 0, 0, 255))))
    img = render_scene(lst)
    # child red fills only inside the clip shape
    assert np.array_equal(img[25, 30], [255, 0, 0, 255])
    assert np.all(img[5, 5] == 255)  # outside clip: background
    # rounded clip corner: (11, 11) outside the radius-12 arc
    assert img[11, 11, 1] > 100  # not pure red


def test_rect_mask_fast_path():
    lst = RenderList()
    parent = lst.add_root(
        Fig(kind=FigKind.nkRectangle, screen_box=rect(10, 10, 40, 30),
            corners=(8, 8, 8, 8), flags=FigFlags.NfRectMaskContent,
            fill=fill(rgba(200, 200, 200, 255))))
    lst.add_child(parent, Fig(kind=FigKind.nkRectangle,
                              screen_box=rect(0, 0, 96, 64),
                              fill=fill(rgba(255, 0, 0, 255))))
    img = render_scene(lst)
    assert np.array_equal(img[25, 30], [255, 0, 0, 255])
    assert np.all(img[5, 70] == 255)


def test_backdrop_blur_smoothing():
    lst = RenderList()
    # hard edge: black rect on white
    lst.add_root(Fig(kind=FigKind.nkRectangle, screen_box=rect(0, 0, 48, 64),
                     fill=fill(rgba(0, 0, 0, 255))))
    from figdraw_tpu.basics import BackdropBlurStyle
    lst.add_root(Fig(kind=FigKind.nkBackdropBlur, screen_box=rect(24, 8, 48, 48),
                     fill=fill(rgba(0, 0, 0, 0)),
                     backdrop_blur=BackdropBlurStyle(blur=10.0)))
    img = render_scene(lst)
    # inside the blur panel, across the black/white edge at x=48: smooth ramp
    row = img[32, 40:60, 0]
    assert row.min() < 60 and row.max() > 200
    grad = np.abs(np.diff(row.astype(int)))
    assert grad.max() < 90  # no hard jump under the blur panel
    # outside the panel the edge is hard
    row2 = img[4, 40:60, 0]
    assert np.abs(np.diff(row2.astype(int))).max() > 150


def test_fully_round_elliptical_pill():
    """Regression: rx == half-width AND ry == half-height packs to 2^24-1,
    whose floor(v+0.5) decode ties to 2^24 in f32 and wrapped the corner to
    square (found visually on the demo pill)."""
    lst = RenderList()
    lst.add_root(Fig(kind=FigKind.nkRectangle, screen_box=rect(10, 10, 72, 40),
                     corners=(36, 36, 36, 36), corner_radii_y=(20, 20, 20, 20),
                     flags=FigFlags.NfEllipticalCorners,
                     fill=fill(rgba(250, 140, 30, 255))))
    img = render_scene(lst)
    # corner region outside the ellipse must be background
    assert np.all(img[12, 12] == 255), img[12, 12]
    assert np.all(img[45, 12] == 255) or img[45, 12, 0] == 255
    # center filled orange
    assert img[30, 46, 0] > 200 and img[30, 46, 2] < 100
    # ellipse edge midpoints filled
    assert img[30, 12, 0] > 200  # left edge center
    assert img[12, 46, 0] > 200  # top edge center


def test_remaining_sdf_modes_direct():
    """Direct eval coverage for modes the walk never emits but the contract
    defines (8 DropShadowAA, 11 Annular non-AA) — atlas.frag:337-363."""
    import jax.numpy as jnp

    from figdraw_tpu.ops.layout import (
        QF_AA, QF_COLOR0, QF_FACTORS, QF_INV_A, QF_INV_D, QF_ORG_X,
        QF_PARAMS, QF_RECT_PARAMS, QF_WIDTH,
    )
    from figdraw_tpu.ops.quad_eval import eval_quad
    from figdraw_tpu.ops.raster_ref import pixel_centers

    def quad_record(mode, factor, spread=0.0, shape_half=20.0):
        f = np.zeros(QF_WIDTH, np.float32)
        # 80x80 quad at origin, identity uv mapping
        f[QF_INV_A] = 1 / 80.0
        f[QF_INV_D] = 1 / 80.0
        f[QF_ORG_X] = 0.0
        f[QF_ORG_X + 1] = 0.0
        f[QF_PARAMS + 0] = 40.0
        f[QF_PARAMS + 1] = 40.0
        f[QF_PARAMS + 2] = shape_half
        f[QF_PARAMS + 3] = shape_half
        f[QF_COLOR0:QF_COLOR0 + 16] = np.tile([0, 0, 0, 1], 4)
        f[QF_FACTORS] = factor
        f[QF_FACTORS + 1] = spread
        f[QF_AA] = 1.2
        f[QF_RECT_PARAMS + 2] = -1.0
        f[QF_RECT_PARAMS + 3] = -1.0
        return jnp.asarray(f)

    px, py = pixel_centers(80, 80)

    # mode 11 Annular (no AA): hard 1/0 ring of width 6
    _rgb, a11 = eval_quad(quad_record(11, 6.0), jnp.int32(11), px, py)
    a11 = np.asarray(a11)
    assert abs(a11[40, 21] - 1.0) < 1e-5  # inside the ring band (edge at x=20)
    assert a11[40, 40] == 0.0  # center: outside band
    # binary coverage (modulo f32 bilinear-color epsilon)
    assert np.all((a11 < 1e-5) | (np.abs(a11 - 1.0) < 1e-5))

    # mode 8 DropShadowAA: inside → AA fill alpha, outside → gaussian
    _rgb, a8 = eval_quad(quad_record(8, 8.0, 2.0), jnp.int32(8), px, py)
    a8 = np.asarray(a8)
    assert abs(a8[40, 40] - 1.0) < 1e-5  # deep inside
    edge_out = a8[40, 64]  # past shape+spread: gaussian falloff
    further = a8[40, 72]
    assert 0.0 < further < edge_out < 1.0


def test_opaque_occlusion_culls_and_stays_correct():
    """A full-tile opaque rounded rect truncates each covered tile's binned
    list (bin_quads modes= path) — occluded translucent quads drop out of the
    per-tile walk with no pixel change (SURVEY.md §7 hard-part 7)."""
    import jax.numpy as jnp

    from figdraw_tpu.ops.binning import bin_quads
    from figdraw_tpu.ops.layout import QF_WIDTH, QI_WIDTH
    from figdraw_tpu.renderer import _bucket

    lst = RenderList()
    # 60 translucent boxes underneath
    for i in range(60):
        lst.add_root(Fig(kind=FigKind.nkRectangle,
                         screen_box=rect(5 + (i % 10) * 12, 5 + (i // 10) * 18,
                                         30, 24),
                         corners=(4,) * 4,
                         fill=fill(rgba(50 + i * 3, 90, 200 - i * 2, 155))))
    # opaque rounded cover whose interior contains the whole 128px tile
    lst.add_root(Fig(kind=FigKind.nkRectangle,
                     screen_box=rect(-16, -16, 160, 160),
                     corners=(10,) * 4, fill=fill(rgba(240, 240, 250, 255))))
    # something translucent on top so order still matters
    lst.add_root(Fig(kind=FigKind.nkRectangle, screen_box=rect(30, 30, 60, 60),
                     fill=fill(rgba(200, 40, 40, 120))))
    r = new_renders()
    r.set_layer(0, lst)

    ref = render_scene(lst, w=128, h=128, use_pallas=False)
    pal = render_scene(lst, w=128, h=128, use_pallas=True)
    assert np.abs(ref.astype(int) - pal.astype(int)).max() <= 1

    # the binning itself must cull: flatten and compare per-tile counts
    ren = FigRenderer(atlas_size=64, use_pallas=False)
    tape = ren.flatten(r, vec2(128, 128))
    n = _bucket(tape.count)
    fields = np.zeros((n, QF_WIDTH), np.float32)
    modes = np.zeros((n, QI_WIDTH), np.int32)
    fields[: tape.count] = tape.fields[: tape.count]
    modes[: tape.count] = tape.modes[: tape.count]
    f = jnp.asarray(fields)
    m = jnp.asarray(modes)
    _, plain = bin_quads(f, jnp.int32(0), jnp.int32(tape.count), 1, 1, 128, 128)
    _, culled = bin_quads(f, jnp.int32(0), jnp.int32(tape.count), 1, 1, 128, 128,
                          modes=m)
    # the inner 128x128 tile center sits inside the opaque cover: everything
    # before it is culled (cover + top quad remain; clear handled separately)
    assert int(culled[0]) < int(plain[0])
    assert int(culled[0]) <= 3


def test_opaque_gradient_cover_culls():
    """A full-tile cover with an all-opaque GRADIENT fill culls exactly like
    a solid opaque cover — the cover test bounds fill alpha by the min over
    vertex + mid/stop alphas, so fill_mode need not be solid."""
    import jax.numpy as jnp

    from figdraw_tpu.fill import FillGradientAxis, linear
    from figdraw_tpu.ops.binning import bin_quads
    from figdraw_tpu.ops.layout import QF_WIDTH, QI_WIDTH
    from figdraw_tpu.renderer import _bucket

    lst = RenderList()
    for i in range(40):
        lst.add_root(Fig(kind=FigKind.nkRectangle,
                         screen_box=rect(4 + (i % 8) * 14, 6 + (i // 8) * 20,
                                         36, 28),
                         fill=fill(rgba(60 + i * 4, 120, 180, 155))))
    lst.add_root(Fig(kind=FigKind.nkRectangle,
                     screen_box=rect(-16, -16, 160, 160), corners=(6,) * 4,
                     fill=linear(rgba(30, 120, 70, 255), rgba(80, 200, 120, 255),
                                 rgba(140, 240, 190, 255),
                                 axis=FillGradientAxis.fgaX)))
    r = new_renders()
    r.set_layer(0, lst)

    ref = render_scene(lst, w=128, h=128, use_pallas=False)
    pal = render_scene(lst, w=128, h=128, use_pallas=True)
    assert np.abs(ref.astype(int) - pal.astype(int)).max() <= 1

    ren = FigRenderer(atlas_size=64, use_pallas=False)
    tape = ren.flatten(r, vec2(128, 128))
    n = _bucket(tape.count)
    fields = np.zeros((n, QF_WIDTH), np.float32)
    modes = np.zeros((n, QI_WIDTH), np.int32)
    fields[: tape.count] = tape.fields[: tape.count]
    modes[: tape.count] = tape.modes[: tape.count]
    f = jnp.asarray(fields)
    m = jnp.asarray(modes)
    _, plain = bin_quads(f, jnp.int32(0), jnp.int32(tape.count), 1, 1, 128, 128)
    _, culled = bin_quads(f, jnp.int32(0), jnp.int32(tape.count), 1, 1, 128, 128,
                          modes=m)
    assert int(culled[0]) < int(plain[0])
    assert int(culled[0]) <= 2  # the gradient cover (+ anything above it)


def _saturation_tape(n_stack, w=128, h=128, top_alpha=155):
    """A tape of n_stack full-tile alpha-155 covers (plus the clear), padded
    to its bucket — dense enough to cross SAT_MIN_QUADS when n_stack is."""
    lst = RenderList()
    for i in range(n_stack):
        lst.add_root(Fig(kind=FigKind.nkRectangle,
                         screen_box=rect(-16.0 - (i % 3), -16.0 - (i % 5),
                                         float(w) + 32 + (i % 3) * 2,
                                         float(h) + 32 + (i % 5) * 2),
                         corners=(4,) * 4,
                         fill=fill(rgba(40 + (i * 7) % 180, (i * 13) % 255,
                                        200 - (i * 3) % 160, top_alpha))))
    r = new_renders()
    r.set_layer(0, lst)
    return lst, r


def test_translucent_saturation_culls_dense_tapes():
    """Dense tapes (>= SAT_MIN_QUADS padded rows): a deep stack of constant-
    alpha full-tile covers saturates — only the top few quads survive the
    binning, and the rendered frame is unchanged to within a display quantum
    (the cull bound is 1/2048/channel)."""
    import jax.numpy as jnp

    from figdraw_tpu.ops.binning import SAT_MIN_QUADS, bin_quads
    from figdraw_tpu.ops.layout import QF_WIDTH, QI_WIDTH
    from figdraw_tpu.renderer import _bucket

    n_stack = 4200  # pads past SAT_MIN_QUADS (4096)
    lst, r = _saturation_tape(n_stack)
    ren = FigRenderer(atlas_size=64, use_pallas=False)
    tape = ren.flatten(r, vec2(128, 128))
    n = _bucket(tape.count)
    assert n >= SAT_MIN_QUADS
    fields = np.zeros((n, QF_WIDTH), np.float32)
    modes = np.zeros((n, QI_WIDTH), np.int32)
    fields[: tape.count] = tape.fields[: tape.count]
    modes[: tape.count] = tape.modes[: tape.count]
    f = jnp.asarray(fields)
    m = jnp.asarray(modes)
    _, plain = bin_quads(f, jnp.int32(0), jnp.int32(tape.count), 1, 1, 128, 128)
    _, culled = bin_quads(f, jnp.int32(0), jnp.int32(tape.count), 1, 1, 128, 128,
                          modes=m)
    assert int(plain[0]) >= n_stack
    # alpha 155 => transmittance 0.392/layer; 2^-11 saturates within 8 layers
    assert int(culled[0]) <= 10

    # pixels: culled pallas vs the unbinned XLA reference stays within 1/255
    ref = render_scene(lst, w=128, h=128, use_pallas=False)
    pal = render_scene(lst, w=128, h=128, use_pallas=True)
    assert np.abs(ref.astype(int) - pal.astype(int)).max() <= 1


def test_translucent_saturation_is_run_scoped():
    """Saturation in a later run must not starve an earlier run whose pixels
    a mid-frame backdrop blur still reads: with run_bounds, each run's
    above-stack restarts at its own end."""
    import jax.numpy as jnp

    from figdraw_tpu.ops.binning import SAT_MIN_QUADS, bin_quads
    from figdraw_tpu.ops.layout import QF_WIDTH, QI_WIDTH
    from figdraw_tpu.renderer import _bucket

    n_stack = 4200
    lst, r = _saturation_tape(n_stack)
    ren = FigRenderer(atlas_size=64, use_pallas=False)
    tape = ren.flatten(r, vec2(128, 128))
    n = _bucket(tape.count)
    assert n >= SAT_MIN_QUADS
    fields = np.zeros((n, QF_WIDTH), np.float32)
    modes = np.zeros((n, QI_WIDTH), np.int32)
    fields[: tape.count] = tape.fields[: tape.count]
    modes[: tape.count] = tape.modes[: tape.count]
    f = jnp.asarray(fields)
    m = jnp.asarray(modes)
    # first 8 quads form their own run (e.g. before a backdrop blur): the
    # deep saturating stack lives entirely in run 2
    runs = jnp.asarray([[0, 8], [8, tape.count]], jnp.int32)
    _, counts = bin_quads(f, jnp.int32(0), jnp.int32(tape.count), 1, 1,
                          128, 128, modes=m, run_bounds=runs, n_runs=2)
    # run 1 survives whole (8 quads) + top of run 2 (<= 10)
    assert 8 <= int(counts[0]) <= 18
    # sanity: global culling without run bounds keeps fewer
    _, global_counts = bin_quads(f, jnp.int32(0), jnp.int32(tape.count), 1, 1,
                                 128, 128, modes=m)
    assert int(global_counts[0]) < int(counts[0])


def test_run_scoped_occlusion_keeps_earlier_runs():
    """bin_quads run_bounds: when ONE binning serves a multi-run frame, a
    cover in a later run must truncate only its OWN run — quads of an
    earlier run (whose pixels a mid-frame backdrop blur may read) survive;
    global culling without run_bounds would drop them."""
    import jax.numpy as jnp

    from figdraw_tpu.ops.binning import bin_quads
    from figdraw_tpu.ops.layout import QF_WIDTH, QI_WIDTH
    from figdraw_tpu.renderer import _bucket

    lst = RenderList()
    for i in range(8):  # run 1: translucent boxes
        lst.add_root(Fig(kind=FigKind.nkRectangle,
                         screen_box=rect(6 + i * 13, 8 + i * 11, 34, 26),
                         fill=fill(rgba(40 + i * 9, 80, 180, 155))))
    # run 2 (after a pass break in the real frame): an opaque full-tile cover
    lst.add_root(Fig(kind=FigKind.nkRectangle,
                     screen_box=rect(-16, -16, 160, 160),
                     fill=fill(rgba(245, 245, 245, 255))))
    r = new_renders()
    r.set_layer(0, lst)

    ren = FigRenderer(atlas_size=64, use_pallas=False)
    tape = ren.flatten(r, vec2(128, 128))
    n = _bucket(tape.count)
    fields = np.zeros((n, QF_WIDTH), np.float32)
    modes = np.zeros((n, QI_WIDTH), np.int32)
    fields[: tape.count] = tape.fields[: tape.count]
    modes[: tape.count] = tape.modes[: tape.count]
    f = jnp.asarray(fields)
    m = jnp.asarray(modes)
    split = tape.count - 1  # cover alone forms the "second run"
    runs = jnp.asarray([[0, split], [split, tape.count]], jnp.int32)

    _, counts = bin_quads(f, jnp.int32(0), jnp.int32(tape.count), 1, 1,
                          128, 128, modes=m, run_bounds=runs, n_runs=2)
    # every run-1 quad survives (the cover is not in their run)...
    assert int(counts[0]) == tape.count
    # ...while treating the whole tape as one run culls them
    _, global_counts = bin_quads(f, jnp.int32(0), jnp.int32(tape.count), 1, 1,
                                 128, 128, modes=m)
    assert int(global_counts[0]) < tape.count


def test_rotated_edge_tie_pixels_match_xla():
    """Snapped integer geometry puts rotated quad edges EXACTLY through
    pixel centers (the inverse-affine u/v lands on 0.0 to the last bit);
    XLA and the Pallas kernels order the multiply-add differently, so without the
    epsilon guard in quad_eval(.planar)'s `inside` test a ±1ulp tie flips
    whole AA edge pixels between the paths (observed: 52/255 on a 3°
    box). Pins pallas == XLA exactly on the tie-heavy angles."""
    for rot in (3.0, 45.0):
        renders = new_renders()
        renders.add_root(0, Fig(kind=FigKind.nkRectangle,
                                screen_box=rect(0, 0, 320, 200),
                                fill=fill(rgba(20, 20, 30, 255))))
        renders.add_root(0, Fig(kind=FigKind.nkRectangle,
                                screen_box=rect(36, 8, 26, 38),
                                corners=(5,) * 4, rotation=rot,
                                fill=fill(rgba(37, 90, 200, 155))))
        arr = from_renders(renders)
        a = FigRenderer(atlas_size=64, use_pallas=False)
        b = FigRenderer(atlas_size=64, use_pallas=True)
        fa = np.asarray(a.render_frame(arr, vec2(320, 200)))
        fb = np.asarray(b.render_frame(arr, vec2(320, 200)))
        assert b.use_pallas, "pallas fell back"
        qa = np.round(np.clip(fa, 0, 1) * 255)
        qb = np.round(np.clip(fb, 0, 1) * 255)
        assert np.abs(qa - qb).max() <= 1, (rot, np.abs(qa - qb).max())
