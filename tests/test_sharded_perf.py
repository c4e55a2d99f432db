"""Multi-chip performance path: the sharded fused executor must drive the
SAME Pallas/megakernel stack as the single-chip renderer and match it within
1/255 on the 8-device CPU mesh.

Round-1 verdict item 2: the sharded path previously bypassed the whole
performance stack (per-item XLA dispatch). These tests pin the replacement:
one packed tape upload, the full pass chain in one jitted shard_map, Pallas
band rasterization with global-row offsets, halo-exchange blur, windowed
atlas draws. Reference frame-command analog: the one-command-stream frame of
glcontext.nim:643-714, now over N chips.
"""

import numpy as np
import pytest

import jax

from figdraw_tpu import (
    BackdropBlurStyle, Fig, FigFlags, FigKind, fill, new_renders, rect, rgba,
    vec2,
)
from figdraw_tpu.renderer import FigRenderer

# heavyweight end-to-end frame-loop suite: excluded by `./ci.sh fast`
pytestmark = [
    pytest.mark.slow,
    pytest.mark.skipif(
        len(jax.devices()) < 2, reason="needs multi-device mesh"
    ),
]

DEJAVU = "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf"


def _screenshot(frame):
    return (np.clip(np.asarray(frame), 0, 1) * 255).round().astype(np.uint8)


def _max_diff(a, b):
    return int(np.abs(a.astype(int) - b.astype(int)).max())


def test_sharded_pallas_300box_scene():
    """Pallas band rasterization + halo blur == single chip on the benchmark
    scene (make_render_tree: shadows, gradients, pill, backdrop blur)."""
    from figdraw_tpu.parallel.sharding import ShardedFigRenderer
    from figdraw_tpu.scenes import make_render_tree

    w, h = 256, 192
    scene = make_render_tree(float(w), float(h), frame=4, copies=3)

    single = FigRenderer(atlas_size=64, use_pallas=False)
    single.render_frame(scene, vec2(w, h))
    ref = single.take_screenshot()

    sharded = ShardedFigRenderer(atlas_size=64, use_pallas=True)
    got = _screenshot(sharded.render_frame(scene, vec2(w, h)))
    assert sharded.use_pallas, "sharded pallas executor fell back to XLA"
    assert _max_diff(got, ref) <= 1


def test_sharded_pallas_masks_blur_text():
    """Clip masks + backdrop blur + atlas glyphs (windowed draws with a
    global row offset; glyph runs straddle band boundaries) through the
    sharded executor."""
    from figdraw_tpu.parallel.sharding import ShardedFigRenderer
    from figdraw_tpu.text.layout import typeset
    from figdraw_tpu.text.typefaces import FigFont, load_typeface

    tid = load_typeface(DEJAVU)
    renders = new_renders()
    renders.add_root(0, Fig(kind=FigKind.nkRectangle,
                            screen_box=rect(0, 0, 256, 160),
                            fill=fill(rgba(250, 250, 250, 255))))
    clip = renders.add_root(0, Fig(
        kind=FigKind.nkRectangle, screen_box=rect(10, 10, 90, 120),
        corners=(12,) * 4, flags=FigFlags.NfClipContent,
        fill=fill(rgba(220, 220, 240, 255))))
    renders.add_child(0, clip, Fig(
        kind=FigKind.nkRectangle, screen_box=rect(0, 0, 300, 300),
        fill=fill(rgba(200, 40, 40, 160)), rotation=20.0))
    f = FigFont(typeface_id=tid, size=18.0)
    arr = typeset(vec2(140, 120),
                  [(f, fill(rgba(0, 0, 0, 255)), "band AV spanning glyphs")])
    renders.add_root(0, Fig(kind=FigKind.nkText,
                            screen_box=rect(110, 14, 140, 120),
                            text_layout=arr))
    renders.add_root(1, Fig(kind=FigKind.nkBackdropBlur,
                            screen_box=rect(30, 60, 180, 60),
                            backdrop_blur=BackdropBlurStyle(blur=9.0),
                            fill=fill(rgba(255, 255, 255, 60))))

    single = FigRenderer(atlas_size=256, use_pallas=False)
    single.render_frame(renders, vec2(256, 160))
    ref = single.take_screenshot()

    sharded = ShardedFigRenderer(atlas_size=256, use_pallas=True)
    got = _screenshot(sharded.render_frame(renders, vec2(256, 160)))
    assert sharded.use_pallas, "sharded pallas executor fell back to XLA"
    assert _max_diff(got, ref) <= 1


def test_sharded_megakernel_clip_table():
    """Mask-heavy pure-SDF scene routes through the sharded MEGAKERNEL (one
    Pallas tile walk per band, targets baked in the mode lane) and matches
    the single-chip renderer (windy_clip_mask_benchmark.nim's sub-clip
    case)."""
    from figdraw_tpu.nodes import RenderList, Renders
    from figdraw_tpu.parallel.sharding import ShardedFigRenderer

    def rect_fig(box, color, flags=0, corners=0):
        return Fig(kind=FigKind.nkRectangle, screen_box=box, fill=fill(color),
                   corners=(corners,) * 4, flags=flags)

    w, h = 320, 240
    lst = RenderList()
    lst.add_root(rect_fig(rect(0, 0, w, h), rgba(248, 249, 251, 255)))
    vp = lst.add_root(rect_fig(rect(20, 20, w - 40, h - 40),
                               rgba(232, 235, 240, 255),
                               flags=FigFlags.NfClipContent, corners=10))
    for row in range(10):
        for col in range(4):
            cell = rect(24 + col * 70, 8 + row * 24, 64, 20)
            ci = lst.add_child(vp, rect_fig(
                cell, rgba(255, 255, 255, 255),
                flags=FigFlags.NfClipContent, corners=4))
            lst.add_child(ci, rect_fig(
                rect(cell.x - 6, cell.y + 4, cell.w + 12, 14),
                rgba(90, 120, 200, 220)))
    scene = Renders()
    scene.set_layer(0, lst)

    single = FigRenderer(atlas_size=64, use_pallas=False)
    single.render_frame(scene, vec2(w, h))
    ref = single.take_screenshot()

    sharded = ShardedFigRenderer(atlas_size=64, use_pallas=True)
    got = _screenshot(sharded.render_frame(scene, vec2(w, h)))
    assert sharded.use_pallas, "sharded megakernel fell back"
    assert _max_diff(got, ref) <= 1


def test_sharded_executor_one_upload():
    """The fused executor ships the frame as ONE packed combo array — the
    tape fields/modes/bounds/radii/clear all ride executor.pack_tape_upload
    (one host-to-device transfer per frame, SURVEY.md §5.8)."""
    from figdraw_tpu import executor as ex
    from figdraw_tpu.parallel.sharding import ShardedFigRenderer
    from figdraw_tpu.scenes import make_render_tree

    calls = []
    orig = ex.pack_tape_upload

    def counting_pack(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    ex.pack_tape_upload = counting_pack
    try:
        sharded = ShardedFigRenderer(atlas_size=64, use_pallas=True)
        scene = make_render_tree(128.0, 96.0, frame=1, copies=2)
        sharded.render_frame(scene, vec2(128, 96))
    finally:
        ex.pack_tape_upload = orig
    assert len(calls) == 1


# --- device-resident camera on the mesh --------------------------------------


def _cam_scene(d=(0, 0), z=1, n=24):
    """Integer axis-aligned boxes under an nkTransform camera root — the
    sharded twin of tests/test_camera.py's boxes_scene_view."""
    from figdraw_tpu.basics import TransformStyle
    from figdraw_tpu.geometry import Mat3
    from figdraw_tpu.nodesarray import from_renders

    renders = new_renders()
    tr = renders.add_root(0, Fig(
        kind=FigKind.nkTransform,
        transform=TransformStyle(translation=vec2(float(d[0]), float(d[1])),
                                 matrix=Mat3.scaling(float(z), float(z))),
    ))
    for i in range(n):
        renders.add_child(0, tr, Fig(
            kind=FigKind.nkRectangle,
            screen_box=rect(6 + (i % 6) * 22, 8 + (i // 6) * 26, 30, 22),
            corners=(5,) * 4,
            fill=fill(rgba(50 + i * 8, (i * 37) % 255, 190, 150))))
    return from_renders(renders)


def _clip_cam_scene(d=(0, 0), z=1, rows=3, cols=3):
    """Axis-aligned clip cells (mask planes → the sharded megakernel) under
    a camera root."""
    from figdraw_tpu.basics import TransformStyle
    from figdraw_tpu.geometry import Mat3
    from figdraw_tpu.nodesarray import from_renders

    renders = new_renders()
    tr = renders.add_root(0, Fig(
        kind=FigKind.nkTransform,
        transform=TransformStyle(translation=vec2(float(d[0]), float(d[1])),
                                 matrix=Mat3.scaling(float(z), float(z))),
    ))
    for r in range(rows):
        for c in range(cols):
            ci = renders.add_child(0, tr, Fig(
                kind=FigKind.nkRectangle,
                screen_box=rect(10 + c * 56, 8 + r * 40, 44, 30),
                corners=(6, 6, 6, 6), flags=FigFlags.NfClipContent,
                fill=fill(rgba(210 - r * 12, 70 + c * 25, 130, 255)),
            ))
            renders.add_child(0, ci, Fig(
                kind=FigKind.nkRectangle,
                screen_box=rect(-16, -16, 360, 360),
                fill=fill(rgba(30, 40, 220, 110)),
            ))
    return from_renders(renders)


def test_sharded_camera_bit_exact():
    """Row-sharded render_view == a sharded re-walk of the scene under the
    same nkTransform camera, bit-exactly (view_rows runs on the replicated
    unpacked combo before the shard_map splits bands); and it matches the
    single-chip camera within 1/255."""
    from figdraw_tpu.parallel.sharding import ShardedFigRenderer

    w, h = 256, 192
    sharded = ShardedFigRenderer(atlas_size=64, use_pallas=False)
    ref = ShardedFigRenderer(atlas_size=64, use_pallas=False)
    snap = sharded.snapshot_scene(_cam_scene(), vec2(w, h))
    for (dx, dy), z in (((9, -7), 1), ((-13, 11), 2)):
        view = np.asarray(sharded.render_view(snap, (dx, dy), zoom=z))
        expect = np.asarray(
            ref.render_frame(_cam_scene((dx, dy), z), vec2(w, h)))
        np.testing.assert_array_equal(view, expect,
                                      err_msg=f"zoom {z} pan {dx},{dy}")

    single = FigRenderer(atlas_size=64, use_pallas=False)
    ssnap = single.snapshot_scene(_cam_scene(), vec2(w, h))
    a = _screenshot(single.render_view(ssnap, (9, -7), zoom=2))
    b = _screenshot(sharded.render_view(snap, (9, -7), zoom=2))
    assert _max_diff(a, b) <= 1


def test_sharded_camera_mega_bit_exact():
    """The mask-heavy camera snapshot rides the sharded megakernel and its
    views equal the sharded re-walk bit-exactly, with no silent downgrade."""
    from figdraw_tpu.parallel.sharding import ShardedFigRenderer

    w, h = 256, 192
    sharded = ShardedFigRenderer(atlas_size=64, use_pallas=True)
    ref = ShardedFigRenderer(atlas_size=64, use_pallas=True)
    snap = sharded.snapshot_scene(_clip_cam_scene(), vec2(w, h))
    assert snap.kind == "mega"
    view = np.asarray(sharded.render_view(snap, (5, -3), zoom=2))
    expect = np.asarray(
        ref.render_frame(_clip_cam_scene((5, -3), 2), vec2(w, h)))
    np.testing.assert_array_equal(view, expect)
    assert sharded.use_pallas, "sharded camera megakernel fell back"


def test_sharded_animation_bit_exact():
    """Row-sharded render_view(root_transforms) == the sharded re-walk with
    the animated roots wrapped in equivalent nkTransforms, bit-exactly
    (executor.animate_rows runs on the replicated unpacked combo before the
    shard_map splits bands); and it equals the single-chip animated view
    within 1/255."""
    from figdraw_tpu.basics import TransformStyle
    from figdraw_tpu.geometry import Mat3
    from figdraw_tpu.nodesarray import from_renders
    from figdraw_tpu.parallel.sharding import ShardedFigRenderer

    def scene(moves=None):
        renders = new_renders()
        keys = []
        for i in range(12):
            f = Fig(
                kind=FigKind.nkRectangle,
                screen_box=rect(8 + (i % 4) * 42, 6 + (i // 4) * 38, 30, 24),
                corners=(5,) * 4,
                fill=fill(rgba(40 + i * 10, (i * 53) % 255, 180, 160)))
            if moves and i in moves:
                a, b, c, d, tx, ty = [float(v) for v in moves[i]]
                tr = renders.add_root(0, Fig(
                    kind=FigKind.nkTransform,
                    transform=TransformStyle(
                        translation=vec2(tx, ty),
                        matrix=Mat3(a, b, 0.0, c, d, 0.0))))
                renders.add_child(0, tr, f)
                keys.append(tr)
            else:
                keys.append(renders.add_root(0, f))
        return from_renders(renders), keys

    moves = {1: (1.0, 0.0, 0.0, 1.0, 12.0, -6.0),
             7: (2.0, 0.0, 0.0, 2.0, 4.0, 8.0)}
    w, h = 256, 192
    sharded = ShardedFigRenderer(atlas_size=64, use_pallas=False)
    ref = ShardedFigRenderer(atlas_size=64, use_pallas=False)
    base, keys = scene()
    snap = sharded.snapshot_scene(base, vec2(w, h))
    view = np.asarray(sharded.render_view(
        snap, root_transforms={keys[i]: m for i, m in moves.items()}))
    wrapped, _ = scene(moves)
    expect = np.asarray(ref.render_frame(wrapped, vec2(w, h)))
    np.testing.assert_array_equal(view, expect)

    single = FigRenderer(atlas_size=64, use_pallas=False)
    ssnap = single.snapshot_scene(base, vec2(w, h))
    a = _screenshot(single.render_view(
        ssnap, root_transforms={keys[i]: m for i, m in moves.items()}))
    b = _screenshot(sharded.render_view(
        snap, root_transforms={keys[i]: m for i, m in moves.items()}))
    assert _max_diff(a, b) <= 1


def test_sharded_camera_views_match_loop():
    """Row-sharded flythrough (chunked lax.map over the sharded executor)
    equals the render_view loop bit-exactly."""
    from figdraw_tpu.parallel.sharding import ShardedFigRenderer

    w, h = 256, 192
    sharded = ShardedFigRenderer(atlas_size=64, use_pallas=False)
    snap = sharded.snapshot_scene(_cam_scene(), vec2(w, h))
    pans = [(3.0 * i, -2.0 * i) for i in range(5)]
    zooms = [1.0, 2.0, 1.5, 1.0, 0.75]
    stack = np.asarray(sharded.render_views(snap, pans, zooms, chunk=2))
    assert stack.shape == (5, h, w, 4)
    for i, (p, z) in enumerate(zip(pans, zooms)):
        exp = np.asarray(sharded.render_view(snap, p, zoom=z))
        np.testing.assert_array_equal(stack[i], exp, err_msg=f"view {i}")
