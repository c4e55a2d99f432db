"""Retained scenes: renderer.update_scene patches a DeviceScene in place.

Contract: after in-place RendersArray edits, update_scene(scene, arr, dirty)
produces BIT-exactly the frame a fresh snapshot_scene of the edited scene
renders — whether the patch path ran (per-row edits: geometry, rotation,
fills, corners, rect-mask clips) or the fallback re-snapshot did (structural
edits, plane masks in a dirty root, atlas generation changes, dirty=None).
The fast path re-walks ONLY the dirty roots (native fd_flatten_layer_spans)
and ships only their packed rows (executor.get_patch_runner scatter), so the
host + wire cost is O(edited quads), not O(scene).
"""

import numpy as np
import pytest

from figdraw_tpu import (
    Fig, FigFlags, FigKind, fill, new_renders, rect, rgba, vec2,
)
from figdraw_tpu.basics import ShadowStyle
from figdraw_tpu.nodes import RenderShadow
from figdraw_tpu.nodesarray import from_renders, pack_fig
from figdraw_tpu.renderer import FigRenderer

DEJAVU = "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf"
W, H = 320, 200


def _native_available():
    from figdraw_tpu import native

    return native._load() is not None


# heavyweight end-to-end frame-loop suite: excluded by `./ci.sh fast`
pytestmark = [
    pytest.mark.slow,
    pytest.mark.skipif(
        not _native_available(), reason="retained patching needs the C++ walk"
    ),
]


def boxes_scene(n=40):
    renders = new_renders()
    renders.add_root(0, Fig(kind=FigKind.nkRectangle,
                            screen_box=rect(0, 0, W, H),
                            fill=fill(rgba(20, 20, 30, 255))))
    boxes = []
    for i in range(n):
        boxes.append(renders.add_root(0, Fig(
            kind=FigKind.nkRectangle,
            screen_box=rect(5 + (i % 10) * 31, 8 + (i // 10) * 46, 26, 38),
            corners=(5,) * 4, rotation=3.0 * i,
            fill=fill(rgba((i * 37) % 255, 90, 200, 155)))))
    return from_renders(renders), boxes


def _fresh_frame(ren, arr, pan=(0.0, 0.0), zoom=1.0):
    return np.asarray(ren.render_view(
        ren.snapshot_scene(arr, vec2(W, H)), pan, zoom))


def _patch_hits(monkeypatch):
    """Count walk_roots_packed fast-path attempts and successes."""
    from figdraw_tpu import native

    stats = {"calls": 0, "ok": 0}
    orig = native.walk_roots_packed

    def counting(*a, **k):
        stats["calls"] += 1
        out = orig(*a, **k)
        if out is not None:
            stats["ok"] += 1
        return out

    monkeypatch.setattr(native, "walk_roots_packed", counting)
    return stats


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["xla", "pallas"])
def test_patch_geometry_and_fill_exact(use_pallas, monkeypatch):
    """Moving/recoloring/rotating roots patches in place and matches a
    fresh snapshot bit-exactly, including under a camera view."""
    arr, boxes = boxes_scene()
    ren = FigRenderer(atlas_size=64, use_pallas=use_pallas)
    scene = ren.snapshot_scene(arr, vec2(W, H))
    assert scene.spans is not None
    stats = _patch_hits(monkeypatch)

    lst = arr[0]
    for k, b in enumerate(boxes[5:15]):
        lst.set_box(b, 5 + (b % 10) * 31, 20 + (b // 10) * 40, 26, 38)
        lst.set_rotation(b, -10.0 - k)
        lst.set_solid_color(b, rgba(250, 80 + 10 * k, 60, 200))
    ren.update_scene(scene, arr, dirty=[(0, b) for b in boxes[5:15]])
    assert stats["ok"] == 1, "expected the fast patch path"

    got = np.asarray(ren.render_view(scene, pan=(3.0, -2.0)))
    want = _fresh_frame(ren, arr, pan=(3.0, -2.0))
    assert np.array_equal(got, want)


def test_patch_bare_int_dirty_means_layer_zero(monkeypatch):
    arr, boxes = boxes_scene(12)
    ren = FigRenderer(atlas_size=64, use_pallas=False)
    scene = ren.snapshot_scene(arr, vec2(W, H))
    stats = _patch_hits(monkeypatch)
    arr[0].set_box(boxes[3], 100, 100, 26, 38)
    ren.update_scene(scene, arr, dirty=[boxes[3]])
    assert stats["ok"] == 1
    assert np.array_equal(np.asarray(ren.render_view(scene)),
                          _fresh_frame(ren, arr))


def test_patch_rect_mask_clip_root(monkeypatch):
    """Editing an NfRectMaskContent clip root (the rect-mask wire columns)
    stays on the fast path — rect-mask state is subtree-local."""
    renders = new_renders()
    renders.add_root(0, Fig(kind=FigKind.nkRectangle,
                            screen_box=rect(0, 0, W, H),
                            fill=fill(rgba(20, 20, 30, 255))))
    c = renders.add_root(0, Fig(
        kind=FigKind.nkRectangle, screen_box=rect(40, 40, 120, 80),
        flags=FigFlags.NfRectMaskContent,
        fill=fill(rgba(200, 200, 210, 255))))
    renders.add_child(0, c, Fig(
        kind=FigKind.nkRectangle, screen_box=rect(-30, 20, 240, 30),
        fill=fill(rgba(255, 60, 60, 200))))
    arr = from_renders(renders)
    ren = FigRenderer(atlas_size=64, use_pallas=True)
    scene = ren.snapshot_scene(arr, vec2(W, H))
    stats = _patch_hits(monkeypatch)
    arr[0].set_box(c, 60, 55, 100, 70)
    ren.update_scene(scene, arr, dirty=[(0, c)])
    assert stats["ok"] == 1
    assert np.array_equal(np.asarray(ren.render_view(scene)),
                          _fresh_frame(ren, arr))


def test_structural_edit_falls_back_exact(monkeypatch):
    """A quad-count-changing edit (shadow added) re-snapshots: still exact,
    fast path attempted once and rejected."""
    arr, boxes = boxes_scene(12)
    ren = FigRenderer(atlas_size=64, use_pallas=False)
    scene = ren.snapshot_scene(arr, vec2(W, H))
    stats = _patch_hits(monkeypatch)
    lst = arr[0]
    shadowed = Fig(
        kind=FigKind.nkRectangle, screen_box=rect(5, 8, 26, 38),
        corners=(5,) * 4, fill=fill(rgba(10, 200, 10, 255)),
        shadows=(RenderShadow(style=ShadowStyle.DropShadow, blur=6.0,
                              x=2, y=3, fill=fill(rgba(0, 0, 0, 120))),))
    pack_fig(lst.nodes[boxes[0]], shadowed, lst.ops_rows, lst.points_rows)
    ren.update_scene(scene, arr, dirty=[(0, boxes[0])])
    assert stats["calls"] == 1 and stats["ok"] == 1  # walk ok, spans differ
    assert np.array_equal(np.asarray(ren.render_view(scene)),
                          _fresh_frame(ren, arr))
    # the re-snapshot refreshed the span table: a follow-up value edit
    # (same quad count) patches again
    stats["calls"] = stats["ok"] = 0
    lst.set_rotation(boxes[0], 33.0)
    ren.update_scene(scene, arr, dirty=[(0, boxes[0])])
    assert stats["ok"] == 1
    assert np.array_equal(np.asarray(ren.render_view(scene)),
                          _fresh_frame(ren, arr))


def test_plane_mask_dirty_root_falls_back_exact():
    """A dirty root that allocates a plane mask (NfClipContent) rejects the
    patch (global mask numbering) and re-snapshots exactly."""
    renders = new_renders()
    renders.add_root(0, Fig(kind=FigKind.nkRectangle,
                            screen_box=rect(0, 0, W, H),
                            fill=fill(rgba(20, 20, 30, 255))))
    c = renders.add_root(0, Fig(
        kind=FigKind.nkRectangle, screen_box=rect(60, 60, 120, 80),
        rotation=17.0, flags=FigFlags.NfClipContent,
        fill=fill(rgba(255, 255, 255, 30))))
    renders.add_child(0, c, Fig(
        kind=FigKind.nkRectangle, screen_box=rect(-20, 10, 200, 30),
        fill=fill(rgba(255, 0, 0, 200))))
    arr = from_renders(renders)
    ren = FigRenderer(atlas_size=64, use_pallas=False)
    scene = ren.snapshot_scene(arr, vec2(W, H))
    arr[0].set_rotation(c, 40.0)
    ren.update_scene(scene, arr, dirty=[(0, c)])
    assert np.array_equal(np.asarray(ren.render_view(scene)),
                          _fresh_frame(ren, arr))


def test_dirty_none_resnapshots():
    arr, boxes = boxes_scene(8)
    ren = FigRenderer(atlas_size=64, use_pallas=False)
    scene = ren.snapshot_scene(arr, vec2(W, H))
    arr[0].set_box(boxes[2], 150, 120, 26, 38)
    ren.update_scene(scene, arr)  # no dirty info: full refresh
    assert np.array_equal(np.asarray(ren.render_view(scene)),
                          _fresh_frame(ren, arr))


def test_patch_preserves_unrelated_rows_and_meta():
    """Only the dirty roots' rows change in the device combo; padding and
    the meta tail stay byte-identical."""
    arr, boxes = boxes_scene(16)
    ren = FigRenderer(atlas_size=64, use_pallas=False)
    scene = ren.snapshot_scene(arr, vec2(W, H))
    before = np.asarray(scene.combo_dev).copy()
    (s, e) = scene.spans[(0, boxes[4])]
    arr[0].set_box(boxes[4], 111, 77, 26, 38)
    ren.update_scene(scene, arr, dirty=[(0, boxes[4])])
    # the patch is deferred into the next render dispatch; flush to read
    # the resident combo directly
    ren._flush_scene_patch(scene)
    after = np.asarray(scene.combo_dev)
    changed = np.where(
        (before != after).any(axis=1) & ~(np.isnan(before).any(axis=1)
                                          & np.isnan(after).any(axis=1))
    )[0]
    assert changed.size > 0
    assert changed.min() >= s and changed.max() < e
    assert np.array_equal(before[e:], after[e:], equal_nan=True)


def test_patch_then_downgrade_uses_patched_host_mirror():
    """Patches land in the host mirror (plan.combo) as well as on the
    device, so a re-plan from the mirror sees the patched scene; the
    patched Pallas frame matches a fresh XLA snapshot within 1/255."""
    arr, boxes = boxes_scene(12)
    ren = FigRenderer(atlas_size=64, use_pallas=True)
    scene = ren.snapshot_scene(arr, vec2(W, H))
    arr[0].set_solid_color(boxes[1], rgba(255, 255, 0, 255))
    arr[0].set_box(boxes[1], 140, 90, 40, 40)
    ren.update_scene(scene, arr, dirty=[(0, boxes[1])])
    ren._flush_scene_patch(scene)
    assert np.array_equal(np.asarray(scene.combo_dev), scene.plan.combo,
                          equal_nan=True)
    got = np.asarray(ren.render_view(scene))
    ref = FigRenderer(atlas_size=64, use_pallas=False)
    want = np.asarray(ref.render_view(ref.snapshot_scene(arr, vec2(W, H))))
    assert np.abs(got - want).max() <= 1.0 / 255.0


def test_patch_multi_layer(monkeypatch):
    """Dirty roots across ZLevels (separate fd layer walks) patch exactly."""
    renders = new_renders()
    renders.add_root(0, Fig(kind=FigKind.nkRectangle,
                            screen_box=rect(0, 0, W, H),
                            fill=fill(rgba(10, 12, 16, 255))))
    a = renders.add_root(0, Fig(kind=FigKind.nkRectangle,
                                screen_box=rect(30, 30, 60, 60),
                                fill=fill(rgba(200, 60, 60, 200))))
    b = renders.add_root(1, Fig(kind=FigKind.nkRectangle,
                                screen_box=rect(60, 50, 80, 40),
                                corners=(8,) * 4,
                                fill=fill(rgba(60, 200, 120, 180))))
    arr = from_renders(renders)
    ren = FigRenderer(atlas_size=64, use_pallas=False)
    scene = ren.snapshot_scene(arr, vec2(W, H))
    stats = _patch_hits(monkeypatch)
    arr[0].set_box(a, 45, 40, 60, 60)
    arr[1].set_box(b, 80, 70, 80, 40)
    ren.update_scene(scene, arr, dirty=[(0, a), (1, b)])
    assert stats["ok"] == 1
    assert np.array_equal(np.asarray(ren.render_view(scene)),
                          _fresh_frame(ren, arr))


def test_patch_text_scene_move_text_root(monkeypatch):
    """Moving a text root (atlas-sampling glyph quads) patches on the
    non-mega layouts when the atlas generation is unchanged."""
    from figdraw_tpu.text.layout import typeset
    from figdraw_tpu.text.typefaces import FigFont, load_typeface

    tid = load_typeface(DEJAVU)
    f = FigFont(typeface_id=tid, size=16.0)

    renders = new_renders()
    renders.add_root(0, Fig(kind=FigKind.nkRectangle,
                            screen_box=rect(0, 0, W, H),
                            fill=fill(rgba(250, 250, 250, 255))))
    t = renders.add_root(0, Fig(
        kind=FigKind.nkText, screen_box=rect(20, 20, 200, 60),
        text_layout=typeset(vec2(200, 60),
                            [(f, fill(rgba(0, 0, 0, 255)), "retained")])))
    arr = from_renders(renders)
    ren = FigRenderer(atlas_size=256, use_pallas=False)
    scene = ren.snapshot_scene(arr, vec2(W, H))
    stats = _patch_hits(monkeypatch)
    arr[0].set_box(t, 40, 90, 200, 60)
    ren.update_scene(scene, arr, dirty=[(0, t)])
    assert stats["ok"] == 1, "text move should take the fast path"
    assert np.array_equal(np.asarray(ren.render_view(scene)),
                          _fresh_frame(ren, arr))


def test_sharded_update_scene_patch_and_fallback(monkeypatch):
    """ShardedFigRenderer.update_scene: the mesh-resident combo (unpacked
    layout) patches in place and matches a fresh sharded snapshot; a
    structural edit falls back exactly."""
    from figdraw_tpu.parallel.sharding import ShardedFigRenderer

    arr, boxes = boxes_scene(24)
    ren = ShardedFigRenderer(atlas_size=64, use_pallas=True)
    scene = ren.snapshot_scene(arr, vec2(W, H))
    assert scene.spans is not None
    stats = _patch_hits(monkeypatch)

    lst = arr[0]
    for b in boxes[3:9]:
        lst.set_box(b, 5 + (b % 10) * 31, 25 + (b // 10) * 40, 26, 38)
        lst.set_solid_color(b, rgba(245, 190, 40, 210))
    ren.update_scene(scene, arr, dirty=[(0, b) for b in boxes[3:9]])
    assert stats["ok"] == 1
    got = np.asarray(ren.render_view(scene, pan=(2.0, 1.0)))
    want = np.asarray(ren.render_view(
        ren.snapshot_scene(arr, vec2(W, H)), pan=(2.0, 1.0)))
    assert np.array_equal(got, want)

    # structural edit: re-snapshot fallback, still exact
    shadowed = Fig(
        kind=FigKind.nkRectangle, screen_box=rect(5, 8, 26, 38),
        corners=(5,) * 4, fill=fill(rgba(10, 200, 10, 255)),
        shadows=(RenderShadow(style=ShadowStyle.DropShadow, blur=6.0,
                              x=2, y=3, fill=fill(rgba(0, 0, 0, 120))),))
    pack_fig(lst.nodes[boxes[0]], shadowed, lst.ops_rows, lst.points_rows)
    ren.update_scene(scene, arr, dirty=[(0, boxes[0])])
    got = np.asarray(ren.render_view(scene))
    want = np.asarray(ren.render_view(ren.snapshot_scene(arr, vec2(W, H))))
    assert np.array_equal(got, want)


def test_sharded_patch_matches_single_chip():
    """A patched sharded scene equals the single-chip patched scene within
    the kernel tolerance contract (here: identical CPU math, exact)."""
    from figdraw_tpu.parallel.sharding import ShardedFigRenderer

    arr, boxes = boxes_scene(24)
    single = FigRenderer(atlas_size=64, use_pallas=False)
    sharded = ShardedFigRenderer(atlas_size=64, use_pallas=True)
    s1 = single.snapshot_scene(arr, vec2(W, H))
    s2 = sharded.snapshot_scene(arr, vec2(W, H))
    arr[0].set_rotation(boxes[7], 45.0)
    arr[0].set_box(boxes[7], 120, 60, 40, 50)
    single.update_scene(s1, arr, dirty=[(0, boxes[7])])
    sharded.update_scene(s2, arr, dirty=[(0, boxes[7])])
    a = np.asarray(single.render_view(s1))
    b = np.asarray(sharded.render_view(s2))
    diff = np.abs(
        np.round(np.clip(a, 0, 1) * 255) - np.round(np.clip(b, 0, 1) * 255)
    )
    assert diff.max() <= 1


def test_atlas_generation_change_falls_back():
    arr, boxes = boxes_scene(8)
    ren = FigRenderer(atlas_size=64, use_pallas=False)
    scene = ren.snapshot_scene(arr, vec2(W, H))
    arr[0].set_rotation(boxes[0], 80.0)
    ren.atlas.generation += 1  # simulate a rebuild between frames
    ren.update_scene(scene, arr, dirty=[(0, boxes[0])])
    assert scene.atlas_generation == ren.atlas.generation
    assert np.array_equal(np.asarray(ren.render_view(scene)),
                          _fresh_frame(ren, arr))


@pytest.mark.parametrize("seed", range(8))
def test_fuzz_retained_patch_matches_fresh_snapshot(seed):
    """Random scenes (clips, rect masks, shadows, gradients, drawables,
    rotations) + random value edits on random roots: update_scene must
    equal a fresh snapshot of the edited scene bit-exactly whether each
    edit patched or fell back."""
    from tests.test_fuzz import random_scene

    rng = np.random.default_rng(4200 + seed)
    arr = from_renders(random_scene(int(rng.integers(0, 10_000))))
    ren = FigRenderer(atlas_size=64, use_pallas=seed % 2 == 0)
    size = vec2(200, 140)
    scene = ren.snapshot_scene(arr, size)
    lst = arr[0]
    roots = list(lst.root_ids)
    from tests.test_fuzz import _rand_rect_fig

    for _round in range(3):
        dirty = []
        for r in rng.choice(roots, size=min(3, len(roots)), replace=False):
            r = int(r)
            kind = int(rng.integers(0, 4))
            if kind == 0:
                lst.set_box(r, float(rng.uniform(-10, 180)),
                            float(rng.uniform(-10, 120)),
                            float(rng.uniform(4, 80)),
                            float(rng.uniform(4, 60)))
            elif kind == 1:
                lst.set_rotation(r, float(rng.uniform(-50, 50)))
            elif kind == 2:
                lst.set_solid_color(r, rgba(*rng.integers(0, 256, 4).tolist()))
            else:
                # wholesale repack: quad count may shrink (tail fills with
                # inert rows) or grow (fallback) — both must stay exact
                lst.set_node(r, _rand_rect_fig(rng, depth=2))
            dirty.append((0, r))
        ren.update_scene(scene, arr, dirty)
        got = np.asarray(ren.render_view(scene))
        want = np.asarray(ren.render_view(ren.snapshot_scene(arr, size)))
        assert np.array_equal(got, want), (seed, _round)


def test_back_to_back_updates_and_flythrough_flush():
    """Two update_scene calls without a render in between (the older
    deferred patch flushes standalone), then a render_views flythrough
    (flushes the newer one): both bit-exact vs fresh snapshots."""
    arr, boxes = boxes_scene(10)
    ren = FigRenderer(atlas_size=64, use_pallas=False)
    scene = ren.snapshot_scene(arr, vec2(W, H))
    arr[0].set_box(boxes[1], 100, 30, 26, 38)
    ren.update_scene(scene, arr, dirty=[(0, boxes[1])])
    arr[0].set_solid_color(boxes[2], rgba(255, 0, 255, 255))
    ren.update_scene(scene, arr, dirty=[(0, boxes[2])])
    pans = [(0.0, 0.0), (4.0, 2.0), (-3.0, 7.0)]
    got = np.asarray(ren.render_views(scene, pans, chunk=2))
    fresh = ren.snapshot_scene(arr, vec2(W, H))
    want = np.stack([np.asarray(ren.render_view(fresh, p)) for p in pans])
    assert np.array_equal(got, want)


def _partial_hits(monkeypatch):
    from figdraw_tpu import executor as ex

    stats = {"n": 0}
    orig = ex.get_partial_patch_view_runner

    def counting(*a, **k):
        stats["n"] += 1
        return orig(*a, **k)

    monkeypatch.setattr(ex, "get_partial_patch_view_runner", counting)
    return stats


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["xla", "pallas"])
def test_partial_render_bit_equals_full(use_pallas, monkeypatch):
    """With a stable camera, the damage-clipped render (quads outside the
    edits' old+new bboxes dropped, previous frame outside the rect) is
    BIT-identical to a full render of the edited scene."""
    arr, boxes = boxes_scene(30)
    ren = FigRenderer(atlas_size=64, use_pallas=use_pallas)
    scene = ren.snapshot_scene(arr, vec2(W, H))
    cam = ((2.0, 1.0), 1.0)
    ren.render_view(scene, *cam)  # establishes last_cam + prev frame
    stats = _partial_hits(monkeypatch)
    lst = arr[0]
    for step in range(3):
        b = boxes[4 + step]
        lst.set_box(b, 30 + 17 * step, 40 + 9 * step, 26, 38)
        lst.set_rotation(b, 20.0 * step - 15)
        lst.set_solid_color(b, rgba(255, 80 * step, 120, 220))
        ren.update_scene(scene, arr, dirty=[(0, b)])
        got = np.asarray(ren.render_view(scene, *cam))
        want = _fresh_frame(ren, arr, *cam)
        assert stats["n"] == step + 1, "partial path not taken"
        assert np.array_equal(got, want), step


def test_partial_skipped_on_camera_change(monkeypatch):
    arr, boxes = boxes_scene(12)
    ren = FigRenderer(atlas_size=64, use_pallas=False)
    scene = ren.snapshot_scene(arr, vec2(W, H))
    ren.render_view(scene, (0.0, 0.0))
    stats = _partial_hits(monkeypatch)
    arr[0].set_box(boxes[2], 90, 90, 26, 38)
    ren.update_scene(scene, arr, dirty=[(0, boxes[2])])
    got = np.asarray(ren.render_view(scene, (5.0, 0.0)))  # camera moved
    assert stats["n"] == 0
    assert np.array_equal(got, _fresh_frame(ren, arr, (5.0, 0.0)))
    # next edit at the new camera: partial resumes
    arr[0].set_rotation(boxes[3], 66.0)
    ren.update_scene(scene, arr, dirty=[(0, boxes[3])])
    got = np.asarray(ren.render_view(scene, (5.0, 0.0)))
    assert stats["n"] == 1
    assert np.array_equal(got, _fresh_frame(ren, arr, (5.0, 0.0)))


def test_partial_render_under_zoomed_camera():
    """The damage rect transforms by the same p' = z·p + d map as the
    quads; a zoomed camera partial equals the full render bit-exactly."""
    arr, boxes = boxes_scene(16)
    ren = FigRenderer(atlas_size=64, use_pallas=False)
    scene = ren.snapshot_scene(arr, vec2(W, H))
    cam = ((10.0, -6.0), 2.0)
    ren.render_view(scene, *cam)
    arr[0].set_box(boxes[5], 60, 20, 26, 38)
    ren.update_scene(scene, arr, dirty=[(0, boxes[5])])
    got = np.asarray(ren.render_view(scene, *cam))
    assert np.array_equal(got, _fresh_frame(ren, arr, *cam))


def test_partial_accumulates_damage_across_updates():
    """Two update_scene calls before one render: the damage union covers
    both edits (the first patch flushes standalone, its damage stays
    pending until a frame covers it)."""
    arr, boxes = boxes_scene(16)
    ren = FigRenderer(atlas_size=64, use_pallas=False)
    scene = ren.snapshot_scene(arr, vec2(W, H))
    ren.render_view(scene)
    arr[0].set_box(boxes[1], 200, 30, 26, 38)
    ren.update_scene(scene, arr, dirty=[(0, boxes[1])])
    arr[0].set_box(boxes[9], 20, 150, 26, 38)
    ren.update_scene(scene, arr, dirty=[(0, boxes[9])])
    got = np.asarray(ren.render_view(scene))
    assert np.array_equal(got, _fresh_frame(ren, arr))


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["xla", "pallas"])
def test_partial_render_text_scene(use_pallas, monkeypatch):
    """Atlas (glyph) scenes take the partial path too: dropped quads'
    clamped gather windows are either fa=0 inside the rect or discarded
    outside it. Moving a box in a text scene is bit-equal to full."""
    from figdraw_tpu.text.layout import typeset
    from figdraw_tpu.text.typefaces import FigFont, load_typeface

    tid = load_typeface(DEJAVU)
    f = FigFont(typeface_id=tid, size=16.0)
    renders = new_renders()
    renders.add_root(0, Fig(kind=FigKind.nkRectangle,
                            screen_box=rect(0, 0, W, H),
                            fill=fill(rgba(250, 250, 250, 255))))
    renders.add_root(0, Fig(
        kind=FigKind.nkText, screen_box=rect(16, 16, 280, 60),
        text_layout=typeset(vec2(280, 60),
                            [(f, fill(rgba(0, 0, 0, 255)),
                              "retained text panel")])))
    b = renders.add_root(0, Fig(kind=FigKind.nkRectangle,
                                screen_box=rect(30, 110, 60, 50),
                                corners=(8,) * 4,
                                fill=fill(rgba(220, 90, 40, 220))))
    arr = from_renders(renders)
    ren = FigRenderer(atlas_size=256, use_pallas=use_pallas)
    scene = ren.snapshot_scene(arr, vec2(W, H))
    ren.render_view(scene)
    stats = _partial_hits(monkeypatch)
    arr[0].set_box(b, 160, 120, 60, 50)
    ren.update_scene(scene, arr, dirty=[(0, b)])
    got = np.asarray(ren.render_view(scene))
    assert stats["n"] == 1, "text scene should take the partial path"
    assert np.array_equal(got, _fresh_frame(ren, arr))


def test_partial_skipped_after_executor_flip():
    """A renderer-level use_pallas flip between frames (a caller switching
    rasterizers) must not mix the stale Pallas frame with XLA in-rect
    pixels: the camera key carries the executor identity."""
    arr, boxes = boxes_scene(12)
    ren = FigRenderer(atlas_size=64, use_pallas=True)
    scene = ren.snapshot_scene(arr, vec2(W, H))
    ren.render_view(scene)  # Pallas frame cached
    ren.use_pallas = False  # the caller switches to the XLA rasterizer
    arr[0].set_box(boxes[2], 90, 90, 26, 38)
    ren.update_scene(scene, arr, dirty=[(0, boxes[2])])
    got = np.asarray(ren.render_view(scene))
    ref = FigRenderer(atlas_size=64, use_pallas=False)
    want = np.asarray(ref.render_view(ref.snapshot_scene(arr, vec2(W, H))))
    assert np.array_equal(got, want)


def test_back_to_back_same_root_newest_wins(monkeypatch):
    """Re-editing the same root before a render merges on host (no
    standalone flush RPC) and the newest rows win."""
    from figdraw_tpu import executor as ex

    flushes = {"n": 0}
    orig = ex.get_patch_runner

    def counting(*a, **k):
        flushes["n"] += 1
        return orig(*a, **k)

    monkeypatch.setattr(ex, "get_patch_runner", counting)
    arr, boxes = boxes_scene(10)
    ren = FigRenderer(atlas_size=64, use_pallas=False)
    scene = ren.snapshot_scene(arr, vec2(W, H))
    arr[0].set_box(boxes[1], 100, 30, 26, 38)
    ren.update_scene(scene, arr, dirty=[(0, boxes[1])])
    arr[0].set_box(boxes[1], 140, 60, 26, 38)  # same root again
    arr[0].set_rotation(boxes[3], 50.0)
    ren.update_scene(scene, arr, dirty=[(0, boxes[1]), (0, boxes[3])])
    got = np.asarray(ren.render_view(scene))
    assert flushes["n"] == 0, "back-to-back updates should merge, not flush"
    assert np.array_equal(got, _fresh_frame(ren, arr))


def test_reserved_text_label_updates_patch_in_place(monkeypatch):
    """snapshot_scene(reserve=...) pads a text root's span with inert rows
    (bit-identical C++/Python encodings, exact blending identities) so
    COUNT-CHANGING label edits stay on the patch path: shrink and grow
    within the reserve both equal fresh snapshots bit-exactly; growth
    beyond the reserve falls back."""
    from figdraw_tpu import native
    from figdraw_tpu.text.layout import typeset
    from figdraw_tpu.text.typefaces import FigFont, load_typeface

    tid = load_typeface(DEJAVU)
    fnt = FigFont(typeface_id=tid, size=16.0)

    def text_fig(label):
        return Fig(kind=FigKind.nkText, screen_box=rect(16, 16, 280, 60),
                   text_layout=typeset(vec2(280, 60),
                                       [(fnt, fill(rgba(0, 0, 0, 255)),
                                         label)]))

    renders = new_renders()
    renders.add_root(0, Fig(kind=FigKind.nkRectangle,
                            screen_box=rect(0, 0, W, H),
                            fill=fill(rgba(250, 250, 250, 255))))
    t = renders.add_root(0, text_fig("42"))
    arr = from_renders(renders)
    ren = FigRenderer(atlas_size=256, use_pallas=False)
    # ensure every label's glyphs up front so the generation stays stable
    for s in ("42", "7", "1337", "123456789012"):
        probe = new_renders()
        probe.add_root(0, text_fig(s))
        ren._ensure_packed_glyphs(from_renders(probe))

    scene = ren.snapshot_scene(arr, vec2(W, H), reserve={(0, t): 10})
    # reserved snapshot == plain snapshot, and the pad rows match the
    # Python inert encoding bit-for-bit
    plain = ren.snapshot_scene(arr, vec2(W, H))
    assert np.array_equal(np.asarray(ren.render_view(scene)),
                          np.asarray(ren.render_view(plain)))
    s_, e_ = scene.spans[(0, t)]
    pad = (e_ - s_) - (plain.spans[(0, t)][1] - plain.spans[(0, t)][0])
    assert pad == 10
    tail = scene.plan.combo[e_ - pad : e_]
    assert np.array_equal(tail.view(np.int32),
                          native.inert_quad_rows(pad, "packed").view(np.int32))

    stats = _patch_hits(monkeypatch)
    lst = arr[0]
    for label in ("7", "1337", "42"):  # shrink, grow, back
        lst.set_node(t, text_fig(label))
        ren.update_scene(scene, arr, dirty=[(0, t)])
        got = np.asarray(ren.render_view(scene))
        fresh = ren.snapshot_scene(arr, vec2(W, H))
        assert np.array_equal(got, np.asarray(ren.render_view(fresh))), label
    assert stats["ok"] == 3, "label edits should stay on the patch path"

    # beyond the reserve: falls back (re-snapshot keeps the reserve)
    lst.set_node(t, text_fig("123456789012"))
    ren.update_scene(scene, arr, dirty=[(0, t)])
    assert scene.spans is not None and scene.snap_args[3] == {(0, t): 10}
    got = np.asarray(ren.render_view(scene))
    fresh = ren.snapshot_scene(arr, vec2(W, H))
    assert np.array_equal(got, np.asarray(ren.render_view(fresh)))


def test_shrinking_root_patches_without_reserve(monkeypatch):
    """A subtree that emits FEWER quads than at snapshot (shadow removed)
    patches in place — the freed tail becomes inert rows."""
    arr, boxes = boxes_scene(10)
    ren = FigRenderer(atlas_size=64, use_pallas=False)
    lst = arr[0]
    shadowed = Fig(
        kind=FigKind.nkRectangle, screen_box=rect(5, 8, 26, 38),
        corners=(5,) * 4, fill=fill(rgba(10, 200, 10, 255)),
        shadows=(RenderShadow(style=ShadowStyle.DropShadow, blur=6.0,
                              x=2, y=3, fill=fill(rgba(0, 0, 0, 120))),))
    lst.set_node(boxes[0], shadowed)
    scene = ren.snapshot_scene(arr, vec2(W, H))
    stats = _patch_hits(monkeypatch)
    plain = Fig(kind=FigKind.nkRectangle, screen_box=rect(5, 8, 26, 38),
                corners=(5,) * 4, fill=fill(rgba(10, 200, 10, 255)))
    lst.set_node(boxes[0], plain)
    ren.update_scene(scene, arr, dirty=[(0, boxes[0])])
    assert stats["ok"] == 1
    assert np.array_equal(np.asarray(ren.render_view(scene)),
                          _fresh_frame(ren, arr))


def test_sharded_partial_render_bit_equals_full(monkeypatch):
    """The damage-clipped render also rides the mesh: same-camera sharded
    updates select prev-frame pixels outside the rect on the PADDED frame
    and equal a fresh sharded snapshot bit-exactly."""
    from figdraw_tpu.parallel.sharding import ShardedFigRenderer

    arr, boxes = boxes_scene(20)
    ren = ShardedFigRenderer(atlas_size=64, use_pallas=True)
    scene = ren.snapshot_scene(arr, vec2(W, H))
    ren.render_view(scene, (1.0, 2.0))
    stats = _partial_hits(monkeypatch)
    lst = arr[0]
    for step in range(2):
        b = boxes[6 + step]
        lst.set_box(b, 40 + 30 * step, 60, 26, 38)
        lst.set_solid_color(b, rgba(20, 220, 180, 230))
        ren.update_scene(scene, arr, dirty=[(0, b)])
        got = np.asarray(ren.render_view(scene, (1.0, 2.0)))
        want = np.asarray(ren.render_view(
            ren.snapshot_scene(arr, vec2(W, H)), (1.0, 2.0)))
        assert stats["n"] == step + 1, "sharded partial path not taken"
        assert np.array_equal(got, want), step


def test_partial_multi_rect_scattered_edits(monkeypatch):
    """Edits in opposite corners keep SEPARATE damage rects (up to
    executor.DAMAGE_RECTS) instead of one near-full-frame union; more
    dirty roots than slots greedily merge — all bit-exact."""
    from figdraw_tpu import executor as ex

    arr, boxes = boxes_scene(40)
    ren = FigRenderer(atlas_size=64, use_pallas=False)
    scene = ren.snapshot_scene(arr, vec2(W, H))
    ren.render_view(scene)
    stats = _partial_hits(monkeypatch)
    lst = arr[0]
    # opposite corners
    lst.set_box(boxes[0], 2, 2, 26, 38)
    lst.set_box(boxes[39], 290, 158, 26, 38)
    ren.update_scene(scene, arr, dirty=[(0, boxes[0]), (0, boxes[39])])
    assert len(scene.pending_damage) == 2
    got = np.asarray(ren.render_view(scene))
    assert stats["n"] == 1
    assert np.array_equal(got, _fresh_frame(ren, arr))
    # more dirty roots than rect slots: greedy merge keeps <= DAMAGE_RECTS
    dirty = [(0, b) for b in boxes[::5]]
    for b, _ in zip(boxes[::5], range(99)):
        lst.set_rotation(b, 25.0)
    ren.update_scene(scene, arr, dirty=dirty)
    assert len(scene.pending_damage) <= ex.DAMAGE_RECTS
    got = np.asarray(ren.render_view(scene))
    assert np.array_equal(got, _fresh_frame(ren, arr))


def test_merge_damage_prefers_min_growth():
    from figdraw_tpu import executor as ex
    from figdraw_tpu.renderer import _merge_damage

    rects = None
    # DAMAGE_RECTS far-apart rects fill the slots
    for i in range(ex.DAMAGE_RECTS):
        rects = _merge_damage(rects, (i * 100.0, 0.0, i * 100.0 + 10, 10.0))
    assert len(rects) == ex.DAMAGE_RECTS
    # one more adjacent to the first: merges with it, not a far one
    rects = _merge_damage(rects, (12.0, 0.0, 20.0, 10.0))
    assert len(rects) == ex.DAMAGE_RECTS
    assert (0.0, 0.0, 20.0, 10.0) in rects
