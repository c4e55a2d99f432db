"""Borders, perf utilities, typeface info, config flags, sharded rasterizer."""

import math
import os

import numpy as np
import pytest

from figdraw_tpu import FigRenderer, fill, new_renders, rect, rgba, vec2
from figdraw_tpu.borders import (
    drawable_dashed_rounded_rect_border_ops,
    drawable_dotted_rounded_rect_border_ops,
    drawable_rounded_rect_border_ops,
    fig_dashed_rounded_rect_border,
    fig_dotted_rounded_rect_border,
)
from figdraw_tpu.nodes import DrawableKind, RenderList


def test_solid_border_ops():
    ops = drawable_rounded_rect_border_ops(rect(0, 0, 100, 60), (10, 10, 10, 10))
    # 4 edges + 4 corner arcs
    assert len(ops) == 8
    kinds = [op.kind for op in ops]
    assert kinds.count(DrawableKind.dkLine) == 4
    assert kinds.count(DrawableKind.dkArc) == 4
    # square corners: only edges
    ops_sq = drawable_rounded_rect_border_ops(rect(0, 0, 100, 60), (0, 0, 0, 0))
    assert all(op.kind == DrawableKind.dkLine for op in ops_sq)


def test_dashed_border_ops_cover_path():
    box = rect(0, 0, 100, 60)
    ops = drawable_dashed_rounded_rect_border_ops(box, (0, 0, 0, 0), 10.0, 10.0)
    # perimeter 320 → 16 cycles of 20 → 16 dashes
    assert len(ops) == 16
    total = sum((op.b - op.a).length() for op in ops)
    assert abs(total - 160.0) < 1.0  # half the perimeter drawn
    # zero gap → solid
    solid = drawable_dashed_rounded_rect_border_ops(box, (0, 0, 0, 0), 10.0, 0.0)
    assert len(solid) == 4
    # offset shifts the phase
    shifted = drawable_dashed_rounded_rect_border_ops(box, (0, 0, 0, 0), 10.0, 10.0, offset=5.0)
    assert shifted[0].b != ops[0].b  # phase shift: first dash is partial


def test_dotted_border_ops():
    box = rect(0, 0, 100, 60)
    ops = drawable_dotted_rounded_rect_border_ops(box, (0, 0, 0, 0), 3.0, 5.0)
    assert all(op.kind == DrawableKind.dkCircle for op in ops)
    # spacing = 2*3 + 5 = 11, perimeter 320 → ~29 dots
    assert 27 <= len(ops) <= 30
    assert all(abs(op.radius - 3.0) < 1e-6 for op in ops)


def test_border_figs_render():
    lst = RenderList()
    lst.add_root(fig_dashed_rounded_rect_border(
        rect(10, 10, 60, 40), (8, 8, 8, 8), fill(rgba(200, 30, 30, 255)),
        weight=4.0, dash_length=8.0, gap_length=6.0))
    lst.add_root(fig_dotted_rounded_rect_border(
        rect(20, 20, 40, 25), (5, 5, 5, 5), fill(rgba(30, 30, 200, 255)),
        weight=4.0, gap_length=4.0))
    r = new_renders()
    r.set_layer(0, lst)
    ren = FigRenderer(atlas_size=64, use_pallas=False)
    ren.render_frame(r, vec2(96, 64))
    img = ren.take_screenshot()
    reddish = ((img[..., 0] > 150) & (img[..., 2] < 100)).sum()
    bluish = ((img[..., 2] > 150) & (img[..., 0] < 100)).sum()
    assert reddish > 50 and bluish > 20


def test_perf_buffer_and_timeseries():
    from figdraw_tpu.utils.perf import FrameStats, PerfBuffer, TimeSeries, perf, time_it

    buf = PerfBuffer()
    with perf("frame", buf):
        with perf("flatten", buf):
            pass
        with perf("raster", buf):
            pass
    dump = buf.dump()
    assert "frame" in dump and "flatten" in dump and "raster" in dump
    assert dump.index("  flatten") < dump.index("frame:")

    ts = TimeSeries(window=10.0)
    for _ in range(5):
        ts.tick()
    assert ts.rate() == pytest.approx(0.5, rel=0.2)

    stats = FrameStats()
    for v in (1.0, 2.0, 3.0, 10.0):
        stats.add(v)
    s = stats.summary()
    assert s["min_ms"] == 1.0 and s["max_ms"] == 10.0
    assert s["avg_ms"] == 4.0

    _result, dt = time_it(lambda: sum(range(100)))
    assert dt >= 0


def test_typeface_info():
    from figdraw_tpu.text.typeface_info import get_typeface_info
    from figdraw_tpu.text.typefaces import load_typeface

    tid = load_typeface("/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf")
    info = get_typeface_info(tid)
    assert "DejaVu" in info.family
    assert info.glyph_count > 1000
    assert info.supports_codepoint(ord("A"))
    assert info.supports_codepoint(ord("ü"))
    assert not info.supports_codepoint(0x10FFF0)
    assert info.units_per_em in (1024, 2048)


def test_config_env_flags(monkeypatch):
    from figdraw_tpu import config

    monkeypatch.setenv("FIGDRAW_TEXT_LCD_FILTERING", "on")
    assert config.runtime_text_lcd_filtering_requested()
    monkeypatch.setenv("FIGDRAW_BACKEND", "xla")
    assert config.runtime_backend_override() is False
    monkeypatch.setenv("FIGDRAW_BACKEND", "pallas")
    assert config.runtime_backend_override() is True
    monkeypatch.delenv("FIGDRAW_BACKEND")
    monkeypatch.setenv("FIGDRAW_FORCE_XLA", "1")
    assert config.runtime_backend_override() is False
    ren = FigRenderer(atlas_size=64)
    assert ren.use_pallas is False


@pytest.mark.skipif(
    len(__import__("jax").devices()) < 2, reason="needs multi-device mesh"
)
def test_sharded_draw_matches_single_device():
    import jax
    import jax.numpy as jnp

    from figdraw_tpu.ops import raster_ref
    from figdraw_tpu.parallel.sharding import (
        ROWS_AXIS,
        default_mesh,
        make_sharded_draw_pass,
    )
    from figdraw_tpu.scenes import make_render_tree
    from figdraw_tpu.renderer import _bucket
    from figdraw_tpu.ops.layout import QF_WIDTH, QI_WIDTH
    from jax.sharding import NamedSharding, PartitionSpec as P

    n = len(jax.devices())
    height, width = 16 * n, 128
    ren = FigRenderer(atlas_size=64, use_pallas=False)
    tape = ren.flatten(make_render_tree(float(width), float(height), 0, copies=2),
                       vec2(width, height))
    cap = _bucket(tape.count)
    fields = np.zeros((cap, QF_WIDTH), np.float32)
    modes = np.zeros((cap, QI_WIDTH), np.int32)
    fields[: tape.count] = tape.fields[: tape.count]
    modes[: tape.count] = tape.modes[: tape.count]
    fields_d = jnp.asarray(fields)
    modes_d = jnp.asarray(modes)
    frame = jnp.ones((height, width, 4), jnp.float32)
    masks = jnp.ones((1, height, width), jnp.float32)
    backdrop = jnp.zeros((height, width, 4), jnp.float32)

    single = raster_ref.draw_pass_frame(
        fields_d, modes_d, jnp.int32(tape.count), frame, masks, backdrop=backdrop
    )

    mesh = default_mesh()
    frame_sh = NamedSharding(mesh, P(ROWS_AXIS, None, None))
    masks_sh = NamedSharding(mesh, P(None, ROWS_AXIS, None))
    draw = make_sharded_draw_pass(mesh)
    sharded = draw(
        fields_d, modes_d, jnp.int32(tape.count),
        jax.device_put(frame, frame_sh),
        jax.device_put(masks, masks_sh),
        jax.device_put(backdrop, frame_sh),
    )
    np.testing.assert_allclose(np.asarray(sharded), np.asarray(single), atol=1e-5)


def test_rolled_executor_matches_unrolled(monkeypatch):
    """Mask-heavy scenes route through the pass-descriptor loop; output must
    match the unrolled executor exactly."""
    import figdraw_tpu.renderer as renderer_mod
    from figdraw_tpu import Fig, FigFlags, FigKind

    def grid_scene(rows, cols):
        lst = RenderList()
        lst.add_root(Fig(kind=FigKind.nkRectangle, screen_box=rect(0, 0, 128, 96),
                         fill=fill(rgba(250, 250, 250, 255))))
        for r in range(rows):
            for c in range(cols):
                cell = rect(4 + c * 30, 4 + r * 22, 26, 18)
                idx = lst.add_root(Fig(
                    kind=FigKind.nkRectangle, screen_box=cell,
                    corners=(4, 4, 4, 4), flags=FigFlags.NfClipContent,
                    fill=fill(rgba(255, 255, 255, 255))))
                lst.add_child(idx, Fig(
                    kind=FigKind.nkRectangle,
                    screen_box=rect(cell.x - 8, cell.y + 4, cell.w + 16, 8),
                    fill=fill(rgba(40 + r * 10, 120, 235, 255))))
        r_ = new_renders()
        r_.set_layer(0, lst)
        return r_

    scene = grid_scene(4, 4)  # 16 clips → ~49 structure items

    monkeypatch.setattr(renderer_mod, "ROLLED_THRESHOLD", 10_000)
    ren_a = FigRenderer(atlas_size=64, use_pallas=False)
    ren_a.render_frame(scene, vec2(128, 96))
    unrolled = ren_a.take_screenshot()

    monkeypatch.setattr(renderer_mod, "ROLLED_THRESHOLD", 4)
    ren_b = FigRenderer(atlas_size=64, use_pallas=False)
    ren_b.render_frame(scene, vec2(128, 96))
    rolled = ren_b.take_screenshot()

    assert np.array_equal(unrolled, rolled)
    # and through pallas (interpret on CPU) — with the low threshold this is
    # the megakernel path (one kernel for the whole multi-mask frame)
    ren_c = FigRenderer(atlas_size=64, use_pallas=True)
    ren_c.render_frame(scene, vec2(128, 96))
    assert ren_c.use_pallas, "mega path fell back to XLA"
    rolled_pallas = ren_c.take_screenshot()
    diff = np.abs(rolled_pallas.astype(int) - unrolled.astype(int))
    assert diff.max() <= 1


def test_mega_executor_nested_masks(monkeypatch):
    """Megakernel parity on nested clips (mask planes beyond depth 1) and
    sibling mask reuse with clears."""
    import figdraw_tpu.renderer as renderer_mod
    from figdraw_tpu import Fig, FigFlags, FigKind

    lst = RenderList()
    lst.add_root(Fig(kind=FigKind.nkRectangle, screen_box=rect(0, 0, 160, 120),
                     fill=fill(rgba(255, 255, 255, 255))))
    for i in range(6):
        outer = lst.add_root(Fig(
            kind=FigKind.nkRectangle, screen_box=rect(6 + i * 25, 10, 22, 100),
            corners=(6, 6, 6, 6), flags=FigFlags.NfClipContent,
            fill=fill(rgba(220, 220, 230, 255))))
        inner = lst.add_child(outer, Fig(
            kind=FigKind.nkRectangle, screen_box=rect(2 + i * 25, 20 + i * 8, 40, 40),
            corners=(12, 12, 12, 12), flags=FigFlags.NfClipContent,
            fill=fill(rgba(80, 160, 220, 255))))
        lst.add_child(inner, Fig(
            kind=FigKind.nkRectangle, screen_box=rect(0, 0, 200, 200),
            fill=fill(rgba(230, 90, 40, 150)), rotation=20.0))
    scene = new_renders()
    scene.set_layer(0, lst)

    monkeypatch.setattr(renderer_mod, "ROLLED_THRESHOLD", 4)
    ren_xla = FigRenderer(atlas_size=64, use_pallas=False)
    ren_xla.render_frame(scene, vec2(160, 120))
    ref = ren_xla.take_screenshot()
    ren_mega = FigRenderer(atlas_size=64, use_pallas=True)
    ren_mega.render_frame(scene, vec2(160, 120))
    assert ren_mega.use_pallas, "mega path fell back to XLA"
    got = ren_mega.take_screenshot()
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1


@pytest.mark.skipif(
    len(__import__("jax").devices()) < 2, reason="needs multi-device mesh"
)
def test_sharded_renderer_full_frame():
    """ShardedFigRenderer end-to-end == single-chip renderer on the 300-box
    scene (incl. the backdrop blur halo exchange)."""
    from figdraw_tpu.parallel.sharding import ShardedFigRenderer
    from figdraw_tpu.scenes import make_render_tree

    w, h = 256, 192
    scene = make_render_tree(float(w), float(h), frame=4, copies=3)

    single = FigRenderer(atlas_size=64, use_pallas=False)
    single.render_frame(scene, vec2(w, h))
    expected = single.take_screenshot()

    sharded = ShardedFigRenderer(atlas_size=64)
    frame = sharded.render_frame(scene, vec2(w, h))
    got = np.clip(np.round(np.asarray(frame) * 255.0), 0, 255).astype(np.uint8)
    diff = np.abs(got.astype(int) - expected.astype(int))
    assert diff.max() <= 1, diff.max()


def test_overlay_layer_composition():
    """External full-frame layers composite between zlevels — this renderer's
    mapping of the reference's 3D-overlay GL sandwich (trender_3d_overlay)."""
    from figdraw_tpu import Fig, FigKind

    renders = new_renders()
    renders.add_root(0, Fig(kind=FigKind.nkRectangle, screen_box=rect(0, 0, 128, 96),
                            fill=fill(rgba(240, 240, 255, 255))))
    renders.add_root(2, Fig(kind=FigKind.nkRectangle, screen_box=rect(10, 10, 40, 20),
                            corners=(5, 5, 5, 5), fill=fill(rgba(255, 0, 0, 255))))
    xx = np.arange(128, dtype=np.float32)[None, :].repeat(96, 0)
    overlay = np.zeros((96, 128, 4), np.float32)
    overlay[..., 1] = 0.8
    overlay[..., 3] = np.clip(xx / 128.0, 0, 1)

    ren = FigRenderer(atlas_size=64, use_pallas=False)
    frame = np.asarray(
        ren.render_frame_with_overlays(renders, vec2(128, 96), {1: overlay})
    )
    assert frame[50, 120][1] > 0.6          # overlay visible over the background
    assert frame[15, 20][0] > 0.9           # z=2 UI drawn above the overlay
    assert frame[50, 2][2] > 0.9            # a=0 region leaves the background
    # no overlays → identical to the plain path
    ren2 = FigRenderer(atlas_size=64, use_pallas=False)
    plain = np.asarray(ren2.render_frame(renders, vec2(128, 96)))
    ren3 = FigRenderer(atlas_size=64, use_pallas=False)
    same = np.asarray(ren3.render_frame_with_overlays(renders, vec2(128, 96), {}))
    assert np.array_equal(plain, same)


def test_text_backend_info():
    """ttext_backend_info.nim analog: backend name, feature list, extensions."""
    from figdraw_tpu.text.typefaces import (
        supported_font_file_extensions, text_backend, text_backend_features,
    )

    assert text_backend() == "fonttools"
    feats = text_backend_features()
    for f in ("opentype-shaping", "bidirectional-text", "font-fallback",
              "opentype-features", "font-variations", "mark-attachment"):
        assert f in feats
    assert supported_font_file_extensions() == [".ttf", ".otf", ".ttc", ".otc"]


def test_system_fonts():
    """tsystemfonts.nim analog: role defaults, discoverable dirs/files,
    candidate-list lookup with exact-stem precedence."""
    import os

    from figdraw_tpu.text.typefaces import (
        SystemFontRole, find_system_font_file_from, supported_font_file_extensions,
        system_default_font_names, system_font_dirs, system_font_files,
    )

    sans = system_default_font_names()
    mono = system_default_font_names(SystemFontRole.Mono)
    # posix tables (tsystemfonts.nim:25-27)
    assert sans == ["Noto Sans", "DejaVu Sans", "Liberation Sans", "Ubuntu"]
    assert mono == ["Noto Sans Mono", "DejaVu Sans Mono", "Liberation Mono",
                    "Ubuntu Mono"]

    dirs = system_font_dirs()
    assert dirs  # /usr/share/fonts exists in the test image
    files = system_font_files()
    assert files
    exts = tuple(supported_font_file_extensions())
    assert all(f.lower().endswith(exts) for f in files)

    # DejaVu ships in the image; exact stem match must win over loose ones
    path = find_system_font_file_from(["DejaVu Sans", "Noto Sans"])
    assert path and os.path.isfile(path)
    assert os.path.splitext(os.path.basename(path))[0] == "DejaVuSans"
    # loose match: a candidate list that only matches partially still resolves
    assert find_system_font_file_from(["DejaVu Sans Mo"]).endswith(".ttf")
    assert find_system_font_file_from([]) == ""
    assert find_system_font_file_from(["no-such-font-family-xyz"]) == ""


def test_one_frame_screenshot_env(monkeypatch, tmp_path):
    """tfigrender_oneframe_screenshot analog: FIGDRAW_TEST_ONE_FRAME writes
    the first frame as a PNG."""
    from PIL import Image

    out = str(tmp_path / "one_frame.png")
    monkeypatch.setenv("FIGDRAW_TEST_ONE_FRAME", out)
    from figdraw_tpu import Fig, FigKind

    renders = new_renders()
    renders.add_root(0, Fig(kind=FigKind.nkRectangle, screen_box=rect(0, 0, 64, 48),
                            fill=fill(rgba(0, 128, 255, 255))))
    ren = FigRenderer(atlas_size=64, use_pallas=False)
    ren.render_frame(renders, vec2(64, 48))
    img = np.asarray(Image.open(out))
    assert img.shape == (48, 64, 4)
    assert img[24, 32, 2] > 200  # the blue fill made it to disk
    # only the first frame writes
    os.remove(out)
    ren.render_frame(renders, vec2(64, 48))
    assert not os.path.exists(out)


@pytest.mark.skipif(
    len(__import__("jax").devices()) < 2, reason="needs multi-device mesh"
)
def test_sharded_renderer_masks_and_text():
    """Row-sharded clip masks (mask planes sharded with the frame) and
    atlas-sampling glyph quads match the single-chip renderer bit-for-bit."""
    from figdraw_tpu import Fig, FigFlags, FigKind
    from figdraw_tpu.parallel.sharding import ShardedFigRenderer
    from figdraw_tpu.text.layout import typeset
    from figdraw_tpu.text.typefaces import FigFont, load_typeface

    tid = load_typeface("/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf")
    renders = new_renders()
    renders.add_root(0, Fig(kind=FigKind.nkRectangle, screen_box=rect(0, 0, 256, 128),
                            fill=fill(rgba(250, 250, 250, 255))))
    clip = renders.add_root(0, Fig(
        kind=FigKind.nkRectangle, screen_box=rect(10, 10, 90, 70),
        corners=(12, 12, 12, 12), flags=FigFlags.NfClipContent,
        fill=fill(rgba(220, 220, 240, 255))))
    renders.add_child(0, clip, Fig(
        kind=FigKind.nkRectangle, screen_box=rect(0, 0, 300, 300),
        fill=fill(rgba(200, 40, 40, 160)), rotation=20.0))
    f = FigFont(typeface_id=tid, size=18.0)
    arr = typeset(vec2(200, 24), [(f, fill(rgba(0, 0, 0, 255)), "sharded text AV")])
    renders.add_root(0, Fig(kind=FigKind.nkText, screen_box=rect(110, 20, 140, 24),
                            text_layout=arr))

    single = FigRenderer(atlas_size=256, use_pallas=False)
    single.render_frame(renders, vec2(256, 128))
    ref = single.take_screenshot()
    sr = ShardedFigRenderer(atlas_size=256)
    out = np.asarray(sr.render_frame(renders, vec2(256, 128)))
    got = (np.clip(out, 0, 1) * 255).round().astype(np.uint8)
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1


def test_take_screenshot_rect():
    """readPixels with a crop rect (glcontext.nim:2094-2135)."""
    from figdraw_tpu import Fig, FigKind

    renders = new_renders()
    renders.add_root(0, Fig(kind=FigKind.nkRectangle, screen_box=rect(8, 8, 16, 16),
                            fill=fill(rgba(255, 0, 0, 255))))
    ren = FigRenderer(atlas_size=64, use_pallas=False)
    ren.render_frame(renders, vec2(64, 48))
    crop = ren.take_screenshot(frame_rect=(8, 8, 16, 16))
    assert crop.shape == (16, 16, 4)
    assert (crop[..., 0] > 200).all()
    # clamped out-of-range rect
    edge = ren.take_screenshot(frame_rect=(60, 40, 100, 100))
    assert edge.shape == (8, 4, 4)


def test_native_tape_uploads_without_repacking(monkeypatch):
    """A native-walk tape arrives combo-backed (fields/modes are views into
    the upload buffer); execute() must use it as-is — re-packing would mean
    the zero-copy export regressed."""
    import numpy as np

    import pytest

    from figdraw_tpu import native as _native

    if not _native.available():
        pytest.skip("native flattener not built")

    from figdraw_tpu import FigRenderer, vec2
    from figdraw_tpu import executor as ex
    from figdraw_tpu.scenes import make_render_tree_array

    ren = FigRenderer(atlas_size=256, use_pallas=True)
    tape = ren.flatten(make_render_tree_array(640, 360, 2, copies=20),
                       vec2(640, 360))
    assert tape.combo is not None
    from figdraw_tpu.ops.layout import PACKED_WIDTH

    assert tape.combo.shape[1] == PACKED_WIDTH  # packed wire layout
    assert tape.combo_quads >= tape.count
    # the mode lanes are a VIEW into the wire buffer (mark writes ride the
    # upload); the logical fields materialize lazily off the hot path
    assert tape.modes_lanes().base is not None

    def boom(*a, **k):
        raise AssertionError("execute re-packed a combo-backed tape")

    monkeypatch.setattr(ex, "pack_tape_combo", boom)
    out = ren.execute(tape)
    assert np.isfinite(np.asarray(out)).all()


def test_packed_wire_roundtrip_bit_exact():
    """The packed upload layout (ops/layout.py): pack -> unpack reproduces
    the tape bit-for-bit on host AND through the device unpack, because
    every tape color is u8/255 and k/255.0f is one IEEE op."""
    import numpy as np

    from figdraw_tpu.executor import unpack_combo_device
    from figdraw_tpu.ops.layout import (
        PACKED_WIDTH, QF_WIDTH, pack_fields_np, unpack_fields_np,
    )

    rng = np.random.RandomState(7)
    n = 257
    fields = rng.uniform(-500, 500, (n, QF_WIDTH)).astype(np.float32)
    # color columns must be u8-quantized like the walks write them
    fields[:, 16:40] = rng.randint(0, 256, (n, 24)).astype(np.float32) / 255.0
    modes = rng.randint(0, 2 ** 20, (n, 2)).astype(np.int32)

    packed = pack_fields_np(fields, modes)
    assert packed.shape == (n, PACKED_WIDTH)
    f2, m2 = unpack_fields_np(packed)
    np.testing.assert_array_equal(f2, fields)
    np.testing.assert_array_equal(m2, modes)

    import jax

    f3, m3 = jax.jit(unpack_combo_device)(packed)
    np.testing.assert_array_equal(np.asarray(f3), fields)
    np.testing.assert_array_equal(np.asarray(m3), modes)


def test_heap_diff_reporter():
    """dumpHeapDiff analog (/root/reference/src/figdraw/opengl/perf.nim:200-216):
    snapshot -> allocate -> diff reports positive RSS/object growth and a
    per-1k-frame drift figure."""
    from figdraw_tpu.utils.perf import dump_heap_diff, heap_snapshot, rss_bytes

    assert rss_bytes() > 10 * 1024 * 1024  # a live CPython process is >10MB
    snap = heap_snapshot()
    assert snap["rss"] > 0 and snap["objects"] > 0
    # lists are GC-tracked (bytearrays are not), so the object counter sees them
    ballast = [[i] for i in range(50_000)]
    msg = dump_heap_diff(snap, label="unit", frames=1000)
    assert "heapDiff unit" in msg
    assert "rss=" in msg and "objects=" in msg and "drift=" in msg
    # object growth must register (RSS growth is allocator-dependent; the
    # object counter is the deterministic part)
    cur = heap_snapshot()
    assert cur["objects"] - snap["objects"] > 40_000
    del ballast
