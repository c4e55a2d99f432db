"""Megakernel fast path: C++ combo export == Python packer, end-to-end parity.

The megakernel executes a mask-heavy frame as ONE Pallas pass (mask planes
live in registers; clear sentinels carry tight bboxes) — the path of the
180x6 clip table (windy_clip_mask_benchmark.nim's workload)."""

import numpy as np
import pytest

from figdraw_tpu import (
    Fig, FigFlags, FigKind, fill, new_renders, rect, rgba, vec2,
)
from figdraw_tpu import native
from figdraw_tpu.nodesarray import from_renders
from figdraw_tpu.renderer import FigRenderer, _bucket
import figdraw_tpu.executor as ex


def clip_table(rows=8, cols=6, w=256.0, h=200.0):
    renders = new_renders()
    renders.add_root(0, Fig(kind=FigKind.nkRectangle, screen_box=rect(0, 0, w, h),
                            fill=fill(rgba(250, 250, 250, 255))))
    for r in range(rows):
        for c in range(cols):
            cell = renders.add_root(0, Fig(
                kind=FigKind.nkRectangle,
                screen_box=rect(4 + c * 40, 4 + r * 24, 36, 20),
                corners=(5, 5, 5, 5), flags=FigFlags.NfClipContent,
                fill=fill(rgba(200 - r * 9, 60 + c * 20, 120, 255)),
            ))
            renders.add_child(0, cell, Fig(
                kind=FigKind.nkRectangle, screen_box=rect(0, 0, 300, 300),
                fill=fill(rgba(30, 30, 220, 120)), rotation=10.0,
            ))
    return renders


@pytest.mark.skipif(not native.available(), reason="native flattener not built")
def test_cxx_mega_export_matches_python_packer():
    arr = from_renders(clip_table())
    ren = FigRenderer(atlas_size=128, use_pallas=False)
    tape = ren.flatten(arr, vec2(256, 200))
    mf, mm = ex.pack_mega_modes(
        tape, tape.fields[: tape.count], tape.modes[: tape.count]
    )
    res = native.flatten_fast(
        arr, 256, 200, 1.0, 1.0, 1.2, (1, 1, 1, 1),
        atlas_entries=ren.atlas.entries, atlas_size=ren.atlas.size,
        white_uv=ren._white_uv(), min_items=24, bucket=_bucket,
    )
    assert res is not None and res[0] == "mega"
    combo, mask_count = res[1], res[2]
    assert mask_count == tape.mask_count
    rows = mf.shape[0]
    # the C++ export writes the PACKED wire layout; unpacking it must give
    # exactly the python packer's logical rows (colors are u8/255 exact)
    from figdraw_tpu.ops.layout import PACKED_WIDTH, unpack_fields_np

    assert combo.shape[1] == PACKED_WIDTH
    uf, um = unpack_fields_np(combo[:rows])
    assert np.array_equal(uf, mf)
    assert np.array_equal(um, mm)
    assert not combo[rows:-1].any()  # padding stays zero (never binned)


@pytest.mark.skipif(not native.available(), reason="native flattener not built")
def test_fast_path_takes_tape_route_for_light_scenes():
    renders = new_renders()
    renders.add_root(0, Fig(kind=FigKind.nkRectangle, screen_box=rect(0, 0, 64, 64),
                            fill=fill(rgba(255, 0, 0, 255))))
    arr = from_renders(renders)
    res = native.flatten_fast(arr, 64, 64, 1.0, 1.0, 1.2, (1, 1, 1, 1),
                              min_items=24, bucket=_bucket)
    assert res is not None and res[0] == "tape"
    assert res[1].count == 1


def test_mega_frame_matches_xla():
    """End-to-end: the mega fast path renders the clip table identically to
    the XLA rolled path (uint8 tolerance 1)."""
    arr = from_renders(clip_table())
    ren_mega = FigRenderer(atlas_size=128, use_pallas=True)
    ren_mega.render_frame(arr, vec2(256, 200))
    assert ren_mega.use_pallas, "mega path fell back"
    mega = ren_mega.take_screenshot()
    ren_xla = FigRenderer(atlas_size=128, use_pallas=False)
    ren_xla.render_frame(arr, vec2(256, 200))
    xla = ren_xla.take_screenshot()
    assert np.abs(mega.astype(int) - xla.astype(int)).max() <= 1


def test_default_routes_atlas_clip_scene_to_rolled():
    """An atlas-bearing mask-heavy scene must NOT take the megakernel (its
    glyph runs need gathers, which the kernels do not do) — the plan picks
    the rolled executor by shape, stays on pallas, and matches XLA."""
    import numpy as np

    from figdraw_tpu import (
        Fig, FigFlags, FigKind, fill, new_renders, rect, rgba, vec2,
    )
    from figdraw_tpu import executor as ex
    from figdraw_tpu.nodes import RenderList, Renders
    from figdraw_tpu.renderer import FigRenderer
    from figdraw_tpu.text.layout import typeset
    from figdraw_tpu.text.typefaces import FigFont, load_typeface

    tid = load_typeface("/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf")
    f = FigFont(typeface_id=tid, size=13.0)
    lst = RenderList()
    lst.add_root(Fig(kind=FigKind.nkRectangle, screen_box=rect(0, 0, 360, 280),
                     fill=fill(rgba(248, 249, 251, 255))))
    for row in range(8):
        for col in range(3):
            cell = rect(8 + col * 116, 8 + row * 33, 110, 28)
            ci = lst.add_root(Fig(kind=FigKind.nkRectangle, screen_box=cell,
                                  corners=(5,) * 4,
                                  flags=FigFlags.NfClipContent,
                                  fill=fill(rgba(255, 255, 255, 255))))
            arr = typeset(vec2(140, 24), [(f, fill(rgba(30, 30, 40, 255)),
                                           f"cell r{row}c{col} spills wide")])
            lst.add_child(ci, Fig(kind=FigKind.nkText,
                                  screen_box=rect(cell.x + 4, cell.y + 5, 140, 20),
                                  text_layout=arr))
    scene = Renders()
    scene.set_layer(0, lst)

    r1 = FigRenderer(atlas_size=256, use_pallas=False)
    r1.render_frame(scene, vec2(360, 280))
    ref = r1.take_screenshot()

    mega_hits = []
    orig = ex.get_mega_executor

    def spy(*a, **k):
        mega_hits.append(k)
        return orig(*a, **k)

    ex.get_mega_executor = spy
    try:
        r2 = FigRenderer(atlas_size=256, use_pallas=True)
        r2.render_frame(scene, vec2(360, 280))
    finally:
        ex.get_mega_executor = orig
    assert not mega_hits, "atlas clip scene took the megakernel by default"
    assert r2.use_pallas, "rolled path fell back"
    got = r2.take_screenshot()
    assert np.abs(ref.astype(int) - got.astype(int)).max() <= 1


@pytest.mark.skipif(not native.available(), reason="native flattener not built")
def test_mega_pooled_buffer_reuse_is_clean():
    """The mega fast path exports into the pooled ping-pong upload buffer;
    C++ zeroes the padding rows (fd_export_mega_packed), so rendering a
    bigger scene, then a smaller one, then the bigger one again on the SAME
    renderer must match a fresh renderer pixel-for-pixel — no stale rows or
    stale meta (clear color) may leak between frames."""
    big = from_renders(clip_table(rows=8))
    small = from_renders(clip_table(rows=3))
    ren = FigRenderer(atlas_size=128, use_pallas=True)
    f_big1 = np.asarray(ren.render_frame(big, vec2(256, 200)))
    np.asarray(ren.render_frame(small, vec2(256, 200)))
    f_big2 = np.asarray(ren.render_frame(big, vec2(256, 200)))
    assert ren.use_pallas, "mega path fell back"
    assert np.array_equal(f_big1, f_big2)
    fresh = FigRenderer(atlas_size=128, use_pallas=True)
    f_ref = np.asarray(fresh.render_frame(big, vec2(256, 200)))
    assert np.array_equal(f_big2, f_ref)
