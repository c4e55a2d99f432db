"""Fallbacks that remain (SURVEY.md §5.3 analog).

The reference falls back from a failed Vulkan/Metal context to OpenGL at
runtime. Here the rasterizer is an explicit choice and a failing kernel
raises (tests/test_triton_kernels.py); what still falls back is the native
flattener, to the bit-identical Python walk, plus cache hygiene under long
frame loops."""

import numpy as np

from figdraw_tpu import Fig, FigKind, FigRenderer, fill, new_renders, rect, rgba, vec2
from figdraw_tpu.nodes import RenderList


def scene():
    lst = RenderList()
    lst.add_root(Fig(kind=FigKind.nkRectangle, screen_box=rect(8, 8, 40, 30),
                     fill=fill(rgba(255, 0, 0, 255))))
    r = new_renders()
    r.set_layer(0, lst)
    return r


def test_native_flatten_falls_back_to_python_walk():
    """Scenes with kinds the native walk can't handle use the Python walk."""
    from figdraw_tpu.nodes import drawable_line
    from figdraw_tpu.nodesarray import from_renders

    r = new_renders()
    lst = RenderList()
    lst.add_root(Fig(kind=FigKind.nkDrawable, screen_box=rect(0, 0, 64, 48),
                     draw_stroke=__import__("figdraw_tpu").RenderStroke(
                         weight=3.0, fill=fill(rgba(0, 0, 255, 255))),
                     draw_ops=(drawable_line(vec2(5, 5), vec2(50, 40)),)))
    r.set_layer(0, lst)
    arr = from_renders(r)
    ren = FigRenderer(atlas_size=64, use_pallas=False)
    ren.render_frame(arr, vec2(64, 48))  # must not raise
    img = ren.take_screenshot()
    assert (img[..., 2] > 180).sum() > 20


def test_soak_bounded_caches():
    """Frame-loop soak: repeated varied renders keep the executor caches and
    typeset cache bounded (production loop hygiene)."""
    from figdraw_tpu import Fig, FigKind, fill, rect, rgba, vec2, new_renders
    from figdraw_tpu import executor as ex
    from figdraw_tpu.nodesarray import from_renders
    from figdraw_tpu.text import layout as layout_mod

    ren = FigRenderer(atlas_size=128, use_pallas=False)
    for i in range(40):
        renders = new_renders()
        renders.add_root(0, Fig(
            kind=FigKind.nkRectangle, screen_box=rect(0, 0, 96, 64),
            fill=fill(rgba(10 + i * 5 % 200, 50, 90, 255)),
            corners=(i % 9,) * 4,
        ))
        ren.render_frame(from_renders(renders), vec2(96, 64))
    info = ex.get_frame_executor.cache_info()
    assert info.currsize <= 64
    if layout_mod._typeset_cache is not None:
        assert len(layout_mod._typeset_cache) <= layout_mod._TYPESET_CACHE_CAP
