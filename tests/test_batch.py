"""render_batch: chunked single-dispatch offline rendering.

Frames whose pass structure matches are stacked into ONE upload + ONE
lax.map dispatch (executor.get_batch_runner); everything else falls back to
per-frame dispatch in order. These tests pin the contract: batched output ==
the per-frame render_frame output BIT-EXACTLY on every executor path
(unrolled / rolled / mega), across structure changes mid-batch, through the
pow2 padding, and past the native combo pool's two-buffer ping-pong.
"""

import numpy as np
import pytest

# heavyweight end-to-end frame-loop suite: excluded by `./ci.sh fast` (-m 'not slow')
pytestmark = pytest.mark.slow

from figdraw_tpu import (
    Fig, FigFlags, FigKind, fill, new_renders, rect, rgba, vec2,
)
from figdraw_tpu.nodes import RenderList
from figdraw_tpu.nodesarray import from_renders
from figdraw_tpu.renderer import FigRenderer


def simple_scene(frame, n=40):
    lst = RenderList()
    for i in range(n):
        lst.add_root(Fig(kind=FigKind.nkRectangle,
                         screen_box=rect(4 + (i % 8) * 14 + frame,
                                         6 + (i // 8) * 20, 36, 28),
                         corners=(4,) * 4,
                         fill=fill(rgba(60 + i * 4, (i * 31) % 255, 180, 155))))
    r = new_renders()
    r.set_layer(0, lst)
    return from_renders(r)


def clip_scene(frame, rows=6, cols=5, w=224.0, h=160.0):
    """Mask-heavy (rows*cols clip cells): rolled executor under XLA, the
    megakernel under Pallas."""
    renders = new_renders()
    renders.add_root(0, Fig(kind=FigKind.nkRectangle,
                            screen_box=rect(0, 0, w, h),
                            fill=fill(rgba(250, 250, 250, 255))))
    for r in range(rows):
        for c in range(cols):
            cell = renders.add_root(0, Fig(
                kind=FigKind.nkRectangle,
                screen_box=rect(4 + c * 42 + (frame % 5), 2 + r * 26, 36, 20),
                corners=(5, 5, 5, 5), flags=FigFlags.NfClipContent,
                fill=fill(rgba(200 - r * 9, 60 + c * 20, 120, 255)),
            ))
            renders.add_child(0, cell, Fig(
                kind=FigKind.nkRectangle, screen_box=rect(0, 0, 300, 300),
                fill=fill(rgba(30, 30, 220, 120)), rotation=10.0 + frame,
            ))
    return from_renders(renders)


def blur_scene(frame):
    """Backdrop blur with an animated radius: the blur radius is a varying
    per-frame array on every executor path."""
    renders = new_renders()
    renders.add_root(0, Fig(kind=FigKind.nkRectangle,
                            screen_box=rect(0, 0, 160, 128),
                            fill=fill(rgba(240, 240, 240, 255))))
    for i in range(12):
        renders.add_root(0, Fig(kind=FigKind.nkRectangle,
                                screen_box=rect(6 + i * 12, 10 + (i % 3) * 30,
                                                30, 24),
                                fill=fill(rgba(30 + i * 15, 90, 200, 255))))
    from figdraw_tpu.nodes import BackdropBlurStyle

    renders.add_root(0, Fig(kind=FigKind.nkBackdropBlur,
                            screen_box=rect(30, 30, 90, 70),
                            backdrop_blur=BackdropBlurStyle(
                                blur=4.0 + 2.0 * (frame % 3)),
                            fill=fill(rgba(255, 255, 255, 60))))
    return from_renders(renders)


def _check_batch(scene_fn, size, frames, use_pallas, chunk=4, atlas_size=64,
                 mesh=None):
    batch_r = FigRenderer(atlas_size=atlas_size, use_pallas=use_pallas)
    ref_r = FigRenderer(atlas_size=atlas_size, use_pallas=use_pallas)
    out = batch_r.render_batch([scene_fn(f) for f in range(frames)], size,
                               chunk=chunk, mesh=mesh)
    h, w = int(size.y), int(size.x)
    assert out.shape == (frames, h, w, 4)
    for f in range(frames):
        expect = np.asarray(ref_r.render_frame(scene_fn(f), size))
        np.testing.assert_array_equal(np.asarray(out[f]), expect,
                                      err_msg=f"frame {f}")
    # the batched path must not have tripped a fallback that disabled pallas
    assert batch_r.use_pallas == use_pallas


def test_batch_simple_unrolled_xla():
    # 5 frames, chunk 4: one full chunk + one single-dispatch remainder,
    # and 5 > the native combo pool's ping-pong of 2 (copies are pinned)
    _check_batch(simple_scene, vec2(160, 128), 5, use_pallas=False)


def test_batch_simple_unrolled_pallas():
    _check_batch(simple_scene, vec2(160, 128), 3, use_pallas=True)


def test_batch_rolled_xla():
    _check_batch(clip_scene, vec2(224, 160), 3, use_pallas=False)


def test_batch_mega_pallas():
    _check_batch(clip_scene, vec2(224, 160), 3, use_pallas=True)


def test_batch_blur_radii_vary():
    _check_batch(blur_scene, vec2(160, 128), 3, use_pallas=False)


def test_batch_mixed_structure():
    """Structure changes mid-sequence split groups; order is preserved."""
    size = vec2(224, 160)
    scenes = [simple_scene(0), simple_scene(1), clip_scene(0), clip_scene(1),
              simple_scene(2)]
    batch_r = FigRenderer(atlas_size=64, use_pallas=False)
    ref_r = FigRenderer(atlas_size=64, use_pallas=False)
    out = batch_r.render_batch(scenes, size, chunk=4)
    rebuilt = [simple_scene(0), simple_scene(1), clip_scene(0), clip_scene(1),
               simple_scene(2)]
    assert out.shape[0] == 5
    for f, sc in enumerate(rebuilt):
        expect = np.asarray(ref_r.render_frame(sc, size))
        np.testing.assert_array_equal(np.asarray(out[f]), expect,
                                      err_msg=f"frame {f}")


def test_batch_pow2_padding():
    """3 frames pad the dispatch to 4; padding is sliced off the result."""
    _check_batch(simple_scene, vec2(160, 128), 3, use_pallas=False, chunk=8)


def test_batch_empty():
    r = FigRenderer(atlas_size=64, use_pallas=False)
    out = r.render_batch([], vec2(64, 48))
    assert out.shape == (0, 48, 64, 4)


def _needs_mesh():
    """The frame-parallel legs exercise a REAL multi-device shard; on a
    single-device host (one GPU; CPU tests get 8 virtual devices from
    conftest) a 1-wide mesh would trivially pass."""
    import jax

    if len(jax.devices()) < 2:
        pytest.skip("needs a multi-device mesh (single-chip environment)")


def test_batch_frame_parallel_mesh():
    """Frame-parallel offline rendering: the chunk's frame axis shards over
    the full device mesh (each device renders whole frames, no collectives)
    and must stay bit-exact vs the per-frame path — including a frame count
    that is neither a multiple of the mesh size nor a power of two."""
    import jax
    from figdraw_tpu.parallel.sharding import frames_mesh

    _needs_mesh()
    mesh = frames_mesh()
    assert mesh.devices.size == len(jax.devices())
    _check_batch(simple_scene, vec2(160, 128), 11, use_pallas=False,
                 chunk=2, mesh=mesh)


def test_batch_frame_parallel_mesh_rolled():
    from figdraw_tpu.parallel.sharding import frames_mesh

    _needs_mesh()
    _check_batch(clip_scene, vec2(224, 160), 5, use_pallas=False,
                 chunk=1, mesh=frames_mesh())


def test_batch_as_uint8_matches_screenshot():
    """Device-side u8 quantization == take_screenshot's host readback."""
    size = vec2(160, 128)
    batch_r = FigRenderer(atlas_size=64, use_pallas=False)
    ref_r = FigRenderer(atlas_size=64, use_pallas=False)
    out = batch_r.render_batch([simple_scene(f) for f in range(3)], size,
                               as_uint8=True)
    assert out.dtype == np.uint8
    for f in range(3):
        frame = ref_r.render_frame(simple_scene(f), size)
        expect = ref_r.take_screenshot(frame)
        np.testing.assert_array_equal(np.asarray(out[f]), expect,
                                      err_msg=f"frame {f}")
