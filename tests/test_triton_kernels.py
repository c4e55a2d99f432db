"""The Pallas tile kernels on the Triton route, tested without a GPU.

Interpret mode runs the kernels' semantics on the CPU (the parity tests in
test_raster.py / test_mega.py / test_golden*.py); these tests cover what
interpret mode cannot: that every kernel lowers through Triton for CUDA and
passes MLIR verification, the wrapper's block-to-bin mapping and padding,
the megakernel/rolled choice by shape, the platform rule for interpret
mode, and that a kernel failure raises instead of silently switching to
XLA. The `gpu` test compiles the kernels for real and needs a card.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from figdraw_tpu import Fig, FigFlags, FigKind, fill, new_renders, rect, rgba, vec2
from figdraw_tpu.nodesarray import from_renders
from figdraw_tpu.ops import raster_pallas as rp
from figdraw_tpu.ops import raster_ref
from figdraw_tpu.ops.layout import QF_WIDTH, QI_WIDTH
from figdraw_tpu.renderer import FigRenderer, _bucket


def _tape_arrays(renders, w, h):
    tape = FigRenderer(atlas_size=64, use_pallas=False).flatten(renders, vec2(w, h))
    n = _bucket(max(tape.count, 1))
    f = np.zeros((n, QF_WIDTH), np.float32)
    m = np.zeros((n, QI_WIDTH), np.int32)
    f[: tape.count] = tape.fields[: tape.count]
    m[: tape.count] = tape.modes[: tape.count]
    return jnp.asarray(f), jnp.asarray(m), tape


def _boxes(w, h, n=12):
    renders = new_renders()
    renders.add_root(0, Fig(kind=FigKind.nkRectangle, screen_box=rect(0, 0, w, h),
                            fill=fill(rgba(245, 245, 250, 255))))
    for i in range(n):
        renders.add_root(0, Fig(
            kind=FigKind.nkRectangle,
            screen_box=rect(3 + (i * 37) % (w - 30), 2 + (i * 23) % (h - 20), 28, 18),
            corners=(4,) * 4, fill=fill(rgba(40 + i * 15, 90, 200 - i * 9, 170))))
    return renders


def _clip_cells(n_cells):
    """n_cells clip cells in a row: one clip plane per cell nesting level."""
    renders = new_renders()
    for i in range(n_cells):
        cell = renders.add_root(0, Fig(
            kind=FigKind.nkRectangle, screen_box=rect(4 + i * 12, 4, 10, 40),
            corners=(3,) * 4, flags=FigFlags.NfClipContent,
            fill=fill(rgba(200, 100, 100, 255))))
        renders.add_child(0, cell, Fig(
            kind=FigKind.nkRectangle, screen_box=rect(0, 0, 200, 200),
            fill=fill(rgba(0, 0, 200, 120))))
    return renders


def _nested_clips(depth):
    """One chain of `depth` nested clip nodes: depth mask planes live at once."""
    renders = new_renders()
    parent = None
    for d in range(depth):
        fig = Fig(kind=FigKind.nkRectangle,
                  screen_box=rect(2 + d * 3, 2 + d * 2, 120 - d * 6, 60 - d * 4),
                  corners=(4,) * 4, flags=FigFlags.NfClipContent,
                  fill=fill(rgba(30 + d * 20, 140, 200 - d * 15, 200)))
        parent = (renders.add_root(0, fig) if parent is None
                  else renders.add_child(0, parent, fig))
    return renders


# --- every kernel lowers through Triton for CUDA and verifies --------------


def _verifying_lowering(monkeypatch):
    """Run the MLIR verifier on each Triton module as it is built: the GPU
    compiler refuses a module that fails it, and only the card would say so
    otherwise."""
    from jax._src.pallas.triton import lowering as tl

    orig = tl.lower_jaxpr_to_triton_module
    verified = []

    def checked(*a, **k):
        res = orig(*a, **k)
        with res.module.context:
            assert res.module.operation.verify()
        verified.append(res)
        return res

    monkeypatch.setattr(tl, "lower_jaxpr_to_triton_module", checked)
    return verified


def _kernel_cases():
    n, h, w = 64, 130, 200
    f = jnp.zeros((n, QF_WIDTH), jnp.float32)
    m = jnp.zeros((n, QI_WIDTH), jnp.int32)
    frame = jnp.ones((h, w, 4), jnp.float32)
    masks = jnp.ones((2, h, w), jnp.float32)
    ph, pw = rp.padded_size(h, w)
    planes = jnp.ones((4, ph, pw), jnp.float32)
    masks_p = jnp.ones((2, ph, pw), jnp.float32)
    return {
        "tile": (lambda f, m, fr, mk: rp.draw_pass_frame(f, m, jnp.int32(5), fr, mk),
                 (f, m, frame, masks)),
        "tile_backdrop": (
            lambda f, m, fr, mk: rp.draw_pass_frame(
                f, m, jnp.int32(5), fr, mk, backdrop=fr),
            (f, m, frame, masks)),
        "mask_target": (
            lambda f, m, fp, mk: rp.draw_pass_mask_prebinned(
                f, m, 0, 5, *rp.prebin(f, jnp.int32(n), ph, pw), fp[:1], mk),
            (f, m, planes, masks_p)),
        "mega": (lambda f, m, fp: rp.draw_pass_mega(f, m, fp, 3), (f, m, planes)),
    }


@pytest.mark.parametrize("kernel", ["tile", "tile_backdrop", "mask_target", "mega"])
def test_kernel_lowers_through_triton_for_cuda(kernel, monkeypatch):
    verified = _verifying_lowering(monkeypatch)
    # trace as the GPU would: compiled kernels, not interpret mode
    monkeypatch.setattr(rp, "_interpret", lambda platform=None: False)
    fn, args = _kernel_cases()[kernel]
    jax.clear_caches()  # no trace cached under interpret mode may be reused
    try:
        text = jax.jit(fn).trace(*args).lower(
            lowering_platforms=("cuda",)).as_text()
    finally:
        jax.clear_caches()
    assert "__gpu$xla.gpu.triton" in text
    assert verified, "no Triton module was built"


# --- wrapper geometry ------------------------------------------------------


@pytest.mark.parametrize("bin_h,bin_w", [(64, 128), (32, 128), (128, 128)])
def test_blocks_map_to_the_bin_that_contains_them(bin_h, bin_w):
    ph, pw = rp.padded_size(300, 500, bin_h, bin_w)
    assert ph % bin_h == 0 and pw % bin_w == 0
    grid, _block_map, _spec, (sub_y, sub_x, bins_x) = rp._grid_specs(
        ph, pw, bin_h, bin_w, 64)
    assert grid == (ph // rp.TILE_H, pw // rp.TILE_W)
    for ty in range(grid[0]):
        for tx in range(grid[1]):
            b = rp._bin_of(ty, tx, sub_y, sub_x, bins_x)
            # the block's top-left pixel lies inside bin b
            y, x = ty * rp.TILE_H, tx * rp.TILE_W
            assert b == (y // bin_h) * (pw // bin_w) + x // bin_w


@pytest.mark.parametrize("h,w", [(37, 53), (64, 128), (130, 200)])
def test_frame_pads_to_whole_bins_and_crops(h, w):
    f, m, tape = _tape_arrays(_boxes(w, h), w, h)
    frame = jnp.full((h, w, 4), 0.5, jnp.float32)
    masks = jnp.ones((1, h, w), jnp.float32)
    got = rp.draw_pass_frame(f, m, jnp.int32(tape.count), frame, masks)
    want = raster_ref.draw_pass_frame(f, m, jnp.int32(tape.count), frame, masks)
    assert got.shape == (h, w, 4)
    assert float(jnp.abs(got - want).max()) <= 1.0 / 255.0


# --- megakernel or rolled executor: chosen by shape ------------------------


@pytest.mark.parametrize("depth", [2, rp.MEGA_MAX_MASKS + 1])
def test_mega_or_rolled_is_chosen_by_mask_planes(depth, monkeypatch):
    import figdraw_tpu.renderer as renderer_mod

    # enough items to take the multi-item executors at a small size
    monkeypatch.setattr(renderer_mod, "ROLLED_THRESHOLD", 4)
    renders = _nested_clips(depth)
    ren = FigRenderer(atlas_size=64, use_pallas=True)
    tape = ren.flatten(renders, vec2(128, 64))
    plan = ren._plan_execution(tape)
    assert plan.n_masks == depth + 1
    assert plan.rolled
    assert (plan.mega_combo is not None) == rp.mega_fits(plan.n_masks)
    got = np.asarray(ren._dispatch_execution(plan))
    ref = FigRenderer(atlas_size=64, use_pallas=False)
    want = np.asarray(ref.execute(ref.flatten(renders, vec2(128, 64))))
    assert np.abs(got - want).max() <= 1.0 / 255.0


def test_megakernel_refuses_more_planes_than_it_carries():
    f = jnp.zeros((64, QF_WIDTH), jnp.float32)
    m = jnp.zeros((64, QI_WIDTH), jnp.int32)
    with pytest.raises(ValueError, match="rolled executor"):
        rp.draw_pass_mega(f, m, jnp.ones((4, 64, 128), jnp.float32),
                          rp.MEGA_MAX_MASKS + 1)


# --- interpret mode follows the platform -----------------------------------


@pytest.mark.parametrize("platform,interpret", [("cpu", True), ("gpu", False)])
def test_interpret_mode_follows_the_platform(platform, interpret):
    assert rp._interpret(platform) is interpret


def test_interpret_mode_refuses_other_platforms():
    with pytest.raises(RuntimeError, match="use_pallas=False"):
        rp._interpret("metal")


# --- a kernel failure raises; nothing switches to XLA ----------------------


@pytest.mark.parametrize("path", ["tile", "mega"])
def test_kernel_failure_raises(path, monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("kernel failed")

    if path == "tile":
        monkeypatch.setattr(rp, "_raster_tiles", boom)
        renders = _boxes(64, 48)
    else:
        import figdraw_tpu.renderer as renderer_mod

        monkeypatch.setattr(renderer_mod, "ROLLED_THRESHOLD", 4)
        monkeypatch.setattr(rp, "_raster_mega", boom)
        renders = _clip_cells(6)
    ren = FigRenderer(atlas_size=64, use_pallas=True)
    jax.clear_caches()  # executors traced earlier would not call the patch
    with pytest.raises(RuntimeError, match="kernel failed"):
        ren.render_frame(from_renders(renders), vec2(96, 64))
    assert ren.use_pallas is True


# --- on the card -----------------------------------------------------------


@pytest.mark.gpu
def test_compiled_kernels_match_the_reference(gpu_device):
    assert not rp._interpret()
    w, h = 320, 200
    f, m, tape = _tape_arrays(_boxes(w, h, n=40), w, h)
    frame = jnp.ones((h, w, 4), jnp.float32)
    masks = jnp.ones((1, h, w), jnp.float32)
    got = rp.draw_pass_frame(f, m, jnp.int32(tape.count), frame, masks)
    want = raster_ref.draw_pass_frame(f, m, jnp.int32(tape.count), frame, masks)
    assert float(jnp.abs(got - want).max()) <= 1.0 / 255.0
