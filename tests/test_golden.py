"""Golden-frame fidelity vs the reference's expected screenshots.

The reference compares one rendered frame against tests/expected/*.png with a
pixie diff score (trender_rgb_boxes_sdf.nim:127-135, threshold 100). We
reproduce the same scenes and compare our device-rasterized frame against the
reference's own golden PNGs (read from the read-only checkout) with a
per-pixel RMSE bound — the BASELINE.json north-star metric.
"""

import os

import numpy as np
import pytest

# reference-PNG fidelity pins: the `./ci.sh quick` tier
pytestmark = pytest.mark.golden

from figdraw_tpu import (
    Fig,
    FigKind,
    FigRenderer,
    RenderShadow,
    RenderStroke,
    ShadowStyle,
    fgaDiagTLBR,
    fgaX,
    fill,
    linear,
    new_renders,
    rect,
    rgba,
    vec2,
)
from figdraw_tpu.nodes import RenderList

EXPECTED_DIR = "/root/reference/tests/expected"


def rgb_boxes_sdf_scene(w, h):
    """Same scene as the reference golden test (trender_rgb_boxes_sdf.nim:13-99)."""
    lst = RenderList()
    root = lst.add_root(Fig(
        kind=FigKind.nkRectangle, screen_box=rect(0, 0, w, h),
        fill=fill(rgba(255, 255, 255, 255)),
    ))
    lst.add_child(root, Fig(
        kind=FigKind.nkRectangle, corners=(10, 20, 30, 40),
        screen_box=rect(60, 60, 220, 140), fill=fill(rgba(220, 40, 40, 255)),
        stroke=RenderStroke(weight=5.0, fill=fill(rgba(0, 0, 0, 255))),
    ))
    lst.add_child(root, Fig(
        kind=FigKind.nkRectangle, screen_box=rect(320, 120, 220, 140),
        fill=linear(rgba(24, 128, 72, 255), rgba(40, 180, 90, 255),
                    rgba(54, 206, 170, 255), axis=fgaX, mid_pos=140),
        shadows=(RenderShadow(style=ShadowStyle.DropShadow, blur=10, spread=10,
                              x=10, y=10, fill=fill(rgba(0, 0, 0, 55))),),
    ))
    lst.add_child(root, Fig(
        kind=FigKind.nkRectangle, screen_box=rect(180, 300, 220, 140),
        fill=fill(rgba(60, 90, 220, 255)),
        shadows=(
            RenderShadow(style=ShadowStyle.InnerShadow, blur=12, spread=0,
                         x=-6, y=-6,
                         fill=linear(rgba(25, 25, 25, 90), rgba(65, 65, 65, 175),
                                     axis=fgaDiagTLBR)),
            RenderShadow(style=ShadowStyle.InnerShadow, blur=12, spread=0,
                         x=6, y=6,
                         fill=linear(rgba(255, 255, 255, 255),
                                     rgba(205, 205, 205, 115), axis=fgaDiagTLBR)),
        ),
    ))
    r = new_renders()
    r.set_layer(0, lst)
    return r


def linear_gradient_scene(w, h):
    """trender_linear_gradient.nim scene."""
    lst = RenderList()
    root = lst.add_root(Fig(
        kind=FigKind.nkRectangle, screen_box=rect(0, 0, w, h),
        fill=fill(rgba(255, 255, 255, 255)),
    ))
    lst.add_child(root, Fig(
        kind=FigKind.nkRectangle, screen_box=rect(80, 80, 440, 120),
        corners=(12, 12, 12, 12),
        fill=linear(rgba(220, 40, 40, 255), rgba(40, 200, 90, 255),
                    rgba(50, 90, 225, 255), axis=fgaX, mid_pos=128),
    ))
    from figdraw_tpu import fgaY

    lst.add_child(root, Fig(
        kind=FigKind.nkRectangle, screen_box=rect(80, 240, 220, 220),
        corners=(10, 10, 10, 10),
        fill=linear(rgba(240, 210, 40, 255), rgba(110, 60, 210, 255), axis=fgaY),
    ))
    lst.add_child(root, Fig(
        kind=FigKind.nkRectangle, screen_box=rect(340, 250, 240, 180),
        fill=fill(rgba(0, 0, 0, 0)),
        stroke=RenderStroke(
            weight=20,
            fill=linear(rgba(245, 70, 70, 255), rgba(70, 115, 245, 255), axis=fgaX),
        ),
    ))
    lst.add_child(root, Fig(
        kind=FigKind.nkRectangle, screen_box=rect(610, 300, 150, 200),
        fill=fill(rgba(245, 245, 245, 255)),
        shadows=(RenderShadow(style=ShadowStyle.DropShadow, blur=6, spread=14,
                              x=0, y=0,
                              fill=linear(rgba(255, 70, 70, 170),
                                          rgba(70, 110, 255, 170), axis=fgaX)),),
    ))
    r = new_renders()
    r.set_layer(0, lst)
    return r


def line_rect_scene(w, h):
    """trender_extras.nim makeLineRenderTree."""
    from figdraw_tpu.extras import fig_line_xy

    lst = RenderList()
    root = lst.add_root(Fig(
        kind=FigKind.nkRectangle, screen_box=rect(0, 0, w, h),
        fill=fill(rgba(255, 255, 255, 255)),
    ))
    lst.add_child(root, fig_line_xy(90.0, 120.0, 710.0, 470.0, rgba(0, 0, 0, 255), 48.0))
    r = new_renders()
    r.set_layer(0, lst)
    return r


def circle_rect_scene(w, h):
    """trender_extras.nim makeCircleRenderTree."""
    from figdraw_tpu.extras import fig_circle_xy

    lst = RenderList()
    root = lst.add_root(Fig(
        kind=FigKind.nkRectangle, screen_box=rect(0, 0, w, h),
        fill=fill(rgba(255, 255, 255, 255)),
    ))
    lst.add_child(root, fig_circle_xy(400.0, 300.0, rgba(0, 0, 0, 255), 110.0))
    r = new_renders()
    r.set_layer(0, lst)
    return r


# The fidelity bar: BASELINE.json's north star is per-pixel RMSE < 1e-3
# against the reference's own golden PNGs on the XLA path. The Pallas kernel
# is held to the same golden with the documented kernel tolerance on top
# (pallas == XLA within 1/255, test_raster.py), so a Pallas-only fidelity
# regression fails the golden suite directly.
GOLDEN_RMSE_BOUND = 1e-3
PALLAS_EXTRA = 1.0 / 255.0


def _golden_compare(scene_fn, golden_name, rmse_bound=GOLDEN_RMSE_BOUND,
                    bad_bound=1e-3, use_pallas=False):
    from PIL import Image

    expected = np.asarray(
        Image.open(os.path.join(EXPECTED_DIR, golden_name)).convert("RGBA"),
        dtype=np.float32,
    )
    h, w = expected.shape[:2]
    ren = FigRenderer(atlas_size=64, use_pallas=use_pallas)
    ren.render_frame(scene_fn(float(w), float(h)), vec2(w, h))
    got = ren.take_screenshot().astype(np.float32)
    diff = np.abs(got[..., :3] - expected[..., :3]) / 255.0
    rmse = float(np.sqrt((diff ** 2).mean()))
    bad = (diff.max(axis=-1) > 32 / 255.0).mean()
    if use_pallas:
        rmse_bound += PALLAS_EXTRA
    print(f"{golden_name} pallas={use_pallas}: "
          f"rmse={rmse:.5f} bad_pixel_ratio={bad:.5f}")
    if rmse >= rmse_bound and os.environ.get("FIGDRAW_DUMP_GOLDEN"):
        Image.fromarray(got.astype(np.uint8)).save(f"/tmp/golden_got_{golden_name}")
    assert rmse < rmse_bound, f"{golden_name} rmse {rmse}"
    assert bad < bad_bound, f"{golden_name} bad pixel ratio {bad}"


goldens = pytest.mark.skipif(
    not os.path.isdir(EXPECTED_DIR), reason="reference goldens not mounted"
)
pallas_param = pytest.mark.parametrize("use_pallas", [False, True],
                                       ids=["xla", "pallas"])


@goldens
@pallas_param
def test_rgb_boxes_sdf_golden(use_pallas):
    # GL golden was rendered by LLVMpipe with its own rounding; SURVEY.md §7
    # budgets an RMSE bound (north star < 1e-3) rather than bit-exactness.
    _golden_compare(rgb_boxes_sdf_scene, "render_rgb_boxes_sdf.png",
                    use_pallas=use_pallas)


# render_rgb_boxes.png (non-sdf) is the reference's LEGACY CPU-texture path
# (-d:useFigDrawTextures, figrender.nim:16-17) whose shadows differ from its
# own SDF renderer; the SDF golden above is the live path's ground truth.


@goldens
@pallas_param
def test_linear_gradient_golden(use_pallas):
    _golden_compare(linear_gradient_scene, "render_linear_gradient.png",
                    use_pallas=use_pallas)


@goldens
@pallas_param
def test_line_rect_golden(use_pallas):
    _golden_compare(line_rect_scene, "render_line_rect.png",
                    use_pallas=use_pallas)


@goldens
@pallas_param
def test_circle_rect_golden(use_pallas):
    _golden_compare(circle_rect_scene, "render_circle_rect.png",
                    use_pallas=use_pallas)


def image_scene(w, h, image_id):
    """trender_image.nim scene: img1.png at (60,60,160,160) over gray."""
    from figdraw_tpu import FigKind, image_style

    lst = RenderList()
    root = lst.add_root(Fig(
        kind=FigKind.nkRectangle, screen_box=rect(0, 0, w, h),
        fill=fill(rgba(160, 160, 160, 255)),
    ))
    lst.add_child(root, Fig(
        kind=FigKind.nkImage, screen_box=rect(60, 60, 160, 160),
        image=image_style(image_id),
    ))
    r = new_renders()
    r.set_layer(0, lst)
    return r


@goldens
@pallas_param
def test_image_golden(use_pallas):
    """Image golden incl. the GL margin-bleed semantics: bilinear at image
    borders blends the transparent atlas margin (entries are inset by margin
    on every side, atlas.py _find_empty_rect), darkening edge rows ~15%
    toward the backdrop exactly like the reference's straight-alpha blend."""
    from PIL import Image

    from figdraw_tpu.resources import ImageMessageBus, put_image

    expected = np.asarray(
        Image.open(os.path.join(EXPECTED_DIR, "render_image.png")).convert("RGBA"),
        dtype=np.float32,
    )
    h, w = expected.shape[:2]
    src = np.asarray(
        Image.open("/root/reference/data/img1.png").convert("RGBA")
    )
    bus = ImageMessageBus()
    ren = FigRenderer(atlas_size=512, use_pallas=use_pallas)
    ren.ensure_image_message_subscription(bus)
    put_image(4242, src, bus=bus)
    ren.render_frame(image_scene(float(w), float(h), 4242), vec2(w, h))
    got = ren.take_screenshot().astype(np.float32)
    diff = np.abs(got[..., :3] - expected[..., :3]) / 255.0
    rmse = float(np.sqrt((diff ** 2).mean()))
    bad = (diff.max(axis=-1) > 32 / 255.0).mean()
    print(f"render_image.png pallas={use_pallas}: rmse={rmse:.5f} bad={bad:.5f}")
    bound = GOLDEN_RMSE_BOUND + (PALLAS_EXTRA if use_pallas else 0.0)
    assert rmse < bound, rmse
    assert bad < 1e-3, bad
