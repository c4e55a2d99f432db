"""render_3d_overlay golden: the reference's raw-GL 3D sandwich reproduced
with a numpy 3D rasterizer composited as an external layer.

The reference draws a spinning pyramid with raw OpenGL underneath the figdraw
UI pass (tests/trender_3d_overlay.nim: perspective + lookAt + rotation MVP,
vertex-color triangles with a depth buffer, LLVMpipe). Here there is no GL
interop; the equivalent is frame-layer composition — here the pyramid is
rasterized by a ~60-line numpy renderer (perspective-correct vertex colors,
z-buffer, GL screen mapping) and injected through
FigRenderer.render_frame_with_overlays below the UI layers.
"""

import os

import numpy as np
import pytest

# reference-PNG fidelity pins: the `./ci.sh quick` tier
pytestmark = pytest.mark.golden

from figdraw_tpu import (
    Fig, FigKind, FigRenderer, RenderShadow, RenderStroke, ShadowStyle, fill,
    new_renders, rect, rgba, vec2,
)
from figdraw_tpu.nodes import RenderList

EXPECTED_DIR = "/root/reference/tests/expected"

goldens = pytest.mark.skipif(
    not os.path.isdir(EXPECTED_DIR), reason="reference goldens not mounted"
)


# --- the reference's pyramid (trender_3d_overlay.nim:34-280) --------------------

def _perspective(fovy_deg, aspect, near, far):
    f = 1.0 / np.tan(np.radians(fovy_deg) * 0.5)
    m = np.zeros((4, 4), np.float64)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = (far + near) / (near - far)
    m[2, 3] = 2.0 * far * near / (near - far)
    m[3, 2] = -1.0
    return m


def _look_at(eye, center, up):
    """The reference's mat4LookAt puts s/u/-f in the matrix COLUMNS (the
    transpose of the usual view rotation — trender_3d_overlay.nim:71-86).
    The golden was rendered with it, so reproduce it exactly."""
    f = center - eye
    f /= np.linalg.norm(f)
    s = np.cross(f, up)
    s /= np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4)
    m[:3, 0], m[:3, 1], m[:3, 2] = s, u, -f
    m[0, 3], m[1, 3], m[2, 3] = -s @ eye, -u @ eye, f @ eye
    return m


def _rot_y(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, 0], [0, 0, 0, 1]])


def _rot_x(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[1, 0, 0, 0], [0, c, -s, 0], [0, s, c, 0], [0, 0, 0, 1]])


def rasterize_pyramid(w: int, h: int, t: float = 0.4) -> np.ndarray:
    """Returns (h, w, 4) f32: the pyramid over the GL clear color, opaque."""
    verts = np.array([
        [-0.5, 0.0, -0.5], [0.5, 0.0, -0.5], [0.5, 0.0, 0.5],
        [-0.5, 0.0, 0.5], [0.0, 0.8, 0.0],
    ])
    colors = np.array([
        [1.0, 0.2, 0.2], [0.2, 1.0, 0.2], [0.2, 0.2, 1.0],
        [1.0, 1.0, 0.2], [1.0, 0.2, 1.0],
    ])
    tris = [(0, 1, 4), (1, 2, 4), (2, 3, 4), (3, 0, 4), (0, 1, 2), (2, 3, 0)]

    proj = _perspective(45.0, w / h, 0.1, 100.0)
    view = _look_at(np.array([1.6, 1.1, 2.2]), np.array([0.0, 0.25, 0.0]),
                    np.array([0.0, 1.0, 0.0]))
    model = _rot_y(t * 0.9) @ _rot_x(-0.4)
    mvp = proj @ view @ model

    clip = (mvp @ np.concatenate([verts, np.ones((5, 1))], axis=1).T).T
    ndc = clip[:, :3] / clip[:, 3:4]
    sx = (ndc[:, 0] + 1.0) * 0.5 * w
    sy = (1.0 - ndc[:, 1]) * 0.5 * h  # GL origin bottom-left → image top-left
    sz = ndc[:, 2]
    inv_w = 1.0 / clip[:, 3]

    frame = np.empty((h, w, 4), np.float32)
    frame[..., :3] = (0.08, 0.10, 0.14)  # glClearColor
    frame[..., 3] = 1.0
    zbuf = np.full((h, w), np.inf, np.float64)

    yy, xx = np.mgrid[0:h, 0:w]
    px = xx + 0.5
    py = yy + 0.5
    for ia, ib, ic in tris:
        ax, ay, bx, by, cx, cy = sx[ia], sy[ia], sx[ib], sy[ib], sx[ic], sy[ic]
        area = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
        if abs(area) < 1e-12:
            continue
        w0 = ((bx - px) * (cy - py) - (by - py) * (cx - px)) / area
        w1 = ((cx - px) * (ay - py) - (cy - py) * (ax - px)) / area
        w2 = 1.0 - w0 - w1
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
        # z (NDC) interpolates linearly in screen space; colors are
        # perspective-correct (attr/w over 1/w)
        z = w0 * sz[ia] + w1 * sz[ib] + w2 * sz[ic]
        hit = inside & (z < zbuf)
        if not hit.any():
            continue
        denom = w0 * inv_w[ia] + w1 * inv_w[ib] + w2 * inv_w[ic]
        for ch in range(3):
            attr = (
                w0 * colors[ia, ch] * inv_w[ia]
                + w1 * colors[ib, ch] * inv_w[ib]
                + w2 * colors[ic, ch] * inv_w[ic]
            ) / denom
            frame[..., ch] = np.where(hit, attr, frame[..., ch])
        zbuf = np.where(hit, z, zbuf)
    return frame


def make_overlay_ui(w: float, h: float):
    """trender_3d_overlay.nim makeOverlay (:261-315)."""
    lst = RenderList()
    root = lst.add_root(Fig(
        kind=FigKind.nkRectangle, screen_box=rect(0, 0, w, h),
        fill=fill(rgba(0, 0, 0, 0)),
    ))
    pad = 24.0
    panel_w = min(320.0, w * 0.4)
    panel = rect(w - panel_w - pad, pad, panel_w, h - pad * 2)
    panel_idx = lst.add_child(root, Fig(
        kind=FigKind.nkRectangle, screen_box=panel,
        fill=fill(rgba(20, 22, 32, 220)),
        stroke=RenderStroke(weight=1.5, fill=fill(rgba(255, 255, 255, 40))),
        corners=(12, 12, 12, 12),
        shadows=(RenderShadow(style=ShadowStyle.DropShadow, blur=18, spread=0,
                              x=0, y=10, fill=fill(rgba(0, 0, 0, 60))),),
    ))
    button_pad = 18.0
    button_w = panel.w - button_pad * 2
    y = panel.y + button_pad
    for i in range(4):
        lst.add_child(panel_idx, Fig(
            kind=FigKind.nkRectangle,
            screen_box=rect(panel.x + button_pad, y, button_w, 34.0),
            fill=fill(rgba(40 + i * 8, 90, 160, 200)),
            corners=(8, 8, 8, 8),
        ))
        y += 46.0
    r = new_renders()
    r.set_layer(0, lst)
    return r


def _render_overlay(w, h, pyramid, legacy_shadow: bool, use_pallas=False):
    """Render the UI-over-pyramid sandwich; legacy_shadow remaps drop-shadow
    quads (mode 7) to the LEGACY LINEAR falloff (mode 21) the golden was
    generated with — see the profile measurement in test_3d_overlay_golden."""
    from figdraw_tpu.ops.layout import QI_MODE

    ren = FigRenderer(atlas_size=256, use_pallas=use_pallas)
    if not legacy_shadow:
        frame = ren.render_frame_with_overlays(
            make_overlay_ui(float(w), float(h)), vec2(w, h), {0: pyramid},
        )
        return np.asarray(frame)
    # reproduce render_frame_with_overlays for the single-overlay case, with
    # the tape's shadow modes rewritten before execution
    import jax.numpy as jnp

    ren.last_frame = jnp.asarray(pyramid, jnp.float32)
    tape = ren.flatten(make_overlay_ui(float(w), float(h)), vec2(w, h),
                       clear_main=False)
    base = tape.modes[: tape.count, QI_MODE] % 128
    tape.modes[: tape.count, QI_MODE] += np.where(base == 7, 14, 0)
    return np.asarray(ren.execute(tape))


@goldens
@pytest.mark.parametrize("use_pallas", [False, True], ids=["xla", "pallas"])
def test_3d_overlay_golden(use_pallas):
    from PIL import Image

    expected = np.asarray(
        Image.open(os.path.join(EXPECTED_DIR, "render_3d_overlay.png")).convert("RGBA"),
        dtype=np.float32,
    )
    h, w = expected.shape[:2]
    pyramid = rasterize_pyramid(w, h)
    extra = (1.0 / 255.0) if use_pallas else 0.0  # documented kernel tolerance

    def score(frame):
        got = (np.clip(frame, 0.0, 1.0) * 255.0).round()
        diff = np.abs(got[..., :3] - expected[..., :3]) / 255.0
        return (
            float(np.sqrt((diff ** 2).mean())),
            float((diff.max(axis=-1) > 32 / 255.0).mean()),
        )

    # The golden predates the reference's gaussian shadowProfile calibration
    # (atlas.frag:211-216): its measured panel-shadow falloff is exactly
    # linear, alpha = A * clamp(1 - sd/blur, 0, 1), with a hard cutoff at
    # sd = blur (verified against the flat-background profile rows above and
    # below the panel; the gaussian renders rmse = 0.0015, all of it in the
    # shadow band, with the pyramid region at 3e-5). Pin the golden with the
    # legacy profile (mode 21) at the 1e-3 north star.
    rmse, bad = score(_render_overlay(w, h, pyramid, legacy_shadow=True,
                                      use_pallas=use_pallas))
    print(f"render_3d_overlay (legacy shadow) pallas={use_pallas}: "
          f"rmse={rmse:.5f} bad={bad:.5f}")
    assert rmse < 0.001 + extra, rmse
    assert bad < 0.001, bad

    # and the CURRENT reference shader semantics (gaussian) stay within the
    # documented profile-delta bound — the 1.5e-3 here is the linear→gaussian
    # profile change itself, not a fidelity gap (the one golden carrying a
    # documented exception to the 1e-3 bar)
    rmse_g, bad_g = score(_render_overlay(w, h, pyramid, legacy_shadow=False,
                                          use_pallas=use_pallas))
    print(f"render_3d_overlay (gaussian) pallas={use_pallas}: "
          f"rmse={rmse_g:.5f} bad={bad_g:.5f}")
    assert rmse_g < 0.002 + extra, rmse_g
    assert bad_g < 0.001, bad_g


SELF_GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "goldens", "render_3d_overlay_gaussian.png")


@pytest.mark.parametrize("use_pallas", [False, True], ids=["xla", "pallas"])
def test_3d_overlay_gaussian_self_golden(use_pallas):
    """The CURRENT shadow profile (gaussian, atlas.frag:211-216 semantics)
    against a committed self-generated golden at the tight 1e-3 bar — the
    reference PNG above predates the profile change, so its gaussian leg
    carries a documented 2e-3 exception; this pins the current code path
    exactly (XLA-generated golden; the Pallas leg doubles as a kernel-parity
    check on the full overlay scene)."""
    from PIL import Image

    expected = np.asarray(Image.open(SELF_GOLDEN).convert("RGBA"),
                          dtype=np.float32)
    h, w = expected.shape[:2]
    pyramid = rasterize_pyramid(w, h)
    frame = _render_overlay(w, h, pyramid, legacy_shadow=False,
                            use_pallas=use_pallas)
    got = (np.clip(frame, 0.0, 1.0) * 255.0).round()
    diff = np.abs(got - expected) / 255.0
    rmse = float(np.sqrt((diff ** 2).mean()))
    bad = float((diff.max(axis=-1) > 32 / 255.0).mean())
    print(f"render_3d_overlay gaussian self-golden pallas={use_pallas}: "
          f"rmse={rmse:.5f} bad={bad:.5f}")
    extra = (1.0 / 255.0) if use_pallas else 0.0  # documented kernel tolerance
    assert rmse < 0.001 + extra, rmse
    assert bad < 0.001, bad
