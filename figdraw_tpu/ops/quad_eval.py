"""Per-quad fragment evaluation: the full atlas.frag dispatch in JAX.

Port of /root/reference/src/figdraw/opengl/glsl/atlas.frag:252-405 (plus the
rect-mask path from atlas_rect_mask.frag:222-237). Given one quad record (the
tape layout in ops/layout.py) and a grid of pixel centers, returns the
straight-alpha fragment color with quad coverage and rect-mask already
applied. Mask-texture multiply and blending are the rasterizer's job.

Everything is branchless jnp (where-selects), so the same function serves the
XLA reference rasterizer (scan over quads) and the Pallas tile kernel (loop
over binned quads), on any pixel-grid shape.
"""

from __future__ import annotations

from functools import partial

import jax.numpy as jnp

from . import sdf
from .layout import (
    QF_AA,
    QF_COLOR0,
    QF_FACTORS,
    QF_INV_A,
    QF_INV_B,
    QF_INV_C,
    QF_INV_D,
    QF_MID_COLOR,
    QF_ORG_X,
    QF_ORG_Y,
    QF_PARAMS,
    QF_RADII,
    QF_RECT_MATX,
    QF_RECT_MATY,
    QF_RECT_PARAMS,
    QF_RECT_RADII,
    QF_STOP_COLOR,
    QF_SUBPIXEL_SHIFT,
    QF_UV3_X,
    QF_UVDU_X,
    QF_UVDU_Y,
    QF_UVDV_X,
    QF_UVDV_Y,
)

# SdfMode constants (figbackend.nim:36-52)
MODE_ATLAS = 0
MODE_CLIP_AA = 3
MODE_DROP_SHADOW = 7
MODE_DROP_SHADOW_AA = 8
MODE_INSET_SHADOW = 9
MODE_ANNULAR = 11
MODE_ANNULAR_AA = 12
MODE_MSDF = 13
MODE_MTSDF = 14
MODE_MSDF_ANNULAR = 15
MODE_MTSDF_ANNULAR = 16
MODE_BACKDROP_BLUR = 17
MODE_BEZIER_ROUND = 18
MODE_BEZIER_BUTT = 19
MODE_BEZIER_SQUARE = 20
# Extension beyond the reference's 0-20 SdfMode table: the LEGACY linear
# shadow falloff alpha = clamp(1 - sd/blur, 0, 1). The reference's
# render_3d_overlay golden was generated before the gaussian shadowProfile
# calibration landed (atlas.frag:211-216); its measured profile is exactly
# linear with a hard cutoff at sd = blur. test_golden_overlay remaps mode
# 7 -> 21 to pin that golden; nothing else emits this mode.
MODE_DROP_SHADOW_LINEAR = 21


def sample_atlas_bilinear(atlas, u, v):
    """GL_LINEAR, clamp-to-edge sample of the RGBA atlas; uv normalized.

    atlas: (S, S, 4) float32 in [0, 1].
    """
    size = atlas.shape[0]
    tx = u * size - 0.5
    ty = v * size - 0.5
    x0 = jnp.floor(tx)
    y0 = jnp.floor(ty)
    fx = tx - x0
    fy = ty - y0
    x0i = jnp.clip(x0.astype(jnp.int32), 0, size - 1)
    y0i = jnp.clip(y0.astype(jnp.int32), 0, size - 1)
    x1i = jnp.clip(x0i + 1, 0, size - 1)
    y1i = jnp.clip(y0i + 1, 0, size - 1)

    def g(yi, xi):
        return atlas[yi, xi]

    c00 = g(y0i, x0i)
    c10 = g(y0i, x1i)
    c01 = g(y1i, x0i)
    c11 = g(y1i, x1i)
    fx = fx[..., None]
    fy = fy[..., None]
    top = c00 * (1.0 - fx) + c10 * fx
    bot = c01 * (1.0 - fx) + c11 * fx
    return top * (1.0 - fy) + bot * fy


def sample_atlas_nearest(atlas, u, v):
    """GL_NEAREST, clamp-to-edge (the reference's pixelate=true mag filter,
    glcontext.nim:165-168)."""
    size = atlas.shape[0]
    xi = jnp.clip(jnp.floor(u * size).astype(jnp.int32), 0, size - 1)
    yi = jnp.clip(jnp.floor(v * size).astype(jnp.int32), 0, size - 1)
    return atlas[yi, xi]


def eval_quad(
    f,  # (QF_WIDTH,) float32 quad record
    mode_packed,  # () int32
    px,  # pixel-center x, any shape
    py,  # pixel-center y, same shape
    atlas=None,  # (S, S, 4) f32 or None
    backdrop=None,  # px.shape + (4,) f32 or None (mode-17 source)
    subpixel_positioning: bool = False,
    pixelate: bool = False,
):
    """Evaluate one quad at pixel centers → (rgb: shape+(3,), a: shape).

    Returns straight-alpha fragColor with quad coverage and rect-mask applied.
    """
    shape = px.shape
    fm = (mode_packed // 256) % 8  # fill mode 0-4; high bits are kernel flags
    rest = mode_packed % 256
    elliptical = rest >= 128
    mode = jnp.where(elliptical, rest - 128, rest)

    # --- inverse-affine to quad parameter space -------------------------------
    ox = f[QF_ORG_X]
    oy = f[QF_ORG_Y]
    rx = px - ox
    ry = py - oy
    u = f[QF_INV_A] * rx + f[QF_INV_B] * ry
    v = f[QF_INV_C] * rx + f[QF_INV_D] * ry
    # epsilon guard: snapped integer geometry routinely puts rotated quad
    # edges EXACTLY through pixel centers (u or v == 0.0 to the last bit),
    # and XLA vs the Pallas kernels order/fuse the inverse-affine multiply-add
    # differently — a ±1ulp tie would flip a whole AA edge pixel between
    # the paths (found by test_retained's cross-renderer pin). 1e-6 in uv
    # is ≤ ~4e-3 px for any plausible quad; ties at -1e-6 exactly cannot
    # arise from snapped geometry. Keep in lockstep with quad_eval_planar.
    inside = (u >= -1e-6) & (u <= 1.0 + 1e-6) & (v >= -1e-6) & (v <= 1.0 + 1e-6)

    quad_hx = f[QF_PARAMS + 0]
    quad_hy = f[QF_PARAMS + 1]
    p_x = (u - 0.5) * 2.0 * quad_hx
    p_y = (v - 0.5) * 2.0 * quad_hy

    inset = mode == MODE_INSET_SHADOW
    shape_hx = jnp.where(inset, quad_hx, f[QF_PARAMS + 2])
    shape_hy = jnp.where(inset, quad_hy, f[QF_PARAMS + 3])

    r_tr = f[QF_RADII + 0]
    r_br = f[QF_RADII + 1]
    r_tl = f[QF_RADII + 2]
    r_bl = f[QF_RADII + 3]

    is_bezier = (mode >= MODE_BEZIER_ROUND) & (mode <= MODE_BEZIER_SQUARE)

    # dist: bezier vs (elliptical) rounded box on the y-up local frame
    d_box_circ = sdf.sd_rounded_box(p_x, -p_y, shape_hx, shape_hy, r_tr, r_br, r_tl, r_bl)
    d_box_ell = sdf.sd_elliptical_rounded_box(
        p_x, -p_y, shape_hx, shape_hy, r_tr, r_br, r_tl, r_bl
    )
    d_box = jnp.where(elliptical, d_box_ell, d_box_circ)
    d_bez = sdf.sd_bezier(
        p_x, p_y,
        f[QF_PARAMS + 2], f[QF_PARAMS + 3],
        f[QF_RADII + 0], f[QF_RADII + 1],
        f[QF_RADII + 2], f[QF_RADII + 3],
    )
    dist = jnp.where(is_bezier, d_bez, d_box)

    sdf_factor = f[QF_FACTORS + 0]
    sdf_spread = jnp.where(fm == 0, f[QF_FACTORS + 1], 0.0)
    aa = f[QF_AA]

    # --- fill color: vertex-bilinear + linear3 (atlas.frag:218-250) -----------
    c0 = f[QF_COLOR0 + 0 : QF_COLOR0 + 4]  # BL
    c1 = f[QF_COLOR0 + 4 : QF_COLOR0 + 8]  # BR
    c2 = f[QF_COLOR0 + 8 : QF_COLOR0 + 12]  # TR
    c3 = f[QF_COLOR0 + 12 : QF_COLOR0 + 16]  # TL
    uu = u[..., None]
    vv = v[..., None]
    vert_color = (
        c3 * (1.0 - uu) * (1.0 - vv)
        + c2 * uu * (1.0 - vv)
        + c0 * (1.0 - uu) * vv
        + c1 * uu * vv
    )
    t3 = jnp.where(
        fm == 1, u,
        jnp.where(fm == 2, v,
                  jnp.where(fm == 3, 0.5 * (u + v), 0.5 * (u + (1.0 - v)))),
    )
    t3 = jnp.clip(t3, 0.0, 1.0)
    mid = jnp.clip(f[QF_FACTORS + 1], 0.01, 0.99)
    mid_c = f[QF_MID_COLOR : QF_MID_COLOR + 4]
    stop_c = f[QF_STOP_COLOR : QF_STOP_COLOR + 4]
    lo_t = (t3 / mid)[..., None]
    hi_t = ((t3 - mid) / (1.0 - mid))[..., None]
    lin3 = jnp.where(
        (t3 <= mid)[..., None],
        vert_color * (1.0 - lo_t) + mid_c * lo_t,
        mid_c * (1.0 - hi_t) + stop_c * hi_t,
    )
    fill_color = jnp.where(fm == 0, vert_color, lin3)

    # --- mode dispatch ----------------------------------------------------------
    # default / ClipAA
    cl = jnp.clip(aa * dist + 0.5, 0.0, 1.0)
    alpha_default = 1.0 - cl

    # bezier strokes
    bez_sd = sdf.bezier_stroke_sd(
        dist, p_x, p_y,
        f[QF_PARAMS + 2], f[QF_PARAMS + 3],
        f[QF_RADII + 0], f[QF_RADII + 1],
        f[QF_RADII + 2], f[QF_RADII + 3],
        jnp.maximum(sdf_factor, 0.0) * 0.5,
        mode, MODE_BEZIER_ROUND, MODE_BEZIER_BUTT, MODE_BEZIER_SQUARE,
    )
    alpha_bezier = 1.0 - jnp.clip(aa * bez_sd + 0.5, 0.0, 1.0)

    # annular
    fhalf = sdf_factor * 0.5
    ann_sd = jnp.abs(dist + fhalf) - fhalf
    alpha_annular = jnp.where(ann_sd < 0.0, 1.0, 0.0)
    alpha_annular_aa = 1.0 - jnp.clip(aa * ann_sd + 0.5, 0.0, 1.0)

    # drop shadow
    ds_sd = dist - sdf_spread
    ds_prof = jnp.minimum(sdf.shadow_profile(ds_sd, sdf_factor), 1.0)
    alpha_drop = jnp.where(ds_sd > 0.0, ds_prof, 1.0)
    alpha_drop_aa = jnp.where(ds_sd >= 0.0, ds_prof, alpha_default)
    # legacy linear falloff (mode 21, see MODE_DROP_SHADOW_LINEAR)
    ds_lin = jnp.clip(1.0 - ds_sd / jnp.maximum(sdf_factor, 1e-6), 0.0, 1.0)
    alpha_drop_lin = jnp.where(ds_sd > 0.0, ds_lin, 1.0)

    # inset shadow: clip on node shape, gaussian on offset shape
    qx_clip = p_x
    qy_clip = -p_y
    off_x = f[QF_PARAMS + 2]
    off_y = -f[QF_PARAMS + 3]
    qx_sh = qx_clip - off_x
    qy_sh = qy_clip - off_y
    clip_circ = sdf.sd_rounded_box(qx_clip, qy_clip, quad_hx, quad_hy, r_tr, r_br, r_tl, r_bl)
    clip_ell = sdf.sd_elliptical_rounded_box(
        qx_clip, qy_clip, quad_hx, quad_hy, r_tr, r_br, r_tl, r_bl
    )
    clip_dist = jnp.where(elliptical, clip_ell, clip_circ)
    sh_circ = sdf.sd_rounded_box(qx_sh, qy_sh, quad_hx, quad_hy, r_tr, r_br, r_tl, r_bl)
    sh_ell = sdf.sd_elliptical_rounded_box(
        qx_sh, qy_sh, quad_hx, quad_hy, r_tr, r_br, r_tl, r_bl
    )
    shadow_dist = jnp.where(elliptical, sh_ell, sh_circ)
    clip_alpha = 1.0 - jnp.clip(aa * clip_dist + 0.5, 0.0, 1.0)
    in_sd = shadow_dist + sdf_spread
    in_prof = jnp.minimum(sdf.shadow_profile(in_sd, sdf_factor), 1.0)
    inset_alpha = jnp.where(in_sd < 0.0, in_prof, 1.0)
    alpha_inset = clip_alpha * inset_alpha

    alpha = alpha_default
    alpha = jnp.where(is_bezier, alpha_bezier, alpha)
    alpha = jnp.where(mode == MODE_ANNULAR, alpha_annular, alpha)
    alpha = jnp.where(mode == MODE_ANNULAR_AA, alpha_annular_aa, alpha)
    alpha = jnp.where(mode == MODE_DROP_SHADOW, alpha_drop, alpha)
    alpha = jnp.where(mode == MODE_DROP_SHADOW_AA, alpha_drop_aa, alpha)
    alpha = jnp.where(mode == MODE_DROP_SHADOW_LINEAR, alpha_drop_lin, alpha)
    alpha = jnp.where(mode == MODE_INSET_SHADOW, alpha_inset, alpha)

    frag_rgb = fill_color[..., 0:3]
    frag_a = fill_color[..., 3] * alpha

    # --- texture modes ------------------------------------------------------------
    tex_u = f[QF_UV3_X] + u * f[QF_UVDU_X] + v * f[QF_UVDV_X]
    tex_v = f[QF_UV3_X + 1] + u * f[QF_UVDU_Y] + v * f[QF_UVDV_Y]

    if atlas is not None:
        atlas_size = atlas.shape[0]
        # mode 0: plain atlas sample tinted by vertex color
        au = tex_u
        if subpixel_positioning:
            au = au - f[QF_SUBPIXEL_SHIFT] / atlas_size
        _sample = sample_atlas_nearest if pixelate else sample_atlas_bilinear
        tex = _sample(atlas, au, tex_v)
        atlas_rgb = tex[..., 0:3] * vert_color[..., 0:3]
        atlas_a = tex[..., 3] * vert_color[..., 3]
        is_atlas = mode == MODE_ATLAS
        frag_rgb = jnp.where(is_atlas, atlas_rgb, frag_rgb)

        # msdf family
        is_msdf_any = (mode >= MODE_MSDF) & (mode <= MODE_MTSDF_ANNULAR)
        is_mtsdf = (mode == MODE_MTSDF) | (mode == MODE_MTSDF_ANNULAR)
        is_sd_stroke = (mode == MODE_MSDF_ANNULAR) | (mode == MODE_MTSDF_ANNULAR)
        px_range = sdf_factor
        sd_threshold = f[QF_FACTORS + 1]
        _sample = sample_atlas_nearest if pixelate else sample_atlas_bilinear
        tex0 = _sample(atlas, tex_u, tex_v)
        sd = jnp.where(
            is_mtsdf, tex0[..., 3], sdf.median3(tex0[..., 0], tex0[..., 1], tex0[..., 2])
        )
        # analytic screenPxRange: fwidth(uv) from the quad's constant affine
        fw_u = jnp.abs(f[QF_UVDU_X] * f[QF_INV_A] + f[QF_UVDV_X] * f[QF_INV_C]) + jnp.abs(
            f[QF_UVDU_X] * f[QF_INV_B] + f[QF_UVDV_X] * f[QF_INV_D]
        )
        fw_v = jnp.abs(f[QF_UVDU_Y] * f[QF_INV_A] + f[QF_UVDV_Y] * f[QF_INV_C]) + jnp.abs(
            f[QF_UVDU_Y] * f[QF_INV_B] + f[QF_UVDV_Y] * f[QF_INV_D]
        )
        unit_range = px_range / atlas_size
        screen_px_range = jnp.maximum(
            0.5 * (unit_range / jnp.maximum(fw_u, 1e-9) + unit_range / jnp.maximum(fw_v, 1e-9)),
            1.0,
        )
        screen_px_distance = screen_px_range * (sd - sd_threshold)
        stroke_w = jnp.maximum(f[QF_PARAMS + 1], 0.0)
        half_w = stroke_w * 0.5
        a_stroke = jnp.clip(half_w - jnp.abs(screen_px_distance) + 0.5, 0.0, 1.0)
        a_solid = jnp.clip(screen_px_distance + 0.5, 0.0, 1.0)
        msdf_alpha = jnp.where(is_sd_stroke, a_stroke, a_solid)
        frag_rgb = jnp.where(is_msdf_any, fill_color[..., 0:3], frag_rgb)
        frag_a = jnp.where(is_msdf_any, fill_color[..., 3] * msdf_alpha, frag_a)
        frag_a = jnp.where(is_atlas, atlas_a, frag_a)

    if backdrop is not None:
        is_backdrop = mode == MODE_BACKDROP_BLUR
        frag_rgb = jnp.where(is_backdrop, backdrop[..., 0:3], frag_rgb)
        frag_a = jnp.where(is_backdrop, backdrop[..., 3] * alpha_default, frag_a)

    # --- rect-mask fast path (atlas_rect_mask.frag:222-237) -----------------------
    rm_hx = f[QF_RECT_PARAMS + 2]
    rm_hy = f[QF_RECT_PARAMS + 3]
    rm_enabled = (rm_hx >= 0.0) & (rm_hy >= 0.0)
    local_x = f[QF_RECT_MATX + 0] * px + f[QF_RECT_MATX + 1] * py + f[QF_RECT_MATX + 2]
    local_y = f[QF_RECT_MATY + 0] * px + f[QF_RECT_MATY + 1] * py + f[QF_RECT_MATY + 2]
    qx = local_x - f[QF_RECT_PARAMS + 0]
    qy = local_y - f[QF_RECT_PARAMS + 1]
    rm_circ = sdf.sd_rounded_box(
        qx, -qy, jnp.maximum(rm_hx, 0.0), jnp.maximum(rm_hy, 0.0),
        f[QF_RECT_RADII + 0], f[QF_RECT_RADII + 1],
        f[QF_RECT_RADII + 2], f[QF_RECT_RADII + 3],
    )
    rm_ell = sdf.sd_elliptical_rounded_box(
        qx, -qy, jnp.maximum(rm_hx, 0.0), jnp.maximum(rm_hy, 0.0),
        f[QF_RECT_RADII + 0], f[QF_RECT_RADII + 1],
        f[QF_RECT_RADII + 2], f[QF_RECT_RADII + 3],
    )
    rm_dist = jnp.where(f[QF_RECT_MATY + 3] > 0.5, rm_ell, rm_circ)
    rm_alpha = 1.0 - jnp.clip(aa * rm_dist + 0.5, 0.0, 1.0)
    frag_a = frag_a * jnp.where(rm_enabled, rm_alpha, 1.0)

    # quad coverage
    frag_a = jnp.where(inside, frag_a, 0.0)
    return frag_rgb, frag_a


def blend_over(dst_rgb, dst_a, src_rgb, src_a):
    """GL blendFuncSeparate(SRC_ALPHA, 1-SRC_ALPHA, ONE, 1-SRC_ALPHA)
    (glutils.nim:150-154), on straight-alpha buffers."""
    a = src_a[..., None]
    out_rgb = src_rgb * a + dst_rgb * (1.0 - a)
    out_a = src_a + dst_a * (1.0 - src_a)
    return out_rgb, out_a
