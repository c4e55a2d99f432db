"""Channel-planar quad evaluation for the Pallas tile kernel.

Same math as ops/quad_eval.py (the atlas.frag port), restructured for the
tile kernels: pixel grids are 2D (TH, TW) blocks and colors are four
separate planes instead of a trailing RGBA dim. Atlas-sampling modes (0,
13-16) are NOT handled here — the renderer routes runs containing them
through the XLA path, where gathers are cheap; every SDF mode, backdrop blur
and the rect-mask fast path are.

Branch structure: a scalar `mode` drives lax.cond branches so a tile only
pays for the SDF family its quad actually uses (bezier cubic-root solve and
the double-SDF inset path are much heavier than the rounded-box path).
"""

from __future__ import annotations

import jax
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
)
from .quad_eval import (
    MODE_ANNULAR,
    MODE_ANNULAR_AA,
    MODE_BACKDROP_BLUR,
    MODE_BEZIER_BUTT,
    MODE_BEZIER_ROUND,
    MODE_BEZIER_SQUARE,
    MODE_DROP_SHADOW,
    MODE_DROP_SHADOW_AA,
    MODE_DROP_SHADOW_LINEAR,
    MODE_INSET_SHADOW,
)


def eval_quad_planar(fget, mode_packed, px, py, backdrop_planes=None):
    """Evaluate one SDF quad over a 2D pixel tile.

    fget(k) -> scalar f32 field at layout offset k (a scalar load from a
    kernel ref or a captured array — keeps this function agnostic of the
    memory source). mode_packed: scalar i32. px, py: (TH, TW) pixel centers.
    backdrop_planes: optional tuple of 4 (TH, TW) planes for mode 17.

    Returns (r, g, b, a): straight-alpha fragment planes with quad coverage
    and rect-mask applied.
    """
    fm = (mode_packed // 256) % 8  # fill mode 0-4; high bits are kernel flags
    rest = mode_packed % 256
    elliptical = rest >= 128
    mode = jnp.where(elliptical, rest - 128, rest)

    ox = fget(QF_ORG_X)
    oy = fget(QF_ORG_Y)
    rx_ = px - ox
    ry_ = py - oy
    u = fget(QF_INV_A) * rx_ + fget(QF_INV_B) * ry_
    v = fget(QF_INV_C) * rx_ + fget(QF_INV_D) * ry_
    # epsilon guard against exact-boundary FP ties — see quad_eval.py's
    # `inside` note; the two evaluators must agree on edge pixels
    inside = (u >= -1e-6) & (u <= 1.0 + 1e-6) & (v >= -1e-6) & (v <= 1.0 + 1e-6)

    quad_hx = fget(QF_PARAMS + 0)
    quad_hy = fget(QF_PARAMS + 1)
    p_x = (u - 0.5) * 2.0 * quad_hx
    p_y = (v - 0.5) * 2.0 * quad_hy

    r_tr = fget(QF_RADII + 0)
    r_br = fget(QF_RADII + 1)
    r_tl = fget(QF_RADII + 2)
    r_bl = fget(QF_RADII + 3)
    pz = fget(QF_PARAMS + 2)
    pw = fget(QF_PARAMS + 3)

    sdf_factor = fget(QF_FACTORS + 0)
    factor_y = fget(QF_FACTORS + 1)
    sdf_spread = jnp.where(fm == 0, factor_y, 0.0)
    aa = fget(QF_AA)

    is_bezier = (mode >= MODE_BEZIER_ROUND) & (mode <= MODE_BEZIER_SQUARE)
    is_inset = mode == MODE_INSET_SHADOW

    def box_dist(qx, qy, bx, by):
        # scalar branch: elliptical decode costs ~2x the circular SDF, so only
        # the used family is evaluated (lax.cond executes one side)
        return jax.lax.cond(
            elliptical,
            lambda _: sdf.sd_elliptical_rounded_box(qx, qy, bx, by, r_tr, r_br, r_tl, r_bl),
            lambda _: sdf.sd_rounded_box(qx, qy, bx, by, r_tr, r_br, r_tl, r_bl),
            None,
        )

    # --- alpha via 3-way branch: box-family / inset / bezier -------------------
    def alpha_box(_):
        shape_hx = pz
        shape_hy = pw
        dist = box_dist(p_x, -p_y, shape_hx, shape_hy)
        cl = jnp.clip(aa * dist + 0.5, 0.0, 1.0)
        a_default = 1.0 - cl
        # shadow modes pay a gaussian exp per pixel; plain fills/strokes are
        # the common case — scalar-branch so they never evaluate it
        is_shadow = (
            (mode == MODE_DROP_SHADOW)
            | (mode == MODE_DROP_SHADOW_AA)
            | (mode == MODE_DROP_SHADOW_LINEAR)
        )

        def shadow(_):
            ds_sd = dist - sdf_spread
            ds_prof = jnp.minimum(sdf.shadow_profile(ds_sd, sdf_factor), 1.0)
            a_drop = jnp.where(ds_sd > 0.0, ds_prof, 1.0)
            a_drop_aa = jnp.where(ds_sd >= 0.0, ds_prof, a_default)
            ds_lin = jnp.clip(
                1.0 - ds_sd / jnp.maximum(sdf_factor, 1e-6), 0.0, 1.0
            )
            a_lin = jnp.where(ds_sd > 0.0, ds_lin, 1.0)
            a = jnp.where(mode == MODE_DROP_SHADOW, a_drop, a_drop_aa)
            return jnp.where(mode == MODE_DROP_SHADOW_LINEAR, a_lin, a)

        def plain(_):
            fhalf = sdf_factor * 0.5
            ann_sd = jnp.abs(dist + fhalf) - fhalf
            a_ann = jnp.where(ann_sd < 0.0, 1.0, 0.0)
            a_ann_aa = 1.0 - jnp.clip(aa * ann_sd + 0.5, 0.0, 1.0)
            a = a_default
            a = jnp.where(mode == MODE_ANNULAR, a_ann, a)
            a = jnp.where(mode == MODE_ANNULAR_AA, a_ann_aa, a)
            return a

        return jax.lax.cond(is_shadow, shadow, plain, None)

    def alpha_inset(_):
        qx_c, qy_c = p_x, -p_y
        qx_s = qx_c - pz
        qy_s = qy_c + pw
        clip_dist = box_dist(qx_c, qy_c, quad_hx, quad_hy)
        shadow_dist = box_dist(qx_s, qy_s, quad_hx, quad_hy)
        clip_alpha = 1.0 - jnp.clip(aa * clip_dist + 0.5, 0.0, 1.0)
        in_sd = shadow_dist + sdf_spread
        in_prof = jnp.minimum(sdf.shadow_profile(in_sd, sdf_factor), 1.0)
        inset_a = jnp.where(in_sd < 0.0, in_prof, 1.0)
        return clip_alpha * inset_a

    def alpha_bezier(_):
        ax_, ay_ = pz, pw
        bx_, by_ = r_tr, r_br
        cx_, cy_ = r_tl, r_bl
        dist = sdf.sd_bezier(p_x, p_y, ax_, ay_, bx_, by_, cx_, cy_)
        bez_sd = sdf.bezier_stroke_sd(
            dist, p_x, p_y, ax_, ay_, bx_, by_, cx_, cy_,
            jnp.maximum(sdf_factor, 0.0) * 0.5,
            mode, MODE_BEZIER_ROUND, MODE_BEZIER_BUTT, MODE_BEZIER_SQUARE,
        )
        return 1.0 - jnp.clip(aa * bez_sd + 0.5, 0.0, 1.0)

    # nested conds, not lax.switch: the Triton lowering of switch's index
    # clamp mixes i1 and i32 operands and fails MLIR verification
    alpha = jax.lax.cond(
        is_bezier, alpha_bezier,
        lambda _: jax.lax.cond(is_inset, alpha_inset, alpha_box, None), None,
    )

    # --- fill color (vertex bilinear + linear3), channel-planar ------------------
    def vert_channel(ch, w0, w1, w2, w3):
        return (
            fget(QF_COLOR0 + 12 + ch) * w3
            + fget(QF_COLOR0 + 8 + ch) * w2
            + fget(QF_COLOR0 + 0 + ch) * w0
            + fget(QF_COLOR0 + 4 + ch) * w1
        )

    def vertex_fill(_):
        # scalar pre-test: equal corners (the typical solid fill) broadcast a
        # constant instead of paying 4 channels of bilinear weights
        const = True
        for ch in range(4):
            c0 = fget(QF_COLOR0 + ch)
            const = (
                const
                & (c0 == fget(QF_COLOR0 + 4 + ch))
                & (c0 == fget(QF_COLOR0 + 8 + ch))
                & (c0 == fget(QF_COLOR0 + 12 + ch))
            )

        def flat(_):
            return tuple(
                jnp.full_like(px, fget(QF_COLOR0 + ch)) for ch in range(4)
            )

        def bilinear(_):
            w3 = (1.0 - u) * (1.0 - v)  # TL (c3)
            w2 = u * (1.0 - v)  # TR (c2)
            w0 = (1.0 - u) * v  # BL (c0)
            w1 = u * v  # BR (c1)
            return tuple(vert_channel(ch, w0, w1, w2, w3) for ch in range(4))

        return jax.lax.cond(const, flat, bilinear, None)

    def gradient3_fill(_):
        w3 = (1.0 - u) * (1.0 - v)
        w2 = u * (1.0 - v)
        w0 = (1.0 - u) * v
        w1 = u * v
        t3 = jnp.where(
            fm == 1, u,
            jnp.where(fm == 2, v,
                      jnp.where(fm == 3, 0.5 * (u + v), 0.5 * (u + (1.0 - v)))),
        )
        t3 = jnp.clip(t3, 0.0, 1.0)
        mid = jnp.clip(factor_y, 0.01, 0.99)
        lo_t = t3 / mid
        hi_t = (t3 - mid) / (1.0 - mid)
        low = t3 <= mid

        def fill_channel(ch):
            vc = vert_channel(ch, w0, w1, w2, w3)
            mc = fget(QF_MID_COLOR + ch)
            sc = fget(QF_STOP_COLOR + ch)
            return jnp.where(
                low, vc * (1.0 - lo_t) + mc * lo_t, mc * (1.0 - hi_t) + sc * hi_t
            )

        return tuple(fill_channel(ch) for ch in range(4))

    fr, fg, fb, fa = jax.lax.cond(fm == 0, vertex_fill, gradient3_fill, None)
    out_r, out_g, out_b = fr, fg, fb
    out_a = fa * alpha

    if backdrop_planes is not None:
        is_bd = mode == MODE_BACKDROP_BLUR
        br, bg, bb, ba = backdrop_planes
        out_r = jnp.where(is_bd, br, out_r)
        out_g = jnp.where(is_bd, bg, out_g)
        out_b = jnp.where(is_bd, bb, out_b)
        out_a = jnp.where(is_bd, ba * alpha, out_a)

    # --- rect-mask fast path -------------------------------------------------------
    rm_hx = fget(QF_RECT_PARAMS + 2)
    rm_hy = fget(QF_RECT_PARAMS + 3)
    rm_enabled = (rm_hx >= 0.0) & (rm_hy >= 0.0)

    def with_rect_mask(_):
        lx = fget(QF_RECT_MATX + 0) * px + fget(QF_RECT_MATX + 1) * py + fget(QF_RECT_MATX + 2)
        ly = fget(QF_RECT_MATY + 0) * px + fget(QF_RECT_MATY + 1) * py + fget(QF_RECT_MATY + 2)
        qx = lx - fget(QF_RECT_PARAMS + 0)
        qy = ly - fget(QF_RECT_PARAMS + 1)
        hx = jnp.maximum(rm_hx, 0.0)
        hy = jnp.maximum(rm_hy, 0.0)
        rt, rb, rtl, rbl = (
            fget(QF_RECT_RADII + 0),
            fget(QF_RECT_RADII + 1),
            fget(QF_RECT_RADII + 2),
            fget(QF_RECT_RADII + 3),
        )
        # scalar branch on the elliptical flag (box_dist's pattern): the
        # elliptical decode costs ~2x the circular SDF, so a rect-masked quad
        # only evaluates the family its clip actually uses
        d = jax.lax.cond(
            fget(QF_RECT_MATY + 3) > 0.5,
            lambda _: sdf.sd_elliptical_rounded_box(
                qx, -qy, hx, hy, rt, rb, rtl, rbl),
            lambda _: sdf.sd_rounded_box(qx, -qy, hx, hy, rt, rb, rtl, rbl),
            None,
        )
        return 1.0 - jnp.clip(aa * d + 0.5, 0.0, 1.0)

    rm_alpha = jax.lax.cond(
        rm_enabled, with_rect_mask, lambda _: jnp.ones_like(px), None
    )
    out_a = out_a * rm_alpha

    out_a = jnp.where(inside, out_a, 0.0)
    return out_r, out_g, out_b, out_a
