"""Signed-distance-field primitives in JAX.

JAX port of the reference's GLSL SDF library
(/root/reference/src/figdraw/opengl/glsl/atlas.frag:41-216). Every function is
pure jnp and shape-polymorphic: scalars broadcast over whatever pixel-grid
shape the caller evaluates (a full frame in the reference rasterizer, a
block inside the Pallas kernel).
"""

from __future__ import annotations

import jax.numpy as jnp


def median3(a, b, c):
    """atlas.frag:41-43."""
    return jnp.maximum(jnp.minimum(a, b), jnp.minimum(jnp.maximum(a, b), c))


def sd_rounded_box(px, py, bx, by, r_tr, r_br, r_tl, r_bl):
    """Rounded-box SDF with per-quadrant radius select (atlas.frag:51-69).

    p is in the shader's y-up local frame; radii order is the packed
    (TR, BR, TL, BL) vec.
    """
    rr = jnp.where(
        px > 0.0,
        jnp.where(py > 0.0, r_tr, r_br),
        jnp.where(py > 0.0, r_tl, r_bl),
    )
    qx = jnp.abs(px) - bx + rr
    qy = jnp.abs(py) - by + rr
    outside = jnp.sqrt(
        jnp.maximum(qx, 0.0) ** 2 + jnp.maximum(qy, 0.0) ** 2
    )
    return jnp.minimum(jnp.maximum(qx, qy), 0.0) + outside - rr


def sd_ellipse(px, py, rx, ry):
    """Approximate ellipse SDF (atlas.frag:71-79)."""
    sx = jnp.maximum(rx, 1e-6)
    sy = jnp.maximum(ry, 1e-6)
    k0 = jnp.sqrt((px / sx) ** 2 + (py / sy) ** 2)
    k1 = jnp.sqrt((px / (sx * sx)) ** 2 + (py / (sy * sy)) ** 2)
    d = k0 * (k0 - 1.0) / jnp.maximum(k1, 1e-6)
    return jnp.where(k0 <= 1e-6, -jnp.minimum(sx, sy), d)


def _select_corner(px, py, r_tr, r_br, r_tl, r_bl):
    """atlas.frag:81-86."""
    return jnp.where(
        px > 0.0,
        jnp.where(py > 0.0, r_tr, r_br),
        jnp.where(py > 0.0, r_tl, r_bl),
    )


def sd_elliptical_rounded_box(px, py, bx, by, r_tr, r_br, r_tl, r_bl):
    """Elliptical-corner rounded box with the 12+12-bit packed radii decode
    (atlas.frag:88-115)."""
    selected = _select_corner(px, py, r_tr, r_br, r_tl, r_bl)

    # negative encoding: circular corner with radius = -v - 1
    circ_r = -selected - 1.0
    d_circular = sd_rounded_box(px, py, bx, by, circ_r, circ_r, circ_r, circ_r)

    # The GLSL decode's floor(v + 0.5) breaks above 2^23: f32 cannot represent
    # x.5 there, so e.g. the fully-round pill encoding 4095 + 4095*4096 =
    # 2^24-1 ties to 2^24 and wraps the x-radius to 0 (square corners). Packed
    # values are exact f32 integers, so only round where x.5 exists.
    packed = jnp.where(
        selected >= 8388608.0, selected, jnp.floor(selected + 0.5)
    )
    rad_x = jnp.mod(packed, 4096.0) * bx / 4095.0
    rad_y = jnp.floor(packed / 4096.0) * by / 4095.0

    # sharp corner when either radius collapses
    qx0 = jnp.abs(px) - bx
    qy0 = jnp.abs(py) - by
    d_sharp = jnp.minimum(jnp.maximum(qx0, qy0), 0.0) + jnp.sqrt(
        jnp.maximum(qx0, 0.0) ** 2 + jnp.maximum(qy0, 0.0) ** 2
    )

    # equal-axis packed radius → circular path
    d_equal = sd_rounded_box(px, py, bx, by, rad_x, rad_x, rad_x, rad_x)

    # true elliptical corner
    qx = jnp.abs(px) - bx + rad_x
    qy = jnp.abs(py) - by + rad_y
    d_corner = sd_ellipse(qx, qy, rad_x, rad_y)
    d_edge = jnp.maximum(qx - rad_x, qy - rad_y)
    d_elliptical = jnp.where((qx > 0.0) & (qy > 0.0), d_corner, d_edge)

    d = jnp.where(
        (rad_x <= 0.0) | (rad_y <= 0.0),
        d_sharp,
        jnp.where(rad_x == rad_y, d_equal, d_elliptical),
    )
    return jnp.where(selected < 0.0, d_circular, d)


def _acos(x):
    """Polynomial acos (Abramowitz & Stegun 4.4.45, |err| < 6.7e-5 rad) —
    keeps the kernels to elementwise arithmetic every Pallas route lowers."""
    xc = jnp.clip(x, -1.0, 1.0)
    a = jnp.abs(xc)
    poly = 1.5707288 + a * (-0.2121144 + a * (0.0742610 + a * (-0.0187293)))
    r = jnp.sqrt(jnp.maximum(1.0 - a, 0.0)) * poly
    return jnp.where(xc >= 0.0, r, 3.14159265358979 - r)


def _cbrt(x):
    """Signed cube root via exp/log — elementwise ops every Pallas route
    lowers."""
    ax = jnp.abs(x)
    r = jnp.exp(jnp.log(jnp.maximum(ax, 1e-30)) / 3.0)
    return jnp.where(ax < 1e-30, 0.0, jnp.sign(x) * r)


def sd_bezier(posx, posy, ax_, ay_, bx_, by_, cx_, cy_):
    """Exact quadratic-bezier distance via the cubic-root solve
    (atlas.frag:121-160). Control points A, B, C are scalars; pos broadcasts.
    """
    abx = bx_ - ax_
    aby = by_ - ay_
    bbx = ax_ - 2.0 * bx_ + cx_
    bby = ay_ - 2.0 * by_ + cy_
    bb = bbx * bbx + bby * bby

    # degenerate: control point collinear midpoint → segment distance
    bax = cx_ - ax_
    bay = cy_ - ay_
    seg_h = jnp.clip(
        ((posx - ax_) * bax + (posy - ay_) * bay)
        / jnp.maximum(bax * bax + bay * bay, 1e-6),
        0.0,
        1.0,
    )
    d_seg = jnp.sqrt(
        (posx - (ax_ + bax * seg_h)) ** 2 + (posy - (ay_ + bay * seg_h)) ** 2
    )

    cx2 = abx * 2.0
    cy2 = aby * 2.0
    dx = ax_ - posx
    dy = ay_ - posy
    kk = 1.0 / jnp.maximum(bb, 1e-6)
    kx = kk * (abx * bbx + aby * bby)
    ky = kk * (2.0 * (abx * abx + aby * aby) + (dx * bbx + dy * bby)) / 3.0
    kz = kk * (dx * abx + dy * aby)
    p = ky - kx * kx
    p3 = p * p * p
    q = kx * (2.0 * kx * kx - 3.0 * ky) + kz
    h = q * q + 4.0 * p3

    def dot2t(t):
        qx = dx + (cx2 + bbx * t) * t
        qy = dy + (cy2 + bby * t) * t
        return qx * qx + qy * qy

    # h >= 0: single root
    hs = jnp.sqrt(jnp.maximum(h, 0.0))
    x1 = (hs - q) / 2.0
    x2 = (-hs - q) / 2.0
    root1 = _cbrt(x1)
    root2 = _cbrt(x2)
    t_single = jnp.clip(root1 + root2 - kx, 0.0, 1.0)
    res_single = dot2t(t_single)

    # h < 0: two candidate roots (p < 0 here, so the denominator is negative;
    # guard |denom| against 0 and let the clip keep acos in range)
    z = jnp.sqrt(jnp.maximum(-p, 1e-12))
    denom = p * z * 2.0
    denom = jnp.where(jnp.abs(denom) < 1e-12, -1e-12, denom)
    v = _acos(jnp.clip(q / denom, -1.0, 1.0)) / 3.0
    m = jnp.cos(v)
    n = jnp.sin(v) * 1.732050808
    t1 = jnp.clip((m + m) * z - kx, 0.0, 1.0)
    t2 = jnp.clip((-n - m) * z - kx, 0.0, 1.0)
    res_double = jnp.minimum(dot2t(t1), dot2t(t2))

    res = jnp.where(h >= 0.0, res_single, res_double)
    d_curve = jnp.sqrt(jnp.maximum(res, 0.0))
    return jnp.where(bb <= 1e-6, d_seg, d_curve)


def shadow_profile(sd, blur_radius):
    """Gaussian falloff, CSS-like sigma = blur/2 (atlas.frag:211-216)."""
    sigma = jnp.maximum(0.5 * blur_radius, 0.5)
    z = sd / sigma
    return jnp.exp(-0.5 * z * z)


def bezier_stroke_sd(dist, posx, posy, ax_, ay_, bx_, by_, cx_, cy_, half_w, mode,
                     MODE_ROUND, MODE_BUTT, MODE_SQUARE):
    """Cap trimming for bezier strokes (atlas.frag:179-209)."""
    chordx = cx_ - ax_
    chordy = cy_ - ay_
    chord_len = jnp.sqrt(chordx * chordx + chordy * chordy)
    fx = jnp.where(chord_len <= 1e-6, 1.0, chordx / jnp.maximum(chord_len, 1e-6))
    fy = jnp.where(chord_len <= 1e-6, 0.0, chordy / jnp.maximum(chord_len, 1e-6))

    def norm_or(vx, vy, fbx, fby):
        ln = jnp.sqrt(vx * vx + vy * vy)
        ok = ln > 1e-6
        return (
            jnp.where(ok, vx / jnp.maximum(ln, 1e-6), fbx),
            jnp.where(ok, vy / jnp.maximum(ln, 1e-6), fby),
        )

    stx, sty = norm_or(bx_ - ax_, by_ - ay_, fx, fy)
    etx, ety = norm_or(cx_ - bx_, cy_ - by_, fx, fy)
    start_proj = (posx - ax_) * stx + (posy - ay_) * sty
    end_proj = (posx - cx_) * etx + (posy - cy_) * ety

    is_square = mode == MODE_SQUARE
    trim = jnp.where(is_square, half_w, 0.0)
    tube = dist
    cross_start = jnp.abs((posx - ax_) * sty - (posy - ay_) * stx)
    cross_end = jnp.abs((posx - cx_) * ety - (posy - cy_) * etx)
    tube = jnp.where(is_square & (start_proj < 0.0), jnp.minimum(tube, cross_start), tube)
    tube = jnp.where(is_square & (end_proj > 0.0), jnp.minimum(tube, cross_end), tube)
    cap_dist = jnp.maximum(-start_proj - trim, end_proj - trim)
    trimmed = jnp.maximum(tube - half_w, cap_dist)
    return jnp.where(mode == MODE_ROUND, dist - half_w, trimmed)
