"""Minimal 2D geometry types for the scene graph and flattener.

A rebuild of the reference's vmath/bumpy usage
(/root/reference/src/figdraw/common/uimaths.nim:1-10). Only the pieces the
renderer actually needs: Vec2, Rect, and a 2D-affine Mat3 standing in for the
reference's Mat4 transform stack (figdraw only ever composes translate /
rotate / scale / arbitrary-matrix in the XY plane).
"""

from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True, slots=True)
class Vec2:
    x: float = 0.0
    y: float = 0.0

    def __add__(self, o: "Vec2") -> "Vec2":
        return Vec2(self.x + o.x, self.y + o.y)

    def __sub__(self, o: "Vec2") -> "Vec2":
        return Vec2(self.x - o.x, self.y - o.y)

    def __mul__(self, s: float) -> "Vec2":
        if isinstance(s, Vec2):
            return Vec2(self.x * s.x, self.y * s.y)
        return Vec2(self.x * s, self.y * s)

    __rmul__ = __mul__

    def __truediv__(self, s: float) -> "Vec2":
        if isinstance(s, Vec2):
            return Vec2(self.x / s.x, self.y / s.y)
        return Vec2(self.x / s, self.y / s)

    def __neg__(self) -> "Vec2":
        return Vec2(-self.x, -self.y)

    def length(self) -> float:
        return math.sqrt(self.x * self.x + self.y * self.y)

    def dot(self, o: "Vec2") -> float:
        return self.x * o.x + self.y * o.y

    def cross(self, o: "Vec2") -> float:
        return self.x * o.y - self.y * o.x

    def normalized_or(self, fallback: "Vec2") -> "Vec2":
        ln = self.length()
        if ln <= 1e-6:
            return fallback
        return Vec2(self.x / ln, self.y / ln)


def vec2(x: float = 0.0, y: float = 0.0) -> Vec2:
    return Vec2(float(x), float(y))


@dataclass(frozen=True, slots=True)
class Rect:
    x: float = 0.0
    y: float = 0.0
    w: float = 0.0
    h: float = 0.0

    @property
    def xy(self) -> Vec2:
        return Vec2(self.x, self.y)

    @property
    def wh(self) -> Vec2:
        return Vec2(self.w, self.h)

    def __add__(self, o: "Rect") -> "Rect":
        return Rect(self.x + o.x, self.y + o.y, self.w + o.w, self.h + o.h)

    def __mul__(self, s: float) -> "Rect":
        return Rect(self.x * s, self.y * s, self.w * s, self.h * s)

    def __truediv__(self, s: float) -> "Rect":
        return Rect(self.x / s, self.y / s, self.w / s, self.h / s)

    def at_xy(self, x: float, y: float) -> "Rect":
        """Offset rect by (x, y) (reference: bumpy's atXY usage)."""
        return Rect(self.x + x, self.y + y, self.w, self.h)


def rect(x: float = 0.0, y: float = 0.0, w: float = 0.0, h: float = 0.0) -> Rect:
    return Rect(float(x), float(y), float(w), float(h))


class Mat3:
    """Row-major 2D affine matrix: [[a, b, tx], [c, d, ty], [0, 0, 1]].

    Stands in for the reference's Mat4 transform stack; figdraw transforms are
    XY-affine (glcontext.nim:1991-2009), so a 3x3 affine is the faithful,
    cheaper equivalent. An arbitrary user Mat4 is accepted via from_mat4 by
    taking its XY-affine part.
    """

    __slots__ = ("a", "b", "tx", "c", "d", "ty")

    def __init__(self, a=1.0, b=0.0, tx=0.0, c=0.0, d=1.0, ty=0.0):
        self.a, self.b, self.tx = a, b, tx
        self.c, self.d, self.ty = c, d, ty

    @staticmethod
    def identity() -> "Mat3":
        return Mat3()

    @staticmethod
    def translation(v: Vec2) -> "Mat3":
        return Mat3(1.0, 0.0, v.x, 0.0, 1.0, v.y)

    @staticmethod
    def rotation(angle: float) -> "Mat3":
        # Positive angles rotate counter-clockwise on the y-down screen,
        # matching the reference's transform convention: its golden
        # render_line_rect shows figLine((90,120)->(710,470)) — a horizontal
        # box rotated by +atan2(350, 620) — sloping up-right on screen.
        co, si = math.cos(angle), math.sin(angle)
        return Mat3(co, si, 0.0, -si, co, 0.0)

    @staticmethod
    def scaling(sx: float, sy: float) -> "Mat3":
        return Mat3(sx, 0.0, 0.0, 0.0, sy, 0.0)

    @staticmethod
    def from_mat4(m) -> "Mat3":
        """XY-affine part of a 4x4 column-major matrix (vmath layout m[col][row]).

        Accepts a nested sequence m[4][4] or a flat 16-sequence, column-major
        like vmath's Mat4 used at transform.matrix (fignodes.nim:112).
        """
        if hasattr(m, "__len__") and len(m) == 16:
            cols = [m[0:4], m[4:8], m[8:12], m[12:16]]
        else:
            cols = m
        # column-major: cols[c][r]
        return Mat3(
            cols[0][0], cols[1][0], cols[3][0],
            cols[0][1], cols[1][1], cols[3][1],
        )

    def __matmul__(self, o: "Mat3") -> "Mat3":
        return Mat3(
            self.a * o.a + self.b * o.c,
            self.a * o.b + self.b * o.d,
            self.a * o.tx + self.b * o.ty + self.tx,
            self.c * o.a + self.d * o.c,
            self.c * o.b + self.d * o.d,
            self.c * o.tx + self.d * o.ty + self.ty,
        )

    def apply(self, v: Vec2) -> Vec2:
        return Vec2(
            self.a * v.x + self.b * v.y + self.tx,
            self.c * v.x + self.d * v.y + self.ty,
        )

    def inverse(self) -> "Mat3":
        det = self.a * self.d - self.b * self.c
        if abs(det) <= 1e-12:
            return Mat3.identity()
        inv_det = 1.0 / det
        ia = self.d * inv_det
        ib = -self.b * inv_det
        ic = -self.c * inv_det
        id_ = self.a * inv_det
        return Mat3(
            ia, ib, -(ia * self.tx + ib * self.ty),
            ic, id_, -(ic * self.tx + id_ * self.ty),
        )

    def mirrors_y(self) -> bool:
        """Whether the transform flips handedness (glcontext.nim:2019-2024)."""
        return (self.a * self.d - self.c * self.b) < 0.0

    def copy(self) -> "Mat3":
        return Mat3(self.a, self.b, self.tx, self.c, self.d, self.ty)

    def __repr__(self) -> str:
        return f"Mat3({self.a},{self.b},{self.tx} / {self.c},{self.d},{self.ty})"


def root_affine(translate=(0.0, 0.0), rotate: float = 0.0, scale=1.0,
                center=(0.0, 0.0)):
    """One animation-table row (m00, m01, m10, m11, tx, ty) for
    render_view's root_transforms: p' = M·p + t with M = R·S — scale
    (scalar or (sx, sy)) then rotate (DEGREES, + = counter-clockwise on the
    y-down screen, node.rotation's convention) about `center`, then
    translate. Equivalent to wrapping the root in
    nkTransform(translation=t, matrix=M), which is exactly what the host
    re-flatten comparison in tests/test_animview.py does.

    rotate=0 degenerates to exact diag(sx, sy) + translate (cos(0)=1 /
    sin(0)=0 are IEEE-exact), preserving the integer/pow-2 bit-exactness
    contract of executor.animate_rows."""
    import numpy as np

    sx, sy = (scale, scale) if np.isscalar(scale) else (scale[0], scale[1])
    rad = math.radians(rotate)
    co, si = math.cos(rad), math.sin(rad)
    # R·S in Mat3's row-major convention (rotation(): a=co b=si c=-si d=co)
    a, b = co * sx, si * sy
    c, d = -si * sx, co * sy
    cx, cy = float(center[0]), float(center[1])
    tx = float(translate[0]) + cx - (a * cx + b * cy)
    ty = float(translate[1]) + cy - (c * cx + d * cy)
    return np.asarray((a, b, c, d, tx, ty), np.float32)
