"""Backend-agnostic draw contract: SdfMode, BackendFill, BackendContext.

Mirrors /root/reference/src/figdraw/figbackend.nim (SdfMode enum :36-52,
BackendFill :91-127, gradientColors :161-183, the ~40-method BackendContext
contract :185-705) plus the quad-encoding helpers from
opengl/glcontext.nim:743-1008 (corner-radius packing, sdf-mode packing) that
every backend shares.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import List, Tuple

from .basics import CornerRadii2D, StrokeCap
from .colors import Color, ColorRGBA, lerp_color
from .fill import Fill, FillGradientAxis, FillKind, gradient_mid_pos01
from .geometry import Mat3, Rect, Vec2, vec2

DEFAULT_SDF_AA_FACTOR = 1.2  # figbackend.nim:34


class SdfMode(enum.IntEnum):
    """The central shading contract (figbackend.nim:36-52)."""

    sdfModeAtlas = 0
    sdfModeClipAA = 3
    sdfModeDropShadow = 7
    sdfModeDropShadowAA = 8
    sdfModeInsetShadow = 9
    sdfModeInsetShadowAnnular = 10
    sdfModeAnnular = 11
    sdfModeAnnularAA = 12
    sdfModeMsdf = 13
    sdfModeMtsdf = 14
    sdfModeMsdfAnnular = 15
    sdfModeMtsdfAnnular = 16
    sdfModeBackdropBlur = 17
    sdfModeBezierStrokeAA = 18
    sdfModeBezierStrokeButtAA = 19
    sdfModeBezierStrokeSquareAA = 20


def bezier_stroke_sdf_mode(cap: StrokeCap) -> SdfMode:
    """figbackend.nim:54-58."""
    if cap == StrokeCap.scButt:
        return SdfMode.sdfModeBezierStrokeButtAA
    if cap == StrokeCap.scSquare:
        return SdfMode.sdfModeBezierStrokeSquareAA
    return SdfMode.sdfModeBezierStrokeAA


# --- Fill mode / sdf mode packing (glcontext.nim:986-1008) -------------------

SDF_FILL_SOLID_OR_VERTEX = 0
SDF_FILL_LINEAR3_X = 1
SDF_FILL_LINEAR3_Y = 2
SDF_FILL_LINEAR3_DIAG_TLBR = 3
SDF_FILL_LINEAR3_DIAG_BLTR = 4
SDF_ELLIPTICAL_RADII_FLAG = 128
SDF_FILL_MODE_SHIFT = 256


def linear3_fill_mode(axis: FillGradientAxis) -> int:
    return {
        FillGradientAxis.fgaX: SDF_FILL_LINEAR3_X,
        FillGradientAxis.fgaY: SDF_FILL_LINEAR3_Y,
        FillGradientAxis.fgaDiagTLBR: SDF_FILL_LINEAR3_DIAG_TLBR,
        FillGradientAxis.fgaDiagBLTR: SDF_FILL_LINEAR3_DIAG_BLTR,
    }[axis]


def encode_sdf_mode(mode: SdfMode, fill_mode: int, elliptical_radii: bool = False) -> int:
    return (
        int(mode)
        + (SDF_ELLIPTICAL_RADII_FLAG if elliptical_radii else 0)
        + fill_mode * SDF_FILL_MODE_SHIFT
    )


# --- Corner-radius packing (glcontext.nim:743-817) ---------------------------


def _clamp_radius(radius: float, max_radius: float) -> float:
    if radius <= 0.0:
        return 0.0
    from .basics import round_half_away

    return round_half_away(max(1.0, min(radius, max_radius)))


def rounded_radii_vec(
    radii: CornerRadii2D, half_extents: Vec2
) -> Tuple[Tuple[float, float, float, float], bool]:
    """Pack per-corner radii for the shader.

    Circular corners keep the scalar encoding; elliptical corners pack two
    normalized 12-bit components per float, with negative values marking a
    circular corner as -(radius+1). Output vec order: (TR, BR, TL, BL).
    Index order of CornerRadii2D.x/y is (TL, TR, BL, BR).
    """
    TL, TR, BL, BR = 0, 1, 2, 3
    if radii.is_circular:
        max_radius = min(half_extents.x, half_extents.y)
        c = [_clamp_radius(radii.x[i], max_radius) for i in range(4)]
        return ((c[TR], c[BR], c[TL], c[BL]), False)

    rx = [_clamp_radius(radii.x[i], half_extents.x) for i in range(4)]
    ry = [_clamp_radius(radii.y[i], half_extents.y) for i in range(4)]
    circle_max_radius = min(half_extents.x, half_extents.y)

    from .basics import round_half_away

    def pack(radius_x: float, radius_y: float) -> float:
        qx = round_half_away(min(max(radius_x / max(half_extents.x, 1e-6), 0.0), 1.0) * 4095.0)
        qy = round_half_away(min(max(radius_y / max(half_extents.y, 1e-6), 0.0), 1.0) * 4095.0)
        return qx + qy * 4096.0

    def encode_corner(i: int) -> float:
        same_input_axes = radii.x[i] == radii.y[i]
        circle_radius = _clamp_radius(radii.x[i], circle_max_radius)
        if same_input_axes:
            return -(circle_radius + 1.0)
        if rx[i] == ry[i]:
            return -(rx[i] + 1.0)
        return pack(rx[i], ry[i])

    return (
        (encode_corner(TR), encode_corner(BR), encode_corner(TL), encode_corner(BL)),
        True,
    )


# --- BackendFill --------------------------------------------------------------


class BackendFillKind(enum.IntEnum):
    bfColor = 0
    bfLinear2 = 1
    bfLinear3 = 2


@dataclass(frozen=True, slots=True)
class BackendFill:
    kind: BackendFillKind = BackendFillKind.bfColor
    color: ColorRGBA = ColorRGBA()
    axis: FillGradientAxis = FillGradientAxis.fgaX
    start: ColorRGBA = ColorRGBA()
    mid: ColorRGBA = ColorRGBA()
    stop: ColorRGBA = ColorRGBA()
    mid_pos: float = 0.5


def to_backend_fill(f: Fill) -> BackendFill:
    """figbackend.nim:108-127."""
    if f.kind == FillKind.flColor:
        return BackendFill(kind=BackendFillKind.bfColor, color=f.color)
    if f.kind == FillKind.flLinear2:
        return BackendFill(
            kind=BackendFillKind.bfLinear2,
            axis=f.lin2.axis,
            start=f.lin2.start,
            stop=f.lin2.stop,
        )
    return BackendFill(
        kind=BackendFillKind.bfLinear3,
        axis=f.lin3.axis,
        start=f.lin3.start,
        mid=f.lin3.mid,
        stop=f.lin3.stop,
        mid_pos=gradient_mid_pos01(f),
    )


def backend_fill_sample(f: BackendFill, t: float) -> ColorRGBA:
    if f.kind == BackendFillKind.bfColor:
        return f.color
    if f.kind == BackendFillKind.bfLinear2:
        return lerp_color(f.start, f.stop, t)
    tt = min(max(t, 0.0), 1.0)
    if tt <= f.mid_pos:
        return lerp_color(f.start, f.mid, tt / f.mid_pos)
    return lerp_color(f.mid, f.stop, (tt - f.mid_pos) / (1.0 - f.mid_pos))


def gradient_colors(f: BackendFill) -> Tuple[ColorRGBA, ColorRGBA, ColorRGBA, ColorRGBA]:
    """Map a fill's gradient axis to 4 vertex colors; order 0=BL 1=BR 2=TR 3=TL
    (figbackend.nim:161-183)."""
    axis = FillGradientAxis.fgaX if f.kind == BackendFillKind.bfColor else f.axis
    s = lambda t: backend_fill_sample(f, t)
    if axis == FillGradientAxis.fgaX:
        return (s(0.0), s(1.0), s(1.0), s(0.0))
    if axis == FillGradientAxis.fgaY:
        return (s(1.0), s(1.0), s(0.0), s(0.0))
    if axis == FillGradientAxis.fgaDiagTLBR:
        return (s(0.5), s(1.0), s(0.5), s(0.0))
    return (s(0.0), s(0.5), s(1.0), s(0.5))


# --- BackendContext base --------------------------------------------------------


class BackendContext:
    """Abstract draw-target contract (figbackend.nim:185-705).

    Implements the pieces every backend shares — the transform stack and SDF AA
    factor — and leaves draw methods to subclasses (the tape backend, the
    recording test backend).
    """

    def __init__(self) -> None:
        self.mat: Mat3 = Mat3.identity()
        self.mats: List[Mat3] = []
        self.aa_factor: float = DEFAULT_SDF_AA_FACTOR
        self._pixel_scale: float = 1.0
        self.frame_size: Vec2 = vec2(0, 0)
        self.frame_begun: bool = False
        self._text_subpixel_shift: float = 0.0
        self._text_lcd_filtering = False
        self._text_subpixel_positioning = False
        self._text_subpixel_glyph_variants = False

    # transforms (glcontext.nim:1991-2029)
    def translate(self, v: Vec2) -> None:
        self.mat = self.mat @ Mat3.translation(v)

    def rotate(self, angle: float) -> None:
        self.mat = self.mat @ Mat3.rotation(angle)

    def scale(self, s) -> None:
        if isinstance(s, Vec2):
            self.mat = self.mat @ Mat3.scaling(s.x, s.y)
        else:
            self.mat = self.mat @ Mat3.scaling(s, s)

    def apply_transform(self, m: Mat3) -> None:
        self.mat = self.mat @ m

    def save_transform(self) -> None:
        self.mats.append(self.mat.copy())

    def restore_transform(self) -> None:
        self.mat = self.mats.pop()

    def clear_transform(self) -> None:
        self.mat = Mat3.identity()
        self.mats.clear()

    def transform_mirrors_y(self) -> bool:
        return self.mat.mirrors_y()

    # sdf AA factor
    def sdf_aa_factor(self) -> float:
        return self.aa_factor

    def set_sdf_aa_factor(self, aa_factor: float) -> None:
        self.aa_factor = aa_factor

    @property
    def pixel_scale(self) -> float:
        return self._pixel_scale

    # text runtime flags (figbackend.nim:663-686)
    def text_lcd_filtering_enabled(self) -> bool:
        return self._text_lcd_filtering

    def set_text_lcd_filtering_enabled(self, enabled: bool) -> None:
        self._text_lcd_filtering = enabled

    def text_subpixel_positioning_enabled(self) -> bool:
        return self._text_subpixel_positioning

    def set_text_subpixel_positioning_enabled(self, enabled: bool) -> None:
        self._text_subpixel_positioning = enabled

    def text_subpixel_glyph_variants_enabled(self) -> bool:
        return self._text_subpixel_glyph_variants

    def set_text_subpixel_glyph_variants_enabled(self, enabled: bool) -> None:
        self._text_subpixel_glyph_variants = enabled

    def set_text_subpixel_shift(self, shift: float) -> None:
        self._text_subpixel_shift = shift

    # --- draw contract; subclasses override what they support ----------------

    def draw_rounded_rect_sdf(
        self,
        rect: Rect,
        fill,  # BackendFill | Color | (c0, c1, c2, c3) vertex colors
        radii: CornerRadii2D,
        mode: SdfMode = SdfMode.sdfModeClipAA,
        factor: float = 4.0,
        spread: float = 0.0,
        shape_size: Vec2 = vec2(0, 0),
    ) -> None:
        raise NotImplementedError

    def draw_quadratic_bezier_sdf(
        self,
        rect: Rect,
        fill,
        p0: Vec2,
        p1: Vec2,
        p2: Vec2,
        stroke_weight: float,
        cap: StrokeCap,
    ) -> None:
        raise NotImplementedError

    def draw_filled_quad(self, verts, colors) -> None:
        raise NotImplementedError

    def draw_image(self, image_id, pos: Vec2, colors, size: Vec2, flip_y: bool) -> None:
        raise NotImplementedError

    def draw_msdf_image(
        self, image_id, pos, color, size, px_range, sd_threshold, stroke_weight, flip_y=False
    ) -> None:
        raise NotImplementedError

    def draw_mtsdf_image(
        self, image_id, pos, color, size, px_range, sd_threshold, stroke_weight, flip_y=False
    ) -> None:
        raise NotImplementedError

    def draw_backdrop_blur(self, rect: Rect, radii: CornerRadii2D, blur_radius: float) -> None:
        raise NotImplementedError

    def begin_mask(self, clip_rect: Rect, radii: CornerRadii2D) -> None:
        raise NotImplementedError

    def end_mask(self) -> None:
        raise NotImplementedError

    def pop_mask(self) -> None:
        raise NotImplementedError

    def begin_rect_mask(self, mask_rect: Rect, radii: CornerRadii2D) -> None:
        # Default: fall back to a real mask (figbackend.nim:619-623)
        self.begin_mask(mask_rect, radii)
        self.end_mask()

    def pop_rect_mask(self) -> None:
        self.pop_mask()

    def begin_frame(self, frame_size: Vec2, clear_main: bool, clear_main_color: Color) -> None:
        raise NotImplementedError

    def end_frame(self) -> None:
        raise NotImplementedError

    def has_image(self, key) -> bool:
        return False
