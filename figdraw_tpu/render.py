"""Backend-agnostic renderer: scene-tree walk emitting backend draw calls.

Port of the hot walk in /root/reference/src/figdraw/figrender.nim — the
renderStages order (:1771-1839), shadow emission (:654-776), rounded-shape
fills/strokes (:806-906), drawable decomposition into lines / SDF quads with
adaptive quadratic spans (:947-1651), image/MSDF nodes (:1673-1732) and the
backdrop-blur pass break (:1734-1754). Draw calls land on any BackendContext
(the tape backend, or a recording backend in tests).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

from .backend import BackendContext, SdfMode, to_backend_fill
from .basics import (
    CornerRadii2D,
    FigFlags,
    FigKind,
    RenderShadow,
    RenderStroke,
    ShadowStyle,
    StrokeCap,
    StrokeJoin,
    init_corner_radii_2d,
    scaled,
)
from .fill import Fill, center_color, fill_alpha_max, fill as make_fill
from .colors import rgba
from .geometry import Rect, Vec2, rect, vec2
from .nodes import (
    DEFAULT_DRAWABLE_BEZIER_STEPS,
    DrawableKind,
    DrawableOp,
    Fig,
    RenderList,
    Renders,
    drawable_line,
)

# Adaptive-curve tuning constants (figrender.nim:1162-1166)
DRAWABLE_ADAPTIVE_TOLERANCE_PX = 0.5
DRAWABLE_SDF_PADDING_PX = 2.0
MAX_ADAPTIVE_DRAWABLE_STEPS = max(DEFAULT_DRAWABLE_BEZIER_STEPS * 4, 64)
MAX_ADAPTIVE_CURVE_DEPTH = 8


def _scaled_corners_2d(corners: CornerRadii2D) -> CornerRadii2D:
    return init_corner_radii_2d(
        [scaled(float(v)) for v in corners.x], [scaled(float(v)) for v in corners.y]
    )


def resolved_corners(node: Fig) -> CornerRadii2D:
    """figrender.nim:565-568: vertical radii come from corner_radii_y only when
    NfEllipticalCorners is set."""
    x = tuple(float(v) for v in node.corners)
    if FigFlags.NfEllipticalCorners in node.flags:
        y = tuple(float(v) for v in node.corner_radii_y)
    else:
        y = x
    return CornerRadii2D(x=x, y=y)


def node_scaled_corners(node: Fig) -> CornerRadii2D:
    return _scaled_corners_2d(resolved_corners(node))


def zero_corners_2d() -> CornerRadii2D:
    return CornerRadii2D()


def uniform_corners_2d(radius: float) -> CornerRadii2D:
    r = float(_radius_corner(radius))
    return init_corner_radii_2d([r, r, r, r])


def _radius_corner(radius: float) -> int:
    if radius <= 0.0:
        return 0
    if radius >= 0xFFFF:
        return 0xFFFF
    return round(radius)


# --- shadows (figrender.nim:654-789) -----------------------------------------


def render_drop_shadows(ctx: BackendContext, node: Fig) -> None:
    for shadow in node.shadows:
        if shadow.style != ShadowStyle.DropShadow:
            continue
        if shadow.blur <= 0.0 and shadow.spread <= 0.0:
            continue
        if fill_alpha_max(shadow.fill) == 0:
            continue
        box = scaled(node.screen_box)
        shadow_x = scaled(shadow.x)
        shadow_y = scaled(shadow.y)
        shadow_blur = scaled(shadow.blur)
        shadow_spread = scaled(shadow.spread)
        from .basics import round_half_away

        blur_pad = round_half_away(1.5 * shadow_blur)
        pad = max(round_half_away(shadow_spread) + blur_pad, 0.0)
        shadow_rect = Rect(box.x + shadow_x, box.y + shadow_y, box.w, box.h)
        quad_rect = Rect(
            shadow_rect.x - pad,
            shadow_rect.y - pad,
            shadow_rect.w + 2.0 * pad,
            shadow_rect.h + 2.0 * pad,
        )
        ctx.draw_rounded_rect_sdf(
            rect=quad_rect,
            fill=to_backend_fill(shadow.fill),
            radii=node_scaled_corners(node),
            mode=SdfMode.sdfModeDropShadow,
            factor=shadow_blur,
            spread=shadow_spread,
            shape_size=shadow_rect.wh,
        )


def render_inner_shadows(ctx: BackendContext, node: Fig) -> None:
    for shadow in node.shadows:
        if shadow.style != ShadowStyle.InnerShadow:
            continue
        if shadow.blur <= 0.0 and shadow.spread <= 0.0:
            continue
        if fill_alpha_max(shadow.fill) == 0:
            continue
        box = scaled(node.screen_box)
        shadow_offset = vec2(scaled(shadow.x), scaled(shadow.y))
        # In inset mode shape_size carries the shadow offset; the backend
        # evaluates clip + offset-shadow distance in one pass.
        ctx.draw_rounded_rect_sdf(
            rect=box,
            fill=to_backend_fill(shadow.fill),
            radii=node_scaled_corners(node),
            mode=SdfMode.sdfModeInsetShadow,
            factor=scaled(shadow.blur),
            spread=scaled(shadow.spread),
            shape_size=shadow_offset,
        )


def has_active_inner_shadow(node: Fig) -> bool:
    for shadow in node.shadows:
        if shadow.style != ShadowStyle.InnerShadow:
            continue
        if shadow.blur <= 0.0 and shadow.spread <= 0.0:
            continue
        if fill_alpha_max(shadow.fill) == 0:
            continue
        return True
    return False


# --- rounded shapes (figrender.nim:806-906) ------------------------------------


def render_rounded_shape_scaled(
    ctx: BackendContext,
    shape_box: Rect,
    shape_fill: Fill,
    shape_stroke: RenderStroke,
    corners: CornerRadii2D,
) -> None:
    box = scaled(shape_box)
    if fill_alpha_max(shape_fill) > 0:
        ctx.draw_rounded_rect_sdf(
            rect=box,
            fill=to_backend_fill(shape_fill),
            radii=corners,
            mode=SdfMode.sdfModeClipAA,
            factor=4.0,
            spread=0.0,
            shape_size=vec2(0, 0),
        )
    if fill_alpha_max(shape_stroke.fill) > 0 and shape_stroke.weight > 0:
        ctx.draw_rounded_rect_sdf(
            rect=box,
            fill=to_backend_fill(shape_stroke.fill),
            radii=corners,
            mode=SdfMode.sdfModeAnnularAA,
            factor=scaled(shape_stroke.weight),
            spread=0.0,
            shape_size=vec2(0, 0),
        )


def render_rounded_shape(
    ctx: BackendContext,
    shape_box: Rect,
    shape_fill: Fill,
    shape_stroke: RenderStroke,
    corners,
) -> None:
    if not isinstance(corners, CornerRadii2D):
        corners = init_corner_radii_2d([float(v) for v in corners])
    render_rounded_shape_scaled(
        ctx, shape_box, shape_fill, shape_stroke, _scaled_corners_2d(corners)
    )


# --- drawables (figrender.nim:908-1651) -----------------------------------------


def _resolve_line_cap(stroke: RenderStroke) -> StrokeCap:
    return StrokeCap.scButt if stroke.cap == StrokeCap.scAuto else stroke.cap


def _resolve_curve_cap(stroke: RenderStroke) -> StrokeCap:
    return StrokeCap.scRound if stroke.cap == StrokeCap.scAuto else stroke.cap


def _resolve_curve_join(stroke: RenderStroke) -> StrokeJoin:
    return StrokeJoin.sjRound if stroke.join == StrokeJoin.sjAuto else stroke.join


def _with_cap(stroke: RenderStroke, cap: StrokeCap) -> RenderStroke:
    return RenderStroke(weight=stroke.weight, fill=stroke.fill, cap=cap, join=stroke.join)


def render_drawable_stroke_cap(
    ctx: BackendContext, center: Vec2, radius: float, fill: Fill
) -> None:
    if radius <= 0.0 or fill_alpha_max(fill) == 0:
        return
    d = radius * 2.0
    box = rect(center.x - radius, center.y - radius, d, d)
    render_rounded_shape(ctx, box, fill, RenderStroke(), uniform_corners_2d(radius))


def render_drawable_line(
    ctx: BackendContext, origin: Vec2, op: DrawableOp, stroke: RenderStroke
) -> None:
    weight = max(0.0, stroke.weight)
    if weight <= 0.0 or fill_alpha_max(stroke.fill) == 0:
        return
    a = origin + op.a
    b = origin + op.b
    delta = b - a
    length = delta.length()
    if length <= 0.0:
        return
    cap = _resolve_line_cap(stroke)
    cap_radius = weight * 0.5
    direction = delta / length
    draw_a, draw_b, draw_length = a, b, length
    if cap == StrokeCap.scSquare:
        draw_a = a - direction * cap_radius
        draw_b = b + direction * cap_radius
        draw_length = length + weight
    center = (draw_a + draw_b) / 2.0
    box = rect(
        center.x - draw_length / 2.0, center.y - weight / 2.0, draw_length, weight
    )
    scaled_box = scaled(box)
    pivot = scaled_box.xy + scaled_box.wh / 2.0
    angle = math.atan2(delta.y, delta.x)

    ctx.save_transform()
    try:
        ctx.translate(pivot)
        ctx.rotate(angle)
        ctx.translate(-pivot)
        render_rounded_shape(ctx, box, stroke.fill, RenderStroke(), zero_corners_2d())
    finally:
        ctx.restore_transform()

    if cap == StrokeCap.scRound:
        render_drawable_stroke_cap(ctx, a, cap_radius, stroke.fill)
        render_drawable_stroke_cap(ctx, b, cap_radius, stroke.fill)


def render_drawable_endpoint_cap(
    ctx: BackendContext,
    origin: Vec2,
    point: Vec2,
    tangent: Vec2,
    radius: float,
    stroke: RenderStroke,
    cap: StrokeCap,
    is_start: bool,
) -> None:
    if radius <= 0.0 or fill_alpha_max(stroke.fill) == 0:
        return
    if cap == StrokeCap.scRound:
        render_drawable_stroke_cap(ctx, origin + point, radius, stroke.fill)
    elif cap == StrokeCap.scSquare:
        direction = tangent.normalized_or(vec2(1.0, 0.0))
        if is_start:
            a, b = point - direction * radius, point
        else:
            a, b = point, point + direction * radius
        render_drawable_line(
            ctx, origin, drawable_line(a, b), _with_cap(stroke, StrokeCap.scButt)
        )


def _line_intersection(p: Vec2, r: Vec2, q: Vec2, s: Vec2) -> Optional[Vec2]:
    denom = r.cross(s)
    if abs(denom) <= 1e-6:
        return None
    t = (q - p).cross(s) / denom
    return p + r * t


def render_drawable_filled_quad(
    ctx: BackendContext, verts: Sequence[Vec2], fill: Fill
) -> None:
    if fill_alpha_max(fill) == 0:
        return
    c = center_color(fill).rgba()
    ctx.draw_filled_quad([scaled(v) for v in verts], [c, c, c, c])


def render_drawable_stroke_join(
    ctx: BackendContext,
    origin: Vec2,
    point: Vec2,
    incoming_tangent: Vec2,
    outgoing_tangent: Vec2,
    radius: float,
    fill: Fill,
    join: StrokeJoin,
) -> None:
    if radius <= 0.0 or fill_alpha_max(fill) == 0:
        return
    if join == StrokeJoin.sjRound:
        render_drawable_stroke_cap(ctx, origin + point, radius, fill)
        return
    if join not in (StrokeJoin.sjBevel, StrokeJoin.sjMiter):
        return
    incoming = incoming_tangent.normalized_or(vec2(1.0, 0.0))
    outgoing = outgoing_tangent.normalized_or(incoming)
    turn = incoming.cross(outgoing)
    if abs(turn) <= 1e-4:
        return
    side = -1.0 if turn > 0.0 else 1.0

    def normal_left(d: Vec2) -> Vec2:
        return vec2(-d.y, d.x)

    incoming_outer = point + normal_left(incoming) * (radius * side)
    outgoing_outer = point + normal_left(outgoing) * (radius * side)
    if join == StrokeJoin.sjMiter:
        miter = _line_intersection(incoming_outer, incoming, outgoing_outer, outgoing)
        if miter is not None and (miter - point).length() <= radius * 4.0:
            render_drawable_filled_quad(
                ctx,
                [origin + point, origin + incoming_outer, origin + miter, origin + outgoing_outer],
                fill,
            )
            return
    render_drawable_filled_quad(
        ctx,
        [origin + point, origin + incoming_outer, origin + outgoing_outer, origin + outgoing_outer],
        fill,
    )


def render_drawable_circle(
    ctx: BackendContext, origin: Vec2, op: DrawableOp, fill: Fill, stroke: RenderStroke
) -> None:
    radius = max(0.0, op.radius)
    if radius <= 0.0:
        return
    d = radius * 2.0
    box = rect(
        origin.x + op.center.x - radius, origin.y + op.center.y - radius, d, d
    )
    render_rounded_shape(ctx, box, fill, stroke, uniform_corners_2d(radius))


def render_drawable_rect(
    ctx: BackendContext, origin: Vec2, op: DrawableOp, fill: Fill, stroke: RenderStroke
) -> None:
    box = rect(origin.x + op.box.x, origin.y + op.box.y, op.box.w, op.box.h)
    render_rounded_shape(ctx, box, fill, stroke, init_corner_radii_2d([float(v) for v in op.corners]))


def render_drawable_ellipse(
    ctx: BackendContext, origin: Vec2, op: DrawableOp, fill: Fill, stroke: RenderStroke
) -> None:
    radii = vec2(max(0.0, op.ellipse_radii.x), max(0.0, op.ellipse_radii.y))
    if radii.x <= 0.0 or radii.y <= 0.0:
        return
    box = rect(
        origin.x + op.ellipse_center.x - radii.x,
        origin.y + op.ellipse_center.y - radii.y,
        radii.x * 2.0,
        radii.y * 2.0,
    )
    corners = init_corner_radii_2d([radii.x] * 4, [radii.y] * 4)
    render_rounded_shape(ctx, box, fill, stroke, corners)


# --- bezier/arc decomposition (figrender.nim:1134-1611) --------------------------


def bezier_point(controls: Sequence[Vec2], t: float) -> Vec2:
    if not controls:
        return vec2(0, 0)
    work = list(controls)
    count = len(work)
    while count > 1:
        for i in range(count - 1):
            work[i] = work[i] * (1.0 - t) + work[i + 1] * t
        count -= 1
    return work[0]


def quadratic_point(p0: Vec2, p1: Vec2, p2: Vec2, t: float) -> Vec2:
    inv = 1.0 - t
    return p0 * (inv * inv) + p1 * (2.0 * inv * t) + p2 * (t * t)


def is_flat_quadratic(p0: Vec2, p1: Vec2, p2: Vec2) -> bool:
    return abs((p1 - p0).cross(p2 - p1)) <= 1e-4


class QuadraticSpan:
    __slots__ = ("p0", "p1", "p2")

    def __init__(self, p0: Vec2, p1: Vec2, p2: Vec2):
        self.p0, self.p1, self.p2 = p0, p1, p2

    def start_tangent(self) -> Vec2:
        return (self.p1 - self.p0).normalized_or(
            (self.p2 - self.p0).normalized_or(vec2(1.0, 0.0))
        )

    def end_tangent(self) -> Vec2:
        return (self.p2 - self.p1).normalized_or(
            (self.p2 - self.p0).normalized_or(vec2(1.0, 0.0))
        )


def _bezier_quadratic_span(controls: Sequence[Vec2], t0: float, t2: float) -> QuadraticSpan:
    tm = (t0 + t2) * 0.5
    p0 = bezier_point(controls, t0)
    pm = bezier_point(controls, tm)
    p2 = bezier_point(controls, t2)
    p1 = pm * 2.0 - (p0 + p2) * 0.5
    return QuadraticSpan(p0, p1, p2)


def _quadratic_approx_error_px(
    controls: Sequence[Vec2], span: QuadraticSpan, t0: float, t2: float
) -> float:
    err = 0.0
    for local_t in (0.25, 0.75):
        t = t0 + (t2 - t0) * local_t
        actual = bezier_point(controls, t)
        approx = quadratic_point(span.p0, span.p1, span.p2, local_t)
        err = max(err, scaled(actual - approx).length())
    return err


def _append_adaptive_bezier_span(
    controls: Sequence[Vec2],
    t0: float,
    t2: float,
    depth: int,
    spans: List[QuadraticSpan],
) -> None:
    span = _bezier_quadratic_span(controls, t0, t2)
    error = _quadratic_approx_error_px(controls, span, t0, t2)
    if (
        error <= DRAWABLE_ADAPTIVE_TOLERANCE_PX
        or depth >= MAX_ADAPTIVE_CURVE_DEPTH
        or len(spans) >= MAX_ADAPTIVE_DRAWABLE_STEPS - 1
    ):
        spans.append(span)
    else:
        tm = (t0 + t2) * 0.5
        _append_adaptive_bezier_span(controls, t0, tm, depth + 1, spans)
        _append_adaptive_bezier_span(controls, tm, t2, depth + 1, spans)


def adaptive_bezier_spans(controls: Sequence[Vec2]) -> List[QuadraticSpan]:
    spans: List[QuadraticSpan] = []
    _append_adaptive_bezier_span(controls, 0.0, 1.0, 0, spans)
    return spans


def fixed_bezier_spans(controls: Sequence[Vec2], steps: int) -> List[QuadraticSpan]:
    return [
        _bezier_quadratic_span(controls, s / steps, (s + 1) / steps)
        for s in range(steps)
    ]


def _explicit_step_count(steps: int, node_steps: int) -> int:
    if steps != 0:
        return max(1, steps)
    if node_steps != 0:
        return max(1, node_steps)
    return 0


def _distance_to_line(p: Vec2, a: Vec2, b: Vec2) -> float:
    ab = b - a
    denom = ab.dot(ab)
    if denom <= 1e-6:
        return (p - a).length()
    h = min(max((p - a).dot(ab) / denom, 0.0), 1.0)
    return (p - (a + ab * h)).length()


def bezier_segment_points(controls: Sequence[Vec2], fixed_steps: int) -> List[Vec2]:
    points = [bezier_point(controls, 0.0)]
    if fixed_steps > 0:
        for step in range(1, fixed_steps + 1):
            points.append(bezier_point(controls, step / fixed_steps))
        return points

    def recurse(t0: float, t2: float, depth: int) -> None:
        p0 = bezier_point(controls, t0)
        p2 = bezier_point(controls, t2)
        tm = (t0 + t2) * 0.5
        pm = bezier_point(controls, tm)
        error = _distance_to_line(scaled(pm), scaled(p0), scaled(p2))
        if (
            error <= DRAWABLE_ADAPTIVE_TOLERANCE_PX
            or depth >= MAX_ADAPTIVE_CURVE_DEPTH
            or len(points) >= MAX_ADAPTIVE_DRAWABLE_STEPS
        ):
            points.append(p2)
        else:
            recurse(t0, tm, depth + 1)
            recurse(tm, t2, depth + 1)

    recurse(0.0, 1.0, 0)
    return points


def _quadratic_bounds(p0: Vec2, p1: Vec2, p2: Vec2, padding: float) -> Rect:
    min_p = vec2(min(p0.x, p2.x), min(p0.y, p2.y))
    max_p = vec2(max(p0.x, p2.x), max(p0.y, p2.y))

    def include(p: Vec2):
        nonlocal min_p, max_p
        min_p = vec2(min(min_p.x, p.x), min(min_p.y, p.y))
        max_p = vec2(max(max_p.x, p.x), max(max_p.y, p.y))

    denom_x = p0.x - 2.0 * p1.x + p2.x
    if abs(denom_x) > 1e-6:
        t = (p0.x - p1.x) / denom_x
        if 0.0 < t < 1.0:
            include(quadratic_point(p0, p1, p2, t))
    denom_y = p0.y - 2.0 * p1.y + p2.y
    if abs(denom_y) > 1e-6:
        t = (p0.y - p1.y) / denom_y
        if 0.0 < t < 1.0:
            include(quadratic_point(p0, p1, p2, t))
    return rect(
        min_p.x - padding,
        min_p.y - padding,
        max_p.x - min_p.x + padding * 2.0,
        max_p.y - min_p.y + padding * 2.0,
    )


def render_drawable_quadratic_bezier_sdf(
    ctx: BackendContext,
    origin: Vec2,
    p0: Vec2,
    p1: Vec2,
    p2: Vec2,
    stroke: RenderStroke,
    cap: StrokeCap = StrokeCap.scAuto,
) -> None:
    resolved_cap = _resolve_curve_cap(stroke) if cap == StrokeCap.scAuto else cap
    if is_flat_quadratic(p0, p1, p2):
        render_drawable_line(ctx, origin, drawable_line(p0, p2), _with_cap(stroke, resolved_cap))
        return
    stroke_weight = max(0.0, stroke.weight)
    from .basics import descaled

    padding = stroke_weight * 0.5 + descaled(DRAWABLE_SDF_PADDING_PX)
    a, b, c = origin + p0, origin + p1, origin + p2
    box = _quadratic_bounds(a, b, c, padding)
    if box.w <= 0.0 or box.h <= 0.0:
        return
    center = box.xy + box.wh * 0.5
    ctx.draw_quadratic_bezier_sdf(
        rect=scaled(box),
        fill=to_backend_fill(stroke.fill),
        p0=scaled(a - center),
        p1=scaled(b - center),
        p2=scaled(c - center),
        stroke_weight=scaled(stroke_weight),
        cap=resolved_cap,
    )


def render_drawable_bezier_quadratics(
    ctx: BackendContext, origin: Vec2, op: DrawableOp, stroke: RenderStroke, node_steps: int
) -> None:
    fixed_steps = _explicit_step_count(op.steps, node_steps)
    spans = (
        fixed_bezier_spans(op.controls, fixed_steps)
        if fixed_steps > 0
        else adaptive_bezier_spans(op.controls)
    )
    cap = _resolve_curve_cap(stroke)
    join = _resolve_curve_join(stroke)
    simple_round = cap == StrokeCap.scRound and join == StrokeJoin.sjRound
    span_cap = StrokeCap.scRound if simple_round else StrokeCap.scButt
    cap_radius = max(0.0, stroke.weight) / 2.0
    previous: Optional[QuadraticSpan] = None
    for step, span in enumerate(spans):
        render_drawable_quadratic_bezier_sdf(
            ctx, origin, span.p0, span.p1, span.p2, stroke, span_cap
        )
        if not simple_round:
            if step == 0:
                render_drawable_endpoint_cap(
                    ctx, origin, span.p0, span.start_tangent(), cap_radius, stroke, cap, True
                )
            else:
                render_drawable_stroke_join(
                    ctx,
                    origin,
                    span.p0,
                    previous.end_tangent(),
                    span.start_tangent(),
                    cap_radius,
                    stroke.fill,
                    join,
                )
            if step == len(spans) - 1:
                render_drawable_endpoint_cap(
                    ctx, origin, span.p2, span.end_tangent(), cap_radius, stroke, cap, False
                )
        previous = span


def render_drawable_bezier_segments(
    ctx: BackendContext, origin: Vec2, op: DrawableOp, stroke: RenderStroke, node_steps: int
) -> None:
    if len(op.controls) < 2:
        return
    if stroke.weight <= 0.0 or fill_alpha_max(stroke.fill) == 0:
        return
    fixed_steps = _explicit_step_count(op.steps, node_steps)
    points = bezier_segment_points(op.controls, fixed_steps)
    if len(points) < 2:
        return
    cap = _resolve_curve_cap(stroke)
    join = _resolve_curve_join(stroke)
    cap_radius = max(0.0, stroke.weight) / 2.0
    segment_stroke = _with_cap(stroke, StrokeCap.scButt)
    previous = points[0]
    previous_tangent = vec2(1.0, 0.0)
    for step in range(1, len(points)):
        current = points[step]
        tangent = current - previous
        render_drawable_line(ctx, origin, drawable_line(previous, current), segment_stroke)
        if step == 1:
            render_drawable_endpoint_cap(
                ctx, origin, previous, tangent, cap_radius, stroke, cap, True
            )
        else:
            render_drawable_stroke_join(
                ctx, origin, previous, previous_tangent, tangent, cap_radius, stroke.fill, join
            )
        if step == len(points) - 1:
            render_drawable_endpoint_cap(
                ctx, origin, current, tangent, cap_radius, stroke, cap, False
            )
        previous = current
        previous_tangent = tangent


def render_drawable_bezier(
    ctx: BackendContext, origin: Vec2, op: DrawableOp, stroke: RenderStroke, node_steps: int
) -> None:
    if len(op.controls) < 2:
        return
    if stroke.weight <= 0.0 or fill_alpha_max(stroke.fill) == 0:
        return
    if len(op.controls) == 3:
        render_drawable_quadratic_bezier_sdf(
            ctx,
            origin,
            op.controls[0],
            op.controls[1],
            op.controls[2],
            stroke,
            _resolve_curve_cap(stroke),
        )
        return
    if len(op.controls) > 3:
        render_drawable_bezier_quadratics(ctx, origin, op, stroke, node_steps)
        return
    render_drawable_bezier_segments(ctx, origin, op, stroke, node_steps)


def _arc_point(center: Vec2, radius: float, angle: float) -> Vec2:
    return center + vec2(math.cos(angle) * radius, math.sin(angle) * radius)


def _adaptive_arc_step_count(radius: float, sweep_angle: float) -> int:
    radius_px = max(0.0, scaled(radius))
    abs_sweep = abs(sweep_angle)
    if radius_px <= 0.0 or abs_sweep <= 0.0:
        return 1
    cos_limit = min(max(1.0 - DRAWABLE_ADAPTIVE_TOLERANCE_PX / radius_px, -1.0), 1.0)
    max_angle = max(0.01, 2.0 * math.acos(cos_limit))
    return min(max(math.ceil(abs_sweep / max_angle), 1), MAX_ADAPTIVE_DRAWABLE_STEPS)


def _arc_step_count(op: DrawableOp, node_steps: int) -> int:
    explicit = _explicit_step_count(op.arc_steps, node_steps)
    if explicit > 0:
        return explicit
    return _adaptive_arc_step_count(op.arc_radius, op.sweep_angle)


def _arc_quadratic_span(op: DrawableOp, step: int, steps: int, radius: float) -> QuadraticSpan:
    t0 = step / steps
    t2 = (step + 1) / steps
    tm = (t0 + t2) * 0.5
    a0 = op.start_angle + op.sweep_angle * t0
    a2 = op.start_angle + op.sweep_angle * t2
    am = op.start_angle + op.sweep_angle * tm
    p0 = _arc_point(op.arc_center, radius, a0)
    pm = _arc_point(op.arc_center, radius, am)
    p2 = _arc_point(op.arc_center, radius, a2)
    p1 = pm * 2.0 - (p0 + p2) * 0.5
    return QuadraticSpan(p0, p1, p2)


def render_drawable_arc(
    ctx: BackendContext, origin: Vec2, op: DrawableOp, stroke: RenderStroke, node_steps: int
) -> None:
    radius = max(0.0, op.arc_radius)
    if radius <= 0.0 or op.sweep_angle == 0.0:
        return
    if stroke.weight <= 0.0 or fill_alpha_max(stroke.fill) == 0:
        return
    steps = _arc_step_count(op, node_steps)
    cap = _resolve_curve_cap(stroke)
    join = _resolve_curve_join(stroke)
    simple_round = cap == StrokeCap.scRound and join == StrokeJoin.sjRound
    span_cap = StrokeCap.scRound if simple_round else StrokeCap.scButt
    cap_radius = max(0.0, stroke.weight) / 2.0
    previous: Optional[QuadraticSpan] = None
    for step in range(steps):
        span = _arc_quadratic_span(op, step, steps, radius)
        render_drawable_quadratic_bezier_sdf(
            ctx, origin, span.p0, span.p1, span.p2, stroke, span_cap
        )
        if not simple_round:
            if step == 0:
                render_drawable_endpoint_cap(
                    ctx, origin, span.p0, span.start_tangent(), cap_radius, stroke, cap, True
                )
            else:
                render_drawable_stroke_join(
                    ctx,
                    origin,
                    span.p0,
                    previous.end_tangent(),
                    span.start_tangent(),
                    cap_radius,
                    stroke.fill,
                    join,
                )
            if step == steps - 1:
                render_drawable_endpoint_cap(
                    ctx, origin, span.p2, span.end_tangent(), cap_radius, stroke, cap, False
                )
        previous = span


def render_drawable_ops(ctx: BackendContext, node: Fig) -> None:
    origin = node.screen_box.xy
    fill = node.fill
    stroke = node.draw_stroke
    node_steps = node.draw_steps
    for op in node.draw_ops:
        if op.kind == DrawableKind.dkLine:
            render_drawable_line(ctx, origin, op, stroke)
        elif op.kind == DrawableKind.dkCircle:
            render_drawable_circle(ctx, origin, op, fill, stroke)
        elif op.kind == DrawableKind.dkRectangle:
            render_drawable_rect(ctx, origin, op, fill, stroke)
        elif op.kind == DrawableKind.dkBezier:
            render_drawable_bezier(ctx, origin, op, stroke, node_steps)
        elif op.kind == DrawableKind.dkArc:
            render_drawable_arc(ctx, origin, op, stroke, node_steps)
        elif op.kind == DrawableKind.dkEllipse:
            render_drawable_ellipse(ctx, origin, op, fill, stroke)


def render_drawable(ctx: BackendContext, node: Fig) -> None:
    """Per-node AA override wrapper (figrender.nim:1653-1667)."""
    if node.draw_aa <= 0.0:
        render_drawable_ops(ctx, node)
        return
    old_aa = ctx.sdf_aa_factor()
    if old_aa == node.draw_aa:
        render_drawable_ops(ctx, node)
        return
    ctx.set_sdf_aa_factor(node.draw_aa)
    try:
        render_drawable_ops(ctx, node)
    finally:
        ctx.set_sdf_aa_factor(old_aa)


# --- node kinds -----------------------------------------------------------------


def render_boxes(ctx: BackendContext, node: Fig) -> None:
    render_rounded_shape_scaled(
        ctx,
        node.screen_box,
        node.fill,
        node.stroke,
        _scaled_corners_2d(resolved_corners(node)),
    )


def render_image(ctx: BackendContext, node: Fig) -> None:
    if node.image.id == 0:
        return
    box = scaled(node.screen_box)
    c = center_color(node.image.fill).rgba()
    ctx.draw_image(
        node.image.id,
        pos=box.xy,
        colors=(c, c, c, c),
        size=vec2(box.w, box.h),
        flip_y=FigFlags.NfInvertY in node.flags,
    )


def _msdf_params(style) -> Tuple[float, float, float]:
    px_range = style.px_range if style.px_range > 0.0 else 4.0
    sd_threshold = (
        style.sd_threshold if 0.0 < style.sd_threshold < 1.0 else 0.5
    )
    stroke_weight = scaled(max(0.0, style.stroke_weight))
    return px_range, sd_threshold, stroke_weight


def render_msdf_image(ctx: BackendContext, node: Fig) -> None:
    if node.msdf_image.id == 0:
        return
    box = scaled(node.screen_box)
    px_range, sd_threshold, stroke_weight = _msdf_params(node.msdf_image)
    ctx.draw_msdf_image(
        node.msdf_image.id,
        pos=box.xy,
        color=center_color(node.msdf_image.fill),
        size=vec2(box.w, box.h),
        px_range=px_range,
        sd_threshold=sd_threshold,
        stroke_weight=stroke_weight,
        flip_y=FigFlags.NfInvertY in node.flags,
    )


def render_mtsdf_image(ctx: BackendContext, node: Fig) -> None:
    if node.mtsdf_image.id == 0:
        return
    box = scaled(node.screen_box)
    px_range, sd_threshold, stroke_weight = _msdf_params(node.mtsdf_image)
    ctx.draw_mtsdf_image(
        node.mtsdf_image.id,
        pos=box.xy,
        color=center_color(node.mtsdf_image.fill),
        size=vec2(box.w, box.h),
        px_range=px_range,
        sd_threshold=sd_threshold,
        stroke_weight=stroke_weight,
        flip_y=FigFlags.NfInvertY in node.flags,
    )


def render_backdrop_blur(ctx: BackendContext, node: Fig) -> None:
    box = scaled(node.screen_box)
    if node.backdrop_blur.blur > 0.0:
        ctx.draw_backdrop_blur(
            rect=box,
            radii=node_scaled_corners(node),
            blur_radius=scaled(node.backdrop_blur.blur),
        )
    if fill_alpha_max(node.fill) == 0:
        return
    overlay = Fig(kind=FigKind.nkRectangle)
    overlay.screen_box = node.screen_box
    overlay.fill = node.fill
    overlay.corners = node.corners
    overlay.corner_radii_y = node.corner_radii_y
    if FigFlags.NfEllipticalCorners in node.flags:
        overlay.flags |= FigFlags.NfEllipticalCorners
    overlay.stroke = RenderStroke(weight=0.0, fill=make_fill(rgba(0, 0, 0, 0)))
    render_boxes(ctx, overlay)


def render_text(ctx: BackendContext, node: Fig) -> None:
    """Text node rendering. Full glyph pipeline lands with the text subsystem;
    the walk hook exists so text layout integration is a backend concern only
    (figrender.nim:417-497)."""
    from .text.rendertext import render_text_node

    render_text_node(ctx, node)


# --- the per-node stage machine (figrender.nim:1756-1839) -------------------------


def render_node(ctx: BackendContext, lst, cursor) -> None:
    if isinstance(lst, RenderList):
        node = lst.nodes[cursor]
    else:
        node = lst.node_at(cursor)
    if FigFlags.NfDisableRender in node.flags:
        return
    box = scaled(node.screen_box)

    did_rotation = node.rotation != 0
    if did_rotation:
        ctx.save_transform()
        center = box.xy + box.wh / 2
        ctx.translate(center)
        ctx.rotate(node.rotation / 180.0 * math.pi)
        ctx.translate(-center)

    did_transform = node.kind == FigKind.nkTransform
    if did_transform:
        ctx.save_transform()
        if node.transform.translation.x != 0.0 or node.transform.translation.y != 0.0:
            ctx.translate(scaled(node.transform.translation))
        if node.transform.use_matrix:
            ctx.apply_transform(node.transform.matrix)

    if node.kind == FigKind.nkRectangle:
        render_drop_shadows(ctx, node)

    did_clip = FigFlags.NfClipContent in node.flags
    if did_clip:
        ctx.begin_mask(scaled(node.screen_box), node_scaled_corners(node))
        ctx.end_mask()

    did_rect_mask = FigFlags.NfRectMaskContent in node.flags
    if did_rect_mask:
        ctx.begin_rect_mask(scaled(node.screen_box), node_scaled_corners(node))

    if node.kind == FigKind.nkText:
        render_text(ctx, node)
    elif node.kind == FigKind.nkDrawable:
        render_drawable(ctx, node)
    elif node.kind == FigKind.nkRectangle:
        render_boxes(ctx, node)
    elif node.kind == FigKind.nkImage:
        render_image(ctx, node)
    elif node.kind == FigKind.nkMsdfImage:
        render_msdf_image(ctx, node)
    elif node.kind == FigKind.nkMtsdfImage:
        render_mtsdf_image(ctx, node)
    elif node.kind == FigKind.nkBackdropBlur:
        render_backdrop_blur(ctx, node)

    if node.kind == FigKind.nkRectangle and has_active_inner_shadow(node):
        render_inner_shadows(ctx, node)

    for child in children_of(lst, cursor):
        render_node(ctx, lst, child)

    # LIFO cleanup (postRender)
    if did_rect_mask:
        ctx.pop_rect_mask()
    if did_clip:
        ctx.pop_mask()
    if did_transform:
        ctx.restore_transform()
    if did_rotation:
        ctx.restore_transform()


def children_of(lst, cursor):
    """Iterate children for either a RenderList index or a fragment cursor."""
    if isinstance(lst, RenderList):
        return lst.child_index(cursor)
    return lst.children(cursor)


def render_root(ctx: BackendContext, renders) -> None:
    """Draw every layer's roots in ZLevel order (figrender.nim:1946-1955)."""
    if isinstance(renders, Renders):
        for zlvl, lst in renders.sorted_pairs():
            for root in lst.root_ids:
                render_node(ctx, lst, root)
    else:
        # RenderFragments-like input
        for zlvl in renders.zlevels():
            for root in renders.roots(zlvl):
                render_node(ctx, renders, root)
