"""figdraw_tpu — a 2D SDF rendering engine in JAX.

A from-scratch JAX/Pallas re-build with the capabilities of the reference
figdraw engine (/root/reference): retained-list scene graphs of SDF-shaded
primitives (rounded rects, borders, shadows, gradients, beziers, images,
MSDF glyphs), ZLevel layer compositing, clip/rect masks and backdrop blur —
rasterized by tiled Pallas kernels (Triton on the GPU) instead of
GL/Vulkan/Metal quad batching.

Umbrella module mirroring the reference's `import figdraw`
(/root/reference/src/figdraw.nim:1-7).
"""

from .basics import (  # noqa: F401
    BackdropBlurStyle,
    CornerRadii2D,
    DirectionCorners,
    DropShadow,
    FigFlags,
    FigKind,
    ImageStyle,
    InnerShadow,
    MsdfImageStyle,
    NfClipContent,
    NfDisableRender,
    NfEllipticalCorners,
    NfInactive,
    NfInvertY,
    NfRectMaskContent,
    NfRootWindow,
    NfSelectText,
    NoShadow,
    RenderShadow,
    RenderStroke,
    SHADOW_COUNT,
    ShadowStyle,
    StrokeCap,
    StrokeJoin,
    TransformStyle,
    ZLevel,
    descaled,
    fig_ui_scale,
    image_style,
    init_corner_radii_2d,
    scaled,
    set_fig_ui_scale,
    to_corner_radii,
)
from .colors import (  # noqa: F401
    BLACK_COLOR,
    BLUE_COLOR,
    CLEAR_COLOR,
    Color,
    ColorRGBA,
    WHITE_COLOR,
    color,
    rgba,
)
from .fill import (  # noqa: F401
    Fill,
    FillGradientAxis,
    FillKind,
    center_color,
    fill,
    fill_alpha_max,
    linear,
    sample_color,
)
from .fill import FillGradientAxis as _FGA  # noqa: F401

fgaX = _FGA.fgaX
fgaY = _FGA.fgaY
fgaDiagTLBR = _FGA.fgaDiagTLBR
fgaDiagBLTR = _FGA.fgaDiagBLTR

from .geometry import Mat3, Rect, Vec2, rect, root_affine, vec2  # noqa: F401
from .nodes import (  # noqa: F401
    DrawableKind,
    DrawableOp,
    Fig,
    FigIdx,
    RenderList,
    Renders,
    drawable_arc,
    drawable_bezier,
    drawable_circle,
    drawable_ellipse,
    drawable_line,
    drawable_rect,
    new_renders,
)
from .backend import (  # noqa: F401
    BackendContext,
    BackendFill,
    SdfMode,
    gradient_colors,
    to_backend_fill,
)
from .fragments import (  # noqa: F401
    RenderCursor,
    RenderFragment,
    RenderFragments,
    new_render_fragments,
)
from .renderer import (  # noqa: F401
    AtlasUsage,
    DeviceScene,
    FigRenderer,
    atlas_usage_snapshot,
    new_fig_renderer,
)
from .borders import (  # noqa: F401
    fig_dashed_rounded_rect_border,
    fig_dotted_rounded_rect_border,
    fig_rounded_rect_border,
)
from .extras import fig_circle, fig_circle_xy, fig_line, fig_line_xy  # noqa: F401
from .transfer import copy_into, to_tree  # noqa: F401
from .resources import (  # noqa: F401
    FontRef,
    ImageMessageBus,
    ImageRef,
    clear_font_glyphs,
    clear_image,
    clear_image_cache,
    clear_images,
    clear_typeface_glyphs,
    load_image,
    put_image,
    replace_image,
)
from .debugtools import (  # noqa: F401
    FigLocation,
    FigVisibility,
    color_at,
    collect_debug_figs,
    fig_visibility,
    hits_at_point,
    top_fig_at_point,
)
from .text.typefaces import (  # noqa: F401
    FigFont,
    FontFeature,
    FontVariation,
    load_typeface,
    register_font,
    supported_font_file_extensions,
    text_backend,
    text_backend_features,
)
from .text.layout import (  # noqa: F401
    HAlign,
    VAlign,
    typeset,
    typeset_cached,
    typeset_for_measurement,
)
from .config import apply_startup_env as _apply_startup_env

# (the persistent compile cache is enabled lazily by FigRenderer —
# touching jax.default_backend() at import time would initialize the backend)
_apply_startup_env()

__version__ = "0.1.0"
