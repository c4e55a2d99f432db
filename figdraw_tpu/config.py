"""Runtime configuration via environment variables.

Counterpart of the reference's env-var flag system (SURVEY.md §5.6;
figrender.nim:103-176, utils/glutils.nim:12-40):

  FIGDRAW_BACKEND                   "pallas" | "xla" — rasterizer selection
                                    (the reference's opengl/vulkan/metal pick)
  FIGDRAW_FORCE_XLA                 1 → force the XLA reference rasterizer
                                    (the FIGDRAW_FORCE_OPENGL fallback analog)
  FIGDRAW_TEXT_LCD_FILTERING        1 → LCD-filtered glyph rasters
  FIGDRAW_TEXT_SUBPIXEL_POSITIONING 1 → subpixel glyph x-shifts
  FIGDRAW_TEXT_SUBPIXEL_GLYPH_VARIANTS  1 → 10 pre-baked subpixel variants
  FIGDRAW_DATA_DIR                  asset root (shared.nim figDataDir)
  FIGDRAW_UI_SCALE / HDI            global UI scale override

Compile-time defines become constructor arguments; nimble feature flags
become optional imports.
"""

from __future__ import annotations

import os


def _truthy(name: str) -> bool:
    return os.environ.get(name, "").strip().lower() in ("1", "true", "yes", "on")


def runtime_text_lcd_filtering_requested() -> bool:
    if os.environ.get("FIGDRAW_TEXT_LCD_FILTERING", "").strip():
        return _truthy("FIGDRAW_TEXT_LCD_FILTERING")
    return _truthy("FIGDRAW_TEXT_LCD_FILTER")


def runtime_text_subpixel_positioning_requested() -> bool:
    return _truthy("FIGDRAW_TEXT_SUBPIXEL_POSITIONING")


def runtime_text_subpixel_glyph_variants_requested() -> bool:
    return _truthy("FIGDRAW_TEXT_SUBPIXEL_GLYPH_VARIANTS")


def runtime_force_xla_requested() -> bool:
    """Rasterizer fallback override (the FIGDRAW_FORCE_OPENGL analog)."""
    if _truthy("FIGDRAW_FORCE_XLA"):
        return True
    backend = os.environ.get("FIGDRAW_BACKEND", "").strip().lower()
    return backend in ("xla", "ref", "reference")


def runtime_backend_override():
    """None (auto), True (pallas), or False (xla)."""
    backend = os.environ.get("FIGDRAW_BACKEND", "").strip().lower()
    if backend == "pallas":
        return True
    if backend in ("xla", "ref", "reference"):
        return False
    if _truthy("FIGDRAW_FORCE_XLA"):
        return False
    return None


def batch_chunk() -> int:
    """Frames per batched dispatch in FigRenderer.render_batch (the offline
    animation path). Default 8: big enough to amortize the per-frame
    transfer + dispatch, small enough to keep the (chunk, H, W, 4) output
    and the stacked upload modest."""
    try:
        return max(1, int(os.environ.get("FIGDRAW_BATCH_CHUNK", "8")))
    except ValueError:
        return 8


def test_one_frame_path():
    """The -d:testOneFrame analog (figrender.nim:1997-2002): when set to a
    path, the renderer writes the first rendered frame there as a PNG (CI
    smoke screenshots without a frame loop)."""
    return os.environ.get("FIGDRAW_TEST_ONE_FRAME") or None


def apply_startup_env() -> None:
    """Reads FIGDRAW_DATA_DIR / FIGDRAW_UI_SCALE / HDI once at import."""
    data_dir = os.environ.get("FIGDRAW_DATA_DIR")
    if data_dir:
        from .text.typefaces import set_fig_data_dir

        set_fig_data_dir(data_dir)
    scale = os.environ.get("FIGDRAW_UI_SCALE") or os.environ.get("HDI")
    if scale:
        try:
            from .basics import set_fig_ui_scale

            set_fig_ui_scale(float(scale))
        except ValueError:
            pass
