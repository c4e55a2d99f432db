"""Text sampling modes demo — siwin_text, offscreen.

Re-derives /root/reference/examples/siwin_text.nim's capability matrix: the
same small-size paragraph rendered under every text sampling configuration
the renderer supports — subpixel positioning off / uv-shift / per-variant
glyphs (siwin_text.nim TextSubpixelMode), each with LCD filtering off and
on (setTextLcdFiltering / setTextSubpixelPositioning /
setTextSubpixelGlyphVariants, siwin_text.nim:33-47) — as a 2x3 panel grid
with status-line labels, one renderer per configuration (the sampling mode
is an atlas-wide property, like the reference's per-window renderer).
Writes examples/out/text_sampling_modes.png.

Run: JAX_PLATFORMS=cpu python examples/text_sampling_modes.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from figdraw_tpu import (
    Fig, FigKind, FigRenderer, fill, new_renders, rect, rgba, vec2,
)
from figdraw_tpu.text.layout import HAlign, VAlign, typeset
from figdraw_tpu.text.typefaces import FigFont, load_typeface

W, H = 1020, 640
PANEL_W, PANEL_H = 316, 284
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "out")

BODY = ("The quick brown fox jumps over the lazy dog, 0123456789.\n"
        "Small text lives or dies on sampling: hinting-free AA, LCD\n"
        "striping and subpixel phase each move the stems differently.\n"
        "iiilll JJJ ,,, ... |||  rn m  cl d  1l I")

MODES = [
    ("subpixel: off", False, False),
    ("subpixel: uv shift", True, False),
    ("subpixel: glyph variants", True, True),
]


def render_panel(font_path, name: str, lcd: bool, subpixel: bool,
                 variants: bool):
    """One renderer per sampling config (atlas contents depend on it)."""
    ren = FigRenderer(atlas_size=512, use_pallas=True)
    ren.text_lcd_filtering = lcd
    ren.text_subpixel_positioning = subpixel
    ren.text_subpixel_glyph_variants = variants
    face_id = load_typeface(font_path)
    body_font = FigFont(typeface_id=face_id, size=12.0)
    label_font = FigFont(typeface_id=face_id, size=15.0)

    renders = new_renders()
    renders.add_root(0, Fig(kind=FigKind.nkRectangle,
                            screen_box=rect(0, 0, PANEL_W, PANEL_H),
                            fill=fill(rgba(252, 252, 250, 255))))
    # the reference's textStatusLine (siwin_text.nim:28-30)
    status = f"LCD: {'on' if lcd else 'off'}, {name}"
    arr = typeset(vec2(PANEL_W - 24, 22),
                  [(label_font, fill(rgba(20, 24, 40, 255)), status)],
                  h_align=HAlign.Left, v_align=VAlign.Top)
    renders.add_root(0, Fig(kind=FigKind.nkText,
                            screen_box=rect(12, 10, PANEL_W - 24, 22),
                            text_layout=arr))
    arr = typeset(vec2(PANEL_W - 24, PANEL_H - 56),
                  [(body_font, fill(rgba(30, 32, 38, 255)), BODY)],
                  h_align=HAlign.Left, v_align=VAlign.Top, wrap=True)
    renders.add_root(0, Fig(kind=FigKind.nkText,
                            screen_box=rect(12, 40, PANEL_W - 24, PANEL_H - 56),
                            text_layout=arr))
    frame = ren.render_frame(renders, vec2(PANEL_W, PANEL_H),
                             clear_color=rgba(252, 252, 250, 255))
    return np.asarray(frame)


def main():
    font_path = os.path.join("/root/reference/examples/fonts", "DejaVuSans.ttf")
    if not os.path.exists(font_path):
        font_path = "/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf"

    page = np.ones((H, W, 4), np.float32)
    page[..., :3] = 0.92
    gap_x = (W - 3 * PANEL_W) // 4
    for row, lcd in enumerate((False, True)):
        for col, (name, subpixel, variants) in enumerate(MODES):
            panel = render_panel(font_path, name, lcd, subpixel, variants)
            x = gap_x + col * (PANEL_W + gap_x)
            y = 24 + row * (PANEL_H + 24)
            page[y:y + PANEL_H, x:x + PANEL_W] = panel
            print(f"panel lcd={lcd} {name}: done")

    os.makedirs(OUT, exist_ok=True)
    out_path = os.path.join(OUT, "text_sampling_modes.png")
    from PIL import Image
    Image.fromarray((np.clip(page, 0, 1) * 255).astype(np.uint8)).save(out_path)
    print(f"wrote {out_path}")


if __name__ == "__main__":
    main()
