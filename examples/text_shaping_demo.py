"""Text shaping showcase on the reference's own bundled fonts.

Port of examples/surfer_text_shaping_demo.nim: three script cards — Arabic
(Noto Naskh, staged positional forms + lam ligatures), Hebrew (Noto Sans
Hebrew, niqqud mark stacking), Devanagari (Noto Sans Devanagari, akhn/rakar
conjuncts + reph + pre-base matra reordering) — each with a wrapped body,
a source-range highlight band, caret markers, a ligature form table and a
stats strip; plus a mixed-fallback panel with FiraCode coding ligatures
(calt) in unfused/fused columns. All fonts run through their wght/wdth
variation axes (surfer_text_shaping_demo.nim:19-22,95-125). Writes
text_shaping_demo.png.

Run: python examples/text_shaping_demo.py  (add JAX_PLATFORMS=cpu to force
the CPU)
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from figdraw_tpu import (
    Fig, FigKind, FigRenderer, RenderShadow, RenderStroke, ShadowStyle, fgaX,
    fgaY, fill, linear, new_renders, rect, rgba, vec2,
)
from figdraw_tpu.text.layout import HAlign, VAlign, typeset
from figdraw_tpu.text.typefaces import (
    FigFont, FontFeature, FontVariation, load_typeface,
)

W, H = 1340, 930
FONT_DIR = "/root/reference/examples/fonts"

ARABIC_BODY = ("السلام عليكم ورحمة الله وبركاته\n"
               "النص العربي يحتاج إلى تشكيل واتجاه صحيح ولف أسطر هادئ.")
HEBREW_BODY = ("שָׁלוֹם עוֹלָם וּבְרוּכִים הַבָּאִים\n"
               "טֶקְסְט עִבְרִי צָרִיךְ נִקּוּד, כִּוּוּן נָכוֹן וּשְׁבִירַת שׁוּרוֹת יַצִּיבָה.")
DEVANAGARI_BODY = ("नमस्ते दुनिया और आपका स्वागत है\n"
                   "देवनागरी पाठ को मात्रा, संयुक्ताक्षर और स्थिर पंक्ति-विन्यास चाहिए.")


def _text(renders, parent_z, box, font, text, ink, h_align=HAlign.Left,
          v_align=VAlign.Top, wrap=False):
    arr = typeset(vec2(box.w, box.h), [(font, ink, text)],
                  h_align=h_align, v_align=v_align, wrap=wrap)
    renders.add_root(parent_z, Fig(kind=FigKind.nkText, screen_box=box,
                                   text_layout=arr))
    return arr


def _rune_range(text, phrase):
    k = text.find(phrase)
    return (k, k + len(phrase)) if k >= 0 else (0, 0)


def _card(renders, box, title, body, highlight, font, label_font, metric_font,
          accent, h_align, ligatures=()):
    renders.add_root(0, Fig(
        kind=FigKind.nkRectangle, screen_box=box, corners=(8, 8, 8, 8),
        fill=fill(rgba(255, 255, 255, 255)),
        stroke=RenderStroke(weight=1.0, fill=fill(rgba(0, 0, 0, 32))),
        shadows=(RenderShadow(style=ShadowStyle.DropShadow, blur=20, spread=0,
                              x=0, y=8, fill=fill(rgba(0, 0, 0, 24))),),
    ))
    ink = fill(rgba(18, 20, 24, 255))
    _text(renders, 1, rect(box.x + 22, box.y + 18, box.w - 44, 30),
          label_font, title, fill(rgba(40, 45, 50, 255)))

    metric_box = rect(box.x + 22, box.y + box.h - 43, box.w - 44, 30)
    lig_h = 36.0 + 38.0 * len(ligatures)
    lig_box = (rect(box.x + 22, metric_box.y - lig_h - 14.0, box.w - 44, lig_h)
               if ligatures else None)
    text_bottom = (lig_box.y if ligatures else metric_box.y) - 12
    tbox = rect(box.x + 22, box.y + 62, box.w - 44,
                max(24.0, text_bottom - box.y - 62))

    arr = typeset(vec2(tbox.w, tbox.h), [(font, ink, body)],
                  h_align=h_align, wrap=True)
    # source highlight bands (merged bidi selection rects) + caret markers
    rr = _rune_range(body, highlight)
    for sel in arr.selection_rects_for(rr):
        if sel.h <= 0:
            continue
        renders.add_root(1, Fig(
            kind=FigKind.nkRectangle, corners=(4, 4, 4, 4),
            screen_box=rect(tbox.x + sel.x, tbox.y + sel.y,
                            max(sel.w, 2.0), sel.h),
            fill=linear(rgba(80, 190, 255, 70), rgba(30, 100, 210, 48),
                        axis=fgaY),
        ))
    for caret in arr.caret_positions_for(rr[0]):
        renders.add_root(1, Fig(
            kind=FigKind.nkRectangle, corners=(1, 1, 1, 1),
            screen_box=rect(tbox.x + caret.pos.x - 1.0, tbox.y + caret.pos.y,
                            2, caret.rect.h),
            fill=fill(rgba(33, 92, 185, 210)),
        ))
    renders.add_root(1, Fig(kind=FigKind.nkText, screen_box=tbox,
                            text_layout=arr))

    if ligatures:
        renders.add_root(1, Fig(
            kind=FigKind.nkRectangle, screen_box=lig_box, corners=(5, 5, 5, 5),
            fill=linear(rgba(246, 248, 249, 255), rgba(231, 236, 239, 255),
                        axis=fgaY),
            stroke=RenderStroke(weight=1.0, fill=fill(rgba(0, 0, 0, 22))),
        ))
        label_w = min(86.0, lig_box.w * 0.28)
        sample_w = max(44.0, (lig_box.w - label_w - 32.0) / 2.0)
        sample_font = FigFont(
            typeface_id=font.typeface_id,
            size=max(22.0, min(font.size * 0.82, 30.0)),
            features=font.features, variations=font.variations,
        )
        gray = fill(rgba(98, 106, 114, 225))
        for label, x in (("form", lig_box.x + 10),
                         ("unfused", lig_box.x + label_w + 12),
                         ("fused", lig_box.x + label_w + sample_w + 24)):
            _text(renders, 1, rect(x, lig_box.y + 8, sample_w, 16),
                  metric_font, label, gray)
        for i, (label, unfused, fused) in enumerate(ligatures):
            row_y = lig_box.y + 27.0 + 38.0 * i
            _text(renders, 1, rect(lig_box.x + 10, row_y, label_w, 38),
                  metric_font, label, fill(rgba(78, 86, 94, 235)),
                  v_align=VAlign.Middle)
            _text(renders, 1,
                  rect(lig_box.x + label_w + 12, row_y, sample_w, 38),
                  sample_font, unfused, fill(rgba(24, 28, 32, 255)),
                  h_align=HAlign.Center, v_align=VAlign.Middle)
            _text(renders, 1,
                  rect(lig_box.x + label_w + sample_w + 24, row_y, sample_w, 38),
                  sample_font, fused, fill(rgba(24, 28, 32, 255)),
                  h_align=HAlign.Center, v_align=VAlign.Middle)

    renders.add_root(1, Fig(kind=FigKind.nkRectangle, screen_box=metric_box,
                            corners=(5, 5, 5, 5), fill=accent))
    stats = (f"{title}  glyphs {len(arr.arranged_glyphs)}  "
             f"source {len(arr.source_runes)}  lines {len(arr.lines)}")
    _text(renders, 1, metric_box, metric_font, stats,
          fill(rgba(255, 255, 255, 235)), h_align=HAlign.Center,
          v_align=VAlign.Middle)


def main() -> None:
    arabic = load_typeface(os.path.join(FONT_DIR, "NotoNaskhArabic-wght.ttf"))
    hebrew = load_typeface(os.path.join(FONT_DIR, "NotoSansHebrew-wdth-wght.ttf"))
    devanagari = load_typeface(
        os.path.join(FONT_DIR, "NotoSansDevanagari-wdth-wght.ttf"))
    code = load_typeface(os.path.join(FONT_DIR, "FiraCode-wght.ttf"))
    ubuntu = load_typeface("/usr/share/fonts/truetype/dejavu/DejaVuSans.ttf")

    body_font = FigFont(typeface_id=ubuntu, size=18.0,
                        fallback_typeface_ids=(arabic, hebrew, devanagari))
    metric_font = FigFont(typeface_id=ubuntu, size=13.0,
                          fallback_typeface_ids=(arabic, hebrew, devanagari))
    arabic_font = FigFont(typeface_id=arabic, size=26.0,
                          variations=(FontVariation("wght", 560.0),))
    hebrew_font = FigFont(typeface_id=hebrew, size=30.0,
                          variations=(FontVariation("wght", 560.0),
                                      FontVariation("wdth", 96.0)))
    devanagari_font = FigFont(typeface_id=devanagari, size=30.0,
                              variations=(FontVariation("wght", 560.0),
                                          FontVariation("wdth", 100.0)))
    code_plain = FigFont(typeface_id=code, size=24.0,
                         features=(FontFeature("liga", 0), FontFeature("calt", 0)),
                         variations=(FontVariation("wght", 520.0),))
    code_font = FigFont(typeface_id=code, size=24.0,
                        variations=(FontVariation("wght", 520.0),))

    ren = FigRenderer(atlas_size=2048)
    renders = new_renders()
    renders.add_root(0, Fig(
        kind=FigKind.nkRectangle, screen_box=rect(0, 0, W, H),
        fill=linear(rgba(236, 240, 241, 255), rgba(215, 222, 226, 255),
                    axis=fgaY),
    ))

    pad, title_h, gap = 28.0, 66.0, 18.0
    usable_w = W - pad * 2
    _text(renders, 1, rect(pad, pad, usable_w, 34),
          FigFont(typeface_id=ubuntu, size=22.0), "FigDraw Text Shaping",
          linear(rgba(30, 42, 58, 255), rgba(45, 92, 145, 255), axis=fgaX))
    _text(renders, 1, rect(pad, pad + 34, usable_w, 24), metric_font,
          "backend: figdraw_tpu OpenType shaper (staged Arabic + Indic)",
          fill(rgba(74, 84, 94, 255)))

    card_w = (usable_w - gap * 2) / 3.0
    card_h = 430.0
    top_y = pad + title_h
    _card(renders, rect(pad, top_y, card_w, card_h), "Arabic", ARABIC_BODY,
          "العربي", arabic_font, body_font, metric_font,
          linear(rgba(21, 135, 115, 235), rgba(25, 92, 145, 235), axis=fgaX),
          HAlign.Right,
          [("la", "ل + ا", "لا"), ("lm", "ل + م", "لم")])
    _card(renders, rect(pad + card_w + gap, top_y, card_w, card_h), "Hebrew",
          HEBREW_BODY, "עִבְרִי", hebrew_font, body_font, metric_font,
          linear(rgba(114, 68, 160, 235), rgba(58, 112, 188, 235), axis=fgaX),
          HAlign.Right)
    _card(renders, rect(pad + (card_w + gap) * 2, top_y, card_w, card_h),
          "Devanagari", DEVANAGARI_BODY, "देवनागरी", devanagari_font,
          body_font, metric_font,
          linear(rgba(185, 96, 34, 235), rgba(118, 113, 34, 235), axis=fgaX),
          HAlign.Left,
          [("ksha", "क् + ष", "क्ष"), ("rta", "र् + ट", "र्ट")])

    # mixed-fallback panel + FiraCode coding ligatures (calt) table
    mixed = rect(pad, top_y + card_h + gap, usable_w,
                 H - (top_y + card_h + gap) - pad)
    renders.add_root(0, Fig(
        kind=FigKind.nkRectangle, screen_box=mixed, corners=(8, 8, 8, 8),
        fill=fill(rgba(252, 253, 253, 255)),
        stroke=RenderStroke(weight=1.0, fill=fill(rgba(0, 0, 0, 32))),
    ))
    _text(renders, 1, rect(mixed.x + 22, mixed.y + 18, mixed.w - 44, 30),
          body_font, "Mixed Fallback Runs", fill(rgba(40, 45, 50, 255)))
    _text(renders, 1, rect(mixed.x + 22, mixed.y + 58, mixed.w - 44, 40),
          body_font,
          "FigDraw fallback: العربية + עברית + देवनागरी + English",
          fill(rgba(20, 22, 24, 255)), wrap=True)
    _text(renders, 1, rect(mixed.x + 22, mixed.y + 108, mixed.w - 44, 18),
          metric_font, "Coding ligatures", fill(rgba(74, 84, 94, 235)))
    code_box = rect(mixed.x + 22, mixed.y + 130, mixed.w - 44,
                    max(64.0, mixed.y + mixed.h - (mixed.y + 130) - 10))
    renders.add_root(1, Fig(
        kind=FigKind.nkRectangle, screen_box=code_box, corners=(5, 5, 5, 5),
        fill=linear(rgba(245, 247, 248, 255), rgba(231, 236, 239, 255),
                    axis=fgaY),
        stroke=RenderStroke(weight=1.0, fill=fill(rgba(0, 0, 0, 22))),
    ))
    code_text = "!=  ===  !==  <=  >=  ->  =>  |>  &&"
    col_w = max(80.0, (code_box.w - 24.0 - 16.0) / 2.0)
    gray = fill(rgba(98, 106, 114, 225))
    _text(renders, 2, rect(code_box.x + 12, code_box.y + 8, col_w, 16),
          metric_font, "unfused", gray)
    _text(renders, 2, rect(code_box.x + 12 + col_w + 16, code_box.y + 8,
                           col_w, 16), metric_font, "fused", gray)
    ink = fill(rgba(22, 28, 34, 255))
    _text(renders, 2, rect(code_box.x + 12, code_box.y + 25, col_w,
                           code_box.h - 31), code_plain, code_text, ink)
    _text(renders, 2, rect(code_box.x + 12 + col_w + 16, code_box.y + 25,
                           col_w, code_box.h - 31), code_font, code_text, ink)

    frame = np.asarray(ren.render_frame(renders, vec2(W, H)))
    from PIL import Image

    out = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "text_shaping_demo.png")
    Image.fromarray((np.clip(frame, 0, 1) * 255).astype(np.uint8)).save(out)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
