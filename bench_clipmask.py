"""Clip vs rect-mask benchmark — the reference's second benchmark.

Reproduces windy_clip_mask_benchmark.nim's methodology (:9-21, 252-275): a
180-row × 6-col table at 1200×800 where every cell clips its spilling
content, once with real sub-clip masks and once with the rect-mask fast
path; plus the flat no-clip table of windy_non_clip_benchmark.nim:81-105
(plain rounded cells, no masks at all) as the mask-free control.

The sub-clip case stresses the megakernel (1080 mask planes per frame);
rect-mask rides the per-quad fast path; no-clip measures the raw quad
throughput of the same table shape.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

ROWS = int(os.environ.get("FIGDRAW_BENCH_ROWS", "180"))
COLS = int(os.environ.get("FIGDRAW_BENCH_COLS", "6"))
WARMUP = int(os.environ.get("FIGDRAW_BENCH_WARMUP", "5"))
FRAMES = int(os.environ.get("FIGDRAW_BENCH_FRAMES", "30"))
W, H = 1200, 800


def make_table_scene(kind: str, w: float, h: float):
    """windy_clip_mask_benchmark.nim makeTableRenderTree (:147-185)."""
    from figdraw_tpu import Fig, FigFlags, FigKind, fill, new_renders, rect, rgba
    from figdraw_tpu.nodes import RenderList

    def rect_fig(box, color, flags=0, corners=0):
        return Fig(kind=FigKind.nkRectangle, screen_box=box, fill=fill(color),
                   corners=(corners,) * 4, flags=flags)

    margin, gap = 22.0, 4.0
    viewport = rect(margin, margin, w - margin * 2, h - margin * 2)
    cell_h = 22.0
    cell_w = (viewport.w - gap * (COLS + 1)) / COLS
    scroll_y = 37.0

    lst = RenderList()
    lst.add_root(rect_fig(rect(0, 0, w, h), rgba(248, 249, 251, 255)))
    vp = lst.add_root(rect_fig(viewport, rgba(232, 235, 240, 255),
                               flags=FigFlags.NfClipContent, corners=10))
    cell_flags = (
        FigFlags.NfClipContent if kind == "subclip" else FigFlags.NfRectMaskContent
    )
    for row in range(ROWS):
        y = viewport.y + gap + row * (cell_h + gap) - scroll_y
        for col in range(COLS):
            x = viewport.x + gap + col * (cell_w + gap)
            cell = rect(x, y, cell_w, cell_h)
            color = (
                rgba(255, 255, 255, 255) if (row + col) % 2 == 0
                else rgba(242, 246, 250, 255)
            )
            ci = lst.add_child(vp, rect_fig(cell, color, flags=cell_flags, corners=4))
            tone = 42 + (row * 7 + col * 17) % 72
            lst.add_child(ci, rect_fig(
                rect(cell.x - 12, cell.y + 4, cell.w + 24, 5),
                rgba(36, 120 + (row * 5) % 80, 235, 255), corners=2))
            lst.add_child(ci, rect_fig(
                rect(cell.x + cell.w * 0.38, cell.y - 5, cell.w * 0.74, cell.h + 10),
                rgba(tone, 170 - (col * 11) % 70, 220, 255), corners=3))
            lst.add_child(ci, rect_fig(
                rect(cell.x + 7, cell.y + cell.h - 7, cell.w - 14, 8),
                rgba(190 + (row + col) % 30, 210, 220, 255), corners=2))
    renders = new_renders()
    renders.set_layer(0, lst)
    return renders


def make_nonclip_scene(w: float, h: float):
    """windy_non_clip_benchmark.nim makeNonClipRenderTree (:81-105)."""
    from figdraw_tpu import Fig, FigKind, fill, new_renders, rect, rgba
    from figdraw_tpu.nodes import RenderList

    margin, gap, cell_h = 18.0, 5.0, 18.0
    cell_w = (w - margin * 2 - gap * (COLS - 1)) / COLS
    lst = RenderList()
    lst.add_root(Fig(kind=FigKind.nkRectangle, screen_box=rect(0, 0, w, h),
                     fill=fill(rgba(248, 249, 251, 255))))
    for row in range(ROWS):
        y = margin + row * (cell_h + gap)
        for col in range(COLS):
            x = margin + col * (cell_w + gap)
            shade = 220 + (row * 3 + col * 7) % 35
            accent = 80 + (row * 11 + col * 13) % 90
            lst.add_root(Fig(kind=FigKind.nkRectangle,
                             screen_box=rect(x, y, cell_w, cell_h),
                             corners=(4,) * 4,
                             fill=fill(rgba(shade, 245 - (col % 5) * 5,
                                            accent, 255))))
    renders = new_renders()
    renders.set_layer(0, lst)
    return renders


KINDS = ("noclip", "rectmask", "subclip")


def main():
    """PAIRED measurement: the three cases interleave inside ONE loop —
    every iteration times one blocked frame of each kind back-to-back, so
    the sub-clip/rect-mask ratio is computed per iteration and drift over
    the run cancels out of it. The headline is the MEDIAN of the
    per-iteration ratios."""
    import json

    from figdraw_tpu import FigRenderer, vec2
    from figdraw_tpu.nodesarray import from_renders

    print(f"clip-mask benchmark (paired): {ROWS}x{COLS} cells @ {W}x{H}, "
          f"{WARMUP} warmup + {FRAMES} interleaved frames", file=sys.stderr)
    size = vec2(W, H)
    rens = {k: FigRenderer(atlas_size=128) for k in KINDS}
    scenes = {
        "noclip": from_renders(make_nonclip_scene(float(W), float(H))),
        "rectmask": from_renders(make_table_scene("rectmask", float(W), float(H))),
        "subclip": from_renders(make_table_scene("subclip", float(W), float(H))),
    }
    for k in KINDS:
        out = None
        for _ in range(WARMUP):
            out = rens[k].render_frame(scenes[k], size)
        out.block_until_ready()

    samples = {k: [] for k in KINDS}
    for _ in range(FRAMES):
        for k in KINDS:
            t0 = time.perf_counter()
            rens[k].render_frame(scenes[k], size).block_until_ready()
            samples[k].append((time.perf_counter() - t0) * 1000.0)

    arrs = {k: np.asarray(v) for k, v in samples.items()}
    ratios = arrs["subclip"] / arrs["rectmask"]
    for k, label in (("noclip", "no-clip table"),
                     ("rectmask", "clip + rect-mask"),
                     ("subclip", "clip + sub-clip")):
        a = arrs[k]
        print(
            f"{label:18s} avg={a.mean():8.2f}ms "
            f"p50={np.percentile(a, 50):8.2f}ms "
            f"p95={np.percentile(a, 95):8.2f}ms min={a.min():8.2f}ms "
            f"max={a.max():8.2f}ms fps={1000.0 / a.mean():7.1f}",
            file=sys.stderr,
        )
    print(
        f"paired sub-clip/rect-mask ratio: p50={np.median(ratios):.3f} "
        f"p90={np.percentile(ratios, 90):.3f} min={ratios.min():.3f} "
        f"max={ratios.max():.3f}",
        file=sys.stderr,
    )
    print(json.dumps({
        "metric": "clipmask_paired_ratio",
        "value": round(float(np.median(ratios)), 3),
        "unit": "x (sub-clip / rect-mask, per-iteration paired)",
        "ratio_p90": round(float(np.percentile(ratios, 90)), 3),
        "subclip_p50_ms": round(float(np.median(arrs["subclip"])), 3),
        "rectmask_p50_ms": round(float(np.median(arrs["rectmask"])), 3),
        "noclip_p50_ms": round(float(np.median(arrs["noclip"])), 3),
    }))


if __name__ == "__main__":
    main()
