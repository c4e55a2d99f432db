"""Video streaming — the reference's replaceImage canvas/video pattern.

Re-derives the streaming workflow of imgutils.nim:563-584 (replaceImage: an
existing atlas slot is overwritten in place each frame, no repack) driven
from a render loop: a procedural 48-frame "video" is published frame by
frame through the image message bus, composited under a HUD (title bar,
progress bar, frame counter chip) and rendered through the async frame
pipeline (render_frame_async overlaps frame N+1's host flatten with frame
N's upload+kernel — the analog of the reference's GL loop pacing).

Writes examples/out/video_stream/frame_###.png (every 6th frame) plus a
contact-sheet video_stream.png.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from figdraw_tpu import (
    Fig, FigKind, fill, image_style, new_renders, rect, rgba, vec2,
)
from figdraw_tpu.renderer import FigRenderer
from figdraw_tpu.resources import ImageMessageBus, ImageRef, put_image, replace_image

W, H = 640, 420
SRC = 256          # video source resolution
FRAMES = 48
VIDEO_ID = 7001
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "out",
                   "video_stream")


def video_frame(t: int) -> np.ndarray:
    """Procedural stand-in for a decoded video frame: drifting plasma field
    with a sweeping scanline."""
    yy, xx = np.mgrid[0:SRC, 0:SRC] / SRC
    ph = t * 0.13
    img = np.zeros((SRC, SRC, 4), np.uint8)
    img[..., 0] = (128 + 110 * np.sin(5.0 * xx + ph)).astype(np.uint8)
    img[..., 1] = (128 + 110 * np.sin(4.0 * yy - 1.7 * ph)).astype(np.uint8)
    img[..., 2] = (128 + 110 * np.sin(3.0 * (xx + yy) + 0.8 * ph)).astype(np.uint8)
    scan = np.abs(yy - ((t % 24) / 24.0)) < 0.015
    img[scan] = (255, 255, 255, 255)
    img[..., 3] = 255
    return img


def make_scene(t: int):
    renders = new_renders()
    root = renders.add_root(0, Fig(kind=FigKind.nkRectangle,
                                   screen_box=rect(0, 0, W, H),
                                   fill=fill(rgba(18, 18, 24, 255))))
    # player chrome
    renders.add_child(0, root, Fig(kind=FigKind.nkRectangle,
                                   screen_box=rect(150, 40, 340, 340),
                                   corners=(14,) * 4,
                                   fill=fill(rgba(40, 42, 52, 255))))
    # the streamed frame (atlas slot VIDEO_ID, replaced in place every frame)
    renders.add_child(0, root, Fig(kind=FigKind.nkImage,
                                   screen_box=rect(170, 60, 300, 300),
                                   image=image_style(VIDEO_ID)))
    # progress bar + playhead
    renders.add_child(0, root, Fig(kind=FigKind.nkRectangle,
                                   screen_box=rect(170, 380, 300, 8),
                                   corners=(4,) * 4,
                                   fill=fill(rgba(60, 62, 72, 255))))
    frac = (t + 1) / FRAMES
    renders.add_child(0, root, Fig(kind=FigKind.nkRectangle,
                                   screen_box=rect(170, 380, 300 * frac, 8),
                                   corners=(4,) * 4,
                                   fill=fill(rgba(90, 180, 255, 255))))
    # frame-counter chip: one tick mark per 8 frames
    for k in range((t // 8) + 1):
        renders.add_child(0, root, Fig(kind=FigKind.nkRectangle,
                                       screen_box=rect(170 + 14 * k, 20, 10, 10),
                                       corners=(3,) * 4,
                                       fill=fill(rgba(255, 200, 80, 255))))
    return renders


def main():
    os.makedirs(OUT, exist_ok=True)
    bus = ImageMessageBus()
    put_image(VIDEO_ID, video_frame(0), bus=bus)
    ref = ImageRef(VIDEO_ID, bus=bus)

    ren = FigRenderer(atlas_size=512)
    ren.ensure_image_message_subscription(bus)

    from PIL import Image

    saved = []
    out = None
    for t in range(FRAMES):
        if t > 0:
            # in-place atlas overwrite: same slot, no repack, no generation
            # bump beyond the pixel upload (imgutils.nim:563-584 semantics)
            replace_image(VIDEO_ID, video_frame(t), bus=bus)
        out = ren.render_frame_async(make_scene(t), vec2(W, H))
        if t % 6 == 0:
            frame = np.asarray(out.result())
            img = (np.clip(frame, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
            p = os.path.join(OUT, f"frame_{t:03d}.png")
            Image.fromarray(img).save(p)
            saved.append(img)
    out.result().block_until_ready()
    ren.drain_async()

    # contact sheet: the saved frames side by side, 4 per row
    cols = 4
    rows = -(-len(saved) // cols)
    sheet = np.zeros((rows * H, cols * W, 4), np.uint8)
    for i, img in enumerate(saved):
        r, c = divmod(i, cols)
        sheet[r * H:(r + 1) * H, c * W:(c + 1) * W] = img
    sheet_path = os.path.join(os.path.dirname(OUT), "video_stream.png")
    Image.fromarray(sheet).save(sheet_path)
    ref.close()
    print(f"streamed {FRAMES} frames; wrote {len(saved)} stills + {sheet_path}")


if __name__ == "__main__":
    main()
