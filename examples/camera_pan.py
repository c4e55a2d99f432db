"""Device-resident camera: scroll and zoom a scene without re-flattening.

Snapshots the showcase scene once (snapshot_scene uploads the tape to the
device) and renders a scroll sweep plus two zoom views, where each frame
ships only a (2,) offset and a zoom scalar to the device (render_view).
Writes out/camera_strip.png.

Run: python examples/camera_pan.py            (GPU)
     JAX_PLATFORMS=cpu python examples/camera_pan.py   (CPU)
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from figdraw_tpu import vec2
from figdraw_tpu.nodesarray import from_renders
from figdraw_tpu.renderer import FigRenderer
from demo_scene import showcase

W, H = 480, 270
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "out")


def main():
    os.makedirs(OUT_DIR, exist_ok=True)
    renderer = FigRenderer(atlas_size=128, use_pallas=True)
    snap = renderer.snapshot_scene(from_renders(showcase(640, 400)),
                                   vec2(W, H))

    # the whole sweep as ONE batched flythrough (render_views): 6 scroll
    # views then two zoom views, chunked single-dispatch lax.maps
    pans = [(-i * 40.0, -i * 12.0) for i in range(6)]
    zooms = [1.0] * 6
    pans += [(-80.0, -40.0), (40.0, 20.0)]
    zooms += [1.6, 0.55]
    frames = list(np.asarray(
        renderer.render_views(snap, pans, zooms, as_uint8=True)))

    from PIL import Image

    strip = np.concatenate(frames, axis=1)
    Image.fromarray(strip).save(os.path.join(OUT_DIR, "camera_strip.png"))
    print(f"wrote camera_strip.png ({len(frames)} views of {W}x{H}, "
          "6 pans + 2 zooms)")


if __name__ == "__main__":
    main()
