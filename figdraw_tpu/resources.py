"""Thread-safe image/font resource layer: the cross-thread message bus.

Port of /root/reference/src/figdraw/common/imgutils.nim (+ rchannels.nim):
  * `ImageMsg` kinds — put / replace / clear / retain / release for images,
    glyphs, fonts (imgutils.nim:27-59)
  * publish fans copies to every subscriber's bounded ring inbox, overwriting
    the oldest on overflow (rchannels.nim push semantics)
  * a replay table keeps the latest put/replace per id so a new renderer, or
    an atlas rebuilt after grow/clear, replays all live content
    (imgutils.nim:139-215) — the engine's "checkpoint/resume" (SURVEY.md §5.4)
  * staleness: per-id generation + global cache generation checked on apply
    (imgutils.nim:419-423)
  * `ImageRef` / `FontRef` RAII handles → retain/release owner-token messages;
    the final release queues eviction (imgutils.nim:61-68, 217-325)

Here the "atlas upload" these messages drive is a host-side numpy write +
one device_put of the dirty atlas (renderer._device_atlas); the bus contract
is unchanged.
"""

from __future__ import annotations

import enum
import itertools
import threading
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

ImageId = int
FontId = int
TypefaceId = int
OwnerToken = int

_id_counter = itertools.count(1)


def next_owner_token() -> OwnerToken:
    return next(_id_counter)


def image_id_from_path(path: str) -> ImageId:
    """Stable id for a file path (the reference hashes the path)."""
    import zlib

    return zlib.crc32(path.encode("utf-8")) or 1


class ImageMsgKind(enum.Enum):
    PutImage = "put-image"
    PutGlyph = "put-glyph"
    ReplaceImage = "replace-image"
    ClearImage = "clear-image"
    ClearImages = "clear-images"
    ClearImageCache = "clear-image-cache"
    ClearFontGlyphs = "clear-font-glyphs"
    ClearTypefaceGlyphs = "clear-typeface-glyphs"
    RetainImage = "retain-image"
    ReleaseImage = "release-image"
    RetainFont = "retain-font"
    ReleaseFont = "release-font"


@dataclass(frozen=True)
class ImageMsg:
    kind: ImageMsgKind
    id: ImageId = 0
    ids: tuple = ()
    image: Optional[np.ndarray] = None  # (h, w, 4) uint8 or float32
    font_id: FontId = 0
    typeface_id: TypefaceId = 0
    owner_token: OwnerToken = 0
    final_release: bool = False
    generation: int = 0
    cache_generation: int = 0
    mipmapped: bool = False
    mips: Optional[tuple] = None  # precomputed chain (flippy), levels 1..n


class ImageMessageSubscription:
    """Bounded ring inbox; push overwrites oldest (rchannels.nim:27-33)."""

    def __init__(self, bus: "ImageMessageBus", capacity: int = 512):
        self._bus = bus
        self._inbox: deque = deque(maxlen=capacity)
        self._lock = threading.Lock()

    def _push(self, msg: ImageMsg) -> None:
        with self._lock:
            self._inbox.append(msg)

    def try_recv(self) -> Optional[ImageMsg]:
        with self._lock:
            if self._inbox:
                return self._inbox.popleft()
        return None

    def drain(self) -> List[ImageMsg]:
        with self._lock:
            out = list(self._inbox)
            self._inbox.clear()
        return out


class ImageMessageBus:
    """Publish/subscribe hub with replay (imgutils.nim:85-215)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._subs: List[ImageMessageSubscription] = []
        self._replay: Dict[ImageId, ImageMsg] = {}
        self._generations: Dict[ImageId, int] = {}
        self._cache_generation = 1

    # --- generations ------------------------------------------------------------

    def _bump_generation(self, image_id: ImageId) -> int:
        gen = self._generations.get(image_id, 0) + 1
        self._generations[image_id] = gen
        return gen

    def message_current(self, msg: ImageMsg) -> bool:
        """Staleness check applied by the consumer (imgutils.nim:419-423)."""
        with self._lock:
            if msg.cache_generation != self._cache_generation:
                return False
            return msg.generation == self._generations.get(msg.id, 0)

    # --- pub/sub ------------------------------------------------------------------

    def subscribe(self) -> ImageMessageSubscription:
        """New subscription; replays current content (imgutils.nim:191-201)."""
        sub = ImageMessageSubscription(self)
        with self._lock:
            self._subs.append(sub)
            for msg in self._replay.values():
                sub._push(msg)
        return sub

    def unsubscribe(self, sub: ImageMessageSubscription) -> None:
        with self._lock:
            if sub in self._subs:
                self._subs.remove(sub)

    def replay_to(self, sub: ImageMessageSubscription) -> None:
        """Re-send live content after an atlas rebuild (imgutils.nim:206-215)."""
        with self._lock:
            for msg in self._replay.values():
                sub._push(msg)

    def publish(self, msg: ImageMsg) -> ImageMsg:
        with self._lock:
            if msg.kind in (ImageMsgKind.PutImage, ImageMsgKind.ReplaceImage):
                gen = self._bump_generation(msg.id)
                msg = ImageMsg(
                    kind=msg.kind,
                    id=msg.id,
                    image=msg.image,
                    generation=gen,
                    cache_generation=self._cache_generation,
                    mipmapped=msg.mipmapped,
                    mips=msg.mips,
                )
                self._replay[msg.id] = msg
            elif msg.kind == ImageMsgKind.ClearImage:
                self._replay.pop(msg.id, None)
                self._generations.pop(msg.id, None)
            elif msg.kind == ImageMsgKind.ClearImages:
                for i in msg.ids:
                    self._replay.pop(i, None)
                    self._generations.pop(i, None)
            elif msg.kind == ImageMsgKind.ClearImageCache:
                self._replay.clear()
                self._generations.clear()
                self._cache_generation += 1
            for sub in self._subs:
                sub._push(msg)
        return msg


# global default bus, like the reference's module-level channels
default_bus = ImageMessageBus()

# host-side image cache: id -> numpy image (the reference's flippy disk cache
# keeps decoded images around; we keep them in memory keyed by id)
_image_cache: Dict[ImageId, np.ndarray] = {}
_mip_cache: Dict[ImageId, tuple] = {}
_image_cache_lock = threading.Lock()


def load_image(path: str, bus: Optional[ImageMessageBus] = None,
               mipmapped: bool = True, flippy_cache: bool = True) -> "ImageRef":
    """Load an image and publish it to renderers (imgutils.nim:553-557).

    Like the reference's pipeline, mipmapped loads go through the .flippy
    sidecar cache — alpha-bled, full mip chain, snappy-compressed, regenerated
    when the source file is newer (imgutils.nim:343-364). flippy_cache=False
    (or mipmapped=False) loads the raw pixels directly."""
    image_id = image_id_from_path(path)
    with _image_cache_lock:
        cached = _image_cache.get(image_id)
    mips: Optional[tuple] = None
    if cached is None:
        if mipmapped and flippy_cache:
            from .utils.flippy import read_image_cached

            flippy = read_image_cached(path)
            cached = flippy.mipmaps[0]
            mips = tuple(flippy.mipmaps[1:])
        else:
            from PIL import Image as PILImage

            cached = np.asarray(PILImage.open(path).convert("RGBA"))
        with _image_cache_lock:
            _image_cache[image_id] = cached
            if mips is not None:
                _mip_cache[image_id] = mips
    else:
        with _image_cache_lock:
            mips = _mip_cache.get(image_id)
    b = bus or default_bus
    b.publish(ImageMsg(kind=ImageMsgKind.PutImage, id=image_id, image=cached,
                       mipmapped=mipmapped, mips=mips))
    return ImageRef(image_id, bus=b)


def put_image(image_id: ImageId, image: np.ndarray,
              bus: Optional[ImageMessageBus] = None,
              mipmapped: bool = False) -> ImageId:
    """Publish an image under an explicit id. Ownership is the caller's —
    wrap in ImageRef(id) for RAII eviction (load_image does)."""
    b = bus or default_bus
    with _image_cache_lock:
        _image_cache[image_id] = image
    b.publish(ImageMsg(kind=ImageMsgKind.PutImage, id=image_id, image=image,
                       mipmapped=mipmapped))
    return image_id


def replace_image(image_id: ImageId, image: np.ndarray, bus: Optional[ImageMessageBus] = None) -> None:
    """In-place frame replace for video/canvas streams (imgutils.nim:563-584)."""
    b = bus or default_bus
    with _image_cache_lock:
        _image_cache[image_id] = image
    b.publish(ImageMsg(kind=ImageMsgKind.ReplaceImage, id=image_id, image=image))


def clear_image(image_id: ImageId, bus: Optional[ImageMessageBus] = None) -> None:
    (bus or default_bus).publish(ImageMsg(kind=ImageMsgKind.ClearImage, id=image_id))
    with _image_cache_lock:
        _image_cache.pop(image_id, None)


def clear_images(ids, bus: Optional[ImageMessageBus] = None) -> None:
    (bus or default_bus).publish(
        ImageMsg(kind=ImageMsgKind.ClearImages, ids=tuple(ids))
    )
    with _image_cache_lock:
        for i in ids:
            _image_cache.pop(i, None)


def clear_image_cache(bus: Optional[ImageMessageBus] = None) -> None:
    (bus or default_bus).publish(ImageMsg(kind=ImageMsgKind.ClearImageCache))
    with _image_cache_lock:
        _image_cache.clear()


def clear_font_glyphs(font_id: FontId, bus: Optional[ImageMessageBus] = None) -> None:
    (bus or default_bus).publish(
        ImageMsg(kind=ImageMsgKind.ClearFontGlyphs, font_id=font_id)
    )


def clear_typeface_glyphs(typeface_id: TypefaceId, bus: Optional[ImageMessageBus] = None) -> None:
    (bus or default_bus).publish(
        ImageMsg(kind=ImageMsgKind.ClearTypefaceGlyphs, typeface_id=typeface_id)
    )


class ImageRef:
    """RAII image handle: retains on creation, releases on close/del; the
    final release queues eviction (imgutils.nim:61-68,217-325)."""

    _refcounts: Dict[ImageId, int] = {}
    _rc_lock = threading.Lock()

    def __init__(self, image_id: ImageId, bus: Optional[ImageMessageBus] = None):
        self.id = image_id
        self._bus = bus or default_bus
        self._token = next_owner_token()
        self._closed = False
        with ImageRef._rc_lock:
            ImageRef._refcounts[image_id] = ImageRef._refcounts.get(image_id, 0) + 1
        self._bus.publish(
            ImageMsg(kind=ImageMsgKind.RetainImage, id=image_id, owner_token=self._token)
        )

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        with ImageRef._rc_lock:
            rc = ImageRef._refcounts.get(self.id, 1) - 1
            final = rc <= 0
            if final:
                ImageRef._refcounts.pop(self.id, None)
            else:
                ImageRef._refcounts[self.id] = rc
        self._bus.publish(
            ImageMsg(
                kind=ImageMsgKind.ReleaseImage,
                id=self.id,
                owner_token=self._token,
                final_release=final,
            )
        )
        if final:
            with _image_cache_lock:
                _image_cache.pop(self.id, None)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class FontRef:
    """RAII font handle (typefaces.nim:36-70)."""

    _refcounts: Dict[FontId, int] = {}
    _rc_lock = threading.Lock()

    def __init__(self, font_id: FontId, bus: Optional[ImageMessageBus] = None):
        self.id = font_id
        self._bus = bus or default_bus
        self._token = next_owner_token()
        self._closed = False
        with FontRef._rc_lock:
            FontRef._refcounts[font_id] = FontRef._refcounts.get(font_id, 0) + 1
        self._bus.publish(
            ImageMsg(kind=ImageMsgKind.RetainFont, font_id=font_id, owner_token=self._token)
        )

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        with FontRef._rc_lock:
            rc = FontRef._refcounts.get(self.id, 1) - 1
            final = rc <= 0
            if final:
                FontRef._refcounts.pop(self.id, None)
            else:
                FontRef._refcounts[self.id] = rc
        self._bus.publish(
            ImageMsg(
                kind=ImageMsgKind.ReleaseFont,
                font_id=self.id,
                owner_token=self._token,
                final_release=final,
            )
        )

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
