"""Video I/O: MJPEG codec + image-sequence wrappers (port of
``boofcv_tpu/io/video.py``).

Reference analog: boofcv-io io/video/VideoMjpegCodec.java (splits a raw
concatenated-MJPEG stream at the JPEG SOI/EOI markers; frame decode is
delegated to the platform codec) and io/wrapper/images/
(LoadFileImageSequence.java, ImageStreamSequence.java).

The marker-scan split is pure byte logic (host); per-frame decode uses
PIL when available (gated import — the library core never requires it).
"""

from __future__ import annotations

import glob
import os
from typing import Iterator, List

import numpy as np

SOI = b"\xff\xd8"   # JPEG start-of-image
EOI = b"\xff\xd9"   # JPEG end-of-image


def split_mjpeg(data: bytes) -> List[bytes]:
    """Split a concatenated-MJPEG byte stream into one JPEG per frame
    (VideoMjpegCodec.read's marker scan)."""
    frames = []
    pos = 0
    while True:
        start = data.find(SOI, pos)
        if start < 0:
            break
        end = data.find(EOI, start + 2)
        if end < 0:
            break
        frames.append(data[start:end + 2])
        pos = end + 2
    return frames


def _decode_jpeg(buf: bytes) -> np.ndarray:
    import io as _io
    from PIL import Image
    return np.asarray(Image.open(_io.BytesIO(buf)))


def read_mjpeg(path: str) -> Iterator[np.ndarray]:
    """Iterate decoded frames of an MJPEG file."""
    with open(path, "rb") as f:
        data = f.read()
    for buf in split_mjpeg(data):
        yield _decode_jpeg(buf)


def write_mjpeg(path: str, frames, quality: int = 90) -> None:
    """Write frames as a concatenated-MJPEG stream (the format
    VideoMjpegCodec reads)."""
    import io as _io
    from PIL import Image
    with open(path, "wb") as f:
        for fr in frames:
            a = np.asarray(fr)
            if a.dtype != np.uint8:
                a = np.clip(a, 0, 255).astype(np.uint8)
            img = Image.fromarray(a)
            buf = _io.BytesIO()
            img.save(buf, format="JPEG", quality=quality)
            f.write(buf.getvalue())


class ImageSequence:
    """Image-file sequence (LoadFileImageSequence analog): iterates files
    matching a glob pattern in sorted order, decoded as numpy arrays."""

    def __init__(self, pattern: str):
        self.paths = sorted(glob.glob(pattern))
        self.index = 0

    def __len__(self) -> int:
        return len(self.paths)

    def __iter__(self):
        from boofcv_tpu_torch.io import image_io
        for p in self.paths:
            ext = os.path.splitext(p)[1].lower()
            if ext in (".pgm", ".ppm", ".pnm", ".png"):
                yield image_io.load(p)
            else:
                yield _decode_jpeg(open(p, "rb").read())
