"""Image file I/O: PGM/PPM, PNG (stdlib zlib), simple sequences (port of
``boofcv_tpu/io/image_io.py``, numpy only; files written byte-equal to the
reference's).

Reference analog: boofcv-io io/image/UtilImageIO.java +
ConvertBufferedImage (the JVM's ImageIO does the codec work there; here
the codecs are self-contained: no imaging library needed).

Supported: PGM/PPM binary (P5/P6), PNG 8-bit gray/RGB/RGBA (non-
interlaced), load/save round-trips.  load() returns float32 arrays
([H, W] gray or [H, W, 3] color).
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np


# ---------------------------------------------------------------------------
# PGM / PPM
# ---------------------------------------------------------------------------

def save_pnm(path: str, image) -> None:
    img = np.asarray(image)
    if img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(
            f"save_pnm supports [H, W] (P5) or [H, W, 3] (P6) arrays; "
            f"got shape {img.shape} — a P6 header mandates exactly 3 "
            "samples/pixel, so other channel counts corrupt the file")
    arr = np.clip(np.round(img), 0, 255).astype(np.uint8)
    with open(path, "wb") as f:
        if arr.ndim == 2:
            f.write(f"P5\n{arr.shape[1]} {arr.shape[0]}\n255\n".encode())
        else:
            f.write(f"P6\n{arr.shape[1]} {arr.shape[0]}\n255\n".encode())
        f.write(arr.tobytes())


def load_pnm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    # parse header tokens (magic, width, height, maxval), skipping comments
    tokens = []
    i = 0
    while len(tokens) < 4:
        if data[i:i + 1] == b"#":
            i = data.index(b"\n", i) + 1
            continue
        j = i
        while data[j:j + 1] not in b" \t\r\n":
            j += 1
        if j > i:
            tokens.append(data[i:j])
        i = j + 1
    magic, w, h, maxval = tokens[0], int(tokens[1]), int(tokens[2]), int(tokens[3])
    body = data[i:]
    # 16-bit PNM samples are 2-byte BIG-ENDIAN (the spec); reading them
    # as uint8 previously returned interleaved high/low bytes silently
    dt = np.dtype(">u2") if maxval > 255 else np.uint8
    if magic == b"P5":
        arr = np.frombuffer(body, dt, count=w * h).reshape(h, w)
    elif magic == b"P6":
        arr = np.frombuffer(body, dt, count=w * h * 3).reshape(h, w, 3)
    else:
        raise ValueError(f"unsupported PNM magic {magic!r}")
    return arr.astype(np.float32)


# ---------------------------------------------------------------------------
# PNG (8-bit, non-interlaced)
# ---------------------------------------------------------------------------

def _png_chunk(tag: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


def save_png(path: str, image) -> None:
    img = np.asarray(image)
    arr = np.clip(np.round(img), 0, 255).astype(np.uint8)
    if arr.ndim == 2:
        color_type = 0
        channels = 1
    elif arr.shape[2] == 3:
        color_type = 2
        channels = 3
    elif arr.shape[2] == 4:
        color_type = 6
        channels = 4
    else:
        raise ValueError("unsupported channel count")
    h, w = arr.shape[:2]
    raw = b"".join(b"\x00" + arr[y].tobytes() for y in range(h))
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_png_chunk(b"IHDR", ihdr))
        f.write(_png_chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(_png_chunk(b"IEND", b""))


def _unfilter(raw: bytes, h: int, w: int, ch: int) -> np.ndarray:
    stride = w * ch
    out = np.zeros((h, stride), np.uint8)
    pos = 0
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ftype = raw[pos]
        pos += 1
        line = np.frombuffer(raw[pos:pos + stride], np.uint8).astype(np.int32)
        pos += stride
        if ftype == 0:
            cur = line
        elif ftype == 1:          # Sub
            cur = line.copy()
            for x in range(ch, stride):
                cur[x] = (cur[x] + cur[x - ch]) & 0xFF
        elif ftype == 2:          # Up
            cur = (line + prev) & 0xFF
        elif ftype == 3:          # Average
            cur = line.copy()
            for x in range(stride):
                left = cur[x - ch] if x >= ch else 0
                cur[x] = (cur[x] + ((left + prev[x]) >> 1)) & 0xFF
        elif ftype == 4:          # Paeth
            cur = line.copy()
            for x in range(stride):
                a = cur[x - ch] if x >= ch else 0
                b = prev[x]
                c = prev[x - ch] if x >= ch else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                cur[x] = (cur[x] + pred) & 0xFF
        else:
            raise ValueError(f"bad filter {ftype}")
        out[y] = cur.astype(np.uint8)
        prev = cur
    return out


def load_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path} is not a PNG")
    pos = 8
    idat = b""
    w = h = bit_depth = color_type = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            w, h, bit_depth, color_type, _, _, interlace = struct.unpack(
                ">IIBBBBB", payload)
            if bit_depth != 8 or interlace != 0:
                raise ValueError("only 8-bit non-interlaced PNG supported")
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
    ch = {0: 1, 2: 3, 4: 2, 6: 4}[color_type]
    raw = zlib.decompress(idat)
    arr = _unfilter(raw, h, w, ch).reshape(h, w, ch)
    if color_type == 0:
        arr = arr[..., 0]
    elif color_type == 4:         # gray+alpha -> gray
        arr = arr[..., 0]
    elif color_type == 6:         # drop alpha
        arr = arr[..., :3]
    return arr.astype(np.float32)


# ---------------------------------------------------------------------------
# Generic front door + sequences
# ---------------------------------------------------------------------------

def load(path: str) -> np.ndarray:
    ext = os.path.splitext(path)[1].lower()
    if ext in (".pgm", ".ppm", ".pnm"):
        return load_pnm(path)
    if ext == ".png":
        return load_png(path)
    raise ValueError(f"unsupported image format {ext}")


def save(path: str, image) -> None:
    ext = os.path.splitext(path)[1].lower()
    if ext in (".pgm", ".ppm", ".pnm"):
        save_pnm(path, image)
    elif ext == ".png":
        save_png(path, image)
    else:
        raise ValueError(f"unsupported image format {ext}")


def load_sequence(directory: str, pattern_exts=(".png", ".pgm", ".ppm")):
    """Sorted list of images in a directory (io/wrapper/images analog)."""
    files = sorted(f for f in os.listdir(directory)
                   if os.path.splitext(f)[1].lower() in pattern_exts)
    return [load(os.path.join(directory, f)) for f in files]


def to_gray(image) -> np.ndarray:
    img = np.asarray(image, np.float32)
    if img.ndim == 2:
        return img
    return img[..., 0] * 0.299 + img[..., 1] * 0.587 + img[..., 2] * 0.114
