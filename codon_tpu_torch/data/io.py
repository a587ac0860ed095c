"""8-bit grayscale PNG codec and dataset discovery, on zlib and struct alone.

Scale-directory layout (e.g. CODON_X4/):
  input_depth/  bicubic-upsampled LR depth at HR size (model input)
  input_color/  guidance image, grayscale (model input)
  input_label/  ground-truth depth (eval target)

The codec reads non-interlaced 8-bit grayscale PNGs (color type 0) with any
of the five row filters, and writes them with filter 0. Any other PNG
(color, palette, 16-bit, interlaced, a bad CRC, truncated data) raises
rather than being guessed at.
"""
from __future__ import annotations

import dataclasses
import os
import struct
import zlib
from typing import List, Optional

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"


def _chunks(data: bytes, path: str):
    pos = len(_SIG)
    while pos < len(data):
        if pos + 8 > len(data):
            raise ValueError(f"{path}: truncated PNG chunk header")
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc_at = pos + 8 + length
        if crc_at + 4 > len(data):
            raise ValueError(f"{path}: truncated PNG chunk {ctype!r}")
        (crc,) = struct.unpack(">I", data[crc_at:crc_at + 4])
        if zlib.crc32(ctype + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: CRC mismatch in chunk {ctype!r}")
        yield ctype, body
        if ctype == b"IEND":
            return
        pos = crc_at + 4
    raise ValueError(f"{path}: PNG without IEND")


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, h: int, w: int, path: str) -> np.ndarray:
    stride = w + 1
    if len(raw) != h * stride:
        raise ValueError(f"{path}: {len(raw)} bytes of pixel data for "
                         f"{h}x{w}, expected {h * stride}")
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride)
    img = np.zeros((h, w), np.uint8)
    prev = np.zeros(w, np.uint8)
    for y in range(h):
        ftype, line = rows[y, 0], rows[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:        # Sub: one byte per pixel, a running sum
            cur = (np.cumsum(line, dtype=np.uint64) & 0xFF).astype(np.uint8)
        elif ftype == 2:        # Up
            cur = line + prev
        elif ftype in (3, 4):   # Average, Paeth: sequential along the row
            out = [0] * w
            up = prev.tolist()
            vals = line.tolist()
            left = 0
            for x in range(w):
                if ftype == 3:
                    pred = (left + up[x]) >> 1
                else:
                    pred = _paeth(left, up[x], up[x - 1] if x else 0)
                left = (vals[x] + pred) & 0xFF
                out[x] = left
            cur = np.asarray(out, np.uint8)
        else:
            raise ValueError(f"{path}: unknown PNG filter type {ftype}")
        img[y] = cur
        prev = cur
    return img


def imread_gray(path: str) -> np.ndarray:
    """uint8 (H, W) from an 8-bit grayscale PNG."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIG:
        raise ValueError(f"{path}: not a PNG")
    ihdr = None
    idat = []
    for ctype, body in _chunks(data, path):
        if ctype == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype != b"IEND" and not ctype[0] & 0x20:   # critical chunk
            raise ValueError(f"{path}: unsupported critical chunk {ctype!r}")
    if ihdr is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, ctype, comp, filt, interlace = ihdr
    if (depth, ctype, comp, filt, interlace) != (8, 0, 0, 0, 0):
        raise ValueError(
            f"{path}: only 8-bit grayscale non-interlaced PNGs are read "
            f"(bit depth {depth}, color type {ctype}, interlace {interlace})")
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{path}: corrupt PNG data ({e})") from e
    return _unfilter(raw, h, w, path)


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body +
            struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF))


def imwrite_gray(path: str, img: np.ndarray) -> None:
    """Write a uint8 (H, W) array as an 8-bit grayscale PNG."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 2:
        raise ValueError(f"imwrite_gray takes uint8 (H, W), got "
                         f"{img.dtype} {img.shape}")
    h, w = img.shape
    rows = np.zeros((h, w + 1), np.uint8)   # filter byte 0 on every row
    rows[:, 1:] = img
    png = (_SIG + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
           + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
           + _chunk(b"IEND", b""))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(png)


@dataclasses.dataclass
class Sample:
    name: str
    depth: np.ndarray            # uint8 (H, W)
    color: np.ndarray            # uint8 (H, W)
    label: Optional[np.ndarray]  # uint8 (H, W) or None


def discover_pairs(scale_dir: str) -> List[str]:
    """Sorted image names (no extension) present in input_color/."""
    cdir = os.path.join(scale_dir, "input_color")
    return sorted(os.path.splitext(f)[0] for f in os.listdir(cdir)
                  if f.lower().endswith(".png"))


def load_sample(scale_dir: str, name: str, with_label: bool = True) -> Sample:
    depth = imread_gray(os.path.join(scale_dir, "input_depth", name + ".png"))
    color = imread_gray(os.path.join(scale_dir, "input_color", name + ".png"))
    label = None
    if with_label:
        lp = os.path.join(scale_dir, "input_label", name + ".png")
        if os.path.exists(lp):
            label = imread_gray(lp)
    return Sample(name, depth, color, label)
