"""A PNG reader in the standard library and numpy, for the pretraining
renders (``geot_tpu`` reads them through PIL, ``data/tooth_pretrain.py:
109-117``; the port takes no dependency on PIL).

``read_png_rgb`` returns what ``Image.open(path).convert("RGB")`` gives,
as float32 (H, W, 3) in [0, 1]: grey (bit depths 1, 2, 4, 8, scaled to
8 bits as PIL scales them) and grey with alpha repeated over the three
channels, palette images (bit depths 1, 2, 4, 8) looked up in ``PLTE``,
RGB as it is, RGBA without its alpha (PIL drops it, it does not
composite); a ``tRNS`` chunk is ignored, as PIL's conversion ignores it.
Non-interlaced images only, with the five row filters of the PNG
specification (section 9). A 16-bit or an interlaced image raises
``ValueError`` naming its colour type and bit depth.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> (name, samples a pixel, bit depths read here)
_TYPES = {0: ("grey", 1, (1, 2, 4, 8)), 2: ("RGB", 3, (8,)),
          3: ("palette", 1, (1, 2, 4, 8)), 4: ("grey+alpha", 2, (8,)),
          6: ("RGBA", 4, (8,))}


def _chunks(data: bytes, path: str):
    """(type, body) of each chunk, CRCs checked."""
    at = len(SIGNATURE)
    while at + 12 <= len(data):
        (n,) = struct.unpack(">I", data[at:at + 4])
        kind = data[at + 4:at + 8]
        body = data[at + 8:at + 8 + n]
        (crc,) = struct.unpack(">I", data[at + 8 + n:at + 12 + n])
        if len(body) != n or zlib.crc32(kind + body) != crc:
            raise ValueError(f"{path}: PNG chunk {kind!r} is truncated or "
                             f"fails its CRC")
        yield kind, body
        at += 12 + n
        if kind == b"IEND":
            return
    raise ValueError(f"{path}: PNG ends before its IEND chunk")


def _unfilter(raw: bytes, height: int, row_bytes: int, bpp: int,
              path: str) -> np.ndarray:
    """The scanlines of the inflated image data with their filters undone
    (PNG section 9.2): (height, row_bytes) uint8. ``bpp`` is the bytes of
    a pixel, at least 1. Sub and Up are vectorised; Average and Paeth run
    byte by byte."""
    stride = row_bytes + 1
    if len(raw) < height * stride:
        raise ValueError(f"{path}: PNG image data holds {len(raw)} bytes, "
                         f"expected {height * stride}")
    out = np.zeros((height, row_bytes), np.uint8)
    prev = bytearray(row_bytes)
    for y in range(height):
        ftype = raw[y * stride]
        line = raw[y * stride + 1:(y + 1) * stride]
        if ftype == 0:                          # None
            cur = bytearray(line)
        elif ftype == 1:                        # Sub: a running sum per byte
            a = np.frombuffer(line, np.uint8).reshape(-1, bpp)  # of a pixel
            cur = bytearray(np.cumsum(a, axis=0, dtype=np.uint8).tobytes())
        elif ftype == 2:                        # Up
            cur = bytearray((np.frombuffer(line, np.uint8)
                             + np.frombuffer(bytes(prev), np.uint8)
                             ).tobytes())
        elif ftype == 3:                        # Average
            cur = bytearray(line)
            for x in range(row_bytes):
                left = cur[x - bpp] if x >= bpp else 0
                cur[x] = (cur[x] + ((left + prev[x]) >> 1)) & 0xFF
        elif ftype == 4:                        # Paeth
            cur = bytearray(line)
            for x in range(row_bytes):
                a = cur[x - bpp] if x >= bpp else 0
                b = prev[x]
                c = prev[x - bpp] if x >= bpp else 0
                pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc
                                                        else c)
                cur[x] = (cur[x] + pred) & 0xFF
        else:
            raise ValueError(f"{path}: PNG row {y} has filter type {ftype}")
        out[y] = np.frombuffer(bytes(cur), np.uint8)
        prev = cur
    return out


def read_png(path: str) -> np.ndarray:
    """The PNG at ``path`` as ``Image.open(path).convert("RGB")`` reads it:
    (H, W, 3) uint8."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, palette, idat = None, None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG has no IHDR chunk")
    width, height, depth, ctype, _, _, interlace = header
    name, samples, depths = _TYPES.get(ctype, (f"type {ctype}", 0, ()))
    if depth not in depths or interlace:
        raise ValueError(
            f"{path}: PNG of colour type {ctype} ({name}) at bit depth "
            f"{depth}{', interlaced' if interlace else ''} is not read: "
            f"8-bit grey, grey+alpha, RGB, RGBA and palette images (grey "
            f"and palette also at 1, 2 and 4 bits), not interlaced")
    row_bytes = (width * samples * depth + 7) // 8
    rows = _unfilter(zlib.decompress(b"".join(idat)), height, row_bytes,
                     max(1, samples * depth // 8), path)
    if depth < 8:
        # sub-byte samples, most significant bits first
        bits = np.unpackbits(rows, axis=1).reshape(height, -1, depth)
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        vals = (bits * weights).sum(axis=-1, dtype=np.uint8)[:, :width]
    else:
        vals = rows.reshape(height, width, samples)
    if ctype == 3:
        if palette is None:
            raise ValueError(f"{path}: palette PNG has no PLTE chunk")
        idx = vals if depth < 8 else vals[..., 0]
        if int(idx.max(initial=0)) >= len(palette):
            raise ValueError(f"{path}: palette index past the "
                             f"{len(palette)}-entry PLTE")
        return palette[idx]
    if ctype == 0:
        grey = vals if depth < 8 else vals[..., 0]
        if depth < 8:
            # PIL's "L;1/2/4" unpackers scale to 8 bits
            grey = (grey.astype(np.uint16) * 255 // ((1 << depth) - 1)
                    ).astype(np.uint8)
        return np.repeat(grey[..., None], 3, axis=-1)
    if ctype == 4:
        return np.repeat(vals[..., :1], 3, axis=-1)
    return np.ascontiguousarray(vals[..., :3])


def read_png_rgb(path: str) -> np.ndarray:
    """(H, W, 3) float32 in [0, 1]: ``read_png(path) / 255``, the render of
    ``geot_tpu``'s ``_load_render``."""
    return read_png(path).astype(np.float32) / 255.0
