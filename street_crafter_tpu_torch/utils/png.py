"""8-bit PNG read/write with the standard library only (zlib + struct).

Stands in for ``imageio`` in the port, which may run where imageio is not
installed. Writes non-interlaced 8-bit gray / gray+alpha / RGB / RGBA with
filter type 0; reads the same colour types with any of the five row filters.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_SAMPLES = {0: 1, 4: 2, 2: 3, 6: 4}          # colour type -> samples/pixel
_COLOR_TYPE = {c: t for t, c in _SAMPLES.items()}


def _chunk(tag: bytes, body: bytes) -> bytes:
    crc = zlib.crc32(tag + body) & 0xFFFFFFFF
    return struct.pack(">I", len(body)) + tag + body + struct.pack(">I", crc)


def write_png(path: str | os.PathLike, img: np.ndarray) -> None:
    """Write a uint8 [H, W] or [H, W, C] (C in 1..4) image."""
    a = np.asarray(img)
    if a.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8, got {a.dtype}")
    if a.ndim == 2:
        a = a[..., None]
    if a.ndim != 3 or a.shape[2] not in _COLOR_TYPE:
        raise ValueError(f"write_png: unsupported shape {a.shape}")
    h, w, c = a.shape
    raw = np.zeros((h, 1 + w * c), np.uint8)      # leading 0 = filter None
    raw[:, 1:] = a.reshape(h, w * c)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    os.makedirs(os.path.dirname(os.fspath(path)) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + _chunk(b"IEND", b""))


def _unfilter_row(ftype: int, line: np.ndarray, prev: np.ndarray,
                  bpp: int) -> np.ndarray:
    if ftype == 0:
        return line.copy()
    if ftype == 1:      # Sub: running sum along the row, mod 256
        return np.cumsum(line.reshape(-1, bpp), axis=0,
                         dtype=np.uint8).reshape(-1)
    if ftype == 2:      # Up
        return line + prev
    out = np.zeros(line.shape[0], np.int32)
    cur = line.astype(np.int32)
    up = prev.astype(np.int32)
    for x in range(0, line.shape[0], bpp):
        s = slice(x, x + bpp)
        left = out[x - bpp:x] if x else np.zeros(bpp, np.int32)
        if ftype == 3:  # Average
            out[s] = (cur[s] + (left + up[s]) // 2) & 0xFF
        elif ftype == 4:  # Paeth
            ul = up[x - bpp:x] if x else np.zeros(bpp, np.int32)
            p = left + up[s] - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - up[s]), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, up[s], ul))
            out[s] = (cur[s] + pred) & 0xFF
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
    return out.astype(np.uint8)


def read_png(path: str | os.PathLike) -> np.ndarray:
    """Read an 8-bit non-interlaced PNG -> uint8 [H, W] or [H, W, C]."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"not a PNG: {path}")
    pos, idat, header = 8, [], None
    while pos < len(data):
        length, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError(f"PNG without IHDR: {path}")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or interlace != 0 or ctype not in _SAMPLES:
        raise ValueError(f"unsupported PNG (depth {depth}, colour type "
                         f"{ctype}, interlace {interlace}): {path}")
    c = _SAMPLES[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, 1 + w * c)
    filters, rows = raw[:, 0], raw[:, 1:]
    if not filters.any():
        out = rows.copy()
    else:
        out = np.empty_like(rows)
        prev = np.zeros(w * c, np.uint8)
        for y in range(h):
            prev = out[y] = _unfilter_row(int(filters[y]), rows[y], prev, c)
    out = out.reshape(h, w, c)
    return out[..., 0] if c == 1 else out
