"""Image files for the CLI, with the standard library alone.

``load_image`` reads a file as ``cv2.imread`` does: a uint8 [H, W] gray
image, or [H, W, 3] in BGR order. ``save_image`` writes a gray [H, W] or
BGR [H, W, 3] uint8 image. ``image_size`` gives (width, height).

PNG (8-bit gray, RGB and RGBA, not interlaced, all five row filters) and
binary PGM/PPM (P5/P6, maxval 255) are decoded and encoded here over
``zlib``, so the CLI reads and writes its frames and model directories
where neither OpenCV nor Pillow is installed. A color file read as gray
goes through ``bgr2gray_u8`` (OpenCV's cvtColor formula); a gray file
read as color repeats its plane three times; alpha is dropped, as
``IMREAD_COLOR`` drops it. Every other file (JPEG, BMP, 16-bit or
palette PNG, ...) goes through cv2, then PIL, as the JAX package's CLI
does; with neither installed it raises ``ImportError`` naming the file.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG color type -> channels (gray, RGB, RGBA)
_PNG_CHANNELS = {0: 1, 2: 3, 6: 4}


class _Unsupported(Exception):
    """A file this module does not decode itself."""


def _to_gray_or_bgr(arr: np.ndarray, gray: bool) -> np.ndarray:
    """[H, W, C] (C = 1, 3 RGB or 4 RGBA) -> what imread gives."""
    from .verify import bgr2gray_u8

    if arr.shape[2] == 1:
        plane = arr[:, :, 0]
        return plane.copy() if gray else np.repeat(arr, 3, axis=2)
    bgr = np.ascontiguousarray(arr[:, :, 2::-1])
    return bgr2gray_u8(bgr) if gray else bgr


def _png_chunks(data: bytes, path: str):
    if not data.startswith(_PNG_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    pos = len(_PNG_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4 or struct.unpack(
                ">I", crc)[0] != zlib.crc32(kind + body):
            raise ValueError(f"{path}: truncated or corrupt PNG chunk "
                             f"{kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{path}: PNG without IEND")


def _png_header(data: bytes, path: str) -> tuple:
    kind, body = next(_png_chunks(data, path))
    if kind != b"IHDR" or len(body) != 13:
        raise ValueError(f"{path}: PNG does not start with IHDR")
    return struct.unpack(">IIBBBBB", body)


def _unfilter(raw: np.ndarray, h: int, w: int, c: int) -> np.ndarray:
    """Undo the PNG row filters of [h, 1 + w*c] bytes -> [h, w, c].

    Sub, Average and Paeth read the reconstructed byte to the left, Up,
    Average and Paeth the one above, so pixel (y, x) depends only on
    pixels of earlier anti-diagonals y + x: all rows are reconstructed
    together one anti-diagonal at a time, each row with its own filter.
    Rows filtered with None only need no work."""
    ftype = raw[:, 0].astype(np.int16)
    filt = raw[:, 1:].reshape(h, w, c).astype(np.int16)
    if (ftype == 0).all():
        return filt.astype(np.uint8)
    if ftype.max() > 4:
        raise ValueError(f"PNG row filter {int(ftype.max())}")
    # reconstructed bytes with a zero row above and a zero column left
    rec = np.zeros((h + 1, w + 1, c), np.int16)
    rows = np.arange(h)
    for d in range(h + w - 1):
        y = rows[max(0, d - w + 1):min(d, h - 1) + 1]
        x = d - y
        a = rec[y + 1, x]       # left
        b = rec[y, x + 1]       # above
        cc = rec[y, x]          # above left
        t = ftype[y][:, None]
        p = a + b - cc
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - cc)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, cc))
        pred = np.select([t == 1, t == 2, t == 3, t == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        rec[y + 1, x + 1] = (filt[y, x] + pred) & 0xFF
    return rec[1:, 1:].astype(np.uint8)


def decode_png(data: bytes, path: str = "<png>") -> np.ndarray:
    """An 8-bit gray, RGB or RGBA PNG -> uint8 [H, W, C] in file order
    (C = 1, 3 or 4). Raises _Unsupported for other PNGs."""
    w, h, depth, ctype, comp, filt, interlace = _png_header(data, path)
    if depth != 8 or ctype not in _PNG_CHANNELS or interlace:
        raise _Unsupported(f"{path}: PNG of bit depth {depth}, color type "
                           f"{ctype}, interlace {interlace}")
    if comp or filt:
        raise ValueError(f"{path}: unknown PNG compression or filter method")
    idat = b"".join(body for kind, body in _png_chunks(data, path)
                    if kind == b"IDAT")
    c = _PNG_CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    if raw.size != h * (1 + w * c):
        raise ValueError(f"{path}: PNG image data of {raw.size} bytes, "
                         f"expected {h * (1 + w * c)}")
    return _unfilter(raw.reshape(h, 1 + w * c), h, w, c)


def encode_png(img: np.ndarray) -> bytes:
    """uint8 gray [H, W] or BGR [H, W, 3] -> PNG bytes (gray or RGB, row
    filter None)."""
    arr = np.asarray(img)
    if arr.dtype != np.uint8 or not (arr.ndim == 2 or (
            arr.ndim == 3 and arr.shape[2] == 3)):
        raise ValueError(f"save a uint8 [H, W] or [H, W, 3] image, got "
                         f"{arr.dtype} {arr.shape}")
    h, w = arr.shape[:2]
    if arr.ndim == 3:
        arr, ctype = arr[:, :, ::-1], 2
    else:
        ctype = 0
    rows = np.zeros((h, 1 + arr[0].size), np.uint8)
    rows[:, 1:] = arr.reshape(h, -1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (_PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0,
                                         0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


def _pnm_header(data: bytes, path: str) -> tuple:
    """(magic, width, height, maxval, offset of the pixels) of a binary
    PGM/PPM."""
    fields, pos = [], 2
    magic = data[:2]
    while len(fields) < 3:
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            while pos < len(data) and data[pos:pos + 1] not in b"\r\n":
                pos += 1
            continue
        start = pos
        while pos < len(data) and data[pos:pos + 1].isdigit():
            pos += 1
        if start == pos:
            raise ValueError(f"{path}: bad PGM/PPM header")
        fields.append(int(data[start:pos]))
    # exactly one whitespace byte ends the header
    return (magic, *fields, pos + 1)


def decode_pnm(data: bytes, path: str = "<pnm>") -> np.ndarray:
    """A binary 8-bit PGM (P5) or PPM (P6) -> uint8 [H, W, C], C = 1 or 3
    (RGB). Raises _Unsupported for other Netpbm files."""
    if data[:2] not in (b"P5", b"P6"):
        raise _Unsupported(f"{path}: Netpbm format {data[:2]!r}")
    magic, w, h, maxval, off = _pnm_header(data, path)
    if maxval != 255:
        raise _Unsupported(f"{path}: Netpbm maxval {maxval}")
    c = 1 if magic == b"P5" else 3
    if len(data) < off + h * w * c:
        raise ValueError(f"{path}: truncated PGM/PPM")
    return np.frombuffer(data, np.uint8, h * w * c, off).reshape(h, w, c)


def encode_pnm(img: np.ndarray) -> bytes:
    """uint8 gray [H, W] -> PGM (P5), BGR [H, W, 3] -> PPM (P6)."""
    arr = np.asarray(img)
    if arr.dtype != np.uint8 or not (arr.ndim == 2 or (
            arr.ndim == 3 and arr.shape[2] == 3)):
        raise ValueError(f"save a uint8 [H, W] or [H, W, 3] image, got "
                         f"{arr.dtype} {arr.shape}")
    h, w = arr.shape[:2]
    if arr.ndim == 3:
        return f"P6\n{w} {h}\n255\n".encode() + np.ascontiguousarray(
            arr[:, :, ::-1]).tobytes()
    return f"P5\n{w} {h}\n255\n".encode() + np.ascontiguousarray(
        arr).tobytes()


def _decode(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(_PNG_SIGNATURE):
        return decode_png(data, path)
    if data[:1] == b"P" and data[1:2].isdigit():
        return decode_pnm(data, path)
    raise _Unsupported(path)


def _load_with_library(path: str, gray: bool) -> np.ndarray:
    """The JAX package CLI's reader: cv2, else PIL."""
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        img = cv2.imread(path, cv2.IMREAD_GRAYSCALE if gray
                         else cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(path)
        return img
    try:
        from PIL import Image
    except ImportError:
        raise ImportError(f"{path}: reading this format needs OpenCV (cv2) "
                          f"or Pillow (PIL), and neither is installed; "
                          f"PNG and PGM/PPM need neither") from None
    with Image.open(path) as im:
        arr = np.asarray(im.convert("L" if gray else "RGB"))
    return arr if gray else arr[:, :, ::-1].copy()


def load_image(path: str, gray: bool = False) -> np.ndarray:
    """uint8 [H, W] (gray) or [H, W, 3] BGR, as cv2.imread gives them."""
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    try:
        arr = _decode(path)
    except _Unsupported:
        return _load_with_library(path, gray)
    if arr.shape[2] == 4:
        arr = arr[:, :, :3]
    return _to_gray_or_bgr(arr, gray)


def save_image(img: np.ndarray, path: str) -> None:
    """Write a uint8 gray [H, W] or BGR [H, W, 3] image: PNG for .png,
    PGM/PPM for .pgm/.ppm/.pnm, cv2 (else PIL) for other extensions."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".png":
        data = encode_png(img)
    elif ext in (".pgm", ".ppm", ".pnm"):
        data = encode_pnm(img)
    else:
        _save_with_library(np.asarray(img), path)
        return
    with open(path, "wb") as f:
        f.write(data)


def _save_with_library(arr: np.ndarray, path: str) -> None:
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        if not cv2.imwrite(path, arr):
            raise OSError(f"cv2 could not write {path}")
        return
    try:
        from PIL import Image
    except ImportError:
        raise ImportError(f"{path}: writing this format needs OpenCV (cv2) "
                          f"or Pillow (PIL), and neither is installed; "
                          f"PNG and PGM/PPM need neither") from None
    Image.fromarray(arr[:, :, ::-1] if arr.ndim == 3 else arr).save(path)


def image_size(path: str) -> tuple[int, int]:
    """(width, height) of an image file (utils.cpp:30-39 getImageSize)."""
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(_PNG_SIGNATURE):
        w, h = _png_header(data, path)[:2]
        return int(w), int(h)
    if data[:2] in (b"P5", b"P6"):
        return tuple(_pnm_header(data, path)[1:3])
    img = _load_with_library(path, gray=True)
    return img.shape[1], img.shape[0]
