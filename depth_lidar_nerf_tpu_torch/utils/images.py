"""Image reading and PNG writing (the port's copy of ``utils/images.py``,
with its own PNG codec).

The reference reads images as ``imageio.imread(f)[..., :3] / 255.``
(``load_llff.py:76``); :func:`imread_rgb_float` keeps the JAX package's
contract on top of that: grayscale is expanded to three channels, alpha is
dropped, and integer images are scaled by their dtype's max.

PNG files are decoded here with ``zlib``, ``struct`` and numpy, so that a
scene of PNGs loads on a machine without imageio or PIL: colour types 0
(grey), 2 (RGB), 4 (grey + alpha) and 6 (RGBA) at bit depths 8 and 16, 3
(palette, expanded to RGB, or RGBA with a ``tRNS`` chunk) at 1, 2, 4 and 8,
scanline filters 0-4. Interlaced PNGs are refused. Other
formats (JPEG) go through imageio, else PIL, and raise naming the format when
neither is importable. :func:`write_png` writes 8-bit grey or RGB PNGs.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunks(data: bytes, path: str):
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError(f"{path}: truncated PNG chunk {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{path}: PNG without an IEND chunk")


def _paeth_row(raw: bytes, prior: bytes, bpp: int) -> bytearray:
    out = bytearray(raw)
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (out[i] + pred) & 0xFF
    return out


def _average_row(raw: bytes, prior: bytes, bpp: int) -> bytearray:
    out = bytearray(raw)
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        out[i] = (out[i] + ((a + prior[i]) >> 1)) & 0xFF
    return out


def _unfilter(raw: bytes, height: int, stride: int, bpp: int,
              path: str) -> np.ndarray:
    """Undo the per-scanline filters (PNG spec section 9) -> ``[H, stride]``
    uint8."""
    if len(raw) < height * (stride + 1):
        raise ValueError(f"{path}: PNG image data is too short")
    rows = np.frombuffer(raw, np.uint8, height * (stride + 1)).reshape(
        height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        ftype, line = int(rows[y, 0]), rows[y, 1:]
        if ftype == 0:
            cur = line
        elif ftype == 1:  # Sub: a running sum along each byte lane of bpp
            lanes = line.reshape(-1, bpp).astype(np.uint32)
            cur = (np.cumsum(lanes, axis=0) & 0xFF).astype(np.uint8).reshape(-1)
        elif ftype == 2:  # Up
            cur = line + prior  # uint8 arithmetic wraps mod 256
        elif ftype == 3:
            cur = np.frombuffer(_average_row(line.tobytes(), prior.tobytes(),
                                             bpp), np.uint8)
        elif ftype == 4:
            cur = np.frombuffer(_paeth_row(line.tobytes(), prior.tobytes(),
                                           bpp), np.uint8)
        else:
            raise ValueError(f"{path}: unknown PNG filter type {ftype}")
        out[y] = cur
        prior = out[y]
    return out


def read_png(path: str) -> np.ndarray:
    """Decode a PNG file -> ``[H, W]`` or ``[H, W, C]`` uint8 (bit depth 8)
    or uint16 (bit depth 16), channels as stored (palette images expand to
    RGB or RGBA)."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, palette, alpha, idat = None, None, None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            alpha = np.frombuffer(body, np.uint8)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    width, height, depth, ctype, _, _, interlace = header
    if interlace:
        raise ValueError(f"{path}: interlaced (Adam7) PNGs are not supported; "
                         "save the image without interlacing")
    if ctype not in _CHANNELS:
        raise ValueError(f"{path}: unknown PNG colour type {ctype}")
    if depth not in ((1, 2, 4, 8) if ctype == 3 else (8, 16)):
        raise ValueError(f"{path}: PNG bit depth {depth} with colour type "
                         f"{ctype} is not supported (8 and 16 are; palette "
                         "images 1, 2, 4 and 8)")
    channels = _CHANNELS[ctype]
    bpp = max(1, channels * depth // 8)
    stride = (width * channels * depth + 7) // 8
    pix = _unfilter(zlib.decompress(b"".join(idat)), height, stride, bpp,
                    path)
    if depth == 16:
        img = pix.view(">u2").astype(np.uint16).reshape(height, width,
                                                         channels)
    elif depth < 8:  # palette indices packed MSB first
        bits = np.unpackbits(pix, axis=1).reshape(height, -1, depth)
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        img = (bits * weights).sum(-1, dtype=np.uint8)[:, :width, None]
    else:
        img = pix.reshape(height, width, channels)
    if ctype == 3:
        if palette is None:
            raise ValueError(f"{path}: palette PNG without a PLTE chunk")
        idx = img[..., 0]
        rgb = palette[idx]
        if alpha is not None:
            a = np.full(len(palette), 255, np.uint8)
            a[:len(alpha)] = alpha[:len(palette)]
            return np.concatenate([rgb, a[idx][..., None]], axis=-1)
        return rgb
    return img[..., 0] if channels == 1 else img


def write_png(path: str, img: np.ndarray, filter_type: int = 0) -> str:
    """Write an 8-bit grey ``[H, W]`` or RGB ``[H, W, 3]`` uint8 image as a
    PNG, every scanline with filter ``0`` (None) or ``2`` (Up)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (
            img.ndim == 3 and img.shape[-1] == 3)):
        raise ValueError(f"write_png takes uint8 [H, W] or [H, W, 3], got "
                         f"{img.dtype} {img.shape}")
    if filter_type not in (0, 2):
        raise ValueError("write_png writes filter 0 (None) or 2 (Up)")
    height, width = img.shape[:2]
    rows = np.ascontiguousarray(img).reshape(height, -1)
    if filter_type == 2:
        rows = rows - np.concatenate([np.zeros_like(rows[:1]), rows[:-1]])
    raw = np.concatenate(
        [np.full((height, 1), filter_type, np.uint8), rows], axis=1).tobytes()

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    ctype = 0 if img.ndim == 2 else 2
    png = (PNG_SIGNATURE
           + chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8, ctype,
                                        0, 0, 0))
           + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(png)
    os.replace(tmp, path)
    return path


def _imread_other(path: str) -> np.ndarray:
    """A non-PNG image through imageio, else PIL."""
    try:
        import imageio.v2 as imageio
    except ImportError:
        pass
    else:
        return np.asarray(imageio.imread(path))
    try:
        from PIL import Image
    except ImportError:
        ext = os.path.splitext(path)[1] or "(no extension)"
        raise RuntimeError(
            f"{path}: reading {ext} images needs imageio or PIL, and neither "
            "is importable; PNG images are read without them") from None
    with Image.open(path) as im:
        return np.asarray(im)


def imread_rgb_float(path: str) -> np.ndarray:
    """Read an image as float RGB in [0, 1] ([H, W, 3], float64).

    Grayscale images are expanded to 3 channels; alpha is dropped; integer
    images are scaled by their dtype max (255 for uint8, 65535 for uint16);
    float images are passed through.
    """
    with open(path, "rb") as f:
        is_png = f.read(len(PNG_SIGNATURE)) == PNG_SIGNATURE
    img = read_png(path) if is_png else _imread_other(path)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    elif img.shape[-1] == 2:  # grayscale + alpha (LA): drop alpha, expand
        img = np.stack([img[..., 0]] * 3, axis=-1)
    img = img[..., :3]
    if np.issubdtype(img.dtype, np.floating):
        return img.astype(np.float64)
    return img / np.float64(np.iinfo(img.dtype).max)
