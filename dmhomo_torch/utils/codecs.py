"""Image file encoders in numpy, scipy and the standard library (the card's
machine has no PIL or imageio):

* :func:`jpeg_bytes` - a baseline JFIF JPEG: YCbCr without subsampling,
  8x8 DCT-II (``scipy.fft``), the standard quantization tables (ITU-T T.81
  Annex K) scaled to a quality as libjpeg scales them (75 is PIL's
  default), the standard Huffman tables;
* :func:`gif_bytes` - an animated GIF89a: every frame quantized to one
  fixed 6 x 7 x 6 colour cube (nearest level per channel, so a pixel lands
  within half a level step), LZW-coded, a per-frame delay in hundredths of
  a second, and a NETSCAPE2.0 block with its loop count (0 = forever).
"""

from __future__ import annotations

import struct

import numpy as np

# ---------------------------------------------------------------------------
# JPEG
# ---------------------------------------------------------------------------

_LUMA_Q = np.array([  # ITU-T T.81 Table K.1, natural order
    16, 11, 10, 16, 24, 40, 51, 61,
    12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56,
    14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77,
    24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101,
    72, 92, 95, 98, 112, 100, 103, 99])
_CHROMA_Q = np.array([  # Table K.2
    17, 18, 24, 47, 99, 99, 99, 99,
    18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99,
    47, 66, 99, 99, 99, 99, 99, 99] + [99] * 32)

# natural (row-major) index of the k-th coefficient in zigzag order
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34,
    27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37,
    44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])


# (counts of code lengths 1..16, symbols) of the standard Huffman tables,
# Tables K.3-K.6
_DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
_DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12)))
_AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], [
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
    0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08, 0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52,
    0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A, 0x25,
    0x26, 0x27, 0x28, 0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5A, 0x63, 0x64,
    0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
    0x9A, 0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
    0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2, 0xD3,
    0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8,
    0xE9, 0xEA, 0xF1, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA])
_AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], [
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
    0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33,
    0x52, 0xF0, 0x15, 0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1, 0x17, 0x18,
    0x19, 0x1A, 0x26, 0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5A, 0x63,
    0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7A,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
    0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4,
    0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9, 0xCA,
    0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7,
    0xE8, 0xE9, 0xEA, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA])


def quant_table(base: np.ndarray, quality: int) -> np.ndarray:
    """libjpeg's ``jpeg_quality_scaling`` of a base table, baseline-clamped
    to 1..255 (natural order)."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255).astype(np.int64)


def _huffman_codes(table) -> dict:
    """symbol -> (code, length) of a canonical Huffman table."""
    counts, symbols = table
    codes, code, k = {}, 0, 0
    for length, n in enumerate(counts, start=1):
        for _ in range(n):
            codes[symbols[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return codes


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def write(self, value: int, length: int) -> None:
        self.acc = (self.acc << length) | (value & ((1 << length) - 1))
        self.n += length
        while self.n >= 8:
            self.n -= 8
            self.out.append((self.acc >> self.n) & 0xFF)
        self.acc &= (1 << self.n) - 1

    def flush(self) -> bytes:
        if self.n:  # pad with 1-bits
            self.write((1 << (8 - self.n)) - 1, 8 - self.n)
        return bytes(self.out).replace(b"\xff", b"\xff\x00")


def _segment(marker: int, payload: bytes) -> bytes:
    return struct.pack(">HH", marker, len(payload) + 2) + payload


def _dct_blocks(plane: np.ndarray, q: np.ndarray) -> np.ndarray:
    """(H8, W8) level-shifted samples -> quantized coefficients of each 8x8
    block in raster order, zigzag order: (n_blocks, 64) int."""
    from scipy.fft import dctn

    h, w = plane.shape
    blocks = plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3).reshape(-1, 8, 8)
    coef = dctn(blocks, type=2, norm="ortho", axes=(1, 2)).reshape(-1, 64)
    return np.round(coef / q).astype(np.int64)[:, ZIGZAG]


def jpeg_bytes(image01: np.ndarray, quality: int = 75) -> bytes:
    """(H, W, 3) values in [0, 1] as a baseline JPEG file's bytes (JFIF
    YCbCr); pixels quantized to 8 bits as ``png_bytes`` quantizes them."""
    img = np.asarray(image01)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"an RGB JPEG takes an (H, W, 3) image, got {img.shape}")
    rgb = (np.clip(img, 0, 1) * 255).astype(np.uint8).astype(np.float64)
    h, w = rgb.shape[:2]
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    planes = [0.299 * r + 0.587 * g + 0.114 * b,
              -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0,
              0.5 * r - 0.418688 * g - 0.081312 * b + 128.0]
    h8, w8 = -(-h // 8) * 8, -(-w // 8) * 8
    tables = [quant_table(_LUMA_Q, quality), quant_table(_CHROMA_Q, quality)]
    coefs = [_dct_blocks(np.pad(p, ((0, h8 - h), (0, w8 - w)), mode="edge") - 128.0,
                         tables[min(i, 1)]) for i, p in enumerate(planes)]
    huff = [(_huffman_codes(_DC_LUMA), _huffman_codes(_AC_LUMA)),
            (_huffman_codes(_DC_CHROMA), _huffman_codes(_AC_CHROMA))]

    bits = _BitWriter()
    prev = [0, 0, 0]
    for blk in range(coefs[0].shape[0]):  # one MCU: a block of each component
        for c, cf in enumerate(coefs):
            dc_codes, ac_codes = huff[min(c, 1)]
            block = cf[blk]
            diff = int(block[0]) - prev[c]
            prev[c] = int(block[0])
            size = abs(diff).bit_length()
            bits.write(*dc_codes[size])
            if size:
                bits.write(diff if diff > 0 else diff + (1 << size) - 1, size)
            nz = np.flatnonzero(block[1:]) + 1
            last = 0
            for k in nz.tolist():
                run = k - last - 1
                while run > 15:
                    bits.write(*ac_codes[0xF0])  # ZRL: 16 zeros
                    run -= 16
                v = int(block[k])
                size = abs(v).bit_length()
                bits.write(*ac_codes[(run << 4) | size])
                bits.write(v if v > 0 else v + (1 << size) - 1, size)
                last = k
            if last < 63:
                bits.write(*ac_codes[0x00])  # EOB

    out = [b"\xff\xd8",
           _segment(0xFFE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for t, table in enumerate(tables):  # in zigzag order
        out.append(_segment(0xFFDB, bytes([t]) + bytes(table[ZIGZAG].tolist())))
    # three components, no subsampling (1x1 each), Y on tables 0, Cb and Cr on 1
    comps = b"".join(bytes([c + 1, 0x11, min(c, 1)]) for c in range(3))
    out.append(_segment(0xFFC0, struct.pack(">BHHB", 8, h, w, 3) + comps))
    for cls_id, (counts, symbols) in ((0x00, _DC_LUMA), (0x10, _AC_LUMA), (0x01, _DC_CHROMA),
                                      (0x11, _AC_CHROMA)):
        out.append(_segment(0xFFC4, bytes([cls_id]) + bytes(counts) + bytes(symbols)))
    scan = b"".join(bytes([c + 1, 0x11 * min(c, 1)]) for c in range(3))
    out.append(_segment(0xFFDA, bytes([3]) + scan + b"\x00\x3f\x00"))
    out.append(bits.flush())
    out.append(b"\xff\xd9")
    return b"".join(out)


# ---------------------------------------------------------------------------
# GIF
# ---------------------------------------------------------------------------

GIF_LEVELS = (6, 7, 6)  # levels of R, G, B in the fixed palette (252 colours)


def gif_palette() -> np.ndarray:
    """(256, 3) uint8: the 6 x 7 x 6 cube (index (r * 7 + g) * 6 + b), then black."""
    axes = [np.round(np.linspace(0, 255, n)).astype(np.uint8) for n in GIF_LEVELS]
    cube = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1).reshape(-1, 3)
    return np.concatenate([cube, np.zeros((256 - len(cube), 3), np.uint8)])


def gif_indices(rgb_u8: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 -> (H, W) palette indices of the nearest level per channel."""
    lv = [np.rint(rgb_u8[..., c].astype(np.float64) * (n - 1) / 255.0).astype(np.int64)
          for c, n in enumerate(GIF_LEVELS)]
    return ((lv[0] * GIF_LEVELS[1] + lv[1]) * GIF_LEVELS[2] + lv[2]).astype(np.uint8)


def lzw_encode(indices: bytes, min_code_size: int = 8) -> bytes:
    """GIF LZW of a byte string of palette indices: variable-width codes (up
    to 12 bits, least significant bit first), a clear code first and
    whenever the table fills, an end code last."""
    clear, end = 1 << min_code_size, (1 << min_code_size) + 1
    out = bytearray()
    acc = n = 0

    def emit(code, width):
        nonlocal acc, n
        acc |= code << n
        n += width
        while n >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            n -= 8

    width = min_code_size + 1
    emit(clear, width)
    table: dict = {}
    next_code = end + 1
    data = memoryview(indices)
    if len(data):
        prefix = data[0]
        for c in data[1:]:
            key = (prefix << 8) | c
            code = table.get(key)
            if code is not None:
                prefix = code
                continue
            emit(prefix, width)
            if next_code < 4096:
                table[key] = next_code
                next_code += 1
                if next_code > (1 << width) and width < 12:
                    width += 1
            else:  # the table is full: start over
                emit(clear, width)
                table.clear()
                next_code, width = end + 1, min_code_size + 1
            prefix = c
        emit(prefix, width)
    emit(end, width)
    if n:
        out.append(acc & 0xFF)
    return bytes(out)


def gif_bytes(frames_u8, delay_cs: int = 50, loop: int = 0) -> bytes:
    """Frames (H, W, 3) uint8 of one size as an animated GIF89a file's bytes."""
    frames = [np.asarray(f) for f in frames_u8]
    h, w = frames[0].shape[:2]
    if any(f.shape != (h, w, 3) or f.dtype != np.uint8 for f in frames):
        raise ValueError("GIF frames must be (H, W, 3) uint8 of one size")
    out = [b"GIF89a", struct.pack("<HHBBB", w, h, 0xF7, 0, 0), gif_palette().tobytes(),
           b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", loop) + b"\x00"]
    for f in frames:
        out.append(b"\x21\xf9\x04\x04" + struct.pack("<H", delay_cs) + b"\x00\x00")
        out.append(b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0) + b"\x08")
        data = lzw_encode(gif_indices(f).tobytes())
        out.extend(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                   for i in range(0, len(data), 255))
        out.append(b"\x00")
    out.append(b"\x3b")
    return b"".join(out)


# ---------------------------------------------------------------------------
# PNG reading
# ---------------------------------------------------------------------------


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the five PNG row filters (None, Sub, Up, Average, Paeth)."""
    rows = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int64)
    for y in range(h):
        kind, line = int(rows[y, 0]), rows[y, 1:].astype(np.int64)
        if kind == 0:
            cur = line
        elif kind == 1:  # Sub: a running sum of each byte of a pixel
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 0xFF
        elif kind == 2:
            cur = (line + prev) & 0xFF
        elif kind in (3, 4):  # Average, Paeth: byte by byte
            ln, up, cur_l = line.tolist(), prev.tolist(), [0] * stride
            for x in range(stride):
                a = cur_l[x - bpp] if x >= bpp else 0
                b = up[x]
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[x - bpp] if x >= bpp else 0
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur_l[x] = (ln[x] + pred) & 0xFF
            cur = np.asarray(cur_l, np.int64)
        else:
            raise ValueError(f"unknown PNG filter {kind}")
        out[y] = cur
        prev = cur
    return out


def read_png(path: str) -> np.ndarray:
    """An 8-bit, non-interlaced gray / gray-alpha / RGB / RGBA PNG as (H, W,
    3) uint8 RGB (gray repeated, alpha dropped)."""
    import zlib

    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path} is not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (n,), kind = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    w, h, depth, colour, _, _, interlace = header
    channels = {0: 1, 2: 3, 4: 2, 6: 4}.get(colour)
    if depth != 8 or channels is None or interlace:
        raise ValueError(f"{path}: only 8-bit non-interlaced gray/RGB(A) PNGs are read")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    img = _unfilter(raw, h, w * channels, channels).reshape(h, w, channels)
    if channels <= 2:
        return np.repeat(img[..., :1], 3, axis=2)
    return np.ascontiguousarray(img[..., :3])
