"""Image files and resizing in NumPy: the port's replacement for the three
outside readers the JAX package's datasets call, which the GPU machine does
not have (`imageio.v2.imread` for PNG, `cv2.resize`, and its own PFM
reader).

- `read_png(path)` gives what `imageio.v2.imread` (through Pillow) gives,
  bit for bit, with the same dtype and shape: grey [H, W] (uint8; uint16 at
  16 bits; bool at 1 bit; 2- and 4-bit levels scaled to 0..255), grey +
  alpha [H, W, 2], RGB [H, W, 3] and RGBA [H, W, 4] (16-bit colour images
  keep their high bytes, as Pillow reads them, and 16-bit grey + alpha
  becomes RGBA), and palette images expanded
  to RGB (a `tRNS` chunk is ignored, as Pillow's conversion ignores it).
  Interlaced (Adam7) files raise. Average and Paeth make a byte depend on
  its left neighbour, so the row filters are undone by an anti-diagonal
  wavefront: pixel (r, c) depends on (r, c-1), (r-1, c) and (r-1, c-1)
  only, so rows + columns - 1 vectorised steps suffice.
- `encode_png(img, filters)` writes 8-bit PNGs with a chosen filter per
  row: one type, every type in turn, or the adaptive choice of libpng
  (the smallest sum of absolute signed bytes).
- `read_pfm(path)` is the JAX package's reader (lara_tpu/data/gso.py:31-46).
- `resize(img, (W, H), interpolation)` gives what `cv2.resize` (OpenCV 5.0
  on x86) gives for the cases the datasets reach, derived against it:
  INTER_LINEAR and INTER_AREA on uint8 (bit for bit) and float32 (within
  1e-6; bit for bit in practice), 1, 3 or 4 channels. OpenCV's rules:
    * uint8 INTER_LINEAR works in 11-bit fixed point: the horizontal pass
      sums pixel · round((1 - f)·2048) and pixel · round(f·2048) exactly;
      the vertical pass is the vector code's ((S0 >> 4)·b0 >> 16) +
      ((S1 >> 4)·b1 >> 16), rounded by (· + 2) >> 2; the fraction f is
      taken from the position rounded to float32;
    * float32 INTER_LINEAR is fma(b - a, f, a) per pass, f taken in double;
    * horizontal source positions are clamped to the image (their weights
      then 1, 0), vertical ones are not: the rows are clamped, the weights
      kept;
    * uint8 INTER_LINEAR at exactly 2× down in both axes is INTER_AREA;
    * INTER_AREA down by integer factors is a box mean: (sum + 2) >> 2 at
      2× for uint8, else the sum (float32, four cells at a time in source
      order) times 1/area, rounded half to even for uint8; by other factors
      down each source cell is weighed by its overlap in float32, in
      OpenCV's order; up it is the linear filter at OpenCV's area-mode
      positions.
"""

from __future__ import annotations

import re
import struct
import zlib
from typing import Tuple, Union

import numpy as np

INTER_LINEAR = 1          # cv2.INTER_LINEAR
INTER_AREA = 3            # cv2.INTER_AREA

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}


# --------------------------------------------------------------------- PNG


def read_png(path: str) -> np.ndarray:
    """The image in the PNG file at `path`, as `imageio.v2.imread` reads it."""
    with open(path, "rb") as f:
        return decode_png(f.read(), str(path))


def decode_png(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """Decode PNG bytes; `name` is the file named in errors."""
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{name}: not a PNG file")
    pos, header, palette, idat = 8, None, None, []
    while pos + 8 <= len(data):
        length, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"{name}: truncated {tag!r} chunk")
        if struct.unpack(">I", crc)[0] != zlib.crc32(tag + body) & 0xFFFFFFFF:
            raise ValueError(f"{name}: bad CRC in the {tag!r} chunk")
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        elif not tag[0] & 0x20:                      # an unknown critical chunk
            raise ValueError(f"{name}: unsupported critical chunk {tag!r}")
    if header is None or not idat:
        raise ValueError(f"{name}: no IHDR or IDAT chunk")
    w, h, depth, ctype, comp, filt_method, interlace = header
    if interlace:
        raise ValueError(f"{name}: interlaced (Adam7) PNG files are not supported")
    if comp or filt_method or ctype not in _DEPTHS or depth not in _DEPTHS[ctype]:
        raise ValueError(f"{name}: unsupported PNG form (colour type {ctype}, bit depth "
                         f"{depth}, compression {comp}, filter method {filt_method})")
    if ctype == 3 and palette is None:
        raise ValueError(f"{name}: palette image without a PLTE chunk")
    ch = _CHANNELS[ctype]
    stride = (w * ch * depth + 7) // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < h * (stride + 1):
        raise ValueError(f"{name}: image data ends early")
    rows = raw[:h * (stride + 1)].reshape(h, stride + 1)
    if rows[:, 0].max(initial=0) > 4:
        raise ValueError(f"{name}: unknown row filter type {int(rows[:, 0].max())}")
    out = unfilter(rows[:, 1:], rows[:, 0], max(1, ch * depth // 8))
    return _to_image(out, w, h, depth, ctype, palette)


def unfilter(filt: np.ndarray, types: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the PNG row filters: filtered bytes [H, stride] and their filter
    types [H] → raw bytes [H, stride]; `bpp` bytes per pixel (at least 1).
    All five filters are undone along anti-diagonals. The rows are skewed so
    that the pixels (i, c) with i + c = d form one column d, held
    contiguous: `done[d + 2, i + 1]` is pixel (i, c) (row and column 0 are
    the zeros above and left of the image), so its left neighbour is
    `done[d + 1, i + 1]`, the pixel above `done[d + 1, i]` and the one above
    left `done[d, i]`."""
    n, stride = filt.shape
    w = stride // bpp
    f = filt.reshape(n, w, bpp)
    skew = np.zeros((n + w - 1, n, bpp), np.int16)
    done = np.zeros((n + w + 1, n + 1, bpp), np.int16)
    for i in range(n):
        skew[i:i + w, i] = f[i]
    is_t = [(types == t)[:, None] for t in range(5)]
    for d in range(n + w - 1):
        lo, hi = max(0, d - w + 1), min(n - 1, d) + 1
        a = done[d + 1, lo + 1:hi + 1]
        b = done[d + 1, lo:hi]
        c = done[d, lo:hi]
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.where(is_t[3][lo:hi], (a + b) >> 1, pred)
        pred = np.where(is_t[2][lo:hi], b, pred)
        pred = np.where(is_t[1][lo:hi], a, pred)
        pred = np.where(is_t[0][lo:hi], 0, pred)
        done[d + 2, lo + 1:hi + 1] = (skew[d, lo:hi] + pred) & 0xFF
    out = np.empty((n, w, bpp), np.uint8)
    for i in range(n):
        out[i] = done[i + 2:i + 2 + w, i + 1]
    return out.reshape(n, stride)


def _to_image(raw: np.ndarray, w: int, h: int, depth: int, ctype: int,
              palette) -> np.ndarray:
    ch = _CHANNELS[ctype]
    if depth < 8:
        bits = np.unpackbits(raw, axis=1).reshape(h, -1, depth)
        vals = (bits << np.arange(depth - 1, -1, -1, dtype=np.uint8)).sum(-1, dtype=np.uint8)
        vals = vals[:, :w]
        if ctype == 3:
            return _palette(palette)[vals]
        if depth == 1:
            return vals.astype(bool)
        return vals * np.uint8(255 // (2 ** depth - 1))
    if depth == 16:
        pairs = raw.reshape(h, w, ch, 2)
        if ctype == 0:
            return pairs.reshape(h, w, 2).view(">u2")[..., 0].astype(np.uint16)
        img = pairs[..., 0].copy()                   # Pillow keeps the high bytes
        if ctype == 4:                               # and reads grey + alpha as RGBA
            img = img[..., [0, 0, 0, 1]]
    else:
        img = raw.reshape(h, w, ch).copy()
    if ctype == 3:
        return _palette(palette)[img[..., 0]]
    return img[..., 0] if ch == 1 else img


def _palette(palette: np.ndarray) -> np.ndarray:
    full = np.zeros((256, 3), np.uint8)
    full[:len(palette)] = palette[:256]
    return full


def _filtered(raw: np.ndarray, ch: int, t: int) -> np.ndarray:
    """Rows of bytes [H, W·C] filtered with type t (mod 256; `ch` bytes per
    pixel)."""
    if t == 0:
        return raw
    r = raw.astype(np.int16)
    up = np.vstack([np.zeros((1, r.shape[1]), np.int16), r[:-1]])
    left = np.hstack([np.zeros((r.shape[0], ch), np.int16), r[:, :-ch]])
    if t == 1:
        pred = left
    elif t == 2:
        pred = up
    elif t == 3:
        pred = (left + up) >> 1
    else:
        upleft = np.hstack([np.zeros((r.shape[0], ch), np.int16), up[:, :-ch]])
        pa, pb, pc = np.abs(up - upleft), np.abs(left - upleft), np.abs(left + up - 2 * upleft)
        pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    return (r - pred).astype(np.uint8)


def encode_png(img: np.ndarray, filters: Union[int, str] = "adaptive") -> bytes:
    """An 8-bit grey / grey + alpha / RGB / RGBA image [H, W(, C)] (uint8) as
    PNG bytes. `filters`: a filter type 0-4 for every row, "cycle" for every
    type in turn, or "adaptive" for the type with the smallest sum of
    absolute signed filtered bytes (libpng's heuristic)."""
    a = np.asarray(img)
    if a.dtype != np.uint8:
        raise ValueError(f"encode_png writes uint8 images, not {a.dtype}")
    a = a[..., None] if a.ndim == 2 else a
    h, w, ch = a.shape
    raw = a.reshape(h, w * ch)
    if isinstance(filters, str):
        cand = np.stack([_filtered(raw, ch, t) for t in range(5)])   # [5, H, W·C]
        if filters == "adaptive":
            types = np.argmin(np.abs(cand.view(np.int8).astype(np.int32)).sum(-1), axis=0)
        elif filters == "cycle":
            types = np.arange(h) % 5
        else:
            raise ValueError(f"unknown PNG filter choice {filters!r}")
        rows = cand[types, np.arange(h)]
    else:
        types, rows = np.full(h, filters), _filtered(raw, ch, filters)
    body = np.concatenate([types[:, None].astype(np.uint8), rows], axis=1)

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    return (_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(body.tobytes(), 6)) + chunk(b"IEND", b""))


# --------------------------------------------------------------------- PFM


def read_pfm(filename: str):
    """Portable float map → (array [H, W] or [H, W, 3], scale), rows from the
    top (dataLoader/utils.py:120-155)."""
    with open(filename, "rb") as f:
        header = f.readline().decode("utf-8").rstrip()
        if header not in ("PF", "Pf"):
            raise ValueError("Not a PFM file.")
        color = header == "PF"
        dims = re.match(r"^(\d+)\s(\d+)\s$", f.readline().decode("utf-8"))
        if not dims:
            raise ValueError("Malformed PFM header.")
        width, height = map(int, dims.groups())
        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        data = np.fromfile(f, endian + "f")
    shape = (height, width, 3) if color else (height, width)
    return np.flipud(data.reshape(shape)), abs(scale)


def write_pfm(filename: str, data: np.ndarray) -> None:
    """A little-endian PFM of a float32 [H, W] or [H, W, 3] array (rows
    from the top), which `read_pfm` reads back."""
    data = np.asarray(data, np.float32)
    color = data.ndim == 3
    with open(filename, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{data.shape[1]} {data.shape[0]}\n".encode())
        f.write(b"-1.0\n")
        f.write(np.ascontiguousarray(np.flipud(data)).astype("<f4").tobytes())


# ------------------------------------------------------------------ resize


def resize(img: np.ndarray, dsize: Tuple[int, int],
           interpolation: int = INTER_LINEAR) -> np.ndarray:
    """`cv2.resize(img, dsize, interpolation=...)` for uint8 and float32
    images [H, W] or [H, W, C]; dsize is (width, height)."""
    a = np.asarray(img)
    if a.dtype not in (np.uint8, np.float32):
        raise ValueError(f"resize supports uint8 and float32 images, not {a.dtype}")
    if interpolation not in (INTER_LINEAR, INTER_AREA):
        raise ValueError(f"resize supports INTER_LINEAR and INTER_AREA, not {interpolation}")
    W, H = int(dsize[0]), int(dsize[1])
    h, w = a.shape[:2]
    if (W, H) == (w, h):
        return a.copy()
    squeeze = a.ndim == 2 or a.shape[2] == 1
    x = a.reshape(h, w, -1)
    if x.shape[2] not in (1, 3, 4):
        raise ValueError(f"resize supports 1, 3 and 4 channels, not {x.shape[2]}")
    scale_x, scale_y = 1.0 / (W / w), 1.0 / (H / h)
    ix, iy = int(np.rint(scale_x)), int(np.rint(scale_y))
    area_fast = (abs(scale_x - ix) < np.finfo(np.float64).eps
                 and abs(scale_y - iy) < np.finfo(np.float64).eps)
    if interpolation == INTER_LINEAR and area_fast and ix == 2 and iy == 2 and a.dtype == np.uint8:
        interpolation = INTER_AREA
    if interpolation == INTER_AREA and scale_x >= 1 and scale_y >= 1:
        out = _area_fast(x, ix, iy) if area_fast else _area(x, W, H, scale_x, scale_y)
    else:
        out = _linear(x, W, H, scale_x, scale_y, interpolation == INTER_AREA)
    return out[..., 0] if squeeze else out


def _positions(n_src: int, n_dst: int, scale: float, area_mode: bool, clamp: bool,
               single: bool):
    """OpenCV's source index and fraction per destination index; `single`:
    the position (d + 0.5)·scale - 0.5 is rounded to float32 before its
    integer part is taken (OpenCV's uint8 path; its float path keeps it in
    double)."""
    d = np.arange(n_dst, dtype=np.float64)
    if area_mode:
        s = np.floor(d * scale).astype(np.int64)
        f = ((d + 1) - (s + 1) * (1.0 / scale)).astype(np.float32)
        f = np.where(f <= 0, np.float32(0), f - np.floor(f)).astype(np.float32)
    else:
        f = (d + 0.5) * scale - 0.5
        if single:                        # uint8: the position is rounded first
            f = f.astype(np.float32)
        s = np.floor(f).astype(np.int64)
        f = (f - s.astype(f.dtype)).astype(np.float32)
    if clamp:
        low, high = s < 0, s >= n_src - 1
        f = np.where(low | high, np.float32(0), f).astype(np.float32)
        s = np.where(low, 0, np.where(high, n_src - 1, s))
    return s, f


def _linear(x, W, H, scale_x, scale_y, area_mode):
    h, w, c = x.shape
    single = x.dtype == np.uint8
    sx, fx = _positions(w, W, scale_x, area_mode, clamp=True, single=single)
    sy, fy = _positions(h, H, scale_y, area_mode, clamp=False, single=single)
    x0, x1 = sx, np.minimum(sx + 1, w - 1)
    y0, y1 = np.clip(sy, 0, h - 1), np.clip(sy + 1, 0, h - 1)
    if x.dtype == np.uint8:
        def fixed(f):
            return (np.rint((np.float32(1) - f) * np.float32(2048)).astype(np.int64),
                    np.rint(f * np.float32(2048)).astype(np.int64))
        a0, a1 = fixed(fx)
        b0, b1 = fixed(fy)
        src = x.astype(np.int64)
        rows = src[:, x0] * a0[None, :, None] + src[:, x1] * a1[None, :, None]
        top = ((rows[y0] >> 4) * b0[:, None, None]) >> 16
        bottom = ((rows[y1] >> 4) * b1[:, None, None]) >> 16
        return np.clip((top + bottom + 2) >> 2, 0, 255).astype(np.uint8)
    if area_mode:
        one = np.float32(1)
        rows = x[:, x0] * (one - fx)[None, :, None] + x[:, x1] * fx[None, :, None]
        return rows[y0] * (one - fy)[:, None, None] + rows[y1] * fy[:, None, None]
    rows = _lerp(x[:, x0], x[:, x1], fx[None, :, None])
    return _lerp(rows[y0], rows[y1], fy[:, None, None])


def _lerp(a: np.ndarray, b: np.ndarray, f: np.ndarray) -> np.ndarray:
    """fma(b - a, f, a) in float32 (OpenCV's float INTER_LINEAR): the
    product is exact in float64, so one rounding remains."""
    d = (b - a).astype(np.float64)
    return (d * f.astype(np.float64) + a.astype(np.float64)).astype(np.float32)


def _area_fast(x, kx, ky):
    h, w, c = x.shape
    H, W = h // ky, w // kx
    blocks = x[:H * ky, :W * kx].reshape(H, ky, W, kx, c)
    if x.dtype == np.uint8:
        total = blocks.astype(np.int64).sum((1, 3))
        if kx == 2 and ky == 2:
            return ((total + 2) >> 2).astype(np.uint8)
        return np.clip(np.rint(total.astype(np.float32) * np.float32(1.0 / (kx * ky))),
                       0, 255).astype(np.uint8)
    cells = [blocks[:, i, :, j] for i in range(ky) for j in range(kx)]   # source order
    if kx == 2 and ky == 2 and c in (1, 4):          # the vector path: rows, then both
        return ((cells[0] + cells[1]) + (cells[2] + cells[3])) * np.float32(0.25)
    total = np.zeros((H, W, c), np.float32)
    for k in range(0, len(cells) - 3, 4):            # unrolled by 4, as OpenCV sums
        total = total + (((cells[k] + cells[k + 1]) + cells[k + 2]) + cells[k + 3])
    for cell in cells[len(cells) // 4 * 4:]:
        total = total + cell
    return total * np.float32(1.0 / (kx * ky))


def _area_tab(n_src: int, n_dst: int, scale: float):
    """OpenCV's computeResizeAreaTab: (destination, source, weight) triples
    in its order."""
    tab = []
    for d in range(n_dst):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, n_src - f1)
        s1, s2 = int(np.ceil(f1)), int(np.floor(f2))
        s2 = min(s2, n_src - 1)
        s1 = min(s1, s2)
        if s1 - f1 > 1e-3:
            tab.append((d, s1 - 1, np.float32((s1 - f1) / cell)))
        for s in range(s1, s2):
            tab.append((d, s, np.float32(1.0 / cell)))
        if f2 - s2 > 1e-3:
            tab.append((d, s2, np.float32(min(min(f2 - s2, 1.0), cell) / cell)))
    return tab


def _area(x, W, H, scale_x, scale_y):
    """INTER_AREA down by a factor that is not an integer: float32 sums of
    overlap-weighted cells, horizontal then vertical, in OpenCV's order."""
    h, w, c = x.shape
    xf = x.astype(np.float32)
    xtab = _area_tab(w, W, scale_x)
    # the terms of each destination column in order, padded with weight 0
    per = [[] for _ in range(W)]
    for d, s, a in xtab:
        per[d].append((s, a))
    k = max(len(p) for p in per)
    src = np.zeros((W, k), np.int64)
    wt = np.zeros((W, k), np.float32)
    for d, p in enumerate(per):
        for j, (s, a) in enumerate(p):
            src[d, j], wt[d, j] = s, a
    rows = np.zeros((h, W, c), np.float32)
    for j in range(k):
        rows = rows + xf[:, src[:, j]] * wt[None, :, j, None]
    out = np.zeros((H, W, c), np.float32)
    started = np.zeros(H, bool)
    for d, s, b in _area_tab(h, H, scale_y):
        term = b * rows[s]
        out[d] = out[d] + term if started[d] else term
        started[d] = True
    if x.dtype == np.uint8:
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)
    return out
