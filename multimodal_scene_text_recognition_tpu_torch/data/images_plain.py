"""The numpy mirror of ``data/images`` (``native/imgdecode.cpp``): the same
decoding, resizing and cropping step for step in Python and numpy, for the
tests to hold the C++ to.  Slow (the JPEG entropy decoding runs a Python
loop a bit); the loaders call the C++.

It mirrors the baseline JPEG, the non-interlaced PNG of 1 to 8 bits, the
uncompressed 8- and 24-bit BMP and the P5/P6 of maxval 255.  It raises
NotImplementedError for what the C++ decodes beyond those (progressive and
CMYK/YCCK JPEG, interlaced or 16-bit PNG, the other BMPs and PNMs), whose
tests hold the C++ straight to PIL, and for what neither decodes."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from . import identify
from .images import FILTERS, _check_size, crop_box, read_png

NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
    47, 55, 62, 63] + [63] * 16)


def l24(r, g, b) -> np.ndarray:
    """PIL's RGB -> L."""
    r, g, b = (np.asarray(v, np.int64) for v in (r, g, b))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(np.uint8)


# ---------------------------------------------------------------- JPEG

class _Huffman:
    def __init__(self, counts: bytes, symbols: bytes):
        self.vals = list(symbols)
        self.maxcode = [-1] * 18
        self.valoffset = [0] * 18
        code, p = 0, 0
        for length in range(1, 17):
            n = counts[length - 1]
            if n:
                self.valoffset[length] = p - code
                code += n
                p += n
                self.maxcode[length] = code - 1
            if code >= (1 << length):
                raise OSError("bogus Huffman table definition")
            code <<= 1


class _Bits:
    """The entropy-coded data of a scan, a bit at a time: stuffed zeros
    dropped, zeros fed from a marker on, the end of the data an error."""

    def __init__(self, data: bytes, pos: int):
        self.d, self.pos, self.acc, self.nbits = data, pos, 0, 0
        self.marker, self.marker_pos = False, 0

    def _byte(self) -> int:
        if self.marker:
            return 0
        d, p = self.d, self.pos
        if p >= len(d):
            raise OSError("image file is truncated")
        b = d[p]
        if b != 0xFF:
            self.pos = p + 1
            return b
        q = p + 1
        while q < len(d) and d[q] == 0xFF:
            q += 1
        if q >= len(d):
            raise OSError("image file is truncated")
        if d[q] == 0:
            self.pos = q + 1
            return 0xFF
        self.marker, self.marker_pos = True, p
        return 0

    def get(self, n: int) -> int:
        while self.nbits < n:
            self.acc = (self.acc << 8) | self._byte()
            self.nbits += 8
        self.nbits -= n
        v = (self.acc >> self.nbits) & ((1 << n) - 1)
        self.acc &= (1 << self.nbits) - 1
        return v

    def decode(self, h: _Huffman) -> int:
        code = 0
        for length in range(1, 17):
            code = (code << 1) | self.get(1)
            if code <= h.maxcode[length]:
                return h.vals[code + h.valoffset[length]]
        return 0  # a bad code: symbol 0, as libjpeg takes it

    def restart(self, expected: int) -> None:
        d = self.d
        self.acc = self.nbits = 0
        p = self.marker_pos if self.marker else self.pos
        while p < len(d) and d[p] != 0xFF:
            p += 1
        while p < len(d) and d[p] == 0xFF:
            p += 1
        if p >= len(d):
            raise OSError("image file is truncated")
        if d[p] != 0xD0 + expected:
            raise OSError("corrupt JPEG data: bad restart marker")
        self.pos, self.marker = p + 1, False

    def end(self) -> int:
        d = self.d
        p = self.marker_pos if self.marker else self.pos
        while p + 1 < len(d) and not (d[p] == 0xFF and d[p + 1] not in (0x00, 0xFF)):
            p += 1
        if p + 1 >= len(d):
            raise OSError("image file is truncated")
        return p


def _extend(r: int, s: int) -> int:
    return r - (1 << s) + 1 if r < (1 << (s - 1)) else r


def _descale(x: np.ndarray, n: int) -> np.ndarray:
    return (x + (1 << (n - 1))) >> n


def _limit(x: np.ndarray) -> np.ndarray:
    return np.clip(x + 128, 0, 255).astype(np.uint8)


def _wrap16(x: np.ndarray) -> np.ndarray:
    return x.astype(np.int16).astype(np.int64)


def _idct_1d(v: List[np.ndarray]):
    """One pass of libjpeg-turbo's SIMD ISLOW IDCT on eight int64 inputs:
    jidctint.c's constants paired as pmaddwd takes them, its four 16-bit
    sums wrapped."""
    z2, z3 = v[2], v[6]
    tmp3 = z2 * (4433 + 6270) + z3 * 4433
    tmp2 = z2 * 4433 + z3 * (4433 - 15137)
    tmp0 = _wrap16(v[0] + v[4]) * 8192
    tmp1 = _wrap16(v[0] - v[4]) * 8192
    t10, t13, t11, t12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    tmp0, tmp1, tmp2, tmp3 = v[7], v[5], v[3], v[1]
    z3, z4 = _wrap16(tmp0 + tmp2), _wrap16(tmp1 + tmp3)
    z3, z4 = z3 * (9633 - 16069) + z4 * 9633, z3 * 9633 + z4 * (9633 - 3196)
    o0 = tmp0 * (2446 - 7373) - tmp3 * 7373 + z3
    o1 = tmp1 * (16819 - 20995) - tmp2 * 20995 + z4
    o2 = tmp2 * (25172 - 20995) - tmp1 * 20995 + z3
    o3 = tmp3 * (12299 - 7373) - tmp0 * 7373 + z4
    return [t10 + o3, t11 + o2, t12 + o1, t13 + o0, t13 - o0, t12 - o1, t11 - o2, t10 - o3]


def idct_islow(coef: np.ndarray, q: np.ndarray) -> np.ndarray:
    """libjpeg-turbo's SIMD ISLOW IDCT, which PIL's x86-64 build runs, of
    blocks ``coef`` int [N, 8, 8] (natural order) dequantized by ``q``
    [8, 8] to 16 bits: uint8 [N, 8, 8].  A block whose rows 1 to 7 are zero
    takes the DC shortcut (each DC shifted in 16 bits); the columns' results
    saturate to 16 bits, the rows' to 8.  Equal to jidctint.c wherever no
    16-bit value overflows."""
    x = _wrap16(coef.astype(np.int64) * q.astype(np.int64))
    cols = _idct_1d([x[:, r, :] for r in range(8)])  # pass 1 down each column
    ws = np.clip(np.stack([_descale(c, 11) for c in cols], axis=1), -32768, 32767)
    dc_only = ~coef[:, 1:, :].any(axis=(1, 2))
    ws[dc_only] = _wrap16(x[dc_only, :1, :] * 4)
    rows = _idct_1d([ws[:, :, c] for c in range(8)])  # pass 2 along each row
    return np.stack([_limit(_descale(r, 18)) for r in rows], axis=2)


def _upsample(plane: np.ndarray, dw: int, dh: int, sx: int, sy: int, W: int, H: int):
    """jdsample.c's upsampling of one component, as ``upsample`` in the C++."""
    p = plane[:dh, :dw].astype(np.int64)
    ys = np.arange(H)
    if sx == 1 and sy == 1:
        out = p
    elif sx == 2 and sy == 1 and dw > 2:
        v3 = p * 3
        out = np.empty((dh, 2 * dw), np.int64)
        out[:, 0] = p[:, 0]
        out[:, 1::2][:, :-1] = (v3[:, :-1] + p[:, 1:] + 2) >> 2
        out[:, 2::2] = (v3[:, 1:] + p[:, :-1] + 1) >> 2
        out[:, -1] = p[:, -1]
    elif sx == 1 and sy == 2:
        i, v = ys >> 1, ys & 1
        near = p[np.clip(i, 0, dh - 1)]
        far = p[np.clip(np.where(v == 1, i + 1, i - 1), 0, dh - 1)]
        out = (near * 3 + far + np.where(v == 1, 2, 1)[:, None]) >> 2
        return out[:H, :W].astype(np.uint8)
    elif sx == 2 and sy == 2 and dw > 2:
        i, v = ys >> 1, ys & 1
        near = p[np.clip(i, 0, dh - 1)]
        far = p[np.clip(np.where(v == 1, i + 1, i - 1), 0, dh - 1)]
        cs = near * 3 + far
        out = np.empty((H, 2 * dw), np.int64)
        out[:, 0] = (cs[:, 0] * 4 + 8) >> 4
        out[:, 1::2][:, :-1] = (cs[:, :-1] * 3 + cs[:, 1:] + 7) >> 4
        out[:, 2::2] = (cs[:, 1:] * 3 + cs[:, :-1] + 8) >> 4
        out[:, -1] = (cs[:, -1] * 4 + 7) >> 4
        return out[:H, :W].astype(np.uint8)
    else:
        out = np.repeat(p, sx, axis=1)
        return out[np.minimum(ys // sy, dh - 1)][:, :W].astype(np.uint8)
    return out[:H, :W].astype(np.uint8)


def _u16(d: bytes, p: int) -> int:
    return (d[p] << 8) | d[p + 1]


def decode_jpeg_plain(d: bytes) -> np.ndarray:
    qt, dc, ac, comps = {}, {}, {}, []
    hmax = vmax = mcux = mcuy = restart = 0
    jfif = adobe = frame = scanned = False
    transform = -1
    W = H = 0
    pos, n = 2, len(d)
    while True:
        while pos < n and d[pos] != 0xFF:
            pos += 1
        while pos < n and d[pos] == 0xFF:
            pos += 1
        if pos >= n:
            if scanned:
                break
            raise OSError("image file is truncated")
        m = d[pos]
        pos += 1
        if m == 0xD9:
            break
        if m == 0xD8 or 0xD0 <= m <= 0xD7 or m == 0x01:
            continue
        if pos + 2 > n:
            raise OSError("image file is truncated")
        length = _u16(d, pos)
        if length < 2:
            raise OSError("corrupt JPEG marker length")
        if pos + length > n:
            raise OSError("image file is truncated")
        s = d[pos + 2:pos + length]
        if 0xC0 <= m <= 0xCF and m not in (0xC4, 0xCC):
            # PIL's own checks, then libjpeg's refusals, as in the C++
            if m == 0xC8 or len(s) < 6 or s[0] != 8 or s[5] not in (1, 3, 4):
                raise OSError("cannot identify image file")
            if m in (0xC5, 0xC6, 0xC7, 0xCD, 0xCE, 0xCF):
                raise OSError("broken data stream (hierarchical JPEG)")
            if m == 0xC3:
                raise NotImplementedError("image decoding: lossless JPEG")
            if m in (0xC9, 0xCA, 0xCB):
                raise NotImplementedError("image decoding: arithmetic-coded JPEG")
            if m == 0xC2:
                raise NotImplementedError("image decoding: progressive JPEG (not mirrored)")
            if frame:
                raise OSError("duplicate JPEG frame header")
            H, W, nc = _u16(s, 1), _u16(s, 3), s[5]
            if W == 0 or H == 0:
                raise OSError("JPEG of empty size")
            if nc == 4:
                raise NotImplementedError("image decoding: CMYK/YCCK JPEG (not mirrored)")
            if len(s) < 6 + 3 * nc:
                raise OSError("corrupt JPEG frame header")
            for i in range(nc):
                c = {"id": s[6 + 3 * i], "h": s[7 + 3 * i] >> 4, "v": s[7 + 3 * i] & 15,
                     "tq": s[8 + 3 * i]}
                if not (1 <= c["h"] <= 4 and 1 <= c["v"] <= 4 and c["tq"] <= 3):
                    raise OSError("bogus JPEG sampling factors or table")
                comps.append(c)
            hmax = max(c["h"] for c in comps)
            vmax = max(c["v"] for c in comps)
            mcux, mcuy = -(-W // (8 * hmax)), -(-H // (8 * vmax))
            for c in comps:
                if hmax % c["h"] or vmax % c["v"]:
                    raise OSError("broken data stream (fractional sampling ratios)")
                c["bw"], c["bh"] = mcux * c["h"], mcuy * c["v"]
                c["dw"], c["dh"] = -(-W * c["h"] // hmax), -(-H * c["v"] // vmax)
                c["coef"] = np.zeros((c["bh"], c["bw"], 64), np.int64)
            frame = True
        elif m == 0xC4:
            p = 0
            while p < len(s):
                if p + 17 > len(s):
                    raise OSError("corrupt JPEG Huffman table")
                tc, th = s[p] >> 4, s[p] & 15
                total = sum(s[p + 1:p + 17])
                if tc > 1 or th > 3 or total > 256 or p + 17 + total > len(s):
                    raise OSError("corrupt JPEG Huffman table")
                (ac if tc else dc)[th] = _Huffman(s[p + 1:p + 17], s[p + 17:p + 17 + total])
                p += 17 + total
        elif m == 0xDB:
            p = 0
            while p < len(s):
                pq, tq = s[p] >> 4, s[p] & 15
                if tq > 3 or pq > 1 or p + 1 + 64 * (pq + 1) > len(s):
                    raise OSError("corrupt JPEG quantization table")
                vals = ([_u16(s, p + 1 + 2 * i) for i in range(64)] if pq
                        else list(s[p + 1:p + 65]))
                table = np.zeros(64, np.int64)
                table[NATURAL[:64]] = vals
                qt[tq] = table.reshape(8, 8)
                p += 1 + 64 * (pq + 1)
        elif m == 0xDD:
            if len(s) < 2:
                raise OSError("corrupt JPEG restart interval")
            restart = _u16(s, 0)
        elif m == 0xE0:
            jfif = jfif or s[:5] == b"JFIF\0"
        elif m == 0xEE:
            if len(s) >= 12 and s[:5] == b"Adobe":
                adobe, transform = True, s[11]
        elif m == 0xDA:
            if not frame:
                raise OSError("JPEG scan before its frame header")
            ns = s[0]
            if not 1 <= ns <= 4 or len(s) < 1 + 2 * ns + 3:
                raise OSError("corrupt JPEG scan header")
            sc, td, ta = [], [], []
            for i in range(ns):
                hit = [c for c in comps if c["id"] == s[1 + 2 * i]]
                if not hit:
                    raise OSError("JPEG scan names an unknown component")
                td.append(s[2 + 2 * i] >> 4)
                ta.append(s[2 + 2 * i] & 15)
                if td[-1] not in dc or ta[-1] not in ac:
                    raise OSError("JPEG scan uses an undefined Huffman table")
                if hit[-1]["tq"] not in qt:
                    raise OSError("JPEG component uses an undefined table")
                sc.append(hit[-1])
            if (s[1 + 2 * ns], s[2 + 2 * ns], s[3 + 2 * ns]) != (0, 63, 0):
                raise OSError("corrupt JPEG scan parameters")
            bits = _Bits(d, pos + length)
            pred = [0] * ns

            def block(k, bx, by):
                b = sc[k]["coef"][by, bx]
                t = bits.decode(dc[td[k]])
                pred[k] += _extend(bits.get(t), t) if t else 0
                b[0] = np.int16(pred[k] if -32768 <= pred[k] < 32768
                                else (pred[k] + 32768) % 65536 - 32768)
                h = ac[ta[k]]
                z = 1
                while z < 64:
                    rs = bits.decode(h)
                    r, size = rs >> 4, rs & 15
                    if size:
                        z += r
                        b[NATURAL[z]] = _extend(bits.get(size), size)
                    elif r != 15:
                        break
                    else:
                        z += 15
                    z += 1

            if ns == 1:
                ux = -(-sc[0]["dw"] // 8)
                units = ux * -(-sc[0]["dh"] // 8)
            else:
                ux, units = mcux, mcux * mcuy
            rst = 0
            for u in range(units):
                if restart and u > 0 and u % restart == 0:
                    bits.restart(rst)
                    rst = (rst + 1) & 7
                    pred = [0] * ns
                mx, my = u % ux, u // ux
                if ns == 1:
                    block(0, mx, my)
                else:
                    for k in range(ns):
                        for yy in range(sc[k]["v"]):
                            for xx in range(sc[k]["h"]):
                                block(k, mx * sc[k]["h"] + xx, my * sc[k]["v"] + yy)
            pos = bits.end()
            scanned = True
            continue
        pos += length
    if not frame or not scanned:
        raise OSError("JPEG without image data")

    planes = []
    for c in comps:
        bh, bw = c["bh"], c["bw"]
        blocks = idct_islow(c["coef"].reshape(-1, 8, 8), qt[c["tq"]])
        plane = blocks.reshape(bh, bw, 8, 8).transpose(0, 2, 1, 3).reshape(bh * 8, bw * 8)
        planes.append(_upsample(plane, c["dw"], c["dh"], hmax // c["h"], vmax // c["v"], W, H))
    if len(comps) == 1:
        return planes[0]
    if jfif:
        ycc = True
    elif adobe:
        ycc = transform != 0
    else:
        ycc = [c["id"] for c in comps] != [82, 71, 66]
    if not ycc:
        return l24(*planes)
    y, cb, cr = (p.astype(np.int64) for p in planes)
    x_cb, x_cr = cb - 128, cr - 128
    r = np.clip(y + ((91881 * x_cr + 32768) >> 16), 0, 255)
    g = np.clip(y + ((-22554 * x_cb + 32768 - 46802 * x_cr) >> 16), 0, 255)
    b = np.clip(y + ((116130 * x_cb + 32768) >> 16), 0, 255)
    return l24(r, g, b)


# ---------------------------------------------------------------- PNG, BMP, PNM

def png_to_gray_plain(raw: bytes, w: int, h: int, color_type: int, depth: int,
                      palette: bytes) -> np.ndarray:
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color_type]
    row_bytes = (w * channels * depth + 7) // 8
    bpp = (channels * depth + 7) // 8
    if len(raw) < (row_bytes + 1) * h:
        raise OSError("image file is truncated")
    rows = np.zeros((h, row_bytes), np.uint8)
    prev = [0] * row_bytes
    for y in range(h):
        src = raw[(row_bytes + 1) * y:(row_bytes + 1) * (y + 1)]
        ft, line = src[0], list(src[1:])
        if ft > 4:
            raise OSError(f"PNG row of unknown filter type {ft}")
        for i in range(row_bytes):
            a = line[i - bpp] if i >= bpp else 0
            b = prev[i]
            c = prev[i - bpp] if i >= bpp else 0
            if ft == 1:
                line[i] = (line[i] + a) & 255
            elif ft == 2:
                line[i] = (line[i] + b) & 255
            elif ft == 3:
                line[i] = (line[i] + ((a + b) >> 1)) & 255
            elif ft == 4:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                line[i] = (line[i] + (a if pa <= pb and pa <= pc else b if pb <= pc else c)) & 255
        rows[y] = line
        prev = line
    pal = np.frombuffer(palette, np.uint8)[:768].reshape(-1, 3)
    lut = np.zeros(256, np.uint8)
    lut[:len(pal)] = l24(pal[:, 0], pal[:, 1], pal[:, 2])
    if depth < 8:
        v = np.unpackbits(rows, axis=1).reshape(h, -1, depth)
        v = (v * (1 << np.arange(depth - 1, -1, -1))).sum(-1)[:, :w]
        return lut[v] if color_type == 3 else (v * {1: 255, 2: 85, 4: 17}[depth]).astype(np.uint8)
    px = rows[:, :w * channels].reshape(h, w, channels)
    if color_type in (0, 4):
        return px[..., 0].copy()
    if color_type == 3:
        return lut[px[..., 0]]
    return l24(px[..., 0], px[..., 1], px[..., 2])


def _le(d: bytes, p: int, k: int, signed: bool = False) -> int:
    return int.from_bytes(d[p:p + k], "little", signed=signed)


def decode_bmp_plain(d: bytes) -> np.ndarray:
    if len(d) < 26:
        raise OSError("image file is truncated")
    offset, hsize = _le(d, 10, 4), _le(d, 14, 4)
    compression, colors = 0, 0
    if hsize == 12:
        width, height, bpp, entry = _le(d, 18, 2), _le(d, 20, 2, True), _le(d, 24, 2), 3
    elif 40 <= hsize <= 124:
        if len(d) < 54:
            raise OSError("image file is truncated")
        width, height, bpp = _le(d, 18, 4, True), _le(d, 22, 4, True), _le(d, 28, 2)
        compression, colors, entry = _le(d, 30, 4), _le(d, 46, 4), 4
    else:
        raise NotImplementedError(f"image decoding: BMP with a {hsize}-byte header")
    if compression:
        raise NotImplementedError("image decoding: compressed BMP")
    if bpp not in (8, 24):
        raise NotImplementedError(f"image decoding: BMP of {bpp} bits a pixel")
    top_down = height < 0
    height = abs(height)
    if not (0 < width <= 65535 and 0 < height <= 65535):
        raise OSError("BMP of a bad size")
    lut = np.zeros(256, np.uint8)
    if bpp == 8:
        colors = colors if 0 < colors <= 256 else 256
        pal = 14 + hsize
        if pal + colors * entry > len(d):
            raise OSError("image file is truncated")
        e = np.frombuffer(d[pal:pal + colors * entry], np.uint8).reshape(colors, entry)
        lut[:colors] = l24(e[:, 2], e[:, 1], e[:, 0])
    stride = ((width * bpp + 31) // 32) * 4
    if offset + stride * (height - 1) + (width * bpp + 7) // 8 > len(d):
        raise OSError("image file is truncated")
    buf = np.frombuffer(d[offset:] + b"\0" * stride, np.uint8)[:stride * height]
    rows = buf.reshape(height, stride)
    if not top_down:
        rows = rows[::-1]
    if bpp == 8:
        return lut[rows[:, :width]]
    px = rows[:, :width * 3].reshape(height, width, 3)
    return l24(px[..., 2], px[..., 1], px[..., 0])


def decode_pnm_plain(d: bytes) -> np.ndarray:
    kind = chr(d[1])
    if kind not in "56":
        raise NotImplementedError(
            f"image decoding: PNM of type P{kind} (only binary P5/P6 are decoded)")
    p, vals = 2, []
    for _ in range(3):
        while True:
            if p >= len(d):
                raise OSError("image file is truncated")
            if d[p] == ord("#"):
                while p < len(d) and d[p] not in b"\r\n":
                    p += 1
            elif d[p] in b" \t\n\r\v\f":
                p += 1
            else:
                break
        q = p
        while q < len(d) and 48 <= d[q] <= 57:
            q += 1
        if q == p or q - p > 7:
            raise OSError("corrupt PNM header")
        vals.append(int(d[p:q]))
        p = q
    p += 1
    w, h, maxval = vals
    if w <= 0 or h <= 0:
        raise OSError("PNM of a bad size")
    if maxval != 255:
        raise NotImplementedError(f"image decoding: PNM of maxval {maxval} (only 255 is decoded)")
    ch = 3 if kind == "6" else 1
    if p + w * h * ch > len(d):
        raise OSError("image file is truncated")
    px = np.frombuffer(d[p:p + w * h * ch], np.uint8).reshape(h, w, ch)
    return px[..., 0].copy() if ch == 1 else l24(px[..., 0], px[..., 1], px[..., 2])


def decode_gray_plain(data: bytes) -> np.ndarray:
    """The mirror of ``images.decode_gray``."""
    data = bytes(data)
    kind = identify.identify(data, _check_size).name
    if kind in ("WEBP", "GIF", "TIFF"):
        raise NotImplementedError(f"image decoding: {kind} files are not decoded")
    if kind == "JPEG":
        return decode_jpeg_plain(data)
    if kind == "PNG":
        png = read_png(data)
        if png.interlace or png.depth == 16:
            raise NotImplementedError("image decoding: interlaced or 16-bit PNG (not mirrored)")
        return png_to_gray_plain(png.raw, png.width, png.height, png.color_type, png.depth,
                                 png.palette)
    if kind == "BMP":
        return decode_bmp_plain(data)
    return decode_pnm_plain(data)  # identify names every other kind


# ---------------------------------------------------------------- resize, crop

def _bilinear(x: float) -> float:
    x = abs(x)
    return 1.0 - x if x < 1.0 else 0.0


def _bicubic(x: float) -> float:
    a = -0.5
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


def resample_coeffs(in_size: int, out_size: int, filter: str):
    """PIL's precompute_coeffs + normalize_coeffs_8bpc: ([out, 2] bounds
    (first, count), [out, ksize] int coefficients in 22 fraction bits)."""
    f, support = (_bicubic, 2.0) if filter == "bicubic" else (_bilinear, 1.0)
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = support * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    bounds = np.zeros((out_size, 2), np.int64)
    kk = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        ss = 1.0 / filterscale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = [f((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for w in k:
            ww += w
        if ww != 0.0:
            k = [w / ww for w in k]
        kk[xx, :xmax] = [int(-0.5 + w * (1 << 22)) if w < 0 else int(0.5 + w * (1 << 22))
                         for w in k]
        bounds[xx] = xmin, xmax
    return bounds, kk


def _pass(src: np.ndarray, bounds: np.ndarray, kk: np.ndarray) -> np.ndarray:
    """One 8-bit pass along the last axis of ``src`` (int64)."""
    idx = np.minimum(bounds[:, :1] + np.arange(kk.shape[1]), src.shape[-1] - 1)
    ss = (src[..., idx] * kk).sum(-1) + (1 << 21)
    return np.clip(ss >> 22, 0, 255)


def resize_gray_plain(img: np.ndarray, out_w: int, out_h: int,
                      filter: str = "bilinear") -> np.ndarray:
    """The mirror of ``images.resize_gray``."""
    img = np.asarray(img, np.uint8)
    if filter not in FILTERS:
        raise ValueError(f"filter {filter!r}: one of {sorted(FILTERS)}")
    if out_w < 1 or out_h < 1 or img.size == 0:
        raise ValueError("height and width must be > 0")
    h, w = img.shape
    if (h, w) == (out_h, out_w):
        return img.copy()
    x = img.astype(np.int64)
    if out_w != w:
        bh, kh = resample_coeffs(w, out_w, filter)
        x = _pass(x, bh, kh)
    if out_h != h:
        bv, kv = resample_coeffs(h, out_h, filter)
        x = _pass(x.T, bv, kv).T
    return x.astype(np.uint8)


def crop_gray_plain(img: np.ndarray, box: Sequence[float]) -> np.ndarray:
    """The mirror of ``images.crop_gray``."""
    img = np.asarray(img, np.uint8)
    x0, y0, x1, y1 = crop_box(box)
    out = np.zeros((max(y1 - y0, 0), max(x1 - x0, 0)), np.uint8)
    h, w = img.shape
    ya, yb, xa, xb = max(y0, 0), min(y1, h), max(x0, 0), min(x1, w)
    if out.size and yb > ya and xb > xa:
        out[ya - y0:yb - y0, xa - x0:xb - x0] = img[ya:yb, xa:xb]
    return out
