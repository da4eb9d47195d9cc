"""QR code symbol encode/decode (module-matrix level), versions 1-40 (port of
``boofcv_tpu/recognition/qr/code.py``, whole: the reference's Python and
numpy, copied).

Reference analog: boofcv-recognition alg/fiducial/qrcode/ —
QrCodeEncoder.java (segment construction, numeric/alphanumeric/byte/kanji
modes, auto version+mask selection), QrCodeDecoderBits.java (bit stream +
RS + mode parsing), QrCodeMaskPattern.java, QrCodeCodeWordLocations
(zigzag placement), QrCode.java VERSION_INFO tables (MAX_VERSION=40).

Image-plane localization lives in qr/detector.py; this module works on
the boolean module matrix (True = dark).
"""

from __future__ import annotations

import numpy as np

from boofcv_tpu_torch.recognition.qr.reed_solomon import ReedSolomon
from boofcv_tpu_torch.recognition.qr.tables import (
    ALIGNMENT, ALPHANUMERIC_CHARS, ALPHANUMERIC_VALUE, BLOCKS, MAX_VERSION,
    MODE_ALPHANUMERIC, MODE_BYTE, MODE_ECI, MODE_KANJI, MODE_NUMERIC,
    count_bits, data_capacity_bytes, total_codewords)

LEVEL_BITS = {"L": 0b01, "M": 0b00, "Q": 0b11, "H": 0b10}
BITS_LEVEL = {v: k for k, v in LEVEL_BITS.items()}

MASKS = [
    lambda r, c: (r + c) % 2 == 0,
    lambda r, c: r % 2 == 0,
    lambda r, c: c % 3 == 0,
    lambda r, c: (r + c) % 3 == 0,
    lambda r, c: (r // 2 + c // 3) % 2 == 0,
    lambda r, c: (r * c) % 2 + (r * c) % 3 == 0,
    lambda r, c: ((r * c) % 2 + (r * c) % 3) % 2 == 0,
    lambda r, c: ((r + c) % 2 + (r * c) % 3) % 2 == 0,
]


def _bch_format(data5: int) -> int:
    """15-bit format info: 5 data bits + 10 BCH bits, masked."""
    g = 0b10100110111
    v = data5 << 10
    for i in range(14, 9, -1):
        if v & (1 << i):
            v ^= g << (i - 10)
    return ((data5 << 10) | v) ^ 0b101010000010010


def _bch_version(version: int) -> int:
    """18-bit version info: 6 data bits + 12 BCH bits (v >= 7 only)."""
    g = 0b1111100100101
    v = version << 12
    for i in range(17, 11, -1):
        if v & (1 << i):
            v ^= g << (i - 12)
    return (version << 12) | v


def _function_mask(version: int) -> np.ndarray:
    """True where a module is a function pattern (not data)."""
    n = 4 * version + 17
    m = np.zeros((n, n), bool)
    for (r, c) in ((0, 0), (0, n - 7), (n - 7, 0)):
        m[max(r - 1, 0):r + 8, max(c - 1, 0):c + 8] = True
    m[6, :] = True
    m[:, 6] = True
    # format areas
    m[8, :9] = True
    m[:9, 8] = True
    m[8, n - 8:] = True
    m[n - 8:, 8] = True
    for cy in ALIGNMENT[version]:
        for cx in ALIGNMENT[version]:
            if (cy < 9 and cx < 9) or (cy < 9 and cx > n - 10) or \
               (cy > n - 10 and cx < 9):
                continue
            m[cy - 2:cy + 3, cx - 2:cx + 3] = True
    if version >= 7:
        m[:6, n - 11:n - 8] = True
        m[n - 11:n - 8, :6] = True
    return m


def _draw_function_patterns(mat: np.ndarray, version: int) -> None:
    n = mat.shape[0]

    def finder(r, c):
        for dr in range(-1, 8):
            for dc in range(-1, 8):
                rr, cc = r + dr, c + dc
                if not (0 <= rr < n and 0 <= cc < n):
                    continue
                inside = 0 <= dr <= 6 and 0 <= dc <= 6
                ring = inside and (dr in (0, 6) or dc in (0, 6))
                core = 2 <= dr <= 4 and 2 <= dc <= 4
                mat[rr, cc] = bool(ring or core)

    finder(0, 0)
    finder(0, n - 7)
    finder(n - 7, 0)
    for i in range(8, n - 8):
        mat[6, i] = (i % 2 == 0)
        mat[i, 6] = (i % 2 == 0)
    for cy in ALIGNMENT[version]:
        for cx in ALIGNMENT[version]:
            if (cy < 9 and cx < 9) or (cy < 9 and cx > n - 10) or \
               (cy > n - 10 and cx < 9):
                continue
            for dr in range(-2, 3):
                for dc in range(-2, 3):
                    mat[cy + dr, cx + dc] = max(abs(dr), abs(dc)) != 1
    mat[n - 8, 8] = True  # dark module
    if version >= 7:
        vi = _bch_version(version)
        # 18 bits, LSB first: module (i%3 offset, i//3) in the two blocks
        for i in range(18):
            bit = bool((vi >> i) & 1)
            mat[n - 11 + i % 3, i // 3] = bit      # lower-left block
            mat[i // 3, n - 11 + i % 3] = bit      # upper-right block


def _place_bits(version: int):
    """Module (row, col) visit order for data bits (zigzag placement)."""
    n = 4 * version + 17
    fm = _function_mask(version)
    order = []
    col = n - 1
    upward = True
    while col > 0:
        if col == 6:
            col -= 1
        rows = range(n - 1, -1, -1) if upward else range(n)
        for r in rows:
            for c in (col, col - 1):
                if not fm[r, c]:
                    order.append((r, c))
        upward = not upward
        col -= 2
    return order


# ---------------------------------------------------------------------------
# Segment encoding (QrCodeEncoder analog)
# ---------------------------------------------------------------------------

def _is_numeric(s: str) -> bool:
    return len(s) > 0 and all("0" <= c <= "9" for c in s)


def _is_alphanumeric(s: str) -> bool:
    return len(s) > 0 and all(c in ALPHANUMERIC_VALUE for c in s)


def _try_kanji(s: str):
    """Return Shift-JIS bytes if every char is a double-byte SJIS char in
    the QR kanji ranges, else None."""
    try:
        raw = s.encode("shift_jis")
    except (UnicodeEncodeError, LookupError):
        return None
    if len(raw) != 2 * len(s):
        return None
    for i in range(0, len(raw), 2):
        hi = raw[i]
        if not (0x81 <= hi <= 0x9F or 0xE0 <= hi <= 0xEB):
            return None
    return raw


def select_mode(s: str) -> int:
    """Smallest-output mode able to hold the whole string
    (QrCodeEncoder.autoSelect analog — single segment)."""
    if _is_numeric(s):
        return MODE_NUMERIC
    if _is_alphanumeric(s):
        return MODE_ALPHANUMERIC
    if _try_kanji(s) is not None:
        return MODE_KANJI
    return MODE_BYTE


def _segment_bits(s: str, mode: int, version: int) -> list:
    """Bit list for one segment: mode + count + payload."""
    bits = []

    def put(val, nbits):
        for i in range(nbits - 1, -1, -1):
            bits.append((val >> i) & 1)

    put(mode, 4)
    if mode == MODE_NUMERIC:
        put(len(s), count_bits(mode, version))
        for i in range(0, len(s), 3):
            grp = s[i:i + 3]
            put(int(grp), {1: 4, 2: 7, 3: 10}[len(grp)])
    elif mode == MODE_ALPHANUMERIC:
        put(len(s), count_bits(mode, version))
        for i in range(0, len(s), 2):
            grp = s[i:i + 2]
            if len(grp) == 2:
                put(ALPHANUMERIC_VALUE[grp[0]] * 45
                    + ALPHANUMERIC_VALUE[grp[1]], 11)
            else:
                put(ALPHANUMERIC_VALUE[grp[0]], 6)
    elif mode == MODE_KANJI:
        raw = _try_kanji(s)
        if raw is None:
            raise ValueError("string is not QR-kanji encodable")
        put(len(s), count_bits(mode, version))
        for i in range(0, len(raw), 2):
            word = (raw[i] << 8) | raw[i + 1]
            if 0x8140 <= word <= 0x9FFC:
                word -= 0x8140
            elif 0xE040 <= word <= 0xEBBF:
                word -= 0xC140
            else:
                raise ValueError("byte pair outside QR kanji ranges")
            put((word >> 8) * 0xC0 + (word & 0xFF), 13)
    elif mode == MODE_BYTE:
        data = s.encode("utf8") if isinstance(s, str) else bytes(s)
        put(len(data), count_bits(mode, version))
        for b in data:
            put(b, 8)
    else:
        raise ValueError(f"unsupported mode {mode}")
    return bits


def _payload_bit_len(s, mode: int, version: int) -> int:
    """Exact bit length of a segment without building it."""
    k = len(s)
    if mode == MODE_NUMERIC:
        body = 10 * (k // 3) + {0: 0, 1: 4, 2: 7}[k % 3]
    elif mode == MODE_ALPHANUMERIC:
        body = 11 * (k // 2) + 6 * (k % 2)
    elif mode == MODE_KANJI:
        body = 13 * k
    else:
        data = s.encode("utf8") if isinstance(s, str) else bytes(s)
        body = 8 * len(data)
    return 4 + count_bits(mode, version) + body


def pick_version(s, mode: int, level: str) -> int:
    """Smallest version whose data capacity fits the single segment."""
    for version in range(1, MAX_VERSION + 1):
        if _payload_bit_len(s, mode, version) <= \
                8 * data_capacity_bytes(version, level):
            return version
    raise ValueError("message too long for any QR version")


def _build_codewords(s, version: int, level: str, mode: int) -> list:
    cap = data_capacity_bytes(version, level)
    bits = _segment_bits(s, mode, version)
    if len(bits) > cap * 8:
        raise ValueError(
            f"message needs {len(bits)} bits; v{version}-{level} holds {cap * 8}")
    # terminator + byte alignment + pad codewords
    bits += [0] * min(4, cap * 8 - len(bits))
    while len(bits) % 8:
        bits.append(0)
    cw = [int("".join(map(str, bits[i:i + 8])), 2)
          for i in range(0, len(bits), 8)]
    pads = [0xEC, 0x11]
    i = 0
    while len(cw) < cap:
        cw.append(pads[i % 2])
        i += 1
    return cw


def _interleave(cw: list, version: int, level: str) -> list:
    ecc_n, blocks = BLOCKS[(version, level)]
    rs = ReedSolomon(ecc_n)
    datas = []
    eccs = []
    idx = 0
    for (cnt, dlen) in blocks:
        for _ in range(cnt):
            block = cw[idx:idx + dlen]
            idx += dlen
            datas.append(block)
            eccs.append(rs.encode(block))
    out = []
    for i in range(max(len(b) for b in datas)):
        for b in datas:
            if i < len(b):
                out.append(b[i])
    for i in range(ecc_n):
        for e in eccs:
            out.append(e[i])
    return out


def _deinterleave(stream: list, version: int, level: str):
    ecc_n, blocks = BLOCKS[(version, level)]
    sizes = [d for (cnt, d) in blocks for _ in range(cnt)]
    nblocks = len(sizes)
    datas = [[] for _ in range(nblocks)]
    it = iter(stream)
    for i in range(max(sizes)):
        for b in range(nblocks):
            if i < sizes[b]:
                datas[b].append(next(it))
    eccs = [[] for _ in range(nblocks)]
    for i in range(ecc_n):
        for b in range(nblocks):
            eccs[b].append(next(it))
    return datas, eccs


# ---------------------------------------------------------------------------
# Mask penalty (QrCodeMaskPattern selection rules N1-N4)
# ---------------------------------------------------------------------------

def mask_penalty(mat: np.ndarray) -> int:
    m = np.asarray(mat, bool)
    n = m.shape[0]
    score = 0
    # N1: runs of >= 5 same-color modules, rows and cols
    for arr in (m, m.T):
        for row in arr:
            run = 1
            for i in range(1, n):
                if row[i] == row[i - 1]:
                    run += 1
                else:
                    if run >= 5:
                        score += 3 + (run - 5)
                    run = 1
            if run >= 5:
                score += 3 + (run - 5)
    # N2: 2x2 blocks of same color
    same = (m[:-1, :-1] == m[1:, :-1]) & (m[:-1, :-1] == m[:-1, 1:]) \
        & (m[:-1, :-1] == m[1:, 1:])
    score += 3 * int(np.sum(same))
    # N3: finder-like 1:1:3:1:1 pattern with 4 light on either side —
    # vectorized sliding-window compare (the per-position Python loop
    # made auto-mask encode ~65x slower than fixed-mask)
    pat = np.array([1, 0, 1, 1, 1, 0, 1, 0, 0, 0, 0], bool)
    k = len(pat)
    if n >= k:
        for arr in (m, m.T):
            win = np.lib.stride_tricks.sliding_window_view(arr, k, axis=1)
            for needle in (pat, pat[::-1]):
                score += 40 * int((win == needle).all(-1).sum())
    # N4: dark-module proportion deviation from 50%
    dark = int(np.sum(m))
    pct = 100 * dark / (n * n)
    score += 10 * int(abs(pct - 50) // 5)
    return score


# ---------------------------------------------------------------------------
# Encode / decode
# ---------------------------------------------------------------------------

def encode(text: str | bytes, version: int | None = None, level: str = "M",
           mask: int | None = None, mode: int | None = None) -> np.ndarray:
    """Encode text into a boolean module matrix (True = dark).

    version=None picks the smallest version that fits; mode=None picks
    numeric/alphanumeric/kanji/byte automatically; mask=None selects the
    lowest-penalty mask (ISO rules N1-N4), as QrCodeEncoder does.
    """
    if isinstance(text, (bytes, bytearray)):
        s = bytes(text)
        mode = MODE_BYTE if mode is None else mode
    else:
        s = text
        if mode is None:
            mode = select_mode(s)
    if version is None:
        version = pick_version(s, mode, level)
    n = 4 * version + 17
    cw = _build_codewords(s, version, level, mode)
    stream = _interleave(cw, version, level)
    order = _place_bits(version)
    bits = []
    for c in stream:
        for i in range(7, -1, -1):
            bits.append((c >> i) & 1)
    bits += [0] * (len(order) - len(bits))

    def render(mask_id: int) -> np.ndarray:
        mat = np.zeros((n, n), bool)
        _draw_function_patterns(mat, version)
        mfn = MASKS[mask_id]
        for (r, c), b in zip(order, bits):
            mat[r, c] = bool(b) ^ mfn(r, c)
        fmt = _bch_format((LEVEL_BITS[level] << 3) | mask_id)
        fbits = [(fmt >> i) & 1 for i in range(14, -1, -1)]
        for (r, c), b in zip(_format_coords_a(n), fbits):
            mat[r, c] = bool(b)
        for (r, c), b in zip(_format_coords_b(n), fbits):
            mat[r, c] = bool(b)
        return mat

    if mask is not None:
        return render(mask)
    best_mat, best_pen = None, None
    for mid in range(8):
        cand = render(mid)
        pen = mask_penalty(cand)
        if best_pen is None or pen < best_pen:
            best_mat, best_pen = cand, pen
    return best_mat


def _format_coords_a(n):
    return [(8, 0), (8, 1), (8, 2), (8, 3), (8, 4), (8, 5), (8, 7),
            (8, 8), (7, 8), (5, 8), (4, 8), (3, 8), (2, 8), (1, 8), (0, 8)]


def _format_coords_b(n):
    return [(n - 1, 8), (n - 2, 8), (n - 3, 8), (n - 4, 8), (n - 5, 8),
            (n - 6, 8), (n - 7, 8), (8, n - 8), (8, n - 7), (8, n - 6),
            (8, n - 5), (8, n - 4), (8, n - 3), (8, n - 2), (8, n - 1)]


def _read_format(mat: np.ndarray):
    n = mat.shape[0]

    def try_read(coords):
        v = 0
        for (r, c) in coords:
            v = (v << 1) | int(mat[r, c])
        # brute-force BCH decode: nearest valid codeword
        best, bd = None, 99
        for d5 in range(32):
            cand = _bch_format(d5)
            dist = bin(cand ^ v).count("1")
            if dist < bd:
                bd, best = dist, d5
        return best if bd <= 3 else None

    d5 = try_read(_format_coords_a(n))
    if d5 is None:
        d5 = try_read(_format_coords_b(n))
    if d5 is None:
        return None
    return BITS_LEVEL[(d5 >> 3) & 0b11], d5 & 0b111


def read_version_info(mat: np.ndarray):
    """Read + BCH-correct the 18-bit version info blocks (v >= 7).
    Returns the decoded version or None."""
    n = mat.shape[0]
    for block in ("ll", "ur"):
        v = 0
        for i in range(18):
            if block == "ll":
                bit = int(mat[n - 11 + i % 3, i // 3])
            else:
                bit = int(mat[i // 3, n - 11 + i % 3])
            v |= bit << i
        best, bd = None, 99
        for ver in range(7, MAX_VERSION + 1):
            dist = bin(_bch_version(ver) ^ v).count("1")
            if dist < bd:
                bd, best = dist, ver
        if bd <= 3:
            return best
    return None


def _parse_bitstream(corrected: list, version: int):
    """Parse the corrected data codewords into bytes — all four modes +
    ECI, segments concatenated until the terminator
    (QrCodeDecoderBits.decodeMessage analog)."""
    bits = []
    for c in corrected:
        for i in range(7, -1, -1):
            bits.append((c >> i) & 1)
    pos = 0
    out = bytearray()

    def take(k):
        nonlocal pos
        if pos + k > len(bits):
            raise IndexError("bitstream exhausted")
        v = 0
        for b in bits[pos:pos + k]:
            v = (v << 1) | b
        pos += k
        return v

    try:
        while pos + 4 <= len(bits):
            mode = take(4)
            if mode == 0:          # terminator
                break
            if mode == MODE_ECI:
                # ECI designator: 8/16/24 bits by leading-ones prefix
                first = take(8)
                if first >= 0xC0:
                    take(16)
                elif first >= 0x80:
                    take(8)
                continue
            count = take(count_bits(mode, version))
            if mode == MODE_NUMERIC:
                left = count
                while left >= 3:
                    out += f"{take(10):03d}".encode()
                    left -= 3
                if left == 2:
                    out += f"{take(7):02d}".encode()
                elif left == 1:
                    out += f"{take(4):01d}".encode()
            elif mode == MODE_ALPHANUMERIC:
                left = count
                while left >= 2:
                    v = take(11)
                    out += ALPHANUMERIC_CHARS[v // 45].encode()
                    out += ALPHANUMERIC_CHARS[v % 45].encode()
                    left -= 2
                if left:
                    out += ALPHANUMERIC_CHARS[take(6)].encode()
            elif mode == MODE_BYTE:
                for _ in range(count):
                    out.append(take(8))
            elif mode == MODE_KANJI:
                raw = bytearray()
                for _ in range(count):
                    v = take(13)
                    word = (v // 0xC0) << 8 | (v % 0xC0)
                    word += 0x8140 if word < 0x1F00 else 0xC140
                    raw += bytes([word >> 8, word & 0xFF])
                out += raw.decode("shift_jis").encode("utf8")
            else:
                return None, {"error": f"unsupported mode {mode:04b}"}
    except IndexError:
        return None, {"error": "bitstream truncated"}
    return bytes(out), {}


def decode(mat: np.ndarray):
    """Decode a boolean module matrix.  Returns (bytes, info dict) or
    (None, reason)."""
    mat = np.asarray(mat, bool)
    n = mat.shape[0]
    version = (n - 17) // 4
    if version < 1 or version > MAX_VERSION or 4 * version + 17 != n:
        return None, {"error": "bad size"}
    if version >= 7:
        # the matrix size fixes the placement grid; version info is a
        # cross-check (a mismatch means a corrupt/non-QR matrix)
        vi = read_version_info(mat)
        if vi is not None and vi != version:
            return None, {"error": "version info mismatch"}
    f = _read_format(mat)
    if f is None:
        return None, {"error": "format"}
    level, mask = f
    mfn = MASKS[mask]
    order = _place_bits(version)
    bits = [int(mat[r, c]) ^ int(mfn(r, c)) for (r, c) in order]
    ecc_n, blocks = BLOCKS[(version, level)]
    total = total_codewords(version, level)
    stream = [int("".join(map(str, bits[i:i + 8])), 2)
              for i in range(0, total * 8, 8)]
    datas, eccs = _deinterleave(stream, version, level)
    rs = ReedSolomon(ecc_n)
    corrected = []
    n_err_total = 0
    for d, e in zip(datas, eccs):
        dec, ne = rs.decode(d + e)
        if dec is None:
            return None, {"error": "ecc"}
        corrected += dec[: len(d)]
        n_err_total += ne
    out, info = _parse_bitstream(corrected, version)
    if out is None:
        return None, info
    return out, {"version": version, "level": level, "mask": mask,
                 "errors_corrected": n_err_total}
