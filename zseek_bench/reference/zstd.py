"""A plain zstd frame decoder (RFC 8878), written from the format's text.

It is the yardstick that the benchmark holds the port's archives to, so it
shares nothing with the port: plain Python with NumPy for the bit windows,
no dictionaries.  Raw, RLE and compressed blocks; raw, RLE, Huffman and
treeless literals with one or four streams; predefined, RLE, FSE and
repeated sequence tables; the three repeat offsets; the optional XXH64
content checksum.  A malformed frame raises `ZstdError`.
"""

from __future__ import annotations

import numpy as np

from zseek_bench.reference.xxhash import xxh64

MAGIC = 0xFD2FB528
BLOCK_MAX = 1 << 17


class ZstdError(ValueError):
    pass


# literal-length and match-length codes: (baseline, extra bits)
LL_BASE = list(range(16)) + [16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128,
                             256, 512, 1024, 2048, 4096, 8192, 16384, 32768,
                             65536]
LL_BITS = [0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13,
                      14, 15, 16]
ML_BASE = list(range(3, 35)) + [35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99,
                                131, 259, 515, 1027, 2051, 4099, 8195, 16387,
                                32771, 65539]
ML_BITS = [0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12,
                      13, 14, 15, 16]
# predefined distributions (RFC 8878 3.1.1.3.2.2)
LL_DEFAULT = ([4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2,
               2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1], 6)
ML_DEFAULT = ([1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
               1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
               1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1], 6)
OF_DEFAULT = ([1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
               1, 1, 1, -1, -1, -1, -1, -1], 5)


# --- bit readers ------------------------------------------------------------

def _windows(buf: bytes) -> np.ndarray:
    """win[i] = the 64 bits that start at byte i, little-endian (zeros past
    the end)."""
    a = np.frombuffer(bytes(buf) + bytes(8), np.uint8).astype(np.uint64)
    n = len(buf)
    w = np.zeros(n + 1, np.uint64)
    for k in range(8):
        w |= a[k: k + n + 1] << np.uint64(8 * k)
    return w


class BackBits:
    """A backward bitstream (zstd's Huffman and FSE streams): the last
    byte's highest set bit marks the end; reads take the highest bits left.
    Reading past the start yields zeros and is allowed only where the
    format allows it, which the caller checks by `left` at the end."""

    def __init__(self, buf: bytes):
        if not buf or buf[-1] == 0:
            raise ZstdError("backward bitstream without an end mark")
        self.win = _windows(buf).tolist()
        self.left = (len(buf) - 1) * 8 + buf[-1].bit_length() - 1

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        self.left -= n
        s = self.left
        if s >= 0:
            return (self.win[s >> 3] >> (s & 7)) & ((1 << n) - 1)
        return (self.win[0] << -s) & ((1 << n) - 1)


class FwdBits:
    """A forward little-endian bitstream (the FSE table description)."""

    def __init__(self, buf: bytes):
        self.v = int.from_bytes(buf, "little")
        self.pos = 0

    def peek(self, n: int) -> int:
        return (self.v >> self.pos) & ((1 << n) - 1)


# --- FSE ----------------------------------------------------------------------

def read_fse_table(buf: bytes, pos: int, max_log: int, max_sym: int):
    """An FSE table description at buf[pos:]: (probabilities, log, bytes
    read)."""
    b = FwdBits(buf[pos: pos + 512])
    log = b.peek(4) + 5
    b.pos = 4
    if log > max_log:
        raise ZstdError(f"FSE accuracy log {log} over {max_log}")
    remaining = (1 << log) + 1
    threshold = 1 << log
    nbits = log + 1
    probs: list[int] = []
    prev0 = False
    while remaining > 1:
        if prev0:
            while True:
                r = b.peek(2)
                b.pos += 2
                probs.extend([0] * r)
                if r != 3:
                    break
            if len(probs) > max_sym:
                raise ZstdError("FSE table: too many symbols")
        mx = (2 * threshold - 1) - remaining
        v = b.peek(nbits)
        if (v & (threshold - 1)) < mx:
            count = v & (threshold - 1)
            b.pos += nbits - 1
        else:
            count = v & (2 * threshold - 1)
            if count >= threshold:
                count -= mx
            b.pos += nbits
        count -= 1
        remaining -= abs(count)
        probs.append(count)
        prev0 = count == 0
        if len(probs) > max_sym + 1:
            raise ZstdError("FSE table: too many symbols")
        while remaining < threshold and remaining > 1:
            nbits -= 1
            threshold >>= 1
    if remaining != 1:
        raise ZstdError("FSE table: probabilities do not sum")
    return probs, log, (b.pos + 7) >> 3


def build_fse(probs: list[int], log: int):
    """Decoding table of a distribution: per state (symbol, bits, base)."""
    size = 1 << log
    sym = [0] * size
    high = size - 1
    nxt = [0] * len(probs)
    for s, p in enumerate(probs):
        if p == -1:
            sym[high] = s
            high -= 1
            nxt[s] = 1
        else:
            nxt[s] = p
    step = (size >> 1) + (size >> 3) + 3
    mask = size - 1
    pos = 0
    for s, p in enumerate(probs):
        for _ in range(max(p, 0)):
            sym[pos] = s
            pos = (pos + step) & mask
            while pos > high:
                pos = (pos + step) & mask
    if pos != 0:
        raise ZstdError("FSE table: spread did not close")
    nbits = [0] * size
    base = [0] * size
    for u in range(size):
        s = sym[u]
        x = nxt[s]
        nxt[s] += 1
        nb = log - (x.bit_length() - 1)
        nbits[u] = nb
        base[u] = (x << nb) - size
    return sym, nbits, base, log


def rle_fse(symbol: int):
    return [symbol], [0], [0], 0


# --- Huffman ------------------------------------------------------------------

def read_huffman(buf: bytes, pos: int):
    """A Huffman tree description at buf[pos:]: (per-prefix symbol list,
    per-prefix bit counts, max bits), bytes read."""
    hb = buf[pos]
    if hb < 128:
        probs, log, n = read_fse_table(buf, pos + 1, 6, 255)
        sym, nbits, base, log = build_fse(probs, log)
        bits = BackBits(buf[pos + 1 + n: pos + 1 + hb])
        s1 = bits.read(log)
        s2 = bits.read(log)
        weights = []
        # two interleaved states; a read past the start ends the list
        while True:
            weights.append(sym[s1])
            s1 = base[s1] + bits.read(nbits[s1])
            if bits.left < 0:
                weights.append(sym[s2])
                break
            weights.append(sym[s2])
            s2 = base[s2] + bits.read(nbits[s2])
            if bits.left < 0:
                weights.append(sym[s1])
                break
        used = 1 + hb
    else:
        nw = hb - 127
        raw = buf[pos + 1: pos + 1 + (nw + 1) // 2]
        weights = []
        for byte in raw:
            weights += [byte >> 4, byte & 15]
        weights = weights[:nw]
        used = 1 + (nw + 1) // 2
    if len(weights) > 255:
        raise ZstdError("Huffman: too many weights")
    total = sum(1 << (w - 1) for w in weights if w)
    if total == 0:
        raise ZstdError("Huffman: no weights")
    maxbits = total.bit_length()
    rest = (1 << maxbits) - total
    if rest & (rest - 1):
        raise ZstdError("Huffman: weights do not complete a tree")
    weights.append(rest.bit_length())
    if maxbits > 11:
        raise ZstdError("Huffman: code longer than 11 bits")
    # canonical table: lower weights (longer codes) take the lower prefixes
    tsym = np.zeros(1 << maxbits, np.int64)
    tnb = np.zeros(1 << maxbits, np.int64)
    start = 0
    for w in range(1, maxbits + 1):
        span = 1 << (w - 1)
        for s, ws in enumerate(weights):
            if ws == w:
                tsym[start: start + span] = s
                tnb[start: start + span] = maxbits + 1 - w
                start += span
    if start != 1 << maxbits:
        raise ZstdError("Huffman: table not filled")
    return (tsym, tnb, maxbits), used


def huffman_stream(buf: bytes, table, n: int) -> bytes:
    """n symbols of one backward Huffman stream, which they must use up."""
    tsym, tnb, mb = table
    if not buf or buf[-1] == 0:
        raise ZstdError("Huffman stream without an end mark")
    left = (len(buf) - 1) * 8 + buf[-1].bit_length() - 1
    # the prefix peeked at every count of bits left, in one NumPy pass
    p = np.arange(left + 1, dtype=np.int64)
    s = p - mb
    w = _windows(buf)
    sc = np.maximum(s, 0)
    v = (w[sc >> 3] >> (sc & 7).astype(np.uint64)).astype(np.int64)
    neg = s < 0
    v[neg] = (w[0].astype(np.int64) << (-s[neg])) if neg.any() else v[neg]
    v &= (1 << mb) - 1
    sym = tsym[v].tolist()
    nxt = (p - tnb[v]).tolist()
    out = bytearray(n)
    q = left
    for k in range(n):
        if q < 0:
            raise ZstdError("Huffman stream overrun")
        out[k] = sym[q]
        q = nxt[q]
    if q != 0:
        raise ZstdError("Huffman stream not used up")
    return bytes(out)


# --- blocks -------------------------------------------------------------------

class FrameState:
    def __init__(self):
        self.huf = None
        self.tables = [None, None, None]   # LL, OF, ML
        self.reps = [1, 4, 8]


def literals(buf: bytes, pos: int, st: FrameState):
    b0 = buf[pos]
    ltype, sf = b0 & 3, (b0 >> 2) & 3
    if ltype in (0, 1):
        if sf in (0, 2):
            size, hdr = b0 >> 3, 1
        elif sf == 1:
            size, hdr = (b0 >> 4) | (buf[pos + 1] << 4), 2
        else:
            size = (b0 >> 4) | (buf[pos + 1] << 4) | (buf[pos + 2] << 12)
            hdr = 3
        pos += hdr
        if size > BLOCK_MAX:
            raise ZstdError("literals over the block maximum")
        if ltype == 0:
            lit = bytes(buf[pos: pos + size])
            if len(lit) != size:
                raise ZstdError("raw literals cut short")
            return lit, pos + size
        return bytes([buf[pos]]) * size, pos + 1
    hdr, bits, streams = {0: (3, 10, 1), 1: (3, 10, 4), 2: (4, 14, 4),
                          3: (5, 18, 4)}[sf]
    h = int.from_bytes(buf[pos: pos + hdr], "little")
    regen = (h >> 4) & ((1 << bits) - 1)
    csize = (h >> (4 + bits)) & ((1 << bits) - 1)
    pos += hdr
    end = pos + csize
    if regen > BLOCK_MAX or end > len(buf):
        raise ZstdError("compressed literals out of bounds")
    if ltype == 2:
        st.huf, used = read_huffman(buf, pos)
        pos += used
    elif st.huf is None:
        raise ZstdError("treeless literals without an earlier tree")
    if streams == 1:
        return huffman_stream(buf[pos: end], st.huf, regen), end
    j = [int.from_bytes(buf[pos + 2 * i: pos + 2 * i + 2], "little")
         for i in range(3)]
    seg = (regen + 3) // 4
    counts = [seg, seg, seg, regen - 3 * seg]
    if counts[3] < 0:
        raise ZstdError("four literal streams of a bad size")
    q = pos + 6
    bounds = [q, q + j[0], q + j[0] + j[1], q + j[0] + j[1] + j[2], end]
    if bounds[3] > end:
        raise ZstdError("literal stream sizes out of bounds")
    return b"".join(huffman_stream(buf[bounds[i]: bounds[i + 1]], st.huf,
                                   counts[i]) for i in range(4)), end


_DEFAULTS = None


def _defaults():
    global _DEFAULTS
    if _DEFAULTS is None:
        _DEFAULTS = [build_fse(*LL_DEFAULT), build_fse(*OF_DEFAULT),
                     build_fse(*ML_DEFAULT)]
    return _DEFAULTS


def sequences(buf: bytes, pos: int, end: int, st: FrameState):
    """The sequences of a block: (literal lengths, offsets, match lengths)
    with the offsets resolved."""
    b0 = buf[pos]
    if b0 == 0:
        if pos + 1 != end:
            raise ZstdError("bytes after an empty sequence section")
        return [], [], []
    if b0 < 128:
        n, pos = b0, pos + 1
    elif b0 < 255:
        n, pos = ((b0 - 128) << 8) + buf[pos + 1], pos + 2
    else:
        n, pos = buf[pos + 1] + (buf[pos + 2] << 8) + 0x7F00, pos + 3
    modes = buf[pos]
    pos += 1
    if modes & 3:
        raise ZstdError("reserved bits in the sequence modes")
    limits = ((35, 9), (31, 8), (52, 9))      # max symbol, max log
    for k, shift in ((0, 6), (1, 4), (2, 2)):
        mode = (modes >> shift) & 3
        if mode == 0:
            st.tables[k] = _defaults()[k]
        elif mode == 1:
            st.tables[k] = rle_fse(buf[pos])
            pos += 1
        elif mode == 2:
            probs, log, used = read_fse_table(buf, pos, limits[k][1],
                                              limits[k][0])
            st.tables[k] = build_fse(probs, log)
            pos += used
        elif st.tables[k] is None:
            raise ZstdError("repeated sequence table without an earlier one")
    (lsym, lnb, lbase, llog), (osym, onb, obase, olog), \
        (msym, mnb, mbase, mlog) = st.tables
    bits = BackBits(buf[pos: end])
    rd = bits.read
    ls, os_, ms = rd(llog), rd(olog), rd(mlog)
    lls, offs, mls = [0] * n, [0] * n, [0] * n
    r1, r2, r3 = st.reps
    for i in range(n):
        oc, mc, lc = osym[os_], msym[ms], lsym[ls]
        if oc > 31 or mc > 52 or lc > 35:
            raise ZstdError("sequence code out of range")
        ov = (1 << oc) + rd(oc)
        ml = ML_BASE[mc] + rd(ML_BITS[mc])
        ll = LL_BASE[lc] + rd(LL_BITS[lc])
        if ov > 3:
            off = ov - 3
            r1, r2, r3 = off, r1, r2
        else:
            idx = ov - 1 + (ll == 0)
            if idx == 0:
                off = r1
            elif idx == 1:
                off = r2
                r1, r2 = off, r1
            elif idx == 2:
                off = r3
                r1, r2, r3 = off, r1, r2
            else:
                off = r1 - 1
                r1, r2, r3 = off, r1, r2
        if off <= 0:
            raise ZstdError("offset of zero")
        lls[i], offs[i], mls[i] = ll, off, ml
        if i + 1 < n:
            ls = lbase[ls] + rd(lnb[ls])
            ms = mbase[ms] + rd(mnb[ms])
            os_ = obase[os_] + rd(onb[os_])
    if bits.left != 0:
        raise ZstdError("sequence bitstream not used up")
    st.reps = [r1, r2, r3]
    return lls, offs, mls


def execute(out: bytearray, lit: bytes, lls, offs, mls, start: int) -> None:
    """Append the block's output: literals and matches in turn.  A match
    reaches back no further than the frame's start (`start`)."""
    lp = 0
    for ll, off, ml in zip(lls, offs, mls):
        if lp + ll > len(lit):
            raise ZstdError("literal length past the literals")
        out += lit[lp: lp + ll]
        lp += ll
        if off > len(out) - start:
            raise ZstdError("offset before the frame's start")
        src = len(out) - off
        if ml <= off:
            out += out[src: src + ml]
        else:
            pat = out[src:]
            out += (pat * (ml // off + 1))[:ml]
    out += lit[lp:]


def decode_frame(buf, pos: int = 0) -> tuple[bytes, int]:
    """The zstd frame at buf[pos:]: (its content, the offset past it)."""
    buf = memoryview(buf).cast("B")
    if len(buf) - pos < 6 or int.from_bytes(buf[pos: pos + 4],
                                            "little") != MAGIC:
        raise ZstdError("no zstd magic")
    fhd = buf[pos + 4]
    fcs_flag, single, checksum, did = fhd >> 6, (fhd >> 5) & 1, \
        (fhd >> 2) & 1, fhd & 3
    if fhd & 0x18:
        raise ZstdError("reserved frame header bits set")
    if did:
        raise ZstdError("dictionaries are not used here")
    q = pos + 5 + (not single)
    fcs_len = {0: int(single), 1: 2, 2: 4, 3: 8}[fcs_flag]
    size = None
    if fcs_len:
        size = int.from_bytes(buf[q: q + fcs_len], "little") + \
            (256 if fcs_len == 2 else 0)
        q += fcs_len
    st = FrameState()
    out = bytearray()
    while True:
        if q + 3 > len(buf):
            raise ZstdError("frame cut short")
        word = buf[q] | (buf[q + 1] << 8) | (buf[q + 2] << 16)
        last, btype, bsize = word & 1, (word >> 1) & 3, word >> 3
        q += 3
        if btype == 0:
            if q + bsize > len(buf):
                raise ZstdError("raw block cut short")
            out += buf[q: q + bsize]
            q += bsize
        elif btype == 1:
            out += bytes([buf[q]]) * bsize
            q += 1
        elif btype == 2:
            if bsize > BLOCK_MAX or q + bsize > len(buf):
                raise ZstdError("compressed block out of bounds")
            block = bytes(buf[q: q + bsize])
            lit, p = literals(block, 0, st)
            lls, offs, mls = sequences(block, p, bsize, st)
            before = len(out)
            execute(out, lit, lls, offs, mls, 0)
            if len(out) - before > BLOCK_MAX:
                raise ZstdError("block over the block maximum")
            q += bsize
        else:
            raise ZstdError("reserved block type")
        if last:
            break
    if checksum:
        want = int.from_bytes(buf[q: q + 4], "little")
        if xxh64(bytes(out)) & 0xFFFFFFFF != want:
            raise ZstdError("content checksum differs")
        q += 4
    if size is not None and size != len(out):
        raise ZstdError("content size differs from the header")
    return bytes(out), q
