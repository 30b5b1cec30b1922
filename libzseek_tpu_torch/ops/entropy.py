"""K2: fused entropy emission (Huffman literal streams + FSE sequences).

Counterpart of libzseek_tpu/ops/pallas_entropy.py entropy_emit_smem
(:578), which runs the Pallas kernel _entropy_kernel (:144, the
pallas_call at :645), with its MODE_* bits (:39-51) and constant tables
(_build_tabs, _ctab_layout, _ctab_predef, CTAB_WIDTH, MODE_LOG_SHIFT,
:61-141), rebuilt here in numpy from the port's copies of
libzseek_tpu/ops/fse.py and format/zstd_frame.py.  The CUDA kernel is
csrc/entropy.cu, its literal placement csrc/huf_place.cuh (shared with K3).

The plain version below computes the same words from prefix sums
instead of a sequential bit pusher: a literal's bit offset is the code
length of the literals after it in its stream, a sequence push's offset
is the running sum of the pushes before it, and every code lands in a
disjoint bit range.  It runs only for tensors on the CPU.

The CUDA kernel runs in phases: the run table and each literal chunk's
code-length sum (a block a row), then a block a chunk places its
literals after a scan of their lengths, while a block a row walks the
three FSE state chains on three lanes and places the sequences' pushes
after a scan of their widths, each thread building whole words.
testing/entropy_mirror.py mirrors those phases in numpy (chunk slots,
thread ranges, scans, which words a chunk stores and which it leaves to
the fix-up, which words each sequence thread builds) for the tests.

Word buffers are int32 (the reference's uint32 words, same bits).  The
planner uses 4-stream rows only from 256 literals; rows below 9 literals
in 4-stream mode are outside this contract.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from libzseek_tpu_torch.format import zstd_frame as zf
from libzseek_tpu_torch.ops import fse
from libzseek_tpu_torch.ops import common as C

# mode bits (meta[:, 3])
MODE_HUF = 1      # 4-stream Huffman literal payload
MODE_RAWLIT = 2   # literal bytes verbatim
MODE_SEQ = 4      # FSE sequence stream
MODE_HUF1 = 8     # with MODE_HUF: single-stream layout
MODE_LL_RLE = 16  # sequence-table modes, decided by ops/fse_plan.py
MODE_OF_RLE = 32
MODE_ML_RLE = 64
MODE_LL_FSE = 128
MODE_OF_FSE = 256
MODE_ML_FSE = 512
# per-stream accuracy-log fields in the mode word (0 = predefined log)
MODE_LOG_SHIFT = {"ll": 12, "of": 16, "ml": 20}

LIT_ANCHOR_INTERVAL = 512
SEQ_ANCHOR_INTERVAL = 128

launches = 0
_count = threading.Lock()   # the zstd stream's worker pipelines launch at once


def _build_tabs():
    ets = [fse.build_encode_table(nm, lg) for nm, lg in (
        (zf.LL_DEFAULT_NORM, zf.LL_DEFAULT_LOG),
        (zf.OF_DEFAULT_NORM, zf.OF_DEFAULT_LOG),
        (zf.ML_DEFAULT_NORM, zf.ML_DEFAULT_LOG))]
    parts = []
    for key, et in zip(("ll", "of", "ml"), ets):
        parts += [(key + "_st", et.state_table),
                  (key + "_dnb", et.delta_nb_bits),
                  (key + "_dfs", et.delta_find_state)]
    parts += [
        ("ll_code", np.searchsorted(zf._LL_BASE, np.arange(64),
                                    side="right") - 1),
        ("ml_code", np.searchsorted(zf._ML_BASE, np.arange(3, 131),
                                    side="right") - 1),
        ("ll_bits", zf.LL_BITS), ("ll_base", zf.LL_BASELINE),
        ("ml_bits", zf.ML_BITS), ("ml_base", zf.ML_BASELINE)]
    offs, chunks, pos = {}, [], 0
    for name, arr in parts:
        offs[name] = pos
        a = np.asarray(arr, np.int32)
        chunks.append(a)
        pos += len(a)
    return np.concatenate(chunks).astype(np.int32), offs


TABS, TAB_OFF = _build_tabs()

# per-block sequence-table pack: segments sized for the format's largest
# accuracy logs, so a row carries the predefined tables or custom ones
CT_MAXLOG = {"ll": 9, "of": 8, "ml": 9}
_STREAMS = (("ll", zf.LL_DEFAULT_NORM, zf.LL_DEFAULT_LOG),
            ("of", zf.OF_DEFAULT_NORM, zf.OF_DEFAULT_LOG),
            ("ml", zf.ML_DEFAULT_NORM, zf.ML_DEFAULT_LOG))


def _ctab_layout():
    offs, pos = {}, 0
    for key, nm, _ in _STREAMS:
        offs[key + "_st"] = pos
        pos += 1 << CT_MAXLOG[key]
        offs[key + "_dnb"] = pos
        pos += len(nm)
        offs[key + "_dfs"] = pos
        pos += len(nm)
    return offs, pos


CTAB_OFF, CTAB_WIDTH = _ctab_layout()


def _ctab_predef() -> np.ndarray:
    out = np.zeros(CTAB_WIDTH, np.int32)
    for key, nm, lg in _STREAMS:
        et = fse.build_encode_table(np.asarray(nm), lg)
        for part, arr in (("_st", et.state_table),
                          ("_dnb", et.delta_nb_bits),
                          ("_dfs", et.delta_find_state)):
            o = CTAB_OFF[key + part]
            out[o: o + len(arr)] = arr
    return out


CTAB_PREDEF = _ctab_predef()

# the C entry point's offset block: constant-table offsets, per-row
# table offsets, row width
_KERNEL_OFFSETS = np.array(
    [TAB_OFF[k] for k in ("ll_code", "ml_code", "ll_bits", "ll_base",
                          "ml_bits", "ml_base")]
    + [CTAB_OFF[f"{s}_{p}"] for s in ("ll", "of", "ml")
       for p in ("st", "dnb", "dfs")] + [CTAB_WIDTH, len(TABS)], np.int32)

_KERNEL_OFFSETS_PTR = _KERNEL_OFFSETS.ctypes.data

_on_device: dict = {}


def _device_const(name: str, table: np.ndarray, dev) -> torch.Tensor:
    """A constant table, copied to `dev` once."""
    key = (name, str(dev))
    t = _on_device.get(key)
    if t is None:
        with _count:
            t = _on_device.get(key)
            if t is None:
                t = _on_device[key] = torch.from_numpy(table).to(dev)
    return t


def anchor_slots(N: int, S: int) -> tuple[int, int]:
    """(LMAXA, SMAXA): literal anchors per stream, sequence anchors."""
    lmaxa = max(1, (N // 4 + LIT_ANCHOR_INTERVAL - 1) // LIT_ANCHOR_INTERVAL)
    smaxa = max(1, (S + SEQ_ANCHOR_INTERVAL - 1) // SEQ_ANCHOR_INTERVAL)
    return lmaxa, smaxa


def entropy_emit(x: torch.Tensor, sll: torch.Tensor, sml: torch.Tensor,
                 soff: torch.Tensor, meta: torch.Tensor, codes: torch.Tensor,
                 S: int, lit_cap: int, seq_cap: int,
                 ctabs: torch.Tensor | None = None):
    """Emit the final entropy-coded streams per block row.

    x (B, N) uint8 raw block bytes; sll/sml/soff (B, S) int32 final
    sequences; meta (B, 8) int32 = (block_len, lit_count, n_seq, mode
    bits, 4 unread columns); codes (B, 256) int32 (value << 4) | nbits;
    ctabs (B, CTAB_WIDTH) per-row sequence tables (default: predefined).

    Returns (lit_words (B, lit_cap//4), seq_words (B, seq_cap//4), osz
    (B, 8) [4 literal stream sizes or the raw literal count, seq bytes,
    0...], lanch (B, 4, LMAXA), sanch (B, 5, SMAXA) [bits, ll_state,
    of_state, ml_state, rep1]), all int32; absent anchors are -1."""
    B, N = x.shape
    if x.dtype != torch.uint8 or N % 4:
        raise ValueError("x must be (B, N) uint8 with N % 4 == 0")
    for t in (sll, sml, soff):
        if t.shape != (B, S) or t.dtype != torch.int32:
            raise ValueError("sequences must be (B, S) int32")
    if ctabs is None:   # one row for all: the CUDA kernel reads it at stride 0
        ctabs = _device_const("ctab_predef", CTAB_PREDEF, x.device)
        ctabs = ctabs[None].expand(B, -1)
    args = (x, sll, sml, soff, meta.to(torch.int32), codes.to(torch.int32),
            ctabs.to(torch.int32), S, lit_cap // 4, seq_cap // 4,
            *anchor_slots(N, S))
    if x.device.type == "cpu":
        return _emit_plain(*args)
    return _emit_cuda(*args)


def _emit_cuda(x, sll, sml, soff, meta, codes, ctabs, S, LITW, SEQW,
               LMAXA, SMAXA):
    global launches
    from libzseek_tpu_torch import kernels
    lib = kernels.library()
    dev = x.device
    B, N = x.shape
    ins = [t.contiguous() for t in (x, sll, sml, soff, meta, codes)]
    tabs = _device_const("tabs", TABS, dev)
    if ctabs.stride(-1) != 1:
        ctabs = ctabs.contiguous()
    outs = [torch.empty(sh, dtype=torch.int32, device=dev) for sh in (
        (B, LITW), (B, SEQW), (B, 8), (B, 4, LMAXA), (B, 5, SMAXA))]
    tmp = torch.empty(lib.zk_entropy_scratch(B, N, S), dtype=torch.int32,
                      device=dev)
    kernels.launch(
        "zk_entropy_emit", dev, *[t.data_ptr() for t in ins], tabs.data_ptr(),
        ctabs.data_ptr(), B, N, S, LITW, SEQW, LMAXA, SMAXA, ctabs.stride(0),
        _KERNEL_OFFSETS_PTR, tmp.data_ptr(), *[t.data_ptr() for t in outs])
    with _count:
        launches += 1
    return tuple(outs)


# --------------------------------------------------------------------
# plain version


def exp_of(v: torch.Tensor) -> torch.Tensor:
    """floor(log2(v)) for v >= 1, 0 for v <= 0."""
    _, e = torch.frexp(torch.clamp(v, min=1).to(torch.float64))
    return (e - 1).to(v.dtype)


def _literal_positions(x, sll, sml, n, lc):
    """Literal mask and literal index of every byte: bytes outside the
    sequences' matches, in order, the first lc of them."""
    B, N = x.shape
    S = sll.shape[1]
    valid = torch.arange(S, device=x.device)[None, :] < n[:, None]
    zero = torch.zeros_like(sll)
    llv = torch.where(valid, sll, zero).to(torch.int64)
    mlv = torch.where(valid, sml, zero).to(torch.int64)
    end = torch.cumsum(llv + mlv, 1)
    start = end - mlv
    live = valid & (mlv > 0)
    marks = torch.zeros((B, N + 1), dtype=torch.int64, device=x.device)
    one = live.to(torch.int64)
    marks.scatter_add_(1, torch.clamp(start, max=N), one)
    marks.scatter_add_(1, torch.clamp(end, max=N), -one)
    is_lit = torch.cumsum(marks[:, :N], 1) == 0
    rank = C.exclusive_cumsum(is_lit.to(torch.int64), dim=1)
    return is_lit & (rank < lc[:, None]), rank


def huf_layout(x, litmask, rank, codes, lc, one, LMAXA):
    """Bit layout of the Huffman literal payload of the masked literals:
    (val, pos) per byte (pos -1 where no literal), the sentinel position
    of each stream (-1 where the stream is not emitted), stream byte
    sizes (B, 4) and the literal anchors (B, 4, LMAXA)."""
    B, N = x.shape
    dev = x.device
    s = torch.where(one, lc, (lc + 3) >> 2).to(torch.int64)
    sid = torch.where(one[:, None], torch.zeros_like(rank),
                      torch.clamp(rank // torch.clamp(s, min=1)[:, None],
                                  max=3))
    p = codes.to(torch.int64).gather(1, x.to(torch.int64))
    ln = torch.where(litmask, p & 15, torch.zeros_like(p))
    bps = torch.zeros((B, 4), dtype=torch.int64, device=dev)
    bps.scatter_add_(1, sid, ln)
    emitted = torch.ones((B, 4), dtype=torch.bool, device=dev)
    emitted[:, 1:] = ~one[:, None]
    sz = torch.where(emitted, (bps + 8) >> 3, torch.zeros_like(bps))
    base = C.exclusive_cumsum(sz, dim=1)
    # bits after a literal within its stream (emission is in reverse)
    after = torch.cumsum(bps, 1).gather(1, sid) - torch.cumsum(ln, 1)
    neg = torch.full_like(rank, -1)
    pos = torch.where(litmask, 8 * base.gather(1, sid) + after, neg)
    sent = torch.where(emitted, 8 * base + bps, torch.full_like(bps, -1))
    # anchors: bits of the stream's literals from local index 512(ka+1)
    nb = N // LIT_ANCHOR_INTERVAL + 1
    local = rank - sid * s[:, None]
    key = sid * nb + torch.clamp(local // LIT_ANCHOR_INTERVAL, 0, nb - 1)
    T = torch.zeros((B, 4 * nb), dtype=torch.int64, device=dev)
    T.scatter_add_(1, torch.where(litmask, key, torch.zeros_like(key)), ln)
    T = T.reshape(B, 4, nb)
    suf = torch.flip(torch.cumsum(torch.flip(T, [2]), 2), [2])
    anch = suf[:, :, 1: LMAXA + 1]
    cnt = torch.stack([s, s, s, lc - 3 * s], 1)
    cnt = torch.where(emitted, cnt, torch.zeros_like(cnt))
    cnt[:, 0] = s
    ka = torch.arange(LMAXA, device=dev)
    ok = LIT_ANCHOR_INTERVAL * (ka[None, None, :] + 1) < cnt[:, :, None]
    lanch = torch.where(ok, anch, torch.full_like(anch, -1))
    return torch.where(litmask, p >> 4, torch.zeros_like(p)), pos, sent, \
        sz, lanch


def place_plain(val, pos, sent, n_words):
    """Plain version of the literal placement (K3's kernel): every code
    at its bit position, plus one sentinel bit per emitted stream."""
    return C.place_bits(torch.cat([val, torch.ones_like(sent)], 1),
                        torch.cat([pos, sent], 1),
                        torch.cat([pos >= 0, sent >= 0], 1), n_words)


def _seq_stream(sll, sml, soff, n, mode, ctabs, rows, SEQW, SMAXA):
    """FSE sequence streams of the masked rows: (words, bytes, sanch)."""
    B, S = sll.shape
    dev = sll.device
    i64 = lambda t: t.to(torch.int64)
    tabs = torch.from_numpy(TABS.astype(np.int64)).to(dev)
    ct = i64(ctabs)
    CTW = ct.shape[1]
    n = i64(n)
    mode = i64(mode)
    rle = {k: (mode & b) != 0 for k, b in (("ll", MODE_LL_RLE),
                                           ("of", MODE_OF_RLE),
                                           ("ml", MODE_ML_RLE))}
    tl = {}
    for k, dflt in (("ll", zf.LL_DEFAULT_LOG), ("of", zf.OF_DEFAULT_LOG),
                    ("ml", zf.ML_DEFAULT_LOG)):
        f = (mode >> MODE_LOG_SHIFT[k]) & 15
        tl[k] = torch.where(f == 0, torch.full_like(f, dflt), f)
    nmax = int(torch.where(rows, n, torch.zeros_like(n)).max()) if B else 0
    zero = torch.zeros(B, dtype=torch.int64, device=dev)

    def ctg(idx):
        return ct.gather(1, torch.clamp(idx, 0, CTW - 1)[:, None])[:, 0]

    def tab(name, idx):
        return tabs[TAB_OFF[name] + idx]

    state = {k: zero.clone() for k in ("ll", "of", "ml")}
    vals, nbs = [], []
    sanch = torch.full((B, 5, SMAXA + 1), -1, dtype=torch.int64, device=dev)
    bits = zero.clone()
    sll, sml, soff = i64(sll), i64(sml), i64(soff)
    for t in range(nmax):
        act = rows & (t < n)
        i = torch.clamp(n - 1 - t, min=0)
        g = lambda a: a.gather(1, i[:, None])[:, 0]
        ll_v, ml_v, of_v = g(sll), g(sml), g(soff)
        code = {
            "ll": torch.where(ll_v > 63, exp_of(ll_v) + 19,
                              tab("ll_code", torch.clamp(ll_v, 0, 63))),
            "ml": torch.where(ml_v - 3 > 127,
                              exp_of(torch.clamp(ml_v - 3, min=1)) + 36,
                              tab("ml_code", torch.clamp(ml_v - 3, 0, 127))),
            "of": exp_of(of_v)}
        nbk, bvk = {}, {}
        for k in ("of", "ml", "ll"):
            st, dnb_o = CTAB_OFF[k + "_st"], CTAB_OFF[k + "_dnb"]
            dfs = ctg(CTAB_OFF[k + "_dfs"] + code[k])
            dnb = ctg(dnb_o + code[k])
            if t == 0:
                nb0 = (dnb + (1 << 15)) >> 16
                new = ctg(st + (((nb0 << 16) - dnb) >> nb0) + dfs)
                nbk[k], bvk[k] = zero, zero
            else:
                s_ = state[k]
                nb = (s_ + dnb) >> 16
                new = ctg(st + (s_ >> nb) + dfs)
                keep = act & ~rle[k]
                nbk[k] = torch.where(keep, nb, zero)
                bvk[k] = torch.where(keep, s_ & ((1 << nb) - 1), zero)
            state[k] = torch.where(act, new, state[k])
        llc, mlc, ofc = code["ll"], code["ml"], code["of"]
        llb = tab("ll_bits", torch.clamp(llc, 0, 35))
        mlb = tab("ml_bits", torch.clamp(mlc, 0, 52))
        pv = [bvk["of"] | (bvk["ml"] << nbk["of"]),
              bvk["ll"] | ((ll_v - tab("ll_base", torch.clamp(llc, 0, 35)))
                           << nbk["ll"]),
              ml_v - tab("ml_base", torch.clamp(mlc, 0, 52)),
              of_v - (1 << ofc)]
        pn = [nbk["of"] + nbk["ml"], nbk["ll"] + llb, mlb, ofc]
        for v_, n_ in zip(pv, pn):
            vals.append(torch.where(act, v_, zero))
            nbs.append(torch.where(act, n_, zero))
        bits = bits + sum(nbs[-4:])
        anc = act & (i > 0) & ((i & (SEQ_ANCHOR_INTERVAL - 1)) == 0)
        ka = torch.where(anc, (i >> 7) - 1, torch.full_like(i, SMAXA))
        for row, v_ in enumerate((bits, state["ll"] - (1 << tl["ll"]),
                                  state["of"] - (1 << tl["of"]),
                                  state["ml"] - (1 << tl["ml"]))):
            sanch[:, row].scatter_(1, ka[:, None], v_[:, None])
    for k in ("ml", "of", "ll"):
        live = rows & ~rle[k]
        vals.append(torch.where(live, state[k] & ((1 << tl[k]) - 1), zero))
        nbs.append(torch.where(live, tl[k], zero))
    vals.append(torch.ones_like(zero))
    nbs.append(rows.to(torch.int64))
    V = torch.stack(vals, 1)
    NB = torch.stack(nbs, 1)
    pos = C.exclusive_cumsum(NB, dim=1)
    words = C.place_bits(V, pos, NB > 0, SEQW)
    nbytes = torch.where(rows, (NB.sum(1) + 7) >> 3, zero)
    # rep1 before sequence 128(ka+1): last explicitly coded offset
    idx = torch.arange(S, device=dev)[None, :]
    valid = idx < n[:, None]
    push = valid & (i64(soff) > 3)
    last = torch.cummax(torch.where(push, idx, torch.full_like(idx, -1))
                        .expand(B, S), 1).values
    last = torch.cat([torch.full_like(last[:, :1], -1), last[:, :-1]], 1)
    rep1 = torch.where(last >= 0,
                       i64(soff).gather(1, torch.clamp(last, min=0)) - 3,
                       torch.ones_like(last))
    ia = SEQ_ANCHOR_INTERVAL * (torch.arange(SMAXA, device=dev) + 1)
    ok = rows[:, None] & (ia[None, :] < n[:, None])
    sanch[:, 4, :SMAXA] = torch.where(
        ok, rep1.gather(1, torch.clamp(ia, max=S - 1).expand(B, SMAXA)),
        torch.full_like(ok, -1, dtype=torch.int64))
    return words, nbytes, sanch[:, :, :SMAXA]


def _emit_plain(x, sll, sml, soff, meta, codes, ctabs, S, LITW, SEQW,
                LMAXA, SMAXA):
    B, N = x.shape
    lc = meta[:, 1].to(torch.int64)
    n = meta[:, 2].to(torch.int64)
    mode = meta[:, 3].to(torch.int64)
    osz = torch.zeros((B, 8), dtype=torch.int64)
    litmask, rank = _literal_positions(x, sll, sml, n, lc)
    huf = (mode & MODE_HUF) != 0
    one = (mode & MODE_HUF1) != 0
    val, pos, sent, sz, lanch = huf_layout(x, litmask & huf[:, None], rank,
                                           codes, lc, one, LMAXA)
    words = place_plain(val, pos, sent, LITW)
    lit_w = torch.where(huf[:, None], words, torch.zeros_like(words))
    osz[:, :4] = torch.where(huf[:, None], sz, osz[:, :4])
    lanch = torch.where(huf[:, None, None], lanch,
                        torch.full_like(lanch, -1))
    raw = (mode & MODE_RAWLIT) != 0
    if bool(raw.any()):
        rawb = torch.zeros((B, 4 * LITW + 1), dtype=torch.uint8)
        live = litmask & raw[:, None]
        rawb.scatter_(1, torch.where(live, rank, 4 * LITW),
                      torch.where(live, x, torch.zeros_like(x)))
        rw = rawb[:, :4 * LITW].contiguous().view(torch.int32)
        lit_w = torch.where(raw[:, None], rw, lit_w)
        osz[:, 0] = torch.where(raw, lc, osz[:, 0])
    rows = ((mode & MODE_SEQ) != 0) & (n > 0)
    seq_w, nbytes, sanch = _seq_stream(sll, sml, soff, n, mode, ctabs, rows,
                                       SEQW, SMAXA)
    osz[:, 4] = nbytes
    i32 = lambda t: t.to(torch.int32)
    return (lit_w, seq_w, i32(osz), i32(lanch), i32(sanch))
