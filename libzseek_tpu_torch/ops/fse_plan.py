"""Per-block FSE sequence-table planning (RFC 8878 §3.1.1.4).

Counterpart of libzseek_tpu/ops/fse_plan.py plan_seq_tables (:157) and
NORM_WIDTH: per stream type (LL, OF, ML) choose Predefined, RLE or
FSE_Compressed at the predefined or the format's largest accuracy log,
and build the chosen encode tables in the per-row pack the entropy
kernel reads.  The reference's ZN_SEQTAB* knobs are not ported (their
defaults, "auto" and the fractional estimate, are fixed here).

The fractional cost estimate round((log - log2(n)) * 16) depends only on
the normalized count n (1..2^log), so it is a table computed once in
float32 numpy; tests hold it to the reference for every n.
"""

from __future__ import annotations

import numpy as np
import torch

from libzseek_tpu_torch.format import zstd_frame as zf
from libzseek_tpu_torch.ops.entropy import (CT_MAXLOG, CTAB_OFF, CTAB_PREDEF,
                                            MODE_LL_FSE, MODE_LL_RLE,
                                            MODE_LOG_SHIFT, MODE_ML_FSE,
                                            MODE_ML_RLE, MODE_OF_FSE,
                                            MODE_OF_RLE, TABS, TAB_OFF,
                                            exp_of)
from libzseek_tpu_torch.ops.huffman_plan import floor_log2

_STREAMS = (
    ("ll", len(zf.LL_DEFAULT_NORM), zf.LL_DEFAULT_LOG, zf.LL_DEFAULT_NORM),
    ("of", len(zf.OF_DEFAULT_NORM), zf.OF_DEFAULT_LOG, zf.OF_DEFAULT_NORM),
    ("ml", len(zf.ML_DEFAULT_NORM), zf.ML_DEFAULT_LOG, zf.ML_DEFAULT_NORM),
)
NSYMS = {k: n for k, n, _, _ in _STREAMS}
LOGS = {k: lg for k, _, lg, _ in _STREAMS}
NORM_WIDTH = sum(n for _, n, _, _ in _STREAMS)
MIN_SEQ_FSE = 32       # sequences a custom table needs to pay for itself


def _pd_bits16(norm, log):
    """Per-symbol predefined cost in 1/16 bits."""
    n = np.asarray(norm, np.float64)
    slots = np.where(n < 0, 1.0, np.maximum(n, 1e-9))
    bits = log - np.log2(slots)
    bits = np.where(n == 0, float(log + 1), bits)
    return np.round(bits * 16).astype(np.int32)


_PD_BITS16 = {k: _pd_bits16(nm, lg) for k, _, lg, nm in _STREAMS}


def _cost16_table(log: int) -> np.ndarray:
    """round((log - log2(n)) * 16) in float32 for n = 0..2^log (0 -> 0)."""
    nf = np.maximum(np.arange((1 << log) + 1, dtype=np.float32),
                    np.float32(1))
    c = np.round((np.float32(log) - np.log2(nf)) * np.float32(16))
    c[0] = 0
    return c.astype(np.int32)


COST16 = {lg: _cost16_table(lg) for lg in (5, 6, 8, 9)}


def _spread_pos(log):
    tab = 1 << log
    step = (tab >> 1) + (tab >> 3) + 3
    return ((np.arange(tab) * step) & (tab - 1)).astype(np.int64)


_SPREAD_POS = {lg: _spread_pos(lg) for lg in (5, 6, 8, 9)}


def seq_codes(ll, ml, offv, valid):
    """Masked LL / ML / OF codes of (B, S) sequences."""
    dev = ll.device
    tabs = torch.from_numpy(TABS).to(dev)
    zero = torch.zeros_like(ll)
    llc = torch.where(ll > 63, exp_of(ll) + 19,
                      tabs[TAB_OFF["ll_code"] + torch.clamp(ll, 0, 63)])
    mb = torch.clamp(ml, min=3) - 3
    mlc = torch.where(mb > 127, exp_of(torch.clamp(mb, min=1)) + 36,
                      tabs[TAB_OFF["ml_code"] + torch.clamp(mb, 0, 127)])
    return {"ll": torch.where(valid, llc, zero),
            "ml": torch.where(valid & (ml >= 3), mlc, zero),
            "of": torch.where(valid & (offv > 0), exp_of(offv), zero)}


def _normalize(hist, log):
    """Normalization at a fixed accuracy log: every used symbol gets at
    least one slot, the remainder lands on the most frequent symbol.
    Returns (norm, ok); ok is False when that would push it below 1."""
    tab = 1 << log
    total = hist.sum(1, keepdim=True)
    used = hist > 0
    scaled = hist * tab // torch.clamp(total, min=1)
    norm = torch.where(used, torch.clamp(scaled, min=1),
                       torch.zeros_like(hist))
    d = tab - norm.sum(1)
    top = hist.argmax(1)
    rows = torch.arange(hist.shape[0], device=hist.device)
    fixed = norm[rows, top] + d
    ok = fixed >= 1
    norm = norm.clone()
    norm[rows, top] = torch.clamp(fixed, min=1)
    return norm, ok & (norm.sum(1) == tab)


def _build_ctable(norm, log: int):
    """FSE_buildCTable for norms without -1 entries: (state_table (B, tab),
    delta_nb_bits (B, nsyms), delta_find_state (B, nsyms))."""
    tab = 1 << log
    B = norm.shape[0]
    pos = torch.from_numpy(_SPREAD_POS[log]).to(norm.device)
    cum_in = torch.cumsum(norm, 1)
    cumul = cum_in - norm
    k = torch.arange(tab, device=norm.device)
    sym_k = (k[None, None, :] >= cum_in[:, :, None]).sum(1)
    order = torch.argsort(sym_k * tab + pos[None, :], dim=1)
    state_table = tab + pos[order]
    c = norm
    max_bits = log - floor_log2(torch.clamp(c - 1, min=1)).to(c.dtype)
    dnb = torch.where(
        c == 0, torch.full_like(c, ((log + 1) << 16) - tab),
        torch.where(c == 1, torch.full_like(c, (log << 16) - tab),
                    (max_bits << 16) - (c << torch.clamp(max_bits, 0, 31))))
    dfs = torch.where(c == 0, torch.zeros_like(c),
                      torch.where(c == 1, cumul - 1, cumul - c))
    return state_table, dnb, dfs


def plan_seq_tables(ll, ml, offv, n_seq):
    """ll/ml/offv (B, S) final sequences, n_seq (B,).  Returns (flags (B,)
    MODE_* bits, ctabs (B, CTAB_WIDTH) per-row encode tables (predefined
    content where a stream is not FSE_Compressed), norms (B, NORM_WIDTH)
    for host serialization, rle_syms (B, 3), est_gain_bits (B,)), int32."""
    B, S = ll.shape
    dev = ll.device
    i64 = lambda t: t.to(torch.int64)
    ll, ml, offv, n_seq = i64(ll), i64(ml), i64(offv), i64(n_seq)
    valid = torch.arange(S, device=dev)[None, :] < n_seq[:, None]
    codes = seq_codes(ll, ml, offv, valid)
    flags = torch.zeros(B, dtype=torch.int64, device=dev)
    gain = torch.zeros_like(flags)
    zero = torch.zeros_like(flags)
    bit_map = {"ll": (MODE_LL_RLE, MODE_LL_FSE), "of": (MODE_OF_RLE,
               MODE_OF_FSE), "ml": (MODE_ML_RLE, MODE_ML_FSE)}
    ctab_parts, norms_out, rle_syms = [], [], []
    pd_tab = torch.from_numpy(CTAB_PREDEF.astype(np.int64)).to(dev)
    for key, nsyms, log, _nm in _STREAMS:
        hist = torch.zeros((B, nsyms), dtype=torch.int64, device=dev)
        hist.scatter_add_(1, torch.clamp(codes[key], 0, nsyms - 1),
                          valid.to(torch.int64))
        nz = (hist > 0).sum(1)
        sym = hist.argmax(1)
        log_m = CT_MAXLOG[key]
        pd16 = torch.from_numpy(_PD_BITS16[key].astype(np.int64)).to(dev)
        bits_pd = (hist * pd16[None, :]).sum(1) >> 4
        symi = torch.arange(nsyms, device=dev)[None, :]
        last = torch.where(hist > 0, symi, torch.zeros_like(symi)).amax(1)

        def custom(lg):
            norm, ok = _normalize(hist, lg)
            c16 = torch.from_numpy(COST16[lg].astype(np.int64)).to(dev)
            cb16 = torch.where(norm > 0, c16[torch.clamp(norm, 0, 1 << lg)],
                               torch.zeros_like(norm))
            cost = ((hist * cb16).sum(1) >> 4) + \
                ((4 + (last + 1) * (lg + 2) + 7) >> 3) * 8
            return norm, ok, cost

        norm_d, ok_d, cost_d = custom(log)
        norm_m, ok_m, cost_m = custom(log_m)
        base_ok = (nz >= 2) & (n_seq >= MIN_SEQ_FSE)
        ok_d = ok_d & base_ok & (cost_d + 16 < bits_pd)
        ok_m = ok_m & base_ok & (cost_m + 16 < bits_pd)
        use_m = ok_m & (~ok_d | (cost_m < cost_d))
        use_d = ok_d & ~use_m
        rle = (nz == 1) & (n_seq > 0)
        use_m = use_m & ~rle
        use_d = use_d & ~rle
        rbit, fbit = bit_map[key]
        sh = MODE_LOG_SHIFT[key]
        flags = flags | torch.where(rle, rbit, zero) | \
            torch.where(use_m | use_d, fbit, zero) | \
            torch.where(use_m, log_m << sh, zero) | \
            torch.where(use_d, log << sh, zero)
        gain = gain + torch.where(use_m, bits_pd - cost_m, zero) + \
            torch.where(use_d, bits_pd - cost_d, zero)
        st_d, dnb_d, dfs_d = _build_ctable(norm_d, log)
        st_m, dnb_m, dfs_m = _build_ctable(norm_m, log_m)
        st_d = torch.nn.functional.pad(st_d, (0, (1 << log_m) - (1 << log)))
        um, ud = use_m[:, None], use_d[:, None]
        for part, (a_m, a_d), width in (
                ("_st", (st_m, st_d), 1 << log_m),
                ("_dnb", (dnb_m, dnb_d), nsyms),
                ("_dfs", (dfs_m, dfs_d), nsyms)):
            o = CTAB_OFF[key + part]
            seg = pd_tab[o: o + width][None, :]
            ctab_parts.append(torch.where(um, a_m, torch.where(ud, a_d, seg)))
        norms_out.append(torch.where(um, norm_m, norm_d))
        rle_syms.append(sym)
    i32 = lambda t: t.to(torch.int32)
    return (i32(flags), i32(torch.cat(ctab_parts, 1)),
            i32(torch.cat(norms_out, 1)), i32(torch.stack(rle_syms, 1)),
            i32(gain))
