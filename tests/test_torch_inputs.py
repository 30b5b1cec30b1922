"""Shared inputs of the port's CPU parity tests (tests/test_torch_*.py),
and the build of the native host runtime they compare codecs with.  It
holds no tests.

Every input is made with numpy from a fixed seed; the stage chains here
run the port's plain versions on the CPU."""

import os
import subprocess

import numpy as np
import torch

import jax.numpy as jnp

from libzseek_tpu import native
from libzseek_tpu.ops import zstd_encode as jze
from libzseek_tpu.testing.corpus import mixed_corpus, text_corpus
from libzseek_tpu_torch.convert import to_numpy
from libzseek_tpu_torch.ops import entropy as E
from libzseek_tpu_torch.ops import fse_plan as fpl
from libzseek_tpu_torch.ops import huffman_plan as hp
from libzseek_tpu_torch.ops.parse_linked import parse_linked
from libzseek_tpu_torch.ops.zstd_encode import _linked_post
from test_torch_cuda_inputs import arms_rows, words  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S = 8192          # sequence slots per block
N_STAGE = 16384   # block size of the stage tests


def build_native_runtime():
    """Build the shared native host runtime (libzseek_tpu/native) unless it
    is there, at the first test of test_torch_codec.py.

    The runtime is loaded on demand and probed for until found, so it must
    not appear while a test compares two codec runs: the LDM pre-pass
    would switch on between them.  tests/test_native.py builds it
    mid-session, and test_entropy_smem.py's smem-against-xla comparison
    failed whenever another worker took that file while the build ran.
    test_torch_codec.py, with five tests, is queued by pytest-xdist's
    loadfile schedule (files by test count, then name) right after
    test_linked_parse.py.  Building there leaves every file before it
    scheduled as without the port, which test_linked_parse.py's
    rng-dependent ladder test needs, and finishes long before
    test_entropy_smem.py (two tests) is handed out.  The library is
    linked under build/ and renamed into place, so no process loads it
    half written; a failed build leaves it absent, as before."""
    if native.have_native():
        return
    src = os.path.join(ROOT, "libzseek_tpu", "native")
    build = os.path.join(ROOT, "build", "native")
    os.makedirs(build, exist_ok=True)
    tmp = os.path.join(build, f"libzseek_native.{os.getpid()}.so")
    r = subprocess.run(["make", "-s", "-B", "-C", src, f"SO={tmp}"],
                       capture_output=True, check=False)
    if r.returncode == 0:
        os.replace(tmp, os.path.join(src, "libzseek_native.so"))


def eq(port, ref, msg=""):
    ref = np.asarray(ref)
    got = to_numpy(port, np.uint32 if ref.dtype == np.uint32 else None)
    np.testing.assert_array_equal(got, ref, err_msg=msg)


def planted(rng, n):
    """Text with planted repeats at distances up to 2 KiB."""
    x = text_corpus(rng, n)
    for _ in range(n // 64):
        s = int(rng.integers(2048, n - 512))
        d = int(rng.integers(8, 2048))
        ln = int(rng.integers(6, 200))
        x[s: s + ln] = x[s - d: s - d + ln]
    return x


def stage_rows(rng):
    """8 blocks: planted-repeat text (two linked frames), the four mixed
    regimes, a short row and an empty padding row."""
    N = N_STAGE
    x = text_corpus(rng, 3 * N)
    for _ in range(300):
        s = int(rng.integers(2048, 3 * N - 512))
        d = int(rng.integers(8, 2048))
        ln = int(rng.integers(6, 200))
        x[s: s + ln] = x[s - d: s - d + ln]
    m = mixed_corpus(rng, 4 * N)
    X = np.zeros((9, N), np.uint8)
    X[1:4] = x.reshape(3, N)
    vocab = [bytes(rng.integers(97, 123, int(rng.integers(2, 9)),
                                np.uint8)) for _ in range(300)]
    text = b" ".join(vocab[int(i)] for i in rng.zipf(1.3, 6000) % 300)
    X[3] = np.frombuffer(text[:N], np.uint8)
    X[4:8] = m.reshape(4, N)
    lens = np.array([N] * 7 + [0], np.int32)
    X[7, 5000:] = 0
    lens[6] = 5000
    min_abs = np.array([N, N, N * 2, 4 * N, 5 * N, 6 * N, 7 * N, 8 * N],
                       np.int32)
    return X, lens, min_abs


def stage_batch():
    """stage_rows(seed 5) through h16 (reference), K1 (plain) and the
    reference's _linked_post: (X, lens, min_abs, h16, k1 outputs, ref)."""
    X, lens, min_abs = stage_rows(np.random.default_rng(5))
    h16, _ = jze.block_entropy_h16(jnp.asarray(X[1:]), jnp.asarray(lens))
    h16 = np.array(h16)
    outs = parse_linked(torch.from_numpy(X), torch.from_numpy(lens),
                        torch.from_numpy(min_abs), torch.from_numpy(h16))
    k1 = [o.numpy() for o in outs]
    ref = jze._linked_post(jnp.asarray(X[1:]), jnp.asarray(lens),
                           *(jnp.asarray(a) for a in k1[:5]), None,
                           cap=k1[0].shape[1], lit_mask=jnp.asarray(k1[5]))
    ref = {k: np.asarray(v) for k, v in ref.items()}
    return X, lens, min_abs, h16, k1, ref


def chain(rows, lens):
    """Port chain up to the entropy stage for one-block frames:
    (seqs, meta, codes, ctabs)."""
    B, N = rows.shape
    X = np.zeros((B + 1, N), np.uint8)
    X[1:] = rows
    min_abs = ((np.arange(B) + 1) * N).astype(np.int32)
    h16 = np.array(jze.block_entropy_h16(jnp.asarray(rows),
                                         jnp.asarray(lens))[0])
    t = torch.from_numpy
    k1 = parse_linked(t(X), t(lens), t(min_abs), t(h16))
    seqs = _linked_post(t(rows), t(lens), *k1[:5], S, k1[5])
    lens_t = t(lens)
    _m, mb, codes, _w, _r, sizes4 = hp.plan_blocks(
        seqs["hist"], seqs["lit_count"], seqs["n_seq"], seqs["const"],
        lens_t, mode_huf=E.MODE_HUF, mode_huf1=E.MODE_HUF1,
        mode_rawlit=E.MODE_RAWLIT, mode_seq=E.MODE_SEQ,
        hist_q=seqs["hist_q"])
    sflags, ctabs, *_ = fpl.plan_seq_tables(seqs["ll"], seqs["ml"],
                                            seqs["offv"], seqs["n_seq"])
    mb = mb | torch.where((mb & E.MODE_SEQ) != 0, sflags,
                          torch.zeros_like(sflags))
    meta = torch.cat([torch.stack([lens_t, seqs["lit_count"],
                                   seqs["n_seq"], mb], 1), sizes4], 1)
    return seqs, meta, codes, ctabs


def fence_batch(rng, N, B=4):
    """Frame A = rows 0..2 (linked), frame B = row 3, a copy of A's last
    block that must not match across the fence: (x2, lens, min_abs,
    h16)."""
    a0 = rng.integers(0, 256, N, np.uint8)
    a1 = np.concatenate([a0[N // 2:], rng.integers(0, 256, N // 2, np.uint8)])
    a2 = np.concatenate([a1[N // 2:], rng.integers(0, 256, N // 2, np.uint8)])
    x2 = np.stack([np.zeros(N, np.uint8), a0, a1, a2, a2.copy()])
    return x2, np.full(B, N, np.int32), \
        np.array([N, N, 2 * N, 4 * N], np.int32), np.full(B, 64, np.int32)


# --- K1 parity cases: 4 rows of 16 KiB, so the reference compiles once
# per parameter set ---

PARSE_N = 16384
PARSE_B = 4
PARSE_OUTS = ("ll", "ml", "offv", "n_seq", "cover_end", "lit_mask")


def _planted_text(rng, n):
    """Markov-ish text with planted repeats (distances up to 24 KiB, so
    some cross into the previous block)."""
    x = text_corpus(rng, n)
    for _ in range(n // 256):
        s = int(rng.integers(0, n - 2048))
        d = int(rng.integers(8, min(s, 24576) + 9))
        ln = int(rng.integers(6, 300))
        if s - d >= 0:
            x[s: s + ln] = x[s - d: s - d + ln]
    return x


def _h16(x2, lens):
    return np.array(jze.block_entropy_h16(jnp.asarray(x2[1:]),
                                          jnp.asarray(lens))[0])


def _corpus_batch(rng, kind):
    # mixed: one regime per row (text-like, period-337 repeats, zeros,
    # noise), so both hash arms run
    N, B = PARSE_N, PARSE_B
    data = _planted_text(rng, B * N) if kind == "text" else \
        mixed_corpus(rng, B * N)
    x2 = np.zeros((B + 1, N), np.uint8)
    x2[1:] = data.reshape(B, N)
    lens = np.array([N, N, N, 9000], np.int32)
    x2[B, 9000:] = 0
    min_abs = np.array([N, N, 2 * N, 4 * N], np.int32)
    return x2, lens, min_abs, _h16(x2, lens)


def parse_cases():
    """{name: (x2, lens, min_abs, h16)}: the multi-frame fence batch,
    planted text, the four mixed regimes, h16 on both sides of the strict
    threshold (6*h16 <= 480), and LDM-covered rows (length 0), which skip
    the parse and must leave the table untouched."""
    rng = np.random.default_rng(2024)
    cases = {"fence": fence_batch(rng, PARSE_N, PARSE_B)}
    for kind in ("text", "mixed"):
        cases[kind] = _corpus_batch(rng, kind)
    x2, lens, ma, _ = cases["text"]
    cases["h16_sides"] = (x2, lens, ma, np.array([80, 81, 60, 100],
                                                 np.int32))
    x2, lens, ma, h16 = cases["mixed"]
    pl = lens.copy()
    pl[1] = 0
    cases["zero_rows"] = (x2, pl, ma, h16)
    return cases


def arms_batch():
    """test_torch_cuda_inputs.arms_rows() with the reference's h16:
    (x2, lens, min_abs, h16)."""
    x2, lens, min_abs = arms_rows()
    return x2, lens, min_abs, _h16(x2, lens)


def parse_both(case, prm):
    """(reference outputs as numpy, plain outputs as numpy) of one case:
    zstd_parse_linked_smem in interpret mode and the port's plain K1."""
    from libzseek_tpu.ops.pallas_match import zstd_parse_linked_smem
    ref = zstd_parse_linked_smem(*(jnp.asarray(a) for a in case),
                                 interpret=True, **prm)
    out = parse_linked(*(torch.from_numpy(a) for a in case), **prm)
    return [np.asarray(r) for r in ref], [o.numpy() for o in out]


def kept_sequences(out, row):
    """[(block-relative start, length, distance)] of a row's kept
    sequences from plain K1's outputs."""
    ll, ml, offv, n_seq = out[:4]
    pos, seqs = 0, []
    for j in range(int(n_seq[row])):
        start = pos + int(ll[row, j])
        seqs.append((start, int(ml[row, j]), int(offv[row, j]) - 3))
        pos = start + int(ml[row, j])
    return seqs


# --- Writer archives at levels >= 4 (64 KiB blocks) ---

ZN_KNOBS = ("ZN_BLOCK", "ZN_REP_PROBE", "ZN_GATE_BITS", "ZN_HLOG",
            "ZN_STRICT_X6", "ZN_STRICT_HB", "ZN_GATED_POLICY")


def level_archives(monkeypatch, level: int, parser: str = "linked"):
    """296 KiB (192 KiB of mixed_corpus, then planted-repeat text) through
    the JAX package's Writer with its ZstdCodec(level, parser) and through
    the port's Writer(sink, "zstd", level=...) on the CPU, or with
    ZstdCodec(level, parser="hash"): 256 KiB frames, so the first frame
    is a chain of four 64 KiB blocks and the second one short block, two
    frames a batch, 32 KiB writes, checksums.  Returns (data, reference
    archive, port archive)."""
    import io

    from libzseek_tpu.runtime.writer import Writer as JWriter
    from libzseek_tpu.runtime.zstd_codec import ZstdCodec as JCodec
    from libzseek_tpu_torch import Writer, ZstdCodec
    for k in ZN_KNOBS:
        monkeypatch.delenv(k, raising=False)
    build_native_runtime()
    rng = np.random.default_rng(100 + level)
    data = (mixed_corpus(rng, 192 * 1024).tobytes()
            + planted(rng, 104 * 1024).tobytes())
    kw = dict(min_frame_size=256 * 1024, batch_frames=2, checksums=True)

    def write(writer):
        for pos in range(0, len(data), 32768):
            writer.write(data[pos: pos + 32768])
        writer.close()

    ref, got = io.BytesIO(), io.BytesIO()
    if parser == "hash":
        from test_torch_hash_inputs import interpret_k7
        interpret_k7(monkeypatch)
        write(JWriter(ref, codec=JCodec(level=level, parser="hash"), **kw))
        write(Writer(got, ZstdCodec(level=level, parser="hash",
                                    device="cpu"), **kw))
    else:
        write(JWriter(ref, codec=JCodec(level=level, parser="linked",
                                        entropy="smem"), **kw))
        write(Writer(got, "zstd", level=level, device="cpu", **kw))
    return data, ref.getvalue(), got.getvalue()


def k2_chain_rows(N: int = 16384, seed: int = 31):
    """K2 rows through the port's chain (one-block frames): planted
    matches, words, a 1-stream row, raw literals (a noise half twice),
    period-337 repeats, an empty-ish row, a 7,000-byte row, an empty row
    (every literal mode; per-block FSE and RLE tables at both accuracy
    logs at N = 16384).  (rows, seqs, meta, codes, ctabs)."""
    rng = np.random.default_rng(seed)
    rows = np.zeros((8, N), np.uint8)
    rows[0] = planted(rng, N)
    rows[1] = words(rng, N)
    rows[2] = np.tile(rng.choice(np.frombuffer(b"aaaabbbcd", np.uint8),
                                 150), N // 150 + 1)[:N]
    noise = rng.integers(0, 256, N // 2, np.uint8)
    rows[3] = np.concatenate([noise, noise])
    rows[4] = mixed_corpus(rng, 4 * N)[N: 2 * N]
    rows[6] = words(rng, N)
    lens = np.array([N, N, N, N, N, N, 7000, 0], np.int32)
    rows[6, 7000:] = 0
    return (rows,) + chain(rows, lens)


def k3_chain_rows(seed: int = 41):
    """K3 rows of 128 KiB through the port's chain: planted matches, words
    cut to N - 1000 bytes, noise; the first two are K3's.  (rows, lens,
    seqs, codes, vec)."""
    n = 131072
    rng = np.random.default_rng(seed)
    rows = np.stack([planted(rng, n), words(rng, n),
                     rng.integers(0, 256, n, np.uint8)])
    lens = np.full(3, n, np.int32)
    lens[1] = n - 1000
    rows[1, n - 1000:] = 0
    seqs, _meta, codes, _ctabs = chain(rows, lens)
    return rows, lens, seqs, codes, torch.tensor([True, True, False])
