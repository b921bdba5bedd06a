"""`.rfqz` container: the framework-native second entropy stage.

The reference reaches its best ratio by piping `.rfq` through the external
`xz` binary (reference main.cpp:134-177) — an inherently sequential LZMA
stage and a runtime dependency. `.rfqz` replaces that with the in-framework
interleaved-rANS coder (codec/rans_np.py host oracle, ops/rans_device.py
TPU kernels): the `.rfq` byte stream is cut into fixed-size blocks, each
block is entropy-coded as one section with a per-section model choice, and
both encode and decode are lane-parallel (TPU/SIMD-friendly) instead of
bit-serial.

Layout:
  magic "RFQZ" | u8 container version (1)
  sections until EOF, each one rans_np section record, but with a leading
  u8 mode: 0 = rANS order-0, 1 = rANS order-1, 255 = stored raw
  (mode 255: u8 255, u32 n, raw bytes)

Mode choice per section: exact entropy accounting from the byte/context
histograms (cheap) + serialized table cost, vs raw. The underlying stream
is the ordinary `.rfq` container, so `.rfqz` works for SE/PE/all paths.

RfqzWriter/RfqzReader are file-like (write/read/close) so the pipeline
functions use them as out_stream/in_stream directly — the same shape as the
reference's xz pipe, minus the subprocess.
"""

from __future__ import annotations

import numpy as np

from ..codec import rans_np
from .header import RfqFormatError

MAGIC = b"RFQZ"
# v2: LZ token fields are per-plane sections, rep-distance slots + MTF
# dist transform, SEQLZ cross-section history. v3: compact frequency
# tables (symbol list/bitmap + varint freqs, last implied — the order-1
# table block drops ~3x in size) and a 32-byte order-1 context bitmap.
# DELIBERATE v1/v2 break: earlier versions only
# ever existed inside this repo's own earlier work — the format is
# pre-release, so no legacy read path is carried; old inputs fail with
# the explicit "unsupported RFQZ container version" error below.
VERSION = 3
# 16MB sections: ~4 ratio points better than 4MB (table amortization +
# stabler order-1 statistics) while keeping per-section parallelism
DEFAULT_BLOCK = 16 << 20
MODE_ORDER0 = 0
MODE_ORDER1 = 1
MODE_LZ = 2  # hash-chain LZ over raw bytes, token fields + literals rANS'd
MODE_SEQLZ = 3  # LZ over UNPACKED bases of a 2-bit seq stream (phase-free)
MODE_STORED = 255

_LZ_MIN_BYTES = 16  # min match (bytes) for MODE_LZ
_LZ_MIN_BASES = 24  # min match (bases) for MODE_SEQLZ
_LZ_TRY_MIN = 16 << 10  # don't bother below this section size
# decoder-side sanity cap on a section's declared uncompressed size: far
# above any real section (DEFAULT_BLOCK is 16MB) but small enough that a
# crafted header can't force a multi-GB allocation before validation
_LZ_MAX_OUT = 1 << 28


class RfqzFormatError(RfqFormatError):
    """Subclasses RfqFormatError so the CLI's error path covers it."""


_LZ_WARNED = False


def _entropy_bits_order0(counts: np.ndarray) -> float:
    total = counts.sum()
    if total == 0:
        return 0.0
    p = counts[counts > 0] / total
    return float(-(p * np.log2(p)).sum() * total)


def _table_cost_bytes(counts: np.ndarray) -> int:
    """Estimated compact-table bytes (v3 serialization: header + symbol
    list/bitmap + ~1.1 B/varint freq, last frequency implied)."""
    npres = int((counts > 0).sum())
    if npres == 0:
        return 0
    sym = 0 if npres == 256 else min(npres, 32)
    return 1 + sym + max(npres - 1, 0) + npres // 8


def choose_mode(data: np.ndarray):
    """Cheap exact-entropy model selection for one section. Returns
    (mode, byte_histogram, raw_pair_histogram_or_None) so the encoder can
    reuse the scans."""
    n = data.shape[0]
    counts = np.bincount(data, minlength=256)
    est0 = _entropy_bits_order0(counts) / 8 + _table_cost_bytes(counts)
    if n < 4096:
        mode = MODE_ORDER0 if est0 < n * 0.98 else MODE_STORED
        return mode, counts, None
    # u16 pair keys, then one widening astype: int64 elementwise shifts and
    # u16 bincounts are both ~20x slower on this host
    pair = np.bincount(
        ((data[:-1].astype(np.uint16) << 8) | data[1:]).astype(np.int64),
        minlength=65536,
    )
    ctx = pair.reshape(256, 256)
    est1 = sum(
        _entropy_bits_order0(ctx[c]) for c in range(256) if ctx[c].any()
    ) / 8 + 0.75 * sum(
        # 0.75: the order-1 table block is itself order-0 rANS'd
        # (rans_np.pack_ctx_tables), recovering ~25% of the varint bytes
        _table_cost_bytes(ctx[c]) for c in range(256)
    ) + 33  # context-presence bitmap + table-block flag
    best = min(est0, est1)
    if best >= n * 0.98:
        return MODE_STORED, counts, pair
    return (MODE_ORDER0 if est0 <= est1 else MODE_ORDER1), counts, pair


def _lz_fields_bytes(ll: np.ndarray, ml: np.ndarray, dd: np.ndarray):
    """Token fields as plane-major byte streams (rANS-friendly): litlen and
    matchlen as u16 with 0xFFFF escaping to an overflow list, dist as u32.
    Returns (fields (8*ntok,) u8, overflow_raw bytes)."""
    ntok = ll.shape[0]
    overflow: list[int] = []
    ll16 = np.minimum(ll, 0xFFFF).astype(np.uint32)
    ml16 = np.minimum(ml, 0xFFFF).astype(np.uint32)
    big = np.flatnonzero((ll >= 0xFFFF) | (ml >= 0xFFFF))
    for t in big:  # rare: scan order (litlen first, then matchlen)
        if ll[t] >= 0xFFFF:
            ll16[t] = 0xFFFF
            overflow.append(int(ll[t]))
        if ml[t] >= 0xFFFF:
            ml16[t] = 0xFFFF
            overflow.append(int(ml[t]))
    d32 = dd.astype(np.uint32)
    fields = np.empty(8 * ntok, dtype=np.uint8)
    fields[0 * ntok : 1 * ntok] = ll16 & 0xFF
    fields[1 * ntok : 2 * ntok] = ll16 >> 8
    fields[2 * ntok : 3 * ntok] = ml16 & 0xFF
    fields[3 * ntok : 4 * ntok] = ml16 >> 8
    fields[4 * ntok : 5 * ntok] = d32 & 0xFF
    fields[5 * ntok : 6 * ntok] = (d32 >> 8) & 0xFF
    fields[6 * ntok : 7 * ntok] = (d32 >> 16) & 0xFF
    fields[7 * ntok : 8 * ntok] = (d32 >> 24) & 0xFF
    oraw = np.asarray(overflow, dtype="<u8").tobytes()
    return fields, oraw


def _lz_fields_parse(fields: np.ndarray, oraw: bytes, ntok: int):
    ll = (
        fields[0 * ntok : 1 * ntok].astype(np.int64)
        | (fields[1 * ntok : 2 * ntok].astype(np.int64) << 8)
    )
    ml = (
        fields[2 * ntok : 3 * ntok].astype(np.int64)
        | (fields[3 * ntok : 4 * ntok].astype(np.int64) << 8)
    )
    dd = (
        fields[4 * ntok : 5 * ntok].astype(np.int64)
        | (fields[5 * ntok : 6 * ntok].astype(np.int64) << 8)
        | (fields[6 * ntok : 7 * ntok].astype(np.int64) << 16)
        | (fields[7 * ntok : 8 * ntok].astype(np.int64) << 24)
    )
    if oraw:
        ov = np.frombuffer(oraw, dtype="<u8")
        k = 0
        for t in np.flatnonzero((ll == 0xFFFF) | (ml == 0xFFFF)):
            if ll[t] == 0xFFFF:
                ll[t] = int(ov[k])
                k += 1
            if ml[t] == 0xFFFF:
                ml[t] = int(ov[k])
                k += 1
        if k != ov.shape[0]:
            raise ValueError("LZ overflow list corrupt")
    return ll, ml, dd


class SeqLzHistory:
    """Rolling cross-section dictionary for MODE_SEQLZ: later
    seq sections match into the unpacked bases of earlier ones, closing
    the window gap vs whole-file LZMA (sections are ~16 Mbase; coverage
    redundancy spans the whole run). The usable history is the newest
    whole sections totalling <= cap bases — a pure function of the
    preceding MODE_SEQLZ sections, so encoder and decoder stay in
    lockstep; ranks of a sharded compress start empty, which only FORGOES
    matches (their backward distances still resolve identically at
    decode, where the history may be longer).

    Round 5: one persistent UNPACKED rolling buffer. A section is
    staged contiguously after the history (unpacked straight into the
    buffer on encode; LZ-expanded in place on decode) so the parse and
    the expand see [history | stream] without any per-section history
    unpack or full-history concatenate (the old path transiently
    allocated ~hist+stream+concat per 16-Mbase section). commit() turns the staged stream into history;
    an uncommitted stage is simply overwritten by the next one."""

    def __init__(self, cap_bases: int = 96 << 20):
        self.cap = cap_bases
        self._buf = np.empty(0, dtype=np.uint8)
        self._start = 0  # usable history = _buf[_start:_end)
        self._end = 0
        self._spans: list[int] = []  # whole-section base counts, oldest..
        self._staged = 0  # bases staged at _end (not yet history)

    def _ensure(self, nbases: int) -> None:
        """Room for nbases at _end: compact-in-place when the usable
        history + stream fit the allocation, else grow geometrically
        (bounded: usable <= cap, so capacity tops out near cap + max
        staged stream)."""
        if self._end + nbases <= self._buf.shape[0]:
            return
        used = self._end - self._start
        if used + nbases <= self._buf.shape[0]:
            self._buf[:used] = self._buf[self._start : self._end]
        else:
            newcap = used + nbases
            newcap += newcap >> 2
            nb = np.empty(newcap, dtype=np.uint8)
            nb[:used] = self._buf[self._start : self._end]
            self._buf = nb
        self._start, self._end = 0, used

    def stage(self, packed: np.ndarray, nbases: int):
        """Unpack a packed-base section into the buffer after the current
        history. Returns (parse_buf, parse_from, stream): parse_buf is the
        contiguous [history | stream] view, stream its staged tail."""
        self._ensure(nbases)
        stream = _np_unpack(
            packed[: (nbases + 3) // 4], nbases,
            out=self._buf[self._end : self._end + nbases],
        )
        self._staged = nbases
        return (
            self._buf[self._start : self._end + nbases],
            self._end - self._start,
            stream,
        )

    def stage_raw(self, nbases: int):
        """Reserve nbases after the history for in-place LZ expansion
        (decode). Returns (full_buf_view, hist_len, stream_view)."""
        self._ensure(nbases)
        self._staged = nbases
        return (
            self._buf[self._start : self._end + nbases],
            self._end - self._start,
            self._buf[self._end : self._end + nbases],
        )

    def commit(self) -> None:
        """The staged stream becomes history; evict oldest whole sections
        while the total exceeds cap (matching the old newest-whole-
        sections-totalling-<=cap rule)."""
        self._end += self._staged
        self._spans.append(self._staged)
        self._staged = 0
        total = self._end - self._start
        while self._spans and total > self.cap:
            drop = self._spans.pop(0)
            self._start += drop
            total -= drop

    def hist_len(self) -> int:
        return self._end - self._start


def _encode_lz(arr: np.ndarray, mode: int, lanes: int,
               seq_hist: "SeqLzHistory | None" = None) -> bytes | None:
    """MODE_LZ / MODE_SEQLZ record, or None when LZ does not apply (no
    native library) — never larger-than-raw gating here; the caller
    compares against the rANS/store candidate. For MODE_SEQLZ with a
    history, the base stream is STAGED into the history's rolling buffer
    (zero extra copies: [history | stream] is already contiguous there); the caller commits it iff this
    candidate wins."""
    from ..codec import _native

    if not _native.available():
        return None
    from ..codec.blocks import gather_slices

    n = arr.shape[0]
    if mode == MODE_SEQLZ:
        if seq_hist is not None:
            parse_buf, pfrom, base_stream = seq_hist.stage(arr, 4 * n)
        else:
            base_stream = _native.unpack_2bit(arr, 4 * n)
            parse_buf, pfrom = base_stream, 0
        stream, minm = base_stream, _LZ_MIN_BASES
    else:
        stream, minm = arr, _LZ_MIN_BYTES
        parse_buf, pfrom = arr, 0
    # probe parse: data without cross-record redundancy (e.g. reads of a
    # random or unshared genome) finds no matches — detect that on a
    # prefix before paying the full hash-chain walk (the full parse runs
    # at ~28M bytes/s; an always-on quarter-length probe caps the wasted
    # work on incompressible streams at 25%). With history the probe
    # includes its tail as dictionary, else coverage spread across
    # sections would read as incompressible.
    probe_n = min(4 << 20, max(256 << 10, stream.shape[0] // 4))
    if stream.shape[0] > 2 * probe_n:
        ht_len = min(pfrom, 4 << 20)
        _pl, pml, _pd = _native.lz_parse(
            parse_buf[pfrom - ht_len : pfrom + probe_n], minm,
            parse_from=ht_len,
        )
        if int(pml.sum()) * 8 < probe_n:
            return None
    ll, ml, dd = _native.lz_parse(parse_buf, minm, parse_from=pfrom)
    if ml.shape[0] <= 1 or int(ml.sum()) * 2 < n // 8:
        return None  # too few matches to beat plain rANS — skip the work
    if mode == MODE_SEQLZ:
        lits = _native.pack_2bit(
            gather_slices(base_stream, _lz_lit_starts(ll, ml), ll)
        )
    else:
        lits = gather_slices(arr, _lz_lit_starts(ll, ml), ll)
    # MTF rep-distance transform: errors chop genome matches into
    # same-distance runs; slot codes 0-3 turn the ~3 uniform dist bytes
    # of each resumed match into a near-free spike at 0
    dd = _native.lz_dist_mtf(dd, ml, True)
    fields, oraw = _lz_fields_bytes(ll, ml, dd)
    ntok = ll.shape[0]
    head = bytearray([mode])
    head += int(n).to_bytes(4, "little")
    head += ntok.to_bytes(4, "little")
    head += (len(oraw) // 8).to_bytes(4, "little")
    body = bytearray()
    # each token-field byte PLANE gets its own section (container v2):
    # the dist low bytes are near-uniform (stored wins), the length hi
    # bytes are near-constant, the length lo bytes are peaky — one mixed
    # model over all eight planes cost ~7.1 B/token vs a ~4 B/token
    # entropy floor (measured on a 9x-coverage corpus)
    for p in range(8):
        body += encode_block(
            fields[p * ntok : (p + 1) * ntok], lanes=lanes, label="inner"
        )
    body += oraw
    body += encode_block(lits, lanes=lanes, label="inner")
    return bytes(head) + bytes(body)


def _auto_lanes(n: int, cap: int) -> int:
    lanes = 16
    while lanes < cap and lanes * 2048 < n:
        lanes *= 2
    return lanes


def _lz_lit_starts(ll: np.ndarray, ml: np.ndarray) -> np.ndarray:
    """Start offset of each token's literal run in the original stream."""
    starts = np.zeros(ll.shape[0], dtype=np.int64)
    np.cumsum((ll + ml)[:-1], out=starts[1:])
    return starts


def _decode_lz(buf: memoryview, off: int, decode_section,
               seq_hist: SeqLzHistory | None = None) -> tuple[bytes, int]:
    mode = buf[off]
    if len(buf) - off < 13:
        raise rans_np.RansTruncated("LZ rfqz section truncated (header)")
    n = int.from_bytes(buf[off + 1 : off + 5], "little")
    ntok = int.from_bytes(buf[off + 5 : off + 9], "little")
    nover = int.from_bytes(buf[off + 9 : off + 13], "little")
    # bound header fields BEFORE any allocation: a corrupt/crafted archive
    # must raise, not OOM the decoder (out_len can be 4*n for MODE_SEQLZ)
    if n > _LZ_MAX_OUT or ntok > n + 1 or nover > 3 * ntok + 4:
        raise RfqzFormatError("LZ rfqz section header corrupt")
    off += 13
    planes = []
    for _p in range(8):
        pb, off = decode_block(buf, off, decode_section)
        planes.append(np.frombuffer(pb, dtype=np.uint8))
    if len(buf) - off < 8 * nover:
        raise rans_np.RansTruncated("LZ rfqz section truncated (overflow)")
    oraw = bytes(buf[off : off + 8 * nover])
    off += 8 * nover
    lits_b, off = decode_block(buf, off, decode_section)
    fields = np.concatenate(planes) if ntok else np.zeros(0, np.uint8)
    if fields.shape[0] != 8 * ntok:
        raise ValueError("LZ token fields corrupt")
    ll, ml, dd = _lz_fields_parse(fields, oraw, ntok)
    lits = np.frombuffer(lits_b, dtype=np.uint8)
    from ..codec import _native

    dd = _native.lz_dist_mtf(dd, ml, False)

    if mode == MODE_SEQLZ:
        if seq_hist is not None:
            # expand in place after the rolling history (the dictionary
            # is already contiguous there) and commit the bases directly
            # — no per-section history unpack/copy
            full, hlen, out_bases = seq_hist.stage_raw(4 * n)
            _lz_expand_py(ll, ml, dd, _np_unpack(lits), 4 * n,
                          out=full, start=hlen)
        else:
            out_bases = _lz_expand_py(ll, ml, dd, _np_unpack(lits), 4 * n)
        if _native.available():
            packed = _native.pack_2bit(out_bases)
        else:
            from ..codec import kernels_np as K

            packed = K.pack_2bit(out_bases)
        if seq_hist is not None:
            seq_hist.commit()
        return packed.tobytes(), off
    out = _lz_expand_py(ll, ml, dd, lits, n)
    return out.tobytes(), off


def _np_unpack(packed: np.ndarray, length: int | None = None,
               out: np.ndarray | None = None):
    n = 4 * packed.shape[0] if length is None else length
    from ..codec import _native

    if _native.available():
        return _native.unpack_2bit(packed, n, out=out)
    from ..codec import kernels_np as K

    res = K.unpack_2bit(packed, n)
    if out is None:
        return res
    out[:n] = res
    return out[:n]


def _lz_expand_py(ll, ml, dd, lits: np.ndarray, out_len: int,
                  hist: np.ndarray | None = None,
                  out: np.ndarray | None = None,
                  start: int = 0) -> np.ndarray:
    from ..codec import _native

    if _native.available():
        return _native.lz_expand(ll, ml, dd, lits, out_len, hist=hist,
                                 out=out, start=start)
    # pure-python fallback (decode must work everywhere)
    if out is None:
        start = 0 if hist is None else hist.shape[0]
        out = np.empty(start + out_len, dtype=np.uint8)
        if start:
            out[:start] = hist
    o, lp = start, 0
    end = start + out_len
    for t in range(ll.shape[0]):
        l, m, d = int(ll[t]), int(ml[t]), int(dd[t])
        if l < 0 or m < 0 or lp + l > lits.shape[0] or o + l + m > end:
            raise ValueError("LZ stream corrupt")
        out[o : o + l] = lits[lp : lp + l]
        lp += l
        o += l
        if m:
            if d <= 0 or d > o:
                raise ValueError("LZ stream corrupt (bad dist)")
            if d >= m:
                out[o : o + m] = out[o - d : o - d + m]
            else:
                for j in range(m):  # overlapping copy
                    out[o + j] = out[o - d + j]
            o += m
    if o != end:
        raise ValueError("LZ stream corrupt (short expand)")
    return out[start:end]


def encode_block(data: bytes | np.ndarray, lanes: int = rans_np.DEFAULT_LANES,
                 encode_section=None, label: str | None = None,
                 seq_hist: SeqLzHistory | None = None) -> bytes:
    """One self-contained section record with mode selection.
    encode_section: override for the device kernel path (same signature as
    rans_np.encode_section). label: stream label from RfqChunk.to_segments
    — 'seq' sections try the phase-free base-level LZ (MODE_SEQLZ), other
    large sections try byte LZ (MODE_LZ); smallest candidate wins."""
    arr = (
        np.frombuffer(data, dtype=np.uint8)
        if isinstance(data, (bytes, bytearray, memoryview))
        else np.asarray(data, dtype=np.uint8)
    )
    # lane count adapts to the section size: every lane costs 8 fixed
    # bytes (u32 length + final state), so 4096 lanes = 32 KB — fine for
    # a 16 MB section (0.2%), ruinous for the ~200 KB LZ field planes.
    # `lanes` acts as the cap (the TPU decode parallelism for big
    # sections); small sections drop to ~one lane per 2 KB.
    lanes = _auto_lanes(arr.shape[0], lanes)
    mode, counts0, pair = choose_mode(arr)
    if mode == MODE_STORED:
        best = bytes([MODE_STORED]) + len(arr).to_bytes(4, "little") + arr.tobytes()
    else:
        if encode_section is None:
            enc = rans_np.encode_section(
                arr, order=mode, lanes=lanes, counts0=counts0, pair_counts=pair
            )
        else:
            enc = encode_section(arr, order=mode, lanes=lanes)
        if len(enc) >= arr.shape[0] + 5:  # entropy estimate was optimistic
            best = (
                bytes([MODE_STORED]) + len(arr).to_bytes(4, "little")
                + arr.tobytes()
            )
        else:
            best = enc
    # qual normally skips the LZ try: order-1 rANS beats byte-LZ on
    # ordinary quality streams in every measurement, so the parse there
    # was pure overhead. EXCEPTION (ratio matrix): run-heavy
    # by-col streams from tiny quality alphabets (2-bin RTA3 style) are
    # dominated by repeated run tokens — a tiny distinct-byte alphabet is
    # the cheap tell (the histogram is already computed), and byte-LZ
    # closed a 7.2% loss to xz -9 there while ordinary 40-bin qual
    # streams (many distinct gap bytes) keep skipping the parse.
    qual_lz = label == "qual" and int((counts0 > 0).sum()) <= 8
    if arr.shape[0] >= _LZ_TRY_MIN and (
        label in ("seq", "tail", "names", None) or qual_lz
    ):
        lz_mode = MODE_SEQLZ if label == "seq" else MODE_LZ
        sh = seq_hist if label == "seq" else None
        try:
            lz = _encode_lz(arr, lz_mode, lanes, seq_hist=sh)
        except (OSError, ValueError) as e:
            # only expected unavailability errors; anything else (a real
            # defect in the native parse/pack path) must propagate, not be
            # silently read as "LZ not profitable"
            global _LZ_WARNED
            if not _LZ_WARNED:
                import sys

                print("repaq_tpu: LZ stage unavailable (%s); "
                      "continuing without it" % e, file=sys.stderr)
                _LZ_WARNED = True
            lz = None
        if lz is not None and len(lz) < len(best):
            best = lz
    if (
        seq_hist is not None and label == "seq" and len(best)
        and best[0] == MODE_SEQLZ
    ):
        # history tracks CHOSEN seqlz sections only — the decoder mirrors
        # this from the mode bytes it actually sees. The bases were staged
        # into the rolling buffer by _encode_lz; a losing/failed candidate
        # leaves its stage uncommitted (overwritten by the next section).
        seq_hist.commit()
    return best


def decode_block(buf: memoryview, off: int, decode_section=None,
                 seq_hist: SeqLzHistory | None = None) -> tuple[bytes, int]:
    mode = buf[off]
    if mode == MODE_STORED:
        if len(buf) - off < 5:
            raise rans_np.RansTruncated("stored rfqz section truncated (header)")
        n = int.from_bytes(buf[off + 1 : off + 5], "little")
        if off + 5 + n > len(buf):
            raise rans_np.RansTruncated("stored rfqz section truncated")
        return bytes(buf[off + 5 : off + 5 + n]), off + 5 + n
    if mode in (MODE_LZ, MODE_SEQLZ):
        return _decode_lz(buf, off, decode_section, seq_hist=seq_hist)
    if mode not in (MODE_ORDER0, MODE_ORDER1):
        raise RfqzFormatError("bad rfqz section mode %d" % mode)
    return (decode_section or rans_np.decode_section)(buf, off)


class RfqzWriter:
    """File-like sink: buffers .rfq bytes, emits coded sections."""

    def __init__(self, path_or_stream, block_size: int = DEFAULT_BLOCK,
                 lanes: int = rans_np.DEFAULT_LANES, encode_section=None,
                 container_header: bool = True):
        """container_header=False emits a bare section stream (no magic):
        the multi-process shard path concatenates per-rank section streams
        under one container header (sections are self-delimiting)."""
        if hasattr(path_or_stream, "write"):
            self._out = path_or_stream
            self._own = False
        else:
            self._out = open(path_or_stream, "wb")
            self._own = True
        self._block = block_size
        self._lanes = lanes
        self._buf = bytearray()
        self._enc = encode_section
        self._seq_hist = SeqLzHistory()
        self.coded_bytes = 0
        if container_header:
            self._out.write(MAGIC + bytes([VERSION]))
            self.coded_bytes = 5
        self.raw_bytes = 0

    # Stream segments below this stay in the mix. 8 KB (was 96 KB in v2):
    # the per-chunk PE tail (overlap flags + N positions, ~58 KB at 16
    # Mbase chunks) compresses 2x better under its own MODE_LZ section
    # than mixed with coords remnants, and compact tables (v3) shrank the
    # fixed cost of a small section.
    _SPLIT_MIN = 8 * 1024

    def write(self, data: bytes) -> int:
        self._buf += data
        self.raw_bytes += len(data)
        while len(self._buf) >= self._block:
            self._flush_one(self._block)
        return len(data)

    def write_segments(self, segments) -> None:
        """Write labeled wire-order segments (RfqChunk.to_segments),
        cutting sections at stream boundaries: sequence, quality, and
        coordinate streams have very different statistics, and giving each
        its own section model is worth several ratio points over mixing
        them. Byte stream (and therefore the decoded .rfq) is unchanged —
        only the section boundaries move."""
        for label, data in segments:
            if (
                label in ("seq", "qual", "coords", "tail", "names")
                and len(data) >= self._SPLIT_MIN
            ):
                if self._buf:
                    self._flush_one(len(self._buf))
                self.raw_bytes += len(data)
                rec = encode_block(
                    data, lanes=self._lanes, encode_section=self._enc,
                    label=label, seq_hist=self._seq_hist,
                )
                self.coded_bytes += len(rec)
                self._out.write(rec)
            else:
                self.write(data)

    def _flush_one(self, size: int) -> None:
        chunk = bytes(self._buf[:size])
        del self._buf[:size]
        rec = encode_block(chunk, lanes=self._lanes, encode_section=self._enc)
        self.coded_bytes += len(rec)
        self._out.write(rec)

    def close(self) -> None:
        if self._buf:
            self._flush_one(len(self._buf))
        if self._own:
            self._out.close()
        else:
            self._out.flush()


class RfqzReader:
    """File-like source: decodes sections lazily; read(n) like a pipe.

    Streams: compressed bytes are fetched in 4MB slices and consumed
    sections are trimmed, so memory stays O(section) — matching the pipe
    semantics of the xz stage this replaces — instead of holding the whole
    archive plus its decoded image resident.
    """

    _FETCH = 4 << 20

    def __init__(self, path_or_stream, decode_section=None):
        if hasattr(path_or_stream, "read"):
            self._f = path_or_stream
            self._own = False
        else:
            self._f = open(path_or_stream, "rb")
            self._own = True
        self._dec = decode_section
        self._comp = bytearray()
        self._eof = False
        self._consumed = 0  # bytes trimmed off _comp (for error offsets)
        while len(self._comp) < 5 and self._fill():
            pass
        if len(self._comp) < 5 or self._comp[:4] != MAGIC:
            raise RfqzFormatError(
                "not an RFQZ file (bad magic); expected a .rfqz produced by "
                "this tool"
            )
        if self._comp[4] != VERSION:
            raise RfqzFormatError(
                "unsupported RFQZ container version %d" % self._comp[4]
            )
        del self._comp[:5]
        self._consumed = 5
        self._buf = bytearray()
        self._pos = 0
        self._seq_hist = SeqLzHistory()

    def _fill(self) -> bool:
        if self._eof:
            return False
        data = self._f.read(self._FETCH)
        if not data:
            self._eof = True
            return False
        self._comp += data
        return True

    def _pull(self) -> bool:
        while True:
            if not self._comp and self._eof:
                return False
            # NOTE the dance around buffer exports: decode errors must not
            # keep views of self._comp alive (via the exception traceback)
            # or the bytearray cannot be grown by _fill; record the error,
            # let the except block close (python clears the traceback),
            # then release the memoryview and act.
            mv = memoryview(self._comp)
            err = None
            try:
                data, end = decode_block(
                    mv, 0, self._dec, seq_hist=self._seq_hist
                )
            except (IndexError, ValueError, RfqzFormatError) as e:
                # RansTruncated / IndexError mean the section extends past
                # the buffered bytes — retry after fetching more. Anything
                # else (bad mode byte, corrupt tables, lane-table
                # violations) is genuine corruption: raise immediately
                # instead of buffering the rest of the archive.
                retryable = isinstance(e, (IndexError, rans_np.RansTruncated))
                err = (retryable, str(e))
            finally:
                mv.release()
            if err is not None:
                retryable, msg = err
                if retryable and self._fill():
                    continue
                if retryable and not self._comp:
                    return False  # clean end exactly at a section boundary
                raise RfqzFormatError(
                    "corrupt or truncated RFQZ section at offset %d: %s"
                    % (self._consumed, msg)
                )
            del self._comp[:end]
            self._consumed += end
            if self._pos:
                del self._buf[: self._pos]
                self._pos = 0
            self._buf += data
            return True

    def read(self, n: int = -1) -> bytes:
        if n < 0:
            while self._pull():
                pass
            out = bytes(self._buf[self._pos :])
            self._buf = bytearray()
            self._pos = 0
            return out
        while len(self._buf) - self._pos < n and self._pull():
            pass
        out = bytes(self._buf[self._pos : self._pos + n])
        self._pos += len(out)
        return out

    # RfqHeader.read / RfqChunk.read use stream.read(k) only
    def close(self) -> None:
        if self._own:
            self._f.close()
