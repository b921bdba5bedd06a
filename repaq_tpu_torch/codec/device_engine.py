"""The ``--engine device`` chunk codec on a torch device: the PyTorch port
of repaq_tpu/codec/device_engine.py, for flat chunks (single-end files,
ragged single-end chunks, paired-end chunks that do not interleave) and
for PE-interleaved chunks of one read length.

Division of labour per chunk, as in the JAX engine:
  device  2-bit pack + quality bin classify (the frontend kernel), by-col
          quality emission, N-position stream, X/Y coordinate streams,
          and for PE revcomp of the odd reads, overlap search and elision
          compaction (encode); unpack (kernel), token FSM (kernel), by-col
          quality decode, N restore, and for PE overlap expansion and
          revcomp (decode)
  host    FASTQ parse, name metadata and all-same predicates, the exact
          stream-size caps, the PE expansion tables, container assembly

Routes to the host engine (codec/vectorized.py), byte-identical by
construction and counted in ``stats``: PE-interleaved chunks of ragged
read lengths, chunks outside the size window or past the int32 key
packing, non-by-column quality modes, palettes of 64 bins (past the
frontend's B <= 63) and the optimistic quality-buffer overflow. Each
route is decided from the chunk; none is a reaction to an exception.

Interleaved chunks whose header lacks the overlap flag take the PE step
with the overlap search off (revcomp, no elision), as vectorized encodes
them; the JAX engine sends them to its flat step (ROADMAP C2).
"""

from __future__ import annotations

import os
import threading

import numpy as np
import torch

from ..constants import BIT_PE_INTERLEAVED
from ..format.chunk import RfqChunk
from ..format.header import RfqHeader
from ..format.header import quality_stats as host_quality_stats
from ..ops import device_streams as ds
from ..ops import kernels
from ..pipeline import EngineConfig
from . import kernels_np as K
from . import vectorized
from .blocks import ReadBlock, lens_to_offsets

_G = ord("G")
_N = ord("N")

# named ranges of a step's stages in a torch.profiler trace (a flag test
# when no profiler runs); tools/profile_torch_pe.py reads them
_span = torch.profiler.record_function

# the chunk-size window of the JAX engine (device_engine.py:51-52), kept so
# that chunks route as they do there: 12 Mbase stays inside JAX's int32
# bid<<24|pos grouping keys after bucketing (the JAX decode's (pos+len)<<6
# packing set it too); the port packs neither, its compaction and decode
# take any int32 size
_MAX_DEVICE_BASES = 12 << 20
_MIN_DEVICE_BASES = 128 << 10
# the frontend takes B <= 63 (the bin id in 6 bits of its meta byte), and
# the JAX engine's quality decode packs it so too: the port keeps the limit
# so that chunks route as they do there. The by-column mode allows 64 bins
# when the major qual doubles as the N qual, and those chunks take the host
# route
_MAX_BINS = 63


def _bucket(x: int, lo: int = 1024) -> int:
    """Smallest c >= x of the form 2^k or 1.5*2^k (>= lo)."""
    c = lo
    while c < x:
        if c + (c >> 1) >= x:
            return c + (c >> 1)
        c *= 2
    return c


def _decode_n_cap(pe: bool, read_lens) -> int:
    """Bases the device decode pads a chunk to: whole (reads, L) rows of a
    PE-interleaved chunk, else its total rounded up to a bucket."""
    if pe:
        return _bucket(len(read_lens), lo=256) * int(read_lens[0])
    return _bucket(int(read_lens.sum()), lo=4096)


def _qfetch(nonmajor: int, esc: int, nbins: int, n_cap: int) -> int:
    """The optimistic quality buffer: with dense non-major positions nearly
    every token is 1 byte, so ~1.25 bytes a token covers the stream; an
    overflow (qual_len > qfetch) takes the host route."""
    if nonmajor * 16 >= n_cap:
        return _bucket(4 * nbins + nonmajor + nonmajor // 4 + 5 * esc + 4096)
    return min(_bucket(4 * nbins + 4 * nonmajor + 5 * esc + 8),
               4 * nbins + n_cap + 8)


def _cut(raw: np.ndarray, sizes, nlens: int):
    """Split a step's u8 payload into parts of the given sizes, in concat
    order, and the nlens int32 lengths that end it."""
    parts, off = [], 0
    for sz in sizes:
        parts.append(raw[off: off + sz])
        off += sz
    return parts, [int(v) for v in raw[off: off + 4 * nlens].view("<i4")]


def _elide(tseq: torch.Tensor, ov: torch.Tensor, n_reads: int):
    """The stored bases of a (b_cap, L) transformed PE grid, concatenated
    and 'G'-padded to b_cap * L, and their count: rows past n_reads store
    nothing, odd rows drop |ov| bases of their pair's overlap, from the
    front for a forward one."""
    dev = tseq.device
    b_cap, L = tseq.shape
    zeros_p = torch.zeros_like(ov)
    drop_row = torch.stack([zeros_p, ov.abs()], dim=1).reshape(-1)
    start_row = torch.stack([zeros_p, ov.clamp(min=0)], dim=1).reshape(-1)
    rvalid = torch.arange(b_cap, device=dev) < n_reads
    stored_row = torch.where(rvalid, L - drop_row, 0).to(torch.int32)
    cum = torch.cumsum(stored_row, 0, dtype=torch.int32)
    # each valid row's span at its offset in the concatenation, the rest
    # 'G': JAX's sort by destination as one gather (the pad rows, which
    # store nothing, are left out of it)
    out = kernels.concat_row_spans(tseq[:n_reads], start_row[:n_reads],
                                   stored_row[:n_reads],
                                   (cum - stored_row)[:n_reads], b_cap * L,
                                   _G)
    return out, cum[-1]


class DeviceEngine:
    """Chunk codec on one torch device. Safe to call from the pipeline's
    worker threads: the palette cache and the stats take a lock, and each
    chunk's tensors are its own."""

    def __init__(self, device, min_bases: int = _MIN_DEVICE_BASES,
                 max_bases: int = _MAX_DEVICE_BASES):
        self.device = torch.device(device)
        self.min_bases = min_bases
        self.max_bases = max_bases
        self._lock = threading.Lock()
        self._palette = None  # (bins on device, major) of one header
        self._palette_key = None
        self.stats = {"device_chunks": 0, "host_chunks": 0,
                      "device_decodes": 0, "host_decodes": 0}

    def config(self) -> EngineConfig:
        """The pipeline.EngineConfig that runs this engine."""
        return EngineConfig(
            make_header_se=lambda b: vectorized.make_header_se(
                b, stats_fn=self.quality_stats),
            make_header_pe=lambda b: vectorized.make_header_pe(
                b, stats_fn=self.quality_stats),
            encode_chunk=self.encode_chunk,
            decode_chunk=self.decode_chunk,
            name="device",
        )

    def _count(self, key: str) -> None:
        with self._lock:
            self.stats[key] += 1

    def _palette_for(self, header: RfqHeader):
        key = bytes(header.qual_buf)
        with self._lock:
            if self._palette_key != key:
                bins = np.asarray(header.normal_qual_buf(), dtype=np.uint8)
                self._palette = (torch.from_numpy(bins).to(self.device),
                                 int(header.major_qual()))
                self._palette_key = key
            return self._palette

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        if not a.flags.writeable:  # torch.from_numpy takes writable arrays
            a = a.copy()
        return torch.from_numpy(a).to(self.device)

    # ------------------------------------------------------------------
    # header inference (reference rfqheader.cpp:130-237 scan on device)
    # ------------------------------------------------------------------

    def quality_stats(self, block: ReadBlock) -> dict:
        """The first-chunk quality scan on the device: histogram plus the
        order-dependent N-policy reductions, one ``kernels.qual_stats``
        call and one copy back. The host scan serves tiny chunks and
        chunks with invalid bases (its error names the offending char)."""
        n = int(block.qual_flat.shape[0])
        if n == 0 or n < self.min_bases:
            return host_quality_stats(block.seq_flat, block.qual_flat)
        with _span("enc.stats"):
            stats = kernels.qual_stats(self._upload(block.seq_flat),
                                       self._upload(block.qual_flat)).cpu()
        ge128, invalid, n_count, fq, ndiff, nonn = stats[128:].tolist()
        if invalid > 0:
            return host_quality_stats(block.seq_flat, block.qual_flat)
        return {
            "empty": False,
            "qual_ge128": ge128 > 0,
            "invalid_lower": False,
            "invalid_other": False,
            "qual_counts": stats[:128].numpy().astype(np.int64),
            "n_count": n_count,
            "first_n_qual": fq if n_count else -1,
            "n_qual_differs": ndiff > 0,
            "nonn_after_matches": nonn > 0,
        }

    # ------------------------------------------------------------------
    # encode
    # ------------------------------------------------------------------

    def encode_chunk(self, header: RfqHeader, block: ReadBlock,
                     is_pe: bool = False) -> RfqChunk | None:
        if block.n == 0:
            return None
        a = vectorized.analyze_chunk(header, block, is_pe)
        n_total = int(a.seq_lens.sum())
        eligible = (
            header.encode_qual_by_col()
            and header.normal_qual_bins() <= _MAX_BINS
            and self.min_bases <= n_total <= self.max_bases
            and header.has_x() == header.has_y()
        )
        chunk = None
        if eligible and not a.can_interleave:
            chunk = self._encode_se_device(header, block, a)
        elif (eligible and a.read_len_same and a.seq_lens[0] > 0
              and block.n % 2 == 0):
            # the PE step works in a (reads, L) grid of whole pairs
            chunk = self._encode_pe_device(header, block, a)
        if chunk is None:
            self._count("host_chunks")
            return vectorized.encode_chunk(header, block, is_pe)
        self._count("device_chunks")
        return chunk

    def _host_caps(self, header: RfqHeader, block: ReadBlock):
        """Exact stream-size precursors from one cheap host pass: they make
        the device functions' caps hard bounds."""
        in_tab = np.zeros(256, dtype=bool)
        in_tab[np.frombuffer(header.qual_buf, dtype=np.uint8)] = True
        qual = block.qual_flat
        nonmajor = int((qual != header.major_qual()).sum())
        esc = int((~in_tab[qual]).sum())
        npos = int((block.seq_flat == _N).sum())
        return nonmajor, esc, npos

    def _stream_caps(self, header, block, n_cap: int) -> dict:
        """The encode step's static caps for a chunk padded to n_cap bases,
        each a hard bound from the exact host counts."""
        nonmajor, esc, npos = self._host_caps(header, block)
        nbins = int(header.normal_qual_bins())
        # positions stream: 1 byte per match + <n/128 two-byte gaps +
        # <n/16384 four-byte gaps (deltas sum to <= n)
        return dict(
            nm_cap=_bucket(nonmajor),
            esc_cap=0 if esc == 0 else _bucket(esc, lo=8),
            np_cap=_bucket(npos, lo=8),
            qfetch=_qfetch(nonmajor, esc, nbins, n_cap),
            npfetch=_bucket(min(4 * npos, npos + n_cap // 64) + 16, lo=64),
            # the N-position stream is skipped when the header restores N
            # via nBaseQual, or the chunk has no Ns
            want_npos=header.encode_n_pos() and npos > 0,
        )

    def _encode_se_device(self, header, block, a) -> RfqChunk | None:
        """Flat streams of a non-interleaved chunk (reference
        rfqcodec.cpp:163-586 minus the PE branches). None: host route."""
        n = int(a.seq_lens.sum())
        b = block.n
        n_cap = _bucket(n, lo=4096)
        if n_cap >= (1 << 24):
            return None  # routed as the JAX engine routes it (its bid<<24|pos
            # grouping keys); the port has no such packing
        caps = self._stream_caps(header, block, n_cap)
        bins, major = self._palette_for(header)
        b_cap = _bucket(b, lo=256)
        has_xy = header.has_x()

        seq_pad = np.full(n_cap, _G, dtype=np.uint8)
        seq_pad[:n] = block.seq_flat
        qual_pad = np.full(n_cap, major, dtype=np.uint8)
        qual_pad[:n] = block.qual_flat
        xy = None
        if has_xy:
            xy = np.zeros((2, b_cap), dtype=np.int32)
            xy[0, :b] = a.xs
            xy[1, :b] = a.ys
        raw = self._encode_se_step(
            self._upload(seq_pad), self._upload(qual_pad),
            None if xy is None else self._upload(xy), b, bins, major,
            int(header.normal_qual_bins()), **caps).cpu().numpy()
        xy_sz = (3 * b_cap + 8) if has_xy else 0
        parts, lens = _cut(raw, [n_cap // 4, caps["qfetch"], caps["npfetch"],
                                 xy_sz, xy_sz], 4)
        return self._assemble(header, block, a, np.zeros(0, dtype=np.int64),
                              parts[0][: (n + 3) // 4], parts[1:], lens, caps)

    @staticmethod
    def _assemble(header, block, a, ov, packed, parts, lens, caps):
        """Container assembly from an encode step's streams: parts are the
        quality, N-position, X and Y buffers, lens their lengths. None when
        the optimistic quality buffer overflowed: host route."""
        qual_all, npos_all, x_all, y_all = parts
        qual_len, npos_len, x_len, y_len = lens
        if qual_len > caps["qfetch"] or npos_len > caps["npfetch"]:
            return None
        has_xy = header.has_x()
        return vectorized.assemble_chunk(
            header, block, a, ov, packed.tobytes(),
            qual_all[:qual_len].tobytes(),
            npos_all[:npos_len].tobytes() if header.encode_n_pos() else b"",
            x_bytes=x_all[:x_len].tobytes() if has_xy else None,
            y_bytes=y_all[:y_len].tobytes() if has_xy else None,
        )

    def _encode_se_step(self, seq, qual, xy, n_reads, bins, major, nbins, *,
                        esc_cap, nm_cap, np_cap, qfetch, npfetch, want_npos):
        """The device work of one flat encode: one u8 payload of packed
        bases, quality stream, N-position stream, X and Y streams and the
        four int32 stream lengths."""
        n_cap = seq.shape[0]
        with _span("enc.frontend"):
            packed, meta = kernels.encode_frontend(seq, qual, bins, major)
        with _span("enc.streams"):
            qual_out, qual_len = ds.qualcol_encode_device(
                meta, qual, nbins, esc_cap=esc_cap, nonmajor_cap=nm_cap,
                out_size=qfetch,
            )
            npos = (ds.encode_positions_from_meta(meta, n_cap, npfetch,
                                                  pos_cap=np_cap)
                    if want_npos else None)
            return self._payload(packed, qual_out[:qfetch], qual_len, npos,
                                 npfetch, xy, n_reads)

    @staticmethod
    def _payload(packed, qual_out, qual_len, npos, npfetch, xy, n_valid,
                 tail=None):
        """One u8 tensor: packed bases, the quality stream, the N-position
        stream (npos: (out, len), or None for none), the X and Y streams of
        the (2, cap) xy (or None), then tail's u8 buffer (tail: (buffer,
        [int32 lengths]) or None); it ends in the int32 lengths of quality,
        N-position, X, Y and tail's lengths."""
        dev = packed.device
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        if npos is None:
            npos = torch.zeros(npfetch, dtype=torch.uint8, device=dev), zero
        if xy is not None:
            xy_out, x_len, y_len = ds.coords_encode2_device(
                xy, 3 * xy.shape[1] + 8, n_valid=n_valid)
        else:
            xy_out = torch.zeros(0, dtype=torch.uint8, device=dev)
            x_len = y_len = zero
        lens = [qual_len, npos[1], x_len, y_len]
        bufs = [packed, qual_out, npos[0], xy_out]
        if tail is not None:
            bufs.append(tail[0])
            lens += tail[1]
        lens = torch.stack(lens).to(torch.int32)
        return torch.cat(bufs + [lens.view(torch.uint8)])

    # -- PE interleaved ------------------------------------------------

    def _encode_pe_device(self, header, block, a) -> RfqChunk | None:
        """PE-interleaved chunk of one read length L: revcomp of the odd
        reads, overlap search and elision compaction on the device
        (reference rfqcodec.cpp:279-407, 1391-1438). None: host route."""
        L = int(a.seq_lens[0])
        b = block.n
        pairs = b // 2
        b_cap = _bucket(b, lo=256)  # even: a bucket >= 256
        p_cap = b_cap // 2
        n_cap = b_cap * L
        if n_cap >= (1 << 24):
            return None  # routed as the JAX engine routes it (its bid<<24|pos
            # grouping keys); the port has no such packing
        caps = self._stream_caps(header, block, n_cap)
        bins, major = self._palette_for(header)
        has_xy = header.has_x()

        seq_mat = np.full((b_cap, L), _G, dtype=np.uint8)
        seq_mat[:b] = block.seq_flat.reshape(b, L)
        qual_mat = np.full((b_cap, L), major, dtype=np.uint8)
        qual_mat[:b] = block.qual_flat.reshape(b, L)
        xy = None
        if has_xy:  # one X/Y per pair
            xy = np.zeros((2, p_cap), dtype=np.int32)
            xy[0, :pairs] = a.xs[0::2]
            xy[1, :pairs] = a.ys[0::2]
        raw = self._encode_pe_step(
            self._upload(seq_mat), self._upload(qual_mat),
            None if xy is None else self._upload(xy), b, bins, major,
            int(header.normal_qual_bins()),
            shift=int(header.overlap_shift), overlap=a.encode_overlap,
            **caps).cpu().numpy()
        xy_sz = (3 * p_cap + 8) if has_xy else 0
        parts, lens = _cut(raw, [n_cap // 4, caps["qfetch"], caps["npfetch"],
                                 xy_sz, xy_sz, p_cap], 5)
        total_stored = lens[4]
        ov = (parts[5][:pairs].view(np.int8).astype(np.int64)
              - header.overlap_shift)
        return self._assemble(header, block, a, ov,
                              parts[0][: (total_stored + 3) // 4],
                              parts[1:5], lens[:4], caps)

    def _encode_pe_step(self, seq_mat, qual_mat, xy, n_reads, bins, major,
                        nbins, *, shift, overlap, esc_cap, nm_cap, np_cap,
                        qfetch, npfetch, want_npos):
        """The device work of one PE-interleaved encode. seq_mat, qual_mat:
        (b_cap, L) u8, rows past n_reads padded with 'G' and the major
        qual; the step owns them and transforms their odd rows in place.
        overlap: search and elide overlaps (the header's flag), else every
        pair stores ov = 0. Returns the payload of _payload with the
        (b_cap/2,) u8 overlap bytes and the stored base count at its end."""
        n_pairs = n_reads // 2
        # in place, one launch: the odd reads' revcomp (vectorized's
        # complement table, as the host engine transforms them), the
        # overlap search (reference rfqcodec.cpp:1391-1438) and the
        # encode-side shift clamp (rfqcodec.cpp:379-382)
        with _span("enc.pairs"):
            ov = kernels.pe_encode_pairs(seq_mat, qual_mat, n_pairs, shift,
                                         overlap)
        with _span("enc.compaction"):
            seq_concat, total_stored = _elide(seq_mat, ov, n_reads)
        qual_flat = qual_mat.reshape(-1)
        n_cap = qual_flat.shape[0]
        with _span("enc.frontend"):  # over the elided seq, the full qual
            packed, meta = kernels.encode_frontend(seq_concat, qual_flat,
                                                   bins, major)
        with _span("enc.streams"):
            qual_out, qual_len = ds.qualcol_encode_device(
                meta, qual_flat, nbins, esc_cap=esc_cap, nonmajor_cap=nm_cap,
                out_size=qfetch)
            npos = (ds.encode_positions_from_meta(meta, n_cap, npfetch,
                                                  pos_cap=np_cap)
                    if want_npos else None)
            ov_store = ((ov + shift) & 0xFF).to(torch.uint8)
            return self._payload(packed, qual_out[:qfetch], qual_len, npos,
                                 npfetch, xy, n_pairs,
                                 (ov_store, [total_stored]))

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------

    def decode_chunk(self, header: RfqHeader, chunk: RfqChunk) -> ReadBlock:
        n = chunk.reads
        if n == 0:
            return ReadBlock.from_reads([])
        read_lens = chunk.read_lengths().astype(np.int64)
        n_total = int(read_lens.sum())
        pe = bool(chunk.flags & BIT_PE_INTERLEAVED)
        L = int(read_lens[0])
        eligible = (
            header.encode_qual_by_col()
            and header.normal_qual_bins() <= _MAX_BINS
            and n_total > 0
            and self.min_bases <= n_total <= self.max_bases
            # the PE step works in a (reads, L) grid of whole pairs
            and (not pe or (bool((read_lens == L).all()) and n % 2 == 0))
        )
        block = None
        if eligible and pe:
            block = self._decode_device_pe(header, chunk, n, L, read_lens)
        elif eligible:
            block = self._decode_device_flat(header, chunk, n, read_lens)
        if block is None:
            self._count("host_decodes")
            return vectorized.decode_chunk(header, chunk)
        self._count("device_decodes")
        return block

    def _decode_device_flat(self, header, chunk, b,
                            read_lens) -> ReadBlock | None:
        """Non-interleaved decode (uniform or ragged read lengths): the
        streams are position-addressed, so the device needs only the total
        length; per-read offsets stay on the host for assembly (reference
        rfqcodec.cpp:1049-1260 minus the PE branches). None: host route."""
        n_total = int(read_lens.sum())
        if (n_total + 3) // 4 != len(chunk.seq_buf):
            return None  # corrupt container: the host path raises
        n_cap = _decode_n_cap(False, read_lens)
        raw = self._decode_run(header, chunk, n_cap)
        if raw is None:
            return None
        seq = raw[:n_total].copy()
        qual = raw[n_cap: n_cap + n_total].copy()
        return vectorized.assemble_block(
            header, chunk, b, read_lens, lens_to_offsets(read_lens), seq, qual
        )

    def _decode_device_pe(self, header, chunk, b, L,
                          read_lens) -> ReadBlock | None:
        """PE-interleaved decode of b reads of length L: the overlap
        expansion (when the header elides overlaps) and the revcomp of the
        odd reads on the device (reference rfqcodec.cpp:860-901). None:
        host route."""
        n_cap = _decode_n_cap(True, read_lens)
        b_cap = n_cap // L
        stored = np.full(b, L, dtype=np.int64)
        tables = None
        if header.encode_pe_by_overlap():
            ovb = np.frombuffer(chunk.overlap_buf, dtype=np.int8)
            if ovb.shape[0] != b // 2:
                return None  # corrupt container: the host path raises
            ov = ovb.astype(np.int64) - header.overlap_shift
            stored[1::2] -= np.abs(ov)
            if (stored < 0).any():
                return None
            # per row: stored offset, forward and backward overlap, and
            # the mate's stored offset (odd rows only)
            off = np.cumsum(stored) - stored
            tab = np.zeros((4, b_cap), dtype=np.int32)
            tab[0, :b] = off
            tab[1, 1:b:2] = np.maximum(ov, 0)
            tab[2, 1:b:2] = np.maximum(-ov, 0)
            tab[3, 1:b:2] = off[0:b:2]
            tables = self._upload(tab)
        if (int(stored.sum()) + 3) // 4 != len(chunk.seq_buf):
            return None  # corrupt container: the host path raises
        raw = self._decode_run(header, chunk, n_cap, L=L, tables=tables)
        if raw is None:
            return None
        n_total = b * L
        lens = np.full(b, L, dtype=np.int64)
        return vectorized.assemble_block(
            header, chunk, b, lens, lens_to_offsets(lens),
            raw[:n_total].copy(), raw[n_cap: n_cap + n_total].copy())

    def _decode_run(self, header, chunk, n_cap: int, **pe):
        """Upload a chunk's streams padded for n_cap bases and run the
        decode step; its (2 * n_cap,) u8 payload as numpy, or None for the
        host route."""
        if n_cap >= (1 << 24):
            return None  # routed as the JAX engine routes it (its decode
            # packs (pos + length) << 6 into int32); the port has no such
            # packing
        nbins = int(header.normal_qual_bins())
        qual_len = len(chunk.qual_buf)
        npos_len = len(chunk.npos_buf) if header.encode_n_pos() else 0
        caps = self.decode_caps(header, chunk, n_cap)
        if caps is None:
            return None  # corrupt quality stream: the host path raises
        qb_cap, nb_cap, _np_cap, qcaps = caps

        packed = np.zeros(n_cap // 4, dtype=np.uint8)
        packed[: len(chunk.seq_buf)] = np.frombuffer(chunk.seq_buf,
                                                     dtype=np.uint8)
        qual_buf = np.zeros(qb_cap, dtype=np.uint8)
        qual_buf[:qual_len] = np.frombuffer(chunk.qual_buf, dtype=np.uint8)
        npos_buf = np.zeros(nb_cap, dtype=np.uint8)
        if npos_len:
            npos_buf[:npos_len] = np.frombuffer(chunk.npos_buf,
                                                dtype=np.uint8)
        bins, major = self._palette_for(header)
        return self._decode_step(
            self._upload(packed), self._upload(qual_buf), qual_len,
            self._upload(npos_buf), npos_len, bins, major, nbins,
            qcaps=qcaps,
            has_npos=bool(header.encode_n_pos()),
            nbq=int(header.n_base_qual), **pe,
        ).cpu().numpy()

    @classmethod
    def decode_caps(cls, header, chunk, n_cap: int | None = None):
        """The device decode's caps for a chunk padded to n_cap bases (by
        default as decode_chunk pads it): (quality buffer, N-position
        buffer, N positions, quality-stream caps), or None for a
        length-corrupt quality stream. The parse reads the quality buffer;
        the N positions' cap is the JAX engine's, which the tests hand
        both packages (the port's decode parses the N stream into runs
        and reads none)."""
        if n_cap is None:
            n_cap = _decode_n_cap(bool(chunk.flags & BIT_PE_INTERLEAVED),
                                  chunk.read_lengths())
        npos_len = len(chunk.npos_buf) if header.encode_n_pos() else 0
        return cls._decode_caps(n_cap, len(chunk.qual_buf), npos_len, chunk,
                                int(header.normal_qual_bins()))

    @staticmethod
    def _decode_caps(n_cap: int, qual_len: int, npos_len: int, chunk,
                     nbins: int):
        """Decode-side caps, each the least of a ladder of fractions of
        the chunk geometry (n_cap/16 .. n_cap) that holds the exact count
        from one host walk over the compressed quality bytes. None for a
        length-corrupt quality stream."""

        def geo(x, lo=1024):
            for num, den in ((1, 16), (3, 32), (1, 8), (3, 16), (1, 4),
                             (3, 8), (1, 2), (3, 4), (1, 1)):
                c = max(lo, (n_cap * num) // den)
                if c >= x:
                    return c
            return n_cap + lo  # above n_cap (table and record slack)

        qb_cap = geo(qual_len + 4 * nbins + 16)
        nb_cap = geo(npos_len + 8, lo=64)
        np_cap = geo(min(32 * npos_len + 8, n_cap), lo=64)
        counts = K.qualcol_decode_counts(
            np.frombuffer(chunk.qual_buf, dtype=np.uint8), nbins)
        if counts is None:
            return None
        t, c, esc = counts
        tok_cap = geo(t, lo=512)
        pos_cap = geo(c, lo=512)
        esc_cap = 0 if esc == 0 else geo(esc, lo=8)
        # run tokens (covering >= 2 positions) number <= positions -
        # tokens; run_cap picks the JAX engine's branch (its (run, 4, 31)
        # grid while small, else the slot-space rebuild). The port's decode
        # writes every run whole and selects nothing by it (nor by pos_cap):
        # both stay so that the tests hand both packages the same caps
        run_cnt = max(0, c - t)
        run_cap = (geo(run_cnt + 2, lo=64) if run_cnt * 31 <= max(4096, c)
                   else None)
        return qb_cap, nb_cap, np_cap, (tok_cap, pos_cap, esc_cap, run_cap)

    def _decode_step(self, packed, qual_buf, qual_len, npos_buf, npos_len,
                     bins, major, nbins, *, qcaps, has_npos, nbq,
                     L=None, tables=None):
        """The device work of one decode: one u8 payload of the (n_cap,)
        bases and the (n_cap,) quality chars. L: a PE-interleaved chunk of
        (n_cap / L, L) reads, whose odd rows are reverse-complemented back;
        tables: its (4, n_cap / L) int32 overlap expansion tables (stored
        offset, forward and backward overlap, the mate's stored offset),
        None when the header stores no overlaps."""
        n_cap = 4 * packed.shape[0]
        tok_cap, pos_cap, esc_cap, run_cap = qcaps
        with _span("dec.unpack"):
            seq = kernels.unpack_bases(packed)
            if has_npos and npos_len:  # in stored (elided) space
                # each token's run of N positions, at most one a byte
                start, count = kernels.positions_parse(npos_buf, npos_len,
                                                       npos_len)
                with _span("dec.nscatter"):
                    kernels.fill_runs(seq, start, count, _N)
        restore_n = not has_npos and nbq < 128
        with _span("dec.qual"):
            qual = ds.qualcol_decode_device(
                qual_buf, nbins, bins, major, n_cap, qual_len,
                tok_cap=tok_cap, pos_cap=pos_cap, esc_cap=esc_cap,
                run_cap=run_cap,
            )
            if restore_n and L is None:
                seq = torch.where(qual == nbq, _N, seq)
        if L is not None:
            # one launch: the overlap expansion (reference
            # rfqcodec.cpp:860-901), the N restore, the odd reads' revcomp
            # and the payload (the quality decode does not read seq)
            with _span("dec.rows"):
                return kernels.pe_decode_rows(seq, qual, tables, L,
                                              nbq if restore_n else None)
        return torch.cat([seq, qual])


def make_engine(device) -> DeviceEngine:
    """A DeviceEngine on ``device``. REPAQ_DEVICE_MIN_BASES /
    REPAQ_DEVICE_MAX_BASES override the size window (tests put tiny
    fixtures on the device path)."""
    return DeviceEngine(
        device,
        min_bases=int(os.environ.get("REPAQ_DEVICE_MIN_BASES",
                                     _MIN_DEVICE_BASES)),
        max_bases=int(os.environ.get("REPAQ_DEVICE_MAX_BASES",
                                     _MAX_DEVICE_BASES)),
    )


def make_engine_config(device) -> EngineConfig:
    """pipeline.EngineConfig of ``make_engine(device)``: header inference
    with the device quality scan, chunk codec on the device with the
    documented host routes."""
    return make_engine(device).config()
