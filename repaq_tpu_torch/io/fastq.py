"""FASTQ input/output.

``FastqReader`` reproduces the reference's buffered 4-line reader semantics
(reference fastqreader.cpp): 1 MB fetch granularity, transparent gzip for
``.gz`` names, and the ``has_no_line_break_at_end`` flag whose *timing*
decides which chunks carry the no-trailing-newline flag.

Two scan modes:

- **fast** (default): records are parsed in bulk with numpy straight into
  ReadBlock arrays — no per-read objects. Valid for windows free of '\\r'
  and empty lines, where the reference's quirky line splitting equals plain
  '\\n' splitting. The reference's lazy-fetch flag timing is modeled
  arithmetically: after consuming through global offset e, the reference
  has fetched ceil(e / 1MB) blocks, so the no-newline flag is visible iff
  that reaches the final block (see _flag_visible).
- **scalar**: exact line-by-line emulation (including the \\r\\n and
  empty-line quirks) for inputs containing '\\r' or empty lines. Sticky
  once triggered. Exact for ANY file size: the reference's \\r\\n skip is
  gated in its 1MB-block frame (fastqreader.cpp:108-117), and _get_line
  recomputes that gate from global offsets, so straddling newlines
  surface as the same empty lines the reference produces (fuzzed >1MB
  with adversarial boundary placements in tests/interop_fuzz.py).

One further deliberate divergence: for files whose size is an exact
multiple of 1MB, the reference reads one byte of uninitialized memory to
decide the flag (fastqreader.cpp:43 with mBufDataLen==0); we use the true
last byte of the stream.
"""

from __future__ import annotations

import gzip
import mmap
import os
import stat
import sys
import zlib
from typing import Optional

import numpy as np

from ..codec import _native
from ..codec.blocks import PESpans, ReadBlock, gather_slices, lens_to_offsets
from ..codec.oracle import FastqRead

FQ_BUF_SIZE = 1 << 20
_ZERO_BLOCK = bytes(FQ_BUF_SIZE)

# Grow a bytearray WITHOUT initializing the new bytes: the reader extends
# its buffer by 1 MB per fetch and immediately readinto()s the region, so
# the zero-fill of `buf += _ZERO_BLOCK` is a full extra write pass over
# the input. PyByteArray_Resize leaves grown bytes uninitialized (CPython
# only guarantees the NUL terminator), which is exactly right here.
# Falls back to the zero-filled append off CPython.
try:
    import ctypes as _ct

    _ba_resize = _ct.pythonapi.PyByteArray_Resize
    _ba_resize.argtypes = [_ct.py_object, _ct.c_ssize_t]
    _ba_resize.restype = _ct.c_int

    def _grow_uninit(buf: bytearray, new_len: int) -> None:
        if _ba_resize(buf, new_len) != 0:  # pragma: no cover
            raise MemoryError
except AttributeError:  # pragma: no cover - non-CPython

    def _grow_uninit(buf: bytearray, new_len: int) -> None:
        buf += _ZERO_BLOCK[: new_len - len(buf)]

_NL = ord("\n")
_CR = ord("\r")


class FastqReader:
    def __init__(self, filename: str, has_quality: bool = True, phred64: bool = False):
        """has_quality=False reads 3-line records and synthesizes 'K' quals;
        phred64 converts quality to phred33 via max(33, q-31) (reference
        fastqreader.h ctor options + read.cpp:39-43; dormant in the
        reference CLI but part of its reader capability)."""
        self.filename = filename
        self.has_quality = has_quality
        self.phred64 = phred64
        self._lpr = 4 if has_quality else 3  # lines per record
        self.zipped = filename.endswith(".gz")
        if self.zipped:
            self._file = gzip.open(filename, "rb")
        elif filename == "/dev/stdin" or filename == "-":
            self._file = sys.stdin.buffer
        else:
            self._file = open(filename, "rb")
        # bytearray: += is amortized O(1); with bytes, accumulating a large
        # chunk from 1MB fetches was quadratic (100Mbase chunks took minutes)
        self._buf = bytearray()
        self._buf_used = 0
        self._gbase = 0  # global offset of _buf[0]
        self._eof = False
        self._total_size = 0
        self._last_byte = _NL
        self._scalar_mode = False
        self._dead = False  # reference returned NULL mid-file (empty line)
        # fast-mode scan cache: newline positions (buffer-relative) at or
        # after _buf_used, plus how far the buffer has been scanned
        self._nl = np.empty(0, dtype=np.int64)
        self._nl_parts: list = []  # pending newline arrays (merged lazily)
        self._scanned = 0
        # was the byte just before the current buffer window a '\n'?
        # (set at compaction; closes the danger-probe seam when a
        # consume boundary lands exactly on the fetch frontier — see
        # _scan_new)
        self._nl_seam = False
        # mmap fast path for plain regular files: the logical buffer is a
        # zero-copy window [_gbase, _fetched) of the mapping, so fetching
        # is pointer arithmetic (no readinto copy) and compaction is free.
        # _fetched still advances in FQ_BUF_SIZE steps to keep the
        # reference's lazy-fetch flag timing (_flag_visible) identical.
        # The exact scalar reader stays bytearray-based: _to_bytearray()
        # materializes the window and drops the mapping on first use.
        # Tradeoff: a file truncated by ANOTHER process mid-read faults
        # with SIGBUS instead of the readinto path's silent short read
        # (both are data loss; the reference misbehaves there too).
        # REPAQ_TPU_NO_MMAP=1 forces the readinto path.
        self._mm: Optional[mmap.mmap] = None
        self._mview: Optional[np.ndarray] = None
        self._fsize = 0
        self._fetched = 0
        if (
            not self.zipped
            and self._file is not sys.stdin.buffer
            and os.environ.get("REPAQ_TPU_NO_MMAP", "") != "1"
        ):
            try:
                st = os.fstat(self._file.fileno())
                if stat.S_ISREG(st.st_mode) and st.st_size > 0:
                    self._mm = mmap.mmap(
                        self._file.fileno(), 0, prot=mmap.PROT_READ
                    )
                    try:
                        # 2MB mappings cut dTLB misses ~15% at multi-GB
                        # corpus scale (this matters under nested EPT
                        # paging); honored for tmpfs inputs when
                        # shmem_enabled is advise/force, harmless no-op
                        # elsewhere
                        self._mm.madvise(mmap.MADV_HUGEPAGE)
                    except (AttributeError, OSError, ValueError):
                        pass
                    self._mview = np.frombuffer(self._mm, dtype=np.uint8)
                    self._fsize = st.st_size
            except (OSError, ValueError):  # pragma: no cover
                self._mm = None
                self._mview = None
        self._fetch_block()

    # ------------------------------------------------------------------
    # logical buffer (bytearray, or a window of the mmap)
    # ------------------------------------------------------------------
    def _blen(self) -> int:
        """Length of the logical buffer."""
        if self._mm is not None:
            d = self._fetched - self._gbase
            return d if d > 0 else 0
        return len(self._buf)

    def _flat(self) -> np.ndarray:
        """uint8 view of the logical buffer (zero-copy in both modes)."""
        if self._mm is not None:
            return self._mview[self._gbase : max(self._gbase, self._fetched)]
        return np.frombuffer(self._buf, dtype=np.uint8)

    def _to_bytearray(self) -> None:
        """Materialize the mmap window into the bytearray and leave mmap
        mode (entry to the exact scalar reader). The file offset is moved
        to the fetch frontier so later readinto fetches continue the
        stream; the mapping is dropped by reference (munmap happens when
        the last exported view dies)."""
        if self._mm is None:
            return
        if self._gbase < self._fetched:
            self._buf = bytearray(
                self._mview[self._gbase : self._fetched].tobytes()
            )
        else:
            self._buf = bytearray()
        self._file.seek(self._fetched)
        self._mm = None
        self._mview = None

    # ------------------------------------------------------------------
    # block fetching
    # ------------------------------------------------------------------
    def _fetch_block(self) -> None:
        if self._mm is not None:
            # advance the window frontier: no bytes move; eof timing
            # mirrors the readinto branch (set only by a short fetch)
            old = self._fetched
            new = min(old + FQ_BUF_SIZE, self._fsize)
            got = new - old
            self._fetched = new
            self._total_size = new
            if got < FQ_BUF_SIZE:
                self._eof = True
            if got:
                self._last_byte = int(self._mview[new - 1])
            return
        # readinto a pre-grown region: saves one full copy of the input
        # (read() materializes a bytes object that += then copies again)
        old = len(self._buf)
        _grow_uninit(self._buf, old + FQ_BUF_SIZE)
        got = 0
        mv = memoryview(self._buf)
        try:
            while got < FQ_BUF_SIZE:
                k = self._file.readinto(mv[old + got : old + FQ_BUF_SIZE])
                if not k:
                    break
                got += k
        finally:
            mv.release()  # release the export before the bytearray resizes
        if got < FQ_BUF_SIZE:
            del self._buf[old + got :]
            self._eof = True
        self._total_size += got
        if got:
            self._last_byte = self._buf[-1]

    def _compact(self) -> None:
        # the slide is clamped to the buffer: a consumed-past-end marker
        # (_buf_used == blen + 1, unterminated tail) must keep _gbase at
        # real file offsets — callers read _gbase + min(_buf_used, blen)
        # as the consumed-through offset
        if self._mm is not None:
            # free in mmap mode: slide the window start
            drop = min(self._buf_used, self._blen())
            if drop == 0:
                return
            self._nl_seam = int(self._mview[self._gbase + drop - 1]) == _NL
            self._gbase += drop
            self._buf_used -= drop
            nl = self._nl_all()
            self._nl = nl[nl >= drop] - drop
            self._scanned = max(0, self._scanned - drop)
            return
        if self._buf_used > FQ_BUF_SIZE:
            drop = min(self._buf_used, len(self._buf))
            if drop == 0:
                return
            self._nl_seam = self._buf[drop - 1] == _NL
            self._buf = self._buf[drop:]
            self._gbase += drop
            self._buf_used -= drop
            nl = self._nl_all()
            self._nl = nl[nl >= drop] - drop
            self._scanned = max(0, self._scanned - drop)

    def close(self) -> None:
        if self._mm is not None:
            self._mview = None
            try:
                # deterministic munmap when no block still holds a span
                # view; with live exports the mapping is released when
                # the last view dies
                self._mm.close()
            except BufferError:
                pass
            self._mm = None
        if self._file is not sys.stdin.buffer:
            self._file.close()

    # ------------------------------------------------------------------
    # no-trailing-newline flag
    # ------------------------------------------------------------------
    def _flag_visible(self, e: int) -> bool:
        """Would the reference reader's flag be set after consuming through
        global offset e? (reference fastqreader.cpp:31-46 + lazy fetches)"""
        if not self._eof or self._last_byte == _NL:
            return False
        e = min(e, self._total_size)
        blocks_total = max(1, -(-self._total_size // FQ_BUF_SIZE))
        return -(-e // FQ_BUF_SIZE) >= blocks_total

    def has_no_line_break_at_end(self) -> bool:
        """Current-state flag (scalar-mode / compare-mode use)."""
        return self._flag_visible(self._gbase + self._buf_used)

    # ------------------------------------------------------------------
    # fast-mode scanning
    # ------------------------------------------------------------------
    def _scan_new(self) -> bool:
        """Scan unscanned bytes for newlines; returns False if danger bytes
        force scalar mode."""
        blen = self._blen()
        start = max(self._scanned, self._buf_used)
        if start >= blen:
            return True
        flat = self._flat()
        # include the previous byte so '\n\n' across the scan seam is seen
        # (a consumed terminator counts: the reference's getLine would
        # have skipped a '\n' right after it, so adjacency is dangerous
        # across consume boundaries too)
        probe_start = max(start - 1, 0)
        if probe_start == 0 and self._gbase == 0 and flat[0] == _NL:
            return False  # file starts with an empty line
        if start == 0 and self._gbase > 0 and self._nl_seam and flat[0] == _NL:
            return False  # '\n\n' straddling a compacted consume boundary
        if _native.available():
            # one fused pass: danger probe + newline positions together
            nl = _native.scan_newlines(flat, probe_start, start, blen)
            if nl is None:
                return False
        else:
            probe = flat[probe_start:].tobytes()
            if b"\r" in probe or b"\n\n" in probe:
                return False
            nl = np.flatnonzero(flat[start:] == _NL) + start
        if nl.size:
            self._nl_parts.append(nl)
        self._scanned = blen
        return True

    def _nl_all(self) -> np.ndarray:
        if self._nl_parts:
            arrs = ([self._nl] if self._nl.size else []) + self._nl_parts
            self._nl = np.concatenate(arrs) if len(arrs) > 1 else arrs[0]
            self._nl_parts = []
        return self._nl

    def _available(self):
        """(record_count, per-record seq_len array, record_end array).

        record_end[i] = buffer offset one past record i's terminating
        newline. Includes an unterminated final record at EOF."""
        nl = self._nl_all()
        lpr = self._lpr
        n_lines = nl.shape[0]
        count = n_lines // lpr
        tail_start = int(nl[-1]) + 1 if n_lines else self._buf_used
        has_tail = self._eof and tail_start < self._blen()
        if has_tail and n_lines % lpr == lpr - 1:
            # final record with unterminated quality line
            count_extra = 1
        else:
            count_extra = 0
        total = count + count_extra
        if total == 0:
            return 0, None, None
        seq_start = nl[0 : lpr * count : lpr] + 1
        seq_end = nl[1 : lpr * count + 1 : lpr]
        seq_lens = seq_end - seq_start
        rec_end = nl[lpr - 1 : lpr * count + lpr - 1 : lpr] + 1
        if count_extra:
            seq_lens = np.concatenate(
                [seq_lens, [int(nl[lpr * count + 1]) - int(nl[lpr * count]) - 1]]
            )
            rec_end = np.concatenate([rec_end, [self._blen()]])
        return total, seq_lens, rec_end

    def _line_table(self, k: int):
        """(line_starts, line_ends, new_used) for the first k available
        records — the index arithmetic of _consume_block without the
        gathers or the consumption bookkeeping."""
        nl = self._nl_all()
        lpr = self._lpr
        count_term = min(k, nl.shape[0] // lpr)
        used = self._buf_used

        line_starts = np.empty(lpr * count_term, dtype=np.int64)
        if count_term:  # a lone unterminated record has no full rows
            line_starts[0] = used
            line_starts[1:] = nl[: lpr * count_term - 1] + 1
        line_ends = nl[: lpr * count_term].copy()
        if k > count_term:
            # unterminated final record (lpr-1 newlines + tail)
            extra_starts = np.empty(lpr, dtype=np.int64)
            extra_starts[0] = nl[lpr * count_term - 1] + 1 if count_term else used
            base = lpr * count_term
            extra_starts[1:] = nl[base : base + lpr - 1] + 1
            extra_ends = np.concatenate(
                [nl[base : base + lpr - 1], [self._blen()]]
            )
            line_starts = np.concatenate([line_starts, extra_starts])
            line_ends = np.concatenate([line_ends, extra_ends])
            new_used = self._blen() + 1  # mirrors the reference's end+1
        else:
            new_used = int(nl[lpr * count_term - 1]) + 1
        return line_starts, line_ends, new_used

    def _commit_consume(self, new_used: int) -> int:
        """Mark bytes through new_used consumed; returns global offset e."""
        self._buf_used = new_used
        self._nl = self._nl[np.searchsorted(self._nl, new_used) :]
        e = self._gbase + min(new_used, self._blen())
        self._compact()
        return e

    def _consume_block(self, k: int) -> tuple[ReadBlock, int]:
        """Build a ReadBlock from the first k available records and consume
        them. Returns (block, global e after the k-th record)."""
        lpr = self._lpr
        line_starts, line_ends, new_used = self._line_table(k)
        flat = self._flat()

        def part(j):
            starts = line_starts[j::lpr]
            lens = line_ends[j::lpr] - starts
            return gather_slices(flat, starts, lens), lens_to_offsets(lens)

        name_flat, name_off = part(0)
        seq_flat, seq_off = part(1)
        strand_flat, strand_off = part(2)
        if self.has_quality:
            qual_flat, qual_off = part(3)
            if self.phred64:
                qual_flat = np.maximum(qual_flat.astype(np.int16) - 31, 33).astype(
                    np.uint8
                )
        else:
            qual_off = seq_off.copy()
            qual_flat = np.full(int(qual_off[-1]), ord("K"), dtype=np.uint8)
        block = ReadBlock(
            k, name_flat, name_off, seq_flat, seq_off,
            strand_flat, strand_off, qual_flat, qual_off,
        )
        e = self._commit_consume(new_used)
        return block, e

    def ensure_available(self, min_records: int) -> int:
        """Fetch until >= min_records complete records are available (or
        EOF). Returns available record count. Switches to scalar mode on
        danger bytes (caller must then use read())."""
        if self._dead:
            return 0
        while True:
            if not self._scalar_mode and not self._scan_new():
                self._scalar_mode = True
            if self._scalar_mode:
                return -1
            n_lines = self._nl.shape[0] + sum(
                p.shape[0] for p in self._nl_parts
            )
            total = n_lines // self._lpr
            if total >= min_records:
                return total
            if self._eof:
                total, _, _ = self._available()  # may add unterminated tail
                return total
            self._fetch_block()

    def available_seq_lens(self):
        return self._available()

    # ------------------------------------------------------------------
    # public block API
    # ------------------------------------------------------------------
    def read_block(
        self, budget_bases: Optional[int] = None, max_records: Optional[int] = None
    ) -> tuple[Optional[ReadBlock], bool]:
        """Read the minimal record prefix whose cumulative base count
        reaches budget_bases (reference repaq.cpp:546-553), or exactly
        max_records. Returns (block, no_line_break_flag_at_block_end)."""
        if self._dead:
            return None, self.has_no_line_break_at_end()
        if self._scalar_mode:
            return self._read_block_scalar(budget_bases, max_records)
        want = max_records if max_records is not None else 4
        while True:
            avail = self.ensure_available(want)
            if avail < 0:
                return self._read_block_scalar(budget_bases, max_records)
            if avail == 0:
                return None, self.has_no_line_break_at_end()
            total, seq_lens, _ = self._available()
            if max_records is not None:
                if total >= max_records or self._eof:
                    k = min(total, max_records)
                    block, e = self._consume_block(k)
                    return block, self._flag_visible(e)
                want = max_records
                continue
            cum = np.cumsum(seq_lens)
            cut = int(np.searchsorted(cum, budget_bases, side="left"))
            if cut < total:
                block, e = self._consume_block(cut + 1)
                return block, self._flag_visible(e)
            if self._eof:
                block, e = self._consume_block(total)
                return block, self._flag_visible(e)
            want = total + max(4, total // 2)

    def _consume_skip(self, k: int) -> int:
        """Advance past the first k available records WITHOUT building
        arrays — identical consumption arithmetic to _consume_block;
        returns the global offset e after the k-th record. Powers the
        multi-host chunk planner, which needs boundaries + flags only."""
        nl = self._nl_all()
        lpr = self._lpr
        count_term = min(k, nl.shape[0] // lpr)
        if k > count_term:
            new_used = self._blen() + 1  # unterminated final record
        else:
            new_used = int(nl[lpr * count_term - 1]) + 1
        self._buf_used = new_used
        self._nl = self._nl[np.searchsorted(self._nl, new_used) :]
        e = self._gbase + min(new_used, self._blen())
        self._compact()
        return e

    def skip_block(
        self, budget_bases: Optional[int] = None,
        max_records: Optional[int] = None,
    ) -> tuple[int, bool]:
        """Plan-only twin of read_block: same record selection and
        consumption, no field gathers. Returns (record_count, flag)."""
        if self._dead:
            return 0, self.has_no_line_break_at_end()
        if self._scalar_mode:
            block, flag = self._read_block_scalar(budget_bases, max_records)
            return (block.n if block is not None else 0), flag
        want = max_records if max_records is not None else 4
        while True:
            avail = self.ensure_available(want)
            if avail < 0:
                block, flag = self._read_block_scalar(
                    budget_bases, max_records
                )
                return (block.n if block is not None else 0), flag
            if avail == 0:
                return 0, self.has_no_line_break_at_end()
            total, seq_lens, _ = self._available()
            if max_records is not None:
                if total >= max_records or self._eof:
                    k = min(total, max_records)
                    return k, self._flag_visible(self._consume_skip(k))
                want = max_records
                continue
            cum = np.cumsum(seq_lens)
            cut = int(np.searchsorted(cum, budget_bases, side="left"))
            if cut < total:
                return cut + 1, self._flag_visible(
                    self._consume_skip(cut + 1)
                )
            if self._eof:
                return total, self._flag_visible(self._consume_skip(total))
            want = total + max(4, total // 2)

    def _read_block_scalar(self, budget_bases, max_records):
        reads = []
        bases = 0
        while True:
            r = self.read()
            if r is None:
                break
            reads.append(r)
            bases += len(r.seq)
            if budget_bases is not None and bases >= budget_bases:
                break
            if max_records is not None and len(reads) >= max_records:
                break
        if not reads:
            return None, self.has_no_line_break_at_end()
        return ReadBlock.from_reads(reads), self.has_no_line_break_at_end()

    # ------------------------------------------------------------------
    # scalar record API (exact reference line semantics)
    # ------------------------------------------------------------------
    _BS = 1 << 20  # the reference's FQ_BUF_SIZE (fastqreader.cpp:5)

    def _get_line(self) -> bytes:
        """Exact reference getLine (fastqreader.cpp:94-155) for ANY file
        size. The reference refills in 1MB blocks aligned to file offsets
        (readToBuf always reads FQ_BUF_SIZE), and the \r\n / \n\n skip is
        gated on `end < mBufDataLen - 1` IN THE FRAME OF THE BLOCK THAT
        HELD THE TERMINATOR — so a second newline straddling (or adjacent
        to) a 1MB boundary is deliberately NOT consumed and surfaces as an
        empty line. Our buffer may coalesce several fetches, so the gate
        is recomputed from global offsets: for terminator at global g_t,
        with B = the 1MB block containing g_t, consume a following '\n'
        iff (g_t + 1) - base(B) < len(B) - 1."""
        start = self._buf_used
        # scan for the terminator, fetching as needed (append-only: the
        # global base _gbase stays valid)
        t = start
        while True:
            buf = self._buf
            n = len(buf)
            while t < n and buf[t] != _CR and buf[t] != _NL:
                t += 1
            if t < n:
                break
            if self._eof:
                # last (partial) block: line runs to EOF; the reference
                # sets mBufUsedLen past mBufDataLen so the next read()
                # returns NULL
                self._buf_used = n + 1
                return bytes(buf[start:])
            self._fetch_more_scalar()

        # the skip gate needs the terminator block's exact length: buffer
        # to the end of that block (or EOF) so partial-final-block sizes
        # are known, and the byte after the terminator is visible
        g_t = self._gbase + t
        base = (g_t // self._BS) * self._BS
        while not self._eof and self._gbase + len(self._buf) < base + self._BS:
            self._fetch_more_scalar()
        buf = self._buf
        n = len(buf)
        line = bytes(buf[start:t])
        end = t + 1
        file_end = self._gbase + n  # exact when this block is the last
        blen = min(self._BS, file_end - base) if self._eof else self._BS
        if end < n and buf[end] == _NL and (g_t + 1 - base) < blen - 1:
            end += 1
        self._buf_used = end
        return line

    def _fetch_more_scalar(self) -> None:
        """Append-fetch for the scalar path: keeps _gbase anchored at
        _buf[0] and drops the fast-path scan cache. Never trims — callers
        hold buffer-relative indices across this call; trimming happens
        between records in read()."""
        self._nl = np.empty(0, dtype=np.int64)
        self._nl_parts = []
        self._scanned = 0
        self._fetch_block()

    def read(self) -> Optional[FastqRead]:
        """Scalar record reader (reference fastqreader.cpp:166-196)."""
        if self._dead:
            return None
        self._to_bytearray()  # the scalar reader works on the bytearray
        # scalar consumption invalidates the fast-path scan cache
        self._nl = np.empty(0, dtype=np.int64)
        self._nl_parts = []
        self._scanned = 0
        # between records no buffer-relative index is live: trim consumed
        # bytes so scalar mode stays O(blocks), preserving the global base
        if self._buf_used > 4 * self._BS:
            drop = self._buf_used - (self._buf_used % self._BS)
            del self._buf[:drop]
            self._gbase += drop
            self._buf_used -= drop
        while self._buf_used >= len(self._buf) and not self._eof:
            self._fetch_block()
        if self._buf_used >= len(self._buf) and self._eof:
            return None
        name = self._get_line()
        seq = self._get_line()
        strand = self._get_line()
        if not name or not seq or not strand:
            self._dead = True
            return None
        if not self.has_quality:
            return FastqRead(name, seq, strand, b"K" * len(seq))
        qual = self._get_line()
        if not qual:
            self._dead = True
            return None
        if self.phred64:
            qual = bytes(max(33, q - 31) for q in qual)
        return FastqRead(name, seq, strand, qual)


class FastqReaderPair:
    """Reads R1/R2 from two files or one interleaved stream (reference
    fastqreader.cpp:262-299)."""

    def __init__(self, left: str, right: str = "", interleaved: bool = False):
        self.interleaved = interleaved
        self.left = FastqReader(left)
        self.right = None if interleaved else FastqReader(right)

    def read(self) -> Optional[tuple[FastqRead, FastqRead]]:
        l = self.left.read()
        r = self.left.read() if self.interleaved else self.right.read()
        if l is None or r is None:
            return None
        return (l, r)

    def read_pair_block(
        self, budget_bases: int
    ) -> tuple[Optional[ReadBlock], bool, bool]:
        """Minimal pair prefix with cum(len1+len2) >= budget (reference
        repaq.cpp:656-663). Returns (interleaved block, flag_r1, flag_r2)."""
        if self.interleaved:
            return self._read_pair_block_interleaved(budget_bases)
        r1, r2 = self.left, self.right
        while True:
            if r1.ensure_available(1) < 0 or r2.ensure_available(1) < 0:
                return self._read_pair_block_scalar(budget_bases)
            t1, l1, _ = r1._available()
            t2, l2, _ = r2._available()
            m = min(t1, t2)
            if m > 0:
                cum = np.cumsum(l1[:m] + l2[:m])
                cut = int(np.searchsorted(cum, budget_bases, side="left"))
                if cut < m:
                    return self._consume_pairs(cut + 1)
            # need more pairs: grow whichever reader limits m
            grew = False
            if t1 == m and not r1._eof:
                r1._fetch_block()
                grew = True
            if t2 == m and not r2._eof:
                r2._fetch_block()
                grew = True
            if not grew:
                if m == 0:
                    return None, r1.has_no_line_break_at_end(), (
                        r2.has_no_line_break_at_end()
                    )
                return self._consume_pairs(m)

    def _consume_pairs(self, k: int):
        r1, r2 = self.left, self.right
        if (
            not _native.available()
            or not (r1.has_quality and r2.has_quality)
            or r1.phred64
            or r2.phred64
        ):
            b1, e1 = r1._consume_block(k)
            b2, e2 = r2._consume_block(k)
            return (
                b1.interleave(b2),
                r1._flag_visible(e1),
                r2._flag_visible(e2),
            )
        # fused path: scatter each field straight from the two file
        # buffers into the interleaved layout — one copy of every byte
        # instead of the gather-then-interleave two (the PE read stage is
        # ~40% of encode wall; this halves its memory traffic)
        ls1, le1, nu1 = r1._line_table(k)
        ls2, le2, nu2 = r2._line_table(k)
        flat1 = r1._flat()
        flat2 = r2._flat()
        if r1._mm is not None and r2._mm is not None:
            # lazy-span tier: seq and qual stay as spans into the mapped
            # inputs (flat1/flat2 are views pinning the mmaps, so they
            # outlive consumption); only names + strands materialize.
            # encode_chunk consumes the spans directly — the packed
            # seq_flat/qual_flat copies happen only if some consumer
            # (verify, header scan, fallback engine) asks for them.
            sl = np.empty(2 * k, dtype=np.int64)
            sl[0::2] = le1[1::4] - ls1[1::4]
            sl[1::2] = le2[1::4] - ls2[1::4]
            ql = np.empty(2 * k, dtype=np.int64)
            ql[0::2] = le1[3::4] - ls1[3::4]
            ql[1::2] = le2[3::4] - ls2[3::4]
            if np.array_equal(sl, ql):
                nl_ = np.empty(2 * k, dtype=np.int64)
                nl_[0::2] = le1[0::4] - ls1[0::4]
                nl_[1::2] = le2[0::4] - ls2[0::4]
                tl = np.empty(2 * k, dtype=np.int64)
                tl[0::2] = le1[2::4] - ls1[2::4]
                tl[1::2] = le2[2::4] - ls2[2::4]
                name_off = lens_to_offsets(nl_)
                strand_off = lens_to_offsets(tl)
                seq_off = lens_to_offsets(sl)
                name_flat = np.empty(int(name_off[-1]), dtype=np.uint8)
                strand_flat = np.empty(int(strand_off[-1]), dtype=np.uint8)
                _native.pe_interleave_2fields(
                    flat1, ls1, le1, flat2, ls2, le2, k,
                    0, (name_flat, name_off), 2, (strand_flat, strand_off),
                )
                spans = PESpans(
                    flat1, flat2,
                    np.ascontiguousarray(ls1[1::4]),
                    np.ascontiguousarray(ls2[1::4]),
                    np.ascontiguousarray(ls1[3::4]),
                    np.ascontiguousarray(ls2[3::4]),
                )
                e1 = r1._commit_consume(nu1)
                e2 = r2._commit_consume(nu2)
                block = ReadBlock(
                    2 * k, name_flat, name_off, None, seq_off,
                    strand_flat, strand_off, None, seq_off,
                )
                block.attach_pe_spans(spans)
                return block, r1._flag_visible(e1), r2._flag_visible(e2)
        fields = []
        for j in range(4):
            lens = np.empty(2 * k, dtype=np.int64)
            lens[0::2] = le1[j::4] - ls1[j::4]
            lens[1::2] = le2[j::4] - ls2[j::4]
            off = lens_to_offsets(lens)
            fields.append((np.empty(int(off[-1]), dtype=np.uint8), off))
        # all four fields of both mates scatter in one record-order pass
        # per source buffer (each source cache line is read once)
        _native.pe_interleave(flat1, ls1, le1, flat2, ls2, le2, k, fields)
        del flat1, flat2  # views pin the bytearrays against resize
        e1 = r1._commit_consume(nu1)
        e2 = r2._commit_consume(nu2)
        block = ReadBlock(
            2 * k,
            fields[0][0], fields[0][1], fields[1][0], fields[1][1],
            fields[2][0], fields[2][1], fields[3][0], fields[3][1],
        )
        return block, r1._flag_visible(e1), r2._flag_visible(e2)

    def skip_pair_block(self, budget_bases: int) -> tuple[int, bool, bool]:
        """Plan-only twin of read_pair_block: same pair selection, no
        array building. Returns (n_pairs, flag_r1, flag_r2)."""
        if self.interleaved:
            r = self.left
            while True:
                if r.ensure_available(2) < 0:
                    block, f1, f2 = self._read_pair_block_scalar(budget_bases)
                    return (block.n // 2 if block is not None else 0), f1, f2
                total, seq_lens, _ = r._available()
                pairs = total // 2
                if pairs > 0:
                    psum = (
                        seq_lens[0 : 2 * pairs : 2]
                        + seq_lens[1 : 2 * pairs : 2]
                    )
                    cum = np.cumsum(psum)
                    cut = int(np.searchsorted(cum, budget_bases, side="left"))
                    if cut < pairs:
                        f = r._flag_visible(r._consume_skip(2 * (cut + 1)))
                        return cut + 1, f, f
                if r._eof:
                    if pairs == 0:
                        f = r.has_no_line_break_at_end()
                        return 0, f, f
                    f = r._flag_visible(r._consume_skip(2 * pairs))
                    return pairs, f, f
                r._fetch_block()
        r1, r2 = self.left, self.right
        while True:
            if r1.ensure_available(1) < 0 or r2.ensure_available(1) < 0:
                block, f1, f2 = self._read_pair_block_scalar(budget_bases)
                return (block.n // 2 if block is not None else 0), f1, f2
            t1, l1, _ = r1._available()
            t2, l2, _ = r2._available()
            m = min(t1, t2)
            if m > 0:
                cum = np.cumsum(l1[:m] + l2[:m])
                cut = int(np.searchsorted(cum, budget_bases, side="left"))
                if cut < m:
                    k = cut + 1
                    return (
                        k,
                        r1._flag_visible(r1._consume_skip(k)),
                        r2._flag_visible(r2._consume_skip(k)),
                    )
            grew = False
            if t1 == m and not r1._eof:
                r1._fetch_block()
                grew = True
            if t2 == m and not r2._eof:
                r2._fetch_block()
                grew = True
            if not grew:
                if m == 0:
                    return 0, r1.has_no_line_break_at_end(), (
                        r2.has_no_line_break_at_end()
                    )
                return (
                    m,
                    r1._flag_visible(r1._consume_skip(m)),
                    r2._flag_visible(r2._consume_skip(m)),
                )

    def _read_pair_block_interleaved(self, budget_bases: int):
        r = self.left
        while True:
            if r.ensure_available(2) < 0:
                return self._read_pair_block_scalar(budget_bases)
            total, seq_lens, _ = r._available()
            pairs = total // 2
            if pairs > 0:
                psum = seq_lens[0 : 2 * pairs : 2] + seq_lens[1 : 2 * pairs : 2]
                cum = np.cumsum(psum)
                cut = int(np.searchsorted(cum, budget_bases, side="left"))
                if cut < pairs:
                    block, e = r._consume_block(2 * (cut + 1))
                    f = r._flag_visible(e)
                    return block, f, f
            if r._eof:
                if pairs == 0:
                    f = r.has_no_line_break_at_end()
                    return None, f, f
                block, e = r._consume_block(2 * pairs)
                f = r._flag_visible(e)
                return block, f, f
            r._fetch_block()

    def _read_pair_block_scalar(self, budget_bases: int):
        reads = []
        bases = 0
        while True:
            pair = self.read()
            if pair is None:
                break
            reads.append(pair[0])
            reads.append(pair[1])
            bases += len(pair[0].seq) + len(pair[1].seq)
            if bases >= budget_bases:
                break
        f1 = self.left.has_no_line_break_at_end()
        f2 = f1 if self.interleaved else self.right.has_no_line_break_at_end()
        if not reads:
            return None, f1, f2
        return ReadBlock.from_reads(reads), f1, f2

    def close(self) -> None:
        self.left.close()
        if self.right is not None:
            self.right.close()


class Writer:
    """Plain or gzip output (reference writer.cpp; gz level 3, 1MB buffer)."""

    def __init__(self, filename: str, compression: int = 3):
        self.filename = filename
        self.zipped = filename.endswith(".gz")
        if self.zipped:
            self._file = open(filename, "wb")
            self._gz = zlib.compressobj(compression, zlib.DEFLATED, 16 + zlib.MAX_WBITS)
        elif filename == "/dev/stdout" or filename == "-":
            self._file = sys.stdout.buffer
            self._gz = None
        else:
            self._file = open(filename, "wb")
            self._gz = None

    def write(self, data: bytes) -> None:
        if self._gz is not None:
            self._file.write(self._gz.compress(data))
        else:
            self._file.write(data)

    def close(self) -> None:
        if self._gz is not None:
            self._file.write(self._gz.flush(zlib.Z_FINISH))
        if self._file is not sys.stdout.buffer:
            self._file.close()
        else:
            self._file.flush()
