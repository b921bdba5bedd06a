"""The hand-written CUDA kernels of the port, each beside its plain torch
version; the counterpart of repaq_tpu/ops/pallas_tpu.py, and of the
run-boundary scans, the PE overlap search, the PE steps' revcomp, overlap
clamp and expansion, the decode's masked writes and the stream coders'
compaction sorts that the JAX package left to XLA, and of the PE encode's
elision sort.

Every wrapper decides by the device of the tensor it is given: a CPU
tensor runs the plain version, a CUDA tensor launches the kernel (built on
first use by ``_build``) and raises if the launch is refused. There is no
fallback from one to the other. ``launches`` counts kernel launches per
wrapper, so a run can show that its main path went through the kernels;
the rANS wrappers of ``rans_device`` count here too. ``captured_ops``
lists the device operations of one call, read from a CUDA graph that
captures it (csrc/graph.cu), for the checks that count a call's kernels.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ..constants import MIN_OVERLAP
from . import _build

_G, _A, _T, _C, _N = 71, 65, 84, 67, 78

launches = {"encode_frontend": 0, "encode_frontend_bytes": 0,
            "pack_bases": 0, "unpack_bases": 0, "token_start_mask": 0,
            "run_offsets": 0, "seg_positions": 0, "rans_encode": 0,
            "rans_layout": 0, "rans_decode": 0, "overlap_pairs": 0,
            "pe_encode_pairs": 0, "pe_decode_rows": 0, "fill_runs": 0,
            "fill_sorted_runs": 0, "concat_row_spans": 0,
            "bucket_compact": 0}
_launch_lock = threading.Lock()


def reset_launches() -> None:
    with _launch_lock:
        for k in launches:
            launches[k] = 0


def _counted(name: str) -> None:
    with _launch_lock:
        launches[name] += 1


# cudaGraphNodeType's values of the nodes a stream capture of a wrapper
# makes; "empty" nodes do no work and are left out
_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 5: "empty"}
_NAME_LEN = 1024
_capture_streams = {}


def captured_ops(fn) -> list:
    """The device operations that one fn() call enqueues, in the order a
    CUDA graph capture of the call records them: each kernel by its
    demangled name, each other operation by its node type ("memcpy",
    "memset", ...). The capture records every operation the call enqueues
    on the current device and runs none of them. fn runs once uncaptured
    on the capturing stream first, so that what a wrapper keeps for a
    stream (the status words) exists before the capture; fn must not
    synchronise with the host."""
    lib = _build.library()
    dev = torch.device("cuda", torch.cuda.current_device())
    with _launch_lock:
        if dev not in _capture_streams:
            _capture_streams[dev] = torch.cuda.Stream(dev)
        stream = _capture_streams[dev]
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.synchronize(dev)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=stream,
                          capture_error_mode="thread_local"):
        fn()
    cap = 1 << 12
    types = (ctypes.c_int * cap)()
    names = ctypes.create_string_buffer(cap * _NAME_LEN)
    n = lib.repaq_graph_nodes(graph.raw_cuda_graph(), ctypes.addressof(types),
                              ctypes.addressof(names), cap, _NAME_LEN)
    graph.reset()
    if n < 0 or n > cap:
        raise RuntimeError("reading the captured graph failed: %s"
                           % ("error %d" % -n if n < 0
                              else "%d nodes, more than %d" % (n, cap)))
    ops = []
    for i in range(n):
        kind = _NODE_TYPES.get(types[i], "node type %d" % types[i])
        if kind == "kernel":
            raw = names.raw[i * _NAME_LEN:(i + 1) * _NAME_LEN]
            ops.append(raw.split(b"\0", 1)[0].decode(errors="replace"))
        elif kind != "empty":
            ops.append(kind)
    return ops


def _on_cuda(*tensors) -> bool:
    """True for CUDA tensors, False for CPU ones; raises on anything else
    or on a mix."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return True
    raise ValueError("tensors must all lie on the CPU or on one CUDA "
                     "device, got %s" % sorted(str(t.device) for t in tensors))


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous with a 16-byte aligned start (the kernels use 16-byte
    vector loads and stores)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(name: str, fn, *args) -> None:
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError("CUDA kernel %s failed to launch: error %d"
                           % (name, rc))
    _counted(name)


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _check_u8(name: str, t: torch.Tensor) -> None:
    if t.dtype != torch.uint8 or t.dim() != 1:
        raise ValueError("%s must be a 1-D uint8 tensor, got %s %s"
                         % (name, t.dtype, tuple(t.shape)))


# ---------------------------------------------------------------------------
# encode frontend (TPU: pallas_tpu._frontend_kernel via encode_frontend_meta32
# and, in byte form, via encode_frontend_pallas) and the pack-only kernel
# (TPU: pallas_tpu._pack_kernel via pack_bases_pallas)
# ---------------------------------------------------------------------------


def _qual_lut(bins: torch.Tensor, major: int) -> torch.Tensor:
    """(256,) u8 quality char -> bin id: the palette position (the last
    one where a char repeats), B for an escape, B + 1 for the major."""
    dev = bins.device
    nbins = int(bins.shape[0])
    c = torch.arange(256, device=dev)
    last = torch.full((256,), -1, dtype=torch.long, device=dev)
    if nbins:
        hit = bins.long()[None, :] == c[:, None]
        last = torch.where(hit, torch.arange(nbins, device=dev), -1).amax(1)
    lut = torch.where(last >= 0, last, nbins)
    return torch.where(c == major, nbins + 1, lut).to(torch.uint8)


def _pad4(t: torch.Tensor, fill: int) -> torch.Tensor:
    """t padded with `fill` to a multiple of 4 bytes (t itself when it is
    one already)."""
    pad = (-t.shape[0]) % 4
    if not pad:
        return t
    return torch.cat([t, torch.full((pad,), fill, dtype=t.dtype,
                                    device=t.device)])


def pack_bases_plain(seq: torch.Tensor) -> torch.Tensor:
    """Plain torch version of ``pack_bases``."""
    code = torch.zeros(256, dtype=torch.uint8, device=seq.device)
    code[_A], code[_T], code[_C] = 1, 2, 3
    v = code[_pad4(seq, _G).long()].view(-1, 4)
    return v[:, 0] | (v[:, 1] << 2) | (v[:, 2] << 4) | (v[:, 3] << 6)


def encode_frontend_plain(seq: torch.Tensor, qual: torch.Tensor,
                          bins: torch.Tensor, major: int):
    """Plain torch version of ``encode_frontend``."""
    nflag = (seq == _N).to(torch.uint8) << 7
    return pack_bases_plain(seq), _qual_lut(bins, major)[qual.long()] | nflag


def _check_frontend(seq, qual, bins, major) -> None:
    for name, t in (("seq", seq), ("qual", qual), ("bins", bins)):
        _check_u8(name, t)
    if qual.shape[0] != seq.shape[0]:
        raise ValueError("seq and qual need one length (got %d and %d)"
                         % (seq.shape[0], qual.shape[0]))
    if bins.shape[0] > 63 or not 0 <= int(major) < 256:
        raise ValueError("need B <= 63 and a byte major (B=%d, major=%r)"
                         % (bins.shape[0], major))


def encode_frontend(seq: torch.Tensor, qual: torch.Tensor,
                    bins: torch.Tensor, major: int):
    """(seq (n,) u8, qual (n,) u8, bins (B,) u8, major) -> (packed
    ((n+3)//4,) u8, meta (n,) u8), any n. Packed: 2-bit codes A=1 T=2 C=3
    else 0, base k of each group of four in bits 2k..2k+1, the last byte's
    missing bases as code 0 ('G'). Meta: quality bin id in bits 0-6 (0..B-1
    palette entry, B escape, B+1 major), bit 7 set for 'N'. B <= 63."""
    _check_frontend(seq, qual, bins, major)
    if not _on_cuda(seq, qual, bins):
        return encode_frontend_plain(seq, qual, bins, int(major))
    n = seq.shape[0]
    packed = torch.empty((n + 3) // 4, dtype=torch.uint8, device=seq.device)
    meta = torch.empty(n, dtype=torch.uint8, device=seq.device)
    if n == 0:
        return packed, meta
    lib = _build.library()
    seq, qual, bins = _aligned(seq), _aligned(qual), bins.contiguous()
    with torch.cuda.device(seq.device):
        _launch("encode_frontend", lib.repaq_encode_frontend, seq.data_ptr(),
                qual.data_ptr(), bins.data_ptr(), int(bins.shape[0]),
                int(major), packed.data_ptr(), meta.data_ptr(), n,
                _stream(seq.device))
    return packed, meta


def encode_frontend_bytes_plain(seq: torch.Tensor, qual: torch.Tensor,
                                bins: torch.Tensor, major: int):
    """Plain torch version of ``encode_frontend_bytes``: the meta bytes of
    ``encode_frontend_plain``, split."""
    packed, meta = encode_frontend_plain(seq, qual, bins, int(major))
    return packed, meta >= 0x80, (meta & 0x7F).to(torch.int32)


def encode_frontend_bytes(seq: torch.Tensor, qual: torch.Tensor,
                          bins: torch.Tensor, major: int):
    """The byte form of the frontend, with the signature and meaning of
    repaq_tpu.ops.pallas_tpu.encode_frontend_pallas: (seq (n,) u8, qual
    (n,) u8, bins (B,) u8, major) -> (packed ((n+3)//4,) u8, nmask (n,)
    bool, bid (n,) int32), any n. bid: 0..B-1 palette entry, B escape, B+1
    major. One launch of its own kernel (counted as
    ``encode_frontend_bytes``) writes all three; the engine reads the meta
    bytes of ``encode_frontend`` instead."""
    _check_frontend(seq, qual, bins, major)
    if not _on_cuda(seq, qual, bins):
        return encode_frontend_bytes_plain(seq, qual, bins, major)
    n, dev = seq.shape[0], seq.device
    packed = torch.empty((n + 3) // 4, dtype=torch.uint8, device=dev)
    nmask = torch.empty(n, dtype=torch.bool, device=dev)
    bid = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return packed, nmask, bid
    lib = _build.library()
    seq, qual, bins = _aligned(seq), _aligned(qual), bins.contiguous()
    with torch.cuda.device(dev):
        _launch("encode_frontend_bytes", lib.repaq_encode_frontend_bytes,
                seq.data_ptr(), qual.data_ptr(), bins.data_ptr(),
                int(bins.shape[0]), int(major), packed.data_ptr(),
                nmask.data_ptr(), bid.data_ptr(), n, _stream(dev))
    return packed, nmask, bid


def pack_bases(seq: torch.Tensor) -> torch.Tensor:
    """(n,) u8 bases -> ((n+3)//4,) packed bytes, any n, the tail padded
    as 'G' (code 0): the signature and meaning of
    repaq_tpu.ops.pallas_tpu.pack_bases_pallas."""
    _check_u8("seq", seq)
    if not _on_cuda(seq):
        return pack_bases_plain(seq)
    n = seq.shape[0]
    out = torch.empty((n + 3) // 4, dtype=torch.uint8, device=seq.device)
    if n == 0:
        return out
    lib = _build.library()
    seq = _aligned(seq)
    with torch.cuda.device(seq.device):
        _launch("pack_bases", lib.repaq_pack_bases, seq.data_ptr(),
                out.data_ptr(), n, _stream(seq.device))
    return out


def frontend_waves() -> tuple:
    """Bases one wave of resident blocks covers in the pack_bases and
    encode_frontend_bytes kernels on the current CUDA device, as the built
    library reports them; the card tests and chip_smoke.py place edge
    cases by them."""
    lib = _build.library()
    waves = (int(lib.repaq_pack_wave_bases()),
             int(lib.repaq_frontend_bytes_wave_bases()))
    if not all(waves):
        raise RuntimeError("the CUDA runtime gave no occupancy for the "
                           "frontend kernels")
    return waves


# ---------------------------------------------------------------------------
# unpack (TPU: pallas_tpu._unpack_kernel via unpack_bases_pallas)
# ---------------------------------------------------------------------------


def unpack_bases_plain(packed: torch.Tensor,
                       out: torch.Tensor | None = None) -> torch.Tensor:
    """Plain torch version of ``unpack_bases``."""
    shifts = torch.arange(0, 8, 2, dtype=torch.uint8, device=packed.device)
    c = ((packed[:, None] >> shifts) & 3).reshape(-1)
    chars = torch.where(c == 0, _G, torch.where(
        c == 1, _A, torch.where(c == 2, _T, _C))).to(torch.uint8)
    if out is None:
        return chars
    return out[:chars.shape[0]].copy_(chars)


def _check_unpack_out(packed: torch.Tensor, out) -> None:
    _check_u8("packed", packed)
    if out is None:
        return
    _check_u8("out", out)
    if not out.is_contiguous() or out.data_ptr() % 16:
        raise ValueError("out must be contiguous with a 16-byte aligned "
                         "start")
    if out.shape[0] < 4 * packed.shape[0]:
        raise ValueError("out holds %d bytes, the unpack writes %d"
                         % (out.shape[0], 4 * packed.shape[0]))


def unpack_bases(packed: torch.Tensor,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """(m,) packed u8 -> (4m,) base chars, low bits first: 0->G 1->A 2->T
    3->C. out: an optional contiguous, 16-byte aligned u8 buffer of at
    least 4m bytes on packed's device; the chars go to its first 4m bytes
    and that view is returned (the rest of out is left as it was)."""
    _check_unpack_out(packed, out)
    if not _on_cuda(packed, *(() if out is None else (out,))):
        return unpack_bases_plain(packed, out)
    packed = _aligned(packed)
    m = packed.shape[0]
    if out is None:
        out = torch.empty(4 * m, dtype=torch.uint8, device=packed.device)
    out = out[:4 * m]
    if m == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(packed.device):
        _launch("unpack_bases", lib.repaq_unpack_bases, packed.data_ptr(),
                out.data_ptr(), m, _stream(packed.device))
    return out


# ---------------------------------------------------------------------------
# token FSM (TPU: pallas_tpu._fsm_kernel via token_fsm_pallas)
# ---------------------------------------------------------------------------


def fsm_tile() -> int:
    """Stream bytes per tile of the token FSM kernel, as the built library
    reports it; the card tests and chip_smoke.py place edge cases by it."""
    return int(_build.library().repaq_token_fsm_tile())


def token_start_mask_plain(lens: torch.Tensor,
                           force_start: torch.Tensor | None = None):
    """Plain torch version of ``token_start_mask``: inclusive prefix
    composition of the per-byte 4-state maps by log-step doubling."""
    n = lens.shape[0]
    dev = lens.device
    if n == 0:
        return torch.zeros(0, dtype=torch.bool, device=dev)
    nxt = (lens.clamp(1, 4).long() - 1)[:, None].expand(n, 4)
    s4 = torch.arange(4, device=dev)
    maps = torch.where(s4 == 0, nxt, (s4 - 1).clamp(min=0).expand(n, 4))
    if force_start is not None:
        maps = torch.where(force_start[:, None], nxt, maps)
    d = 1
    while d < n:  # maps[i] becomes the composition of bytes (i - 2d, i]
        maps = torch.cat([maps[:d], torch.gather(maps[d:], 1, maps[:-d])])
        d *= 2
    entry = torch.cat([torch.zeros(1, dtype=maps.dtype, device=dev),
                       maps[:-1, 0]])
    starts = entry == 0
    if force_start is not None:
        starts = starts | force_start
    return starts


def token_start_mask(lens: torch.Tensor,
                     force_start: torch.Tensor | None = None):
    """Token boundaries of a stream of 1/2/4-byte tokens (the signature
    and meaning of repaq_tpu.ops.device_streams.token_start_mask).

    lens: (n,) int token length IF a token started at that byte (clamped
    to 1..4), of any integer type; the kernel reads uint8 and int32 as
    they are (uint8 moves half the bytes), other types after a clamp to
    uint8. force_start: optional (n,) bool, a token starts there whatever
    the state. Returns the (n,) bool start mask."""
    if lens.dim() != 1:
        raise ValueError("lens must be 1-D")
    if force_start is not None and force_start.shape != lens.shape:
        raise ValueError("force_start must match lens")
    tensors = (lens,) if force_start is None else (lens, force_start)
    if not _on_cuda(*tensors):
        return token_start_mask_plain(lens, force_start)
    dev = lens.device
    n = lens.shape[0]
    out = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return out
    lib = _build.library()
    if lens.dtype not in (torch.uint8, torch.int32):
        lens = lens.clamp(1, 4).to(torch.uint8)
    lens = _aligned(lens)
    if force_start is not None:
        force_start = _aligned(force_start.to(torch.bool))
    # the tiles' status words and the tile counter start at zero
    status = torch.zeros(lib.repaq_token_fsm_status_words(n),
                         dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _launch("token_start_mask", lib.repaq_token_start_mask,
                lens.data_ptr(), lens.element_size(),
                None if force_start is None else force_start.data_ptr(), n,
                status.data_ptr(), out.data_ptr(), _stream(dev))
    return out


# ---------------------------------------------------------------------------
# run boundaries (JAX: XLA's lax.cummax and flipped lax.cummin with the
# arithmetic around them, repaq_tpu/ops/device_streams.py:33, :37,
# :275-278, :726-730 on encode and :1001, :1138 on decode)
# ---------------------------------------------------------------------------


def run_tiles() -> tuple:
    """Elements per tile of the run_offsets and seg_positions kernels, as
    the built library reports them; the card tests and chip_smoke.py place
    edge cases by them."""
    lib = _build.library()
    return (int(lib.repaq_run_offsets_tile()),
            int(lib.repaq_seg_positions_tile()))


# one buffer of status words for the run-boundary and compaction kernels
# per (device, CUDA stream): zeroed once, and left zeroed by every launch,
# whose last block clears what the launch used; launches on one stream run
# in order
_run_status: dict = {}


def _status_words(dev: torch.device, stream: int, words: int) -> torch.Tensor:
    """Zeroed int64 status words, at least `words`, for a launch on
    `stream`; a larger need replaces the buffer with a larger one."""
    with _launch_lock:
        buf = _run_status.get((dev, stream))
        if buf is None or buf.numel() < words:
            buf = torch.zeros(max(words, 1 << 12), dtype=torch.int64,
                              device=dev)
            _run_status[(dev, stream)] = buf
        return buf


def run_offsets_plain(mask: torch.Tensor):
    """Plain torch version of ``run_offsets``: the JAX expression."""
    n = mask.shape[-1]
    i = torch.arange(n, dtype=torch.int32, device=mask.device).expand(
        mask.shape)
    prev = torch.cat([torch.zeros_like(mask[..., :1]), mask[..., :-1]], -1)
    rs_idx = torch.cummax(torch.where(mask & ~prev, i, -1), -1).values
    end_idx = torch.cummin(torch.where(mask, n, i).flip(-1), -1).values.flip(-1)
    return (torch.where(mask, i - rs_idx, 0),
            torch.where(mask, (end_idx - i).clamp(max=32), 0))


def run_offsets(mask: torch.Tensor):
    """Run offsets of a (n,) or (rows, n) bool mask along its last
    dimension: (off, to_end), int32 of the mask's shape, with

        off[i]    = i - (the last j <= i with mask[j] & ~mask[j - 1]),
        to_end[i] = min(32, (the first j >= i with ~mask[j], or n) - i)

    where mask[i], else 0 (mask[-1] counts as False at each row's start),
    exactly as ``run_offsets_plain``. One launch for every row."""
    if mask.dtype != torch.bool or mask.dim() not in (1, 2):
        raise ValueError("run_offsets takes a 1-D or 2-D bool tensor, got "
                         "%s %s" % (mask.dtype, tuple(mask.shape)))
    if not _on_cuda(mask):
        return run_offsets_plain(mask)
    dev = mask.device
    off = torch.empty(mask.shape, dtype=torch.int32, device=dev)
    to_end = torch.empty(mask.shape, dtype=torch.int32, device=dev)
    if mask.numel() == 0:
        return off, to_end
    lib = _build.library()
    mask = _aligned(mask)
    rows = 1 if mask.dim() == 1 else mask.shape[0]
    n = mask.shape[-1]
    with torch.cuda.device(dev):
        stream = _stream(dev)
        status = _status_words(dev, stream,
                               lib.repaq_run_offsets_status_words(rows, n))
        _launch("run_offsets", lib.repaq_run_offsets, mask.data_ptr(),
                off.data_ptr(), to_end.data_ptr(), rows, n,
                status.data_ptr(), stream)
    return off, to_end


def seg_positions_plain(adv: torch.Tensor,
                        seg_start: torch.Tensor) -> torch.Tensor:
    """Plain torch version of ``seg_positions``: the JAX expression."""
    raw = torch.cumsum(adv, 0, dtype=torch.int32)
    base = torch.cummax(torch.where(seg_start, raw - adv, 0), 0).values
    return raw - base.clamp(min=0) - 1


def seg_positions(adv: torch.Tensor, seg_start: torch.Tensor) -> torch.Tensor:
    """Positions of a segmented stream: raw - max(0, base) - 1 with raw the
    inclusive int32 prefix sum of the (m,) int32 adv and base, at each
    element, the largest raw[j] - adv[j] over the j <= i where the (m,)
    bool seg_start is set; exactly as ``seg_positions_plain`` while no
    prefix sum of adv leaves int32 (the decode's stay below 2^30: length <
    2^24 positions a bin and fewer than 64 bins). One launch."""
    if adv.dtype != torch.int32 or adv.dim() != 1:
        raise ValueError("seg_positions takes a 1-D int32 adv, got %s %s"
                         % (adv.dtype, tuple(adv.shape)))
    if seg_start.dtype != torch.bool or seg_start.shape != adv.shape:
        raise ValueError("seg_start must be a bool tensor of adv's shape, "
                         "got %s %s" % (seg_start.dtype,
                                         tuple(seg_start.shape)))
    if not _on_cuda(adv, seg_start):
        return seg_positions_plain(adv, seg_start)
    dev = adv.device
    n = adv.shape[0]
    pos = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return pos
    lib = _build.library()
    adv = _aligned(adv)
    seg_start = _aligned(seg_start)
    with torch.cuda.device(dev):
        stream = _stream(dev)
        status = _status_words(dev, stream,
                               lib.repaq_seg_positions_status_words(n))
        _launch("seg_positions", lib.repaq_seg_positions, adv.data_ptr(),
                seg_start.data_ptr(), pos.data_ptr(), n, status.data_ptr(),
                stream)
    return pos


# ---------------------------------------------------------------------------
# PE overlap search (JAX: XLA's double polynomial hash search,
# repaq_tpu/ops/device_streams.py:1303-1395)
# ---------------------------------------------------------------------------

_OV_ROWS = 1 << 16  # pairs a step of the plain version


def _first_overlap_plain(a: torch.Tensor, b: torch.Tensor,
                         minlen: int) -> torch.Tensor:
    """The smallest o in [12, minlen] with a[:, La-o:] == b[:, :o] a row,
    0 where none: (rows,) int32."""
    la = a.shape[1]
    found = torch.zeros(a.shape[0], dtype=torch.int32, device=a.device)
    for o in range(MIN_OVERLAP, minlen + 1):
        hit = (a[:, la - o:] == b[:, :o]).all(1)
        found = torch.where((found == 0) & hit, o, found)
    return found


def overlap_pairs_plain(r1: torch.Tensor, r2: torch.Tensor) -> torch.Tensor:
    """Plain torch version of ``overlap_pairs``: every o compared exactly,
    MIN_OVERLAP up, over steps of _OV_ROWS pairs."""
    p, l1 = r1.shape
    minlen = min(l1, r2.shape[1])
    ov = torch.zeros(p, dtype=torch.int32, device=r1.device)
    if minlen < MIN_OVERLAP:
        return ov
    for lo in range(0, p, _OV_ROWS):
        a, b = r1[lo:lo + _OV_ROWS], r2[lo:lo + _OV_ROWS]
        fwd = _first_overlap_plain(a, b, minlen)
        bwd = _first_overlap_plain(b, a, minlen)
        ov[lo:lo + _OV_ROWS] = torch.where(fwd > 0, fwd, -bwd)
    return ov


def _check_rows(name: str, t: torch.Tensor) -> None:
    """A 2-D uint8 tensor whose rows are contiguous (they may lie any
    stride apart)."""
    if t.dtype != torch.uint8 or t.dim() != 2:
        raise ValueError("%s must be a 2-D uint8 tensor, got %s %s"
                         % (name, t.dtype, tuple(t.shape)))
    if t.stride(1) != 1 and t.shape[1] > 1 and t.shape[0] > 0:
        raise ValueError("%s's rows must be contiguous (stride(1) == 1), "
                         "got strides %s" % (name, t.stride()))


def overlap_pairs(r1: torch.Tensor, r2: torch.Tensor) -> torch.Tensor:
    """First exact overlap of each pair of rows, the reference's search
    (rfqcodec.cpp:1391-1438) and codec/oracle.py's ``overlap``: +o for the
    smallest o in [12, minlen] with r1[p, L1-o:] == r2[p, :o], else -o for
    the smallest with r2[p, L2-o:] == r1[p, :o], else 0; minlen = min(L1,
    L2), raw bytes. r1: (p, L1) u8, r2: (p, L2) u8, r2's rows already
    reverse-complemented; each row contiguous, rows any stride apart (the
    odd and even rows of one grid, say). Returns (p,) int32. One launch.
    On no main path: the PE encode runs the same search inside
    ``pe_encode_pairs``."""
    _check_rows("r1", r1)
    _check_rows("r2", r2)
    if r1.shape[0] != r2.shape[0]:
        raise ValueError("r1 and r2 need one row count (got %d and %d)"
                         % (r1.shape[0], r2.shape[0]))
    if not _on_cuda(r1, r2):
        return overlap_pairs_plain(r1, r2)
    dev = r1.device
    p = r1.shape[0]
    out = torch.empty(p, dtype=torch.int32, device=dev)
    if p == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(dev):
        _launch("overlap_pairs", lib.repaq_overlap_pairs, r1.data_ptr(),
                r1.stride(0), r1.shape[1], r2.data_ptr(), r2.stride(0),
                r2.shape[1], p, out.data_ptr(), _stream(dev))
    return out


# ---------------------------------------------------------------------------
# PE pair tiles (JAX: XLA code of the PE encode step's revcomp, search and
# clamp, repaq_tpu/codec/device_engine.py:580-591, and of the PE decode
# step's expansion, N restore and revcomp, :984-1021)
# ---------------------------------------------------------------------------

# codec/vectorized.py's _COMP: ACGT and acgt to their uppercase
# complements, every other byte to 'N' (the kernels compute the same)
_COMP = [_N] * 256
for _a, _b in zip(b"AaTtCcGg", b"TTAAGGCC"):
    _COMP[_a] = _b


def comp_table(device) -> torch.Tensor:
    """(256,) uint8: byte -> the complement the PE kernels write."""
    return torch.tensor(_COMP, dtype=torch.uint8, device=device)


def pe_pair_tile(L: int, decode: int = 0) -> int:
    """Pairs a tile of pe_encode_pairs (decode 0) or of pe_decode_rows
    with tables (1) or without (2) at rows of L bytes, as the built
    library picks them; 0 where the decode takes its direct route (rows
    too long for a stage). The card tests place edge cases by it."""
    return int(_build.library().repaq_pe_pair_tile(L, decode))


def _check_grid(name: str, t: torch.Tensor) -> None:
    if t.dtype != torch.uint8 or t.dim() != 2 or not t.is_contiguous() \
            or t.shape[0] % 2:
        raise ValueError("%s must be a contiguous (rows, L) uint8 tensor of "
                         "an even row count, got %s %s"
                         % (name, t.dtype, tuple(t.shape)))


def pe_encode_pairs_plain(seq_mat: torch.Tensor, qual_mat: torch.Tensor,
                          n_pairs: int, shift: int,
                          search: bool) -> torch.Tensor:
    """Plain torch version of ``pe_encode_pairs``: the odd rows rewritten
    by a LUT gather of their flips, overlap_pairs_plain over the first
    n_pairs pairs, then the shift clamp."""
    seq_mat[1::2] = comp_table(seq_mat.device)[seq_mat[1::2].flip(1).long()]
    qual_mat[1::2] = qual_mat[1::2].flip(1)
    p_cap = seq_mat.shape[0] // 2
    ov = torch.zeros(p_cap, dtype=torch.int32, device=seq_mat.device)
    if search:
        n = max(0, min(int(n_pairs), p_cap))
        ov[:n] = overlap_pairs_plain(seq_mat[0:2 * n:2], seq_mat[1:2 * n:2])
        shifted = ov + shift
        ov = torch.where((shifted <= 127) & (shifted >= -127), ov, 0)
    return ov


def pe_encode_pairs(seq_mat: torch.Tensor, qual_mat: torch.Tensor,
                    n_pairs: int, shift: int, search: bool) -> torch.Tensor:
    """A PE encode chunk's pair work on its (rows, L) uint8 grids, in
    place: each odd seq row reverse-complemented (``comp_table``) and each
    odd qual row reversed; then, with ``search``, each pair's first exact
    overlap on the transformed rows (``overlap_pairs``' semantics: +o
    forward, -o backward, 0 none), 0 for the pairs at or past n_pairs, and
    the encode's shift clamp: 0 where |ov + shift| > 127. Without
    ``search`` (a header without the overlap flag) ov is all zeros.
    Returns ov, (rows / 2,) int32. Both grids contiguous, of one shape and
    an even row count. One launch."""
    _check_grid("seq_mat", seq_mat)
    _check_grid("qual_mat", qual_mat)
    if seq_mat.shape != qual_mat.shape:
        raise ValueError("seq_mat and qual_mat need one shape (got %s and "
                         "%s)" % (tuple(seq_mat.shape),
                                  tuple(qual_mat.shape)))
    rows, L = seq_mat.shape
    _check_size("the grid's bytes", rows * L)
    if not _on_cuda(seq_mat, qual_mat):
        return pe_encode_pairs_plain(seq_mat, qual_mat, n_pairs, shift,
                                     search)
    dev = seq_mat.device
    ov = torch.empty(rows // 2, dtype=torch.int32, device=dev)
    if rows == 0:
        return ov
    # the kernel reads the aligned vectors that hold the grids: one that
    # starts off 16 bytes is transformed in an aligned copy
    grids = [g if g.data_ptr() % 16 == 0 else g.clone()
             for g in (seq_mat, qual_mat)]
    lib = _build.library()
    with torch.cuda.device(dev):
        _launch("pe_encode_pairs", lib.repaq_pe_encode_pairs,
                grids[0].data_ptr(), grids[1].data_ptr(), L, rows // 2,
                max(0, min(int(n_pairs), rows // 2)), int(shift),
                int(bool(search)), ov.data_ptr(), _stream(dev))
    for g, mat in zip(grids, (seq_mat, qual_mat)):
        if g is not mat:
            mat.copy_(g)
    return ov


def pe_decode_rows_plain(stored: torch.Tensor, qual: torch.Tensor,
                         tables: torch.Tensor | None, L: int,
                         nbq: int | None = None,
                         out: torch.Tensor | None = None) -> torch.Tensor:
    """Plain torch version of ``pe_decode_rows``: an int32 index grid by
    three wheres, clamped, one gather, the N where, the odd rows' LUT
    gather of their flips, the quality's flips."""
    dev = qual.device
    rows = qual.shape[0] // L
    n = rows * L
    if out is None:
        out = torch.empty(2 * n, dtype=torch.uint8, device=dev)
    i = torch.arange(L, dtype=torch.int32, device=dev)[None, :]
    if tables is None:
        so = (torch.arange(rows, dtype=torch.int32, device=dev) * L)[:, None]
        f = w = prev = torch.zeros_like(so)
    else:
        so, f, w, prev = (t[:, None] for t in tables)
    odd = (torch.arange(rows, device=dev) % 2 == 1)[:, None]
    src = torch.where(i < f, so - f + i,
                      torch.where(i >= L - w, prev + i - (L - w), so + i - f))
    src = torch.where(odd, src, so + i)
    seq = stored[src.clamp(0, stored.shape[0] - 1).long()]
    qm = qual.view(rows, L)
    if nbq is not None:
        seq = torch.where(qm == nbq, _N, seq).to(torch.uint8)
    seq[1::2] = comp_table(dev)[seq[1::2].flip(1).long()]
    out[:n].view(rows, L).copy_(seq)
    oq = out[n:].view(rows, L)
    oq.copy_(qm)
    oq[1::2] = qm[1::2].flip(1)
    return out


def _check_decode_rows(stored, qual, tables, L, nbq, out) -> None:
    _check_u8("stored", stored)
    _check_u8("qual", qual)
    if L < 1 or qual.shape[0] % L or (qual.shape[0] // L) % 2:
        raise ValueError("qual must hold an even number of rows of L = %d "
                         "bytes, got %d bytes" % (L, qual.shape[0]))
    rows = qual.shape[0] // L
    _check_size("the grid's bytes", 2 * qual.shape[0])
    _check_size("stored", stored.shape[0])
    if rows and stored.shape[0] == 0:
        raise ValueError("stored holds no bytes for %d rows" % rows)
    if tables is not None and (tables.dtype != torch.int32
                               or tables.shape != (4, rows)):
        raise ValueError("tables must be a (4, %d) int32 tensor, got %s %s"
                         % (rows, tables.dtype, tuple(tables.shape)))
    if nbq is not None and not 0 <= nbq < 256:
        raise ValueError("nbq must be a byte or None, got %r" % (nbq,))
    if out is not None and (out.dtype != torch.uint8 or out.dim() != 1
                            or out.shape[0] != 2 * qual.shape[0]
                            or not out.is_contiguous()):
        raise ValueError("out must be a contiguous (%d,) uint8 tensor, got "
                         "%s %s" % (2 * qual.shape[0], out.dtype,
                                    tuple(out.shape)))


def pe_decode_rows(stored: torch.Tensor, qual: torch.Tensor,
                   tables: torch.Tensor | None, L: int,
                   nbq: int | None = None,
                   out: torch.Tensor | None = None) -> torch.Tensor:
    """A PE decode chunk's payload: out[:n] the (rows, L) seq grid, out[n:]
    the quality grid, n = rows * L. Row r is rebuilt from the stored bases
    by tables, (4, rows) int32 (stored offset so, forward and backward
    overlap f and w, the mate's stored offset prev): an even row is
    stored[so + i], an odd row stored[so - f + i] for i < f, stored[prev + i
    - (L - w)] for i >= L - w, else stored[so + i - f] (int32 arithmetic,
    the index clamped to [0, stored.numel())); tables=None stores every
    row's L bases at r * L. With nbq, 'N' where the row's quality (as
    decoded, before any reversal) equals nbq. Then odd seq rows are
    reverse-complemented (``comp_table``) and odd quality rows reversed.
    Rows past a chunk's reads have zero tables in the engine, so each holds
    stored[0:L] (its N restore and revcomp applied) and its decoded
    quality. stored: 1-D uint8; qual: (rows * L,) uint8, rows even; out:
    None for a new tensor. One launch; returns out."""
    _check_decode_rows(stored, qual, tables, L, nbq, out)
    tensors = [t for t in (stored, qual, tables, out) if t is not None]
    if not _on_cuda(*tensors):
        return pe_decode_rows_plain(stored, qual, tables, L, nbq, out)
    dev = qual.device
    rows = qual.shape[0] // L
    if out is None:
        out = torch.empty(2 * qual.shape[0], dtype=torch.uint8, device=dev)
    if rows == 0:
        return out
    stored, qual = _aligned(stored), _aligned(qual)
    tables = None if tables is None else tables.contiguous()
    lib = _build.library()
    with torch.cuda.device(dev):
        _launch("pe_decode_rows", lib.repaq_pe_decode_rows,
                stored.data_ptr(), stored.shape[0], qual.data_ptr(),
                None if tables is None else tables.data_ptr(), rows, L,
                -1 if nbq is None else int(nbq), out.data_ptr(),
                _stream(dev))
    return out


# ---------------------------------------------------------------------------
# masked run writes (JAX: XLA's .at[].set(mode="drop") scatters aimed at a
# dump element, repaq_tpu/ops/device_streams.py:982, :992, :1161, :1197,
# :1211, :1228, :1242, :1257 and repaq_tpu/codec/device_engine.py:845, :982)
# ---------------------------------------------------------------------------

_FILL_ENTRIES = {torch.uint8: "repaq_fill_runs_u8",
                 torch.bool: "repaq_fill_runs_u8",
                 torch.int32: "repaq_fill_runs_i32"}


def _per_entry(x, n: int, dtype, dev) -> torch.Tensor:
    """x as an (n,) tensor: x itself, or the scalar x repeated."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.full((n,), x, dtype=dtype, device=dev)


def fill_runs_plain(out: torch.Tensor, start: torch.Tensor, count, value,
                    keep: torch.Tensor | None = None) -> torch.Tensor:
    """Plain torch version of ``fill_runs``: the kept runs expanded to one
    index a written element, then one index_put_."""
    n, dev = start.shape[0], out.device
    c = _per_entry(count, n, torch.int32, dev).long().clamp(min=0)
    if keep is not None:
        c = torch.where(keep, c, 0)
    entry = torch.repeat_interleave(torch.arange(n, device=dev), c)
    first = torch.cumsum(c, 0) - c
    tgt = (start.long()[entry] + torch.arange(entry.shape[0], device=dev)
           - first[entry])
    ok = (tgt >= 0) & (tgt < out.shape[0])
    v = _per_entry(value, n, out.dtype, dev)
    out[tgt[ok]] = v[entry[ok]]
    return out


def _check_fill(out, start, count, value, keep) -> None:
    if out.dtype not in _FILL_ENTRIES or out.dim() != 1 or \
            not out.is_contiguous():
        raise ValueError("out must be a contiguous 1-D uint8, bool or int32 "
                         "tensor, got %s %s" % (out.dtype, tuple(out.shape)))
    if start.dtype != torch.int32 or start.dim() != 1:
        raise ValueError("start must be a 1-D int32 tensor, got %s %s"
                         % (start.dtype, tuple(start.shape)))
    n = start.shape[0]
    for name, t, dtype in (("count", count, torch.int32),
                           ("value", value, out.dtype),
                           ("keep", keep, torch.bool)):
        if isinstance(t, torch.Tensor) and (t.dtype != dtype
                                            or t.shape != (n,)):
            raise ValueError("%s must be a (%d,) %s tensor, got %s %s"
                             % (name, n, dtype, t.dtype, tuple(t.shape)))
    if not isinstance(count, torch.Tensor) and not 0 <= int(count) < 2**31:
        raise ValueError("count must be a non-negative int32, got %r"
                         % (count,))


def fill_runs(out: torch.Tensor, start: torch.Tensor, count, value,
              keep: torch.Tensor | None = None) -> torch.Tensor:
    """Masked run writes into out, in place: for each entry i with keep[i],
    out[start[i] + j] = value[i] for 0 <= j < count[i], each target kept
    only inside [0, out.numel()); masked entries and targets outside write
    nothing, so no spare element is needed. out: contiguous 1-D uint8,
    bool or int32; start: (n,) int32; count: (n,) int32 or one int for
    every entry (the decode's runs are at most 32); value: (n,) of out's
    dtype or one scalar; keep: (n,) bool, or None for every entry. Where
    two kept entries write one target, either value may land. One launch;
    returns out."""
    _check_fill(out, start, count, value, keep)
    tensors = [t for t in (out, start, count, value, keep)
               if isinstance(t, torch.Tensor)]
    if not _on_cuda(*tensors):
        return fill_runs_plain(out, start, count, value, keep)
    n = start.shape[0]
    if n == 0:
        return out
    lib = _build.library()
    start = start.contiguous()
    cnt = count.contiguous() if isinstance(count, torch.Tensor) else None
    val = value.contiguous() if isinstance(value, torch.Tensor) else None
    keep = None if keep is None else keep.contiguous()
    with torch.cuda.device(out.device):
        _launch("fill_runs", getattr(lib, _FILL_ENTRIES[out.dtype]),
                out.data_ptr(), out.numel(), start.data_ptr(),
                None if cnt is None else cnt.data_ptr(),
                0 if cnt is not None else int(count),
                None if val is None else val.data_ptr(),
                0 if val is not None else int(value),
                None if keep is None else keep.data_ptr(), n,
                _stream(out.device))
    return out


# ---------------------------------------------------------------------------
# sorted runs, written a tile of the output at a time (JAX: the decode's
# quality writes, repaq_tpu/ops/device_streams.py:1160-1161, :1197,
# :1241-1242, and the PE elision's sort by destination,
# repaq_tpu/codec/device_engine.py:606-618)
# ---------------------------------------------------------------------------

_RUNS_MAX_SEGMENTS = 256


def sorted_runs_tile() -> int:
    """Output bytes a tile of the sorted-run kernels (fill_sorted_runs,
    concat_row_spans), as the built library reports it; the card tests and
    chip_smoke.py place edge cases by it."""
    return int(_build.library().repaq_sorted_runs_tile())


def segment_bounds(seg_off: torch.Tensor, n: int) -> list:
    """The segments' entry bounds as the kernels read seg_off: each offset
    clamped to [0, n] and raised to the largest before it, so segment s is
    [b[s], b[s + 1]) and the segments are disjoint and in order."""
    bounds, top = [], 0
    for v in seg_off.tolist():
        top = max(top, min(max(int(v), 0), n))
        bounds.append(top)
    return bounds


def fill_sorted_runs_plain(length: int, background: int,
                           start: torch.Tensor, count: torch.Tensor,
                           seg_off: torch.Tensor,
                           seg_value: torch.Tensor) -> torch.Tensor:
    """Plain torch version of ``fill_sorted_runs``: torch.full, then
    fill_runs_plain of each segment's entries, segment by segment."""
    out = torch.full((length,), background, dtype=torch.uint8,
                     device=start.device)
    b = segment_bounds(seg_off, start.shape[0])
    for s, v in enumerate(seg_value.tolist()):
        if b[s] < b[s + 1]:
            fill_runs_plain(out, start[b[s]:b[s + 1]],
                            count[b[s]:b[s + 1]], int(v))
    return out


def _check_size(name: str, v: int) -> None:
    if not 0 <= v < 2**31:
        raise ValueError("%s must be in [0, 2^31), got %d" % (name, v))


def _check_entries(names: tuple, tensors: tuple, n: int) -> None:
    for name, t in zip(names, tensors):
        if t.dtype != torch.int32 or t.shape != (n,):
            raise ValueError("%s must be a (%d,) int32 tensor, got %s %s"
                             % (name, n, t.dtype, tuple(t.shape)))


def _check_sorted_runs(length, background, start, count, seg_off,
                       seg_value) -> None:
    _check_size("length", length)
    if not 0 <= background < 256:
        raise ValueError("background must be a byte, got %d" % background)
    n = start.shape[0] if start.dim() == 1 else -1
    _check_entries(("start", "count"), (start, count), n)
    _check_size("the entries", n)
    if seg_value.dtype != torch.uint8 or seg_value.dim() != 1 or \
            seg_value.shape[0] > _RUNS_MAX_SEGMENTS:
        raise ValueError("seg_value must be a 1-D uint8 tensor of at most %d "
                         "segments, got %s %s" % (_RUNS_MAX_SEGMENTS,
                                                  seg_value.dtype,
                                                  tuple(seg_value.shape)))
    _check_entries(("seg_off",), (seg_off,), seg_value.shape[0] + 1)


def fill_sorted_runs(length: int, background: int, start: torch.Tensor,
                     count: torch.Tensor, seg_off: torch.Tensor,
                     seg_value: torch.Tensor) -> torch.Tensor:
    """A new (length,) uint8 tensor: background everywhere but where a run
    writes. For each segment s and entry i in [seg_off[s], seg_off[s + 1]),
    out[start[i] + j] = seg_value[s] for 0 <= j < count[i], each target
    kept only inside [0, length); a later segment's byte lands over an
    earlier one's. start, count: (n,) int32; seg_off: (S + 1,) int32, read
    as segment_bounds reads it; seg_value: (S,) uint8, S <= 256. Exact as
    fill_sorted_runs_plain on any input; fastest where, within a segment,
    each run ends at or before the next one's start (the decode's tokens:
    a segment that breaks it is read whole by every tile). One call is
    counted as one launch: two kernels, an order check and the tiles."""
    _check_sorted_runs(length, background, start, count, seg_off, seg_value)
    if not _on_cuda(start, count, seg_off, seg_value):
        return fill_sorted_runs_plain(length, background, start, count,
                                      seg_off, seg_value)
    dev, n, nseg = start.device, start.shape[0], seg_value.shape[0]
    out = torch.empty(length, dtype=torch.uint8, device=dev)
    if length == 0:
        return out
    lib = _build.library()
    start, count = _aligned(start), _aligned(count)
    seg_off, seg_value = seg_off.contiguous(), seg_value.contiguous()
    scratch = torch.empty(lib.repaq_sorted_runs_scratch_words(n, nseg,
                                                              length),
                          dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _launch("fill_sorted_runs", lib.repaq_fill_sorted_runs,
                out.data_ptr(), length, background, start.data_ptr(),
                count.data_ptr(), n, seg_off.data_ptr(), seg_value.data_ptr(),
                nseg, scratch.data_ptr(), _stream(dev))
    return out


def concat_row_spans_plain(src: torch.Tensor, src_start: torch.Tensor,
                           span: torch.Tensor, dest_off: torch.Tensor,
                           length: int, background: int) -> torch.Tensor:
    """Plain torch version of ``concat_row_spans``: every source byte's
    destination, the ones no span keeps aimed at a spare last byte, then
    one index_put_ into a background-filled buffer."""
    dev, width = src.device, src.shape[1]
    rel = (torch.arange(width, device=dev)[None, :]
           - src_start.long()[:, None])
    dest = dest_off.long()[:, None] + rel
    keep = ((rel >= 0) & (rel < span.long()[:, None]) & (dest >= 0)
            & (dest < length))
    out = torch.full((length + 1,), background, dtype=torch.uint8,
                     device=dev)
    out[torch.where(keep, dest, length).reshape(-1)] = src.reshape(-1)
    return out[:length]


def concat_row_spans(src: torch.Tensor, src_start: torch.Tensor,
                     span: torch.Tensor, dest_off: torch.Tensor, length: int,
                     background: int) -> torch.Tensor:
    """A new (length,) uint8 tensor: for each row r of the (rows, width)
    uint8 src, out[dest_off[r] + j] = src[r, src_start[r] + j] for 0 <= j <
    span[r] where the source column lies in [0, width) and the target in
    [0, length); background elsewhere. src's rows contiguous, any stride
    apart; src_start, span, dest_off: (rows,) int32. Where two rows write
    one target, either byte may land (the elision's rows, dest_off the
    exclusive prefix sum of span, write disjoint spans). The same kernels
    as fill_sorted_runs, the rows one segment; one call is counted as one
    launch."""
    _check_rows("src", src)
    rows, width = src.shape
    _check_size("length", length)
    _check_size("rows", rows)
    if not 0 <= background < 256:
        raise ValueError("background must be a byte, got %d" % background)
    _check_entries(("src_start", "span", "dest_off"),
                   (src_start, span, dest_off), rows)
    if not _on_cuda(src, src_start, span, dest_off):
        return concat_row_spans_plain(src, src_start, span, dest_off, length,
                                      background)
    dev = src.device
    out = torch.empty(length, dtype=torch.uint8, device=dev)
    if length == 0:
        return out
    lib = _build.library()
    src_start, span, dest_off = (src_start.contiguous(), _aligned(span),
                                 _aligned(dest_off))
    scratch = torch.empty(lib.repaq_sorted_runs_scratch_words(rows, 1,
                                                              length),
                          dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _launch("concat_row_spans", lib.repaq_concat_row_spans,
                out.data_ptr(), length, background, src.data_ptr(),
                src.stride(0), width, src_start.data_ptr(), span.data_ptr(),
                dest_off.data_ptr(), rows, scratch.data_ptr(), _stream(dev))
    return out


# ---------------------------------------------------------------------------
# stable bucket compaction (JAX: XLA's sorts that compact or group by key,
# repaq_tpu/ops/device_streams.py:136, :187, :237, :403-419, :502, :536,
# :1094)
# ---------------------------------------------------------------------------

_COMPACT_MAX_BUCKETS = 256


def compact_tile(is_mask: bool, nbuckets: int, n: int = 1) -> int:
    """Elements per tile of the route a bucket_compact call of this form
    and n elements takes (a mask, its tile growing past
    compact_mask_switch() tiles; ids up to 8 buckets; more), as the built
    library reports it; the card tests and chip_smoke.py place edge cases
    by it."""
    return int(_build.library().repaq_bucket_compact_tile(int(is_mask),
                                                          nbuckets, n))


def compact_mask_switch() -> int:
    """The most tiles of compact_tile(True, 1) a mask call takes; a
    larger call takes larger tiles."""
    return int(_build.library().repaq_bucket_compact_mask_switch())


def compact_wave(is_mask: bool, nbuckets: int, n: int = 1) -> int:
    """Tiles one wave of resident blocks takes at once in the route of a
    bucket_compact call of this form and n elements on the current CUDA
    device (its blocks take tiles until none is left), 0 where a block
    takes one tile; the card tests give the kernel more tiles than
    this."""
    return int(_build.library().repaq_bucket_compact_wave(int(is_mask),
                                                          nbuckets, n))


def bucket_compact_plain(bucket: torch.Tensor, nbuckets: int, cap: int,
                         fill: int, payload: torch.Tensor | None = None):
    """Plain torch version of ``bucket_compact``: one stable sort of the
    int64 keys bucket * n + i (the dropped elements after every bucket),
    then the payload gather."""
    n, dev = bucket.shape[0], bucket.device
    # a bool mask's True is bucket 0, its False bucket 1 (dropped)
    b = (~bucket if bucket.dtype == torch.bool else bucket).long()
    i = torch.arange(n, dtype=torch.long, device=dev)
    kept = b < nbuckets
    keys = torch.where(kept, b * n + i, nbuckets * n)
    skeys = torch.sort(keys, stable=True).values[:cap]
    pad = cap - skeys.shape[0]
    if pad > 0:
        skeys = torch.cat([skeys, torch.full((pad,), nbuckets * n,
                                             dtype=torch.long, device=dev)])
    ok = skeys < nbuckets * n
    src = torch.where(ok, skeys % max(n, 1), 0)
    idx = torch.where(ok, src, fill).to(torch.int32)
    pay = None
    if payload is not None:
        pay = torch.where(ok, payload[src] if n else 0, 0).to(torch.int32)
    counts = torch.bincount(b[kept], minlength=nbuckets)[:nbuckets]
    return idx, pay, counts.to(torch.int32)


def _check_compact(bucket, nbuckets, cap, fill, payload) -> None:
    if bucket.dim() != 1 or bucket.dtype not in (torch.bool, torch.uint8):
        raise ValueError("bucket must be a 1-D bool or uint8 tensor, got %s "
                         "%s" % (bucket.dtype, tuple(bucket.shape)))
    if bucket.dtype == torch.bool and nbuckets != 1:
        raise ValueError("a bool mask is one bucket, got nbuckets %d"
                         % nbuckets)
    if not 1 <= nbuckets <= _COMPACT_MAX_BUCKETS:
        raise ValueError("nbuckets must be in 1..%d, got %d"
                         % (_COMPACT_MAX_BUCKETS, nbuckets))
    if not 0 <= cap < 2**31 or bucket.shape[0] >= 2**31 or \
            not -2**31 <= fill < 2**31:
        raise ValueError("n and cap must be below 2^31 and fill an int32 "
                         "(n %d, cap %d, fill %d)"
                         % (bucket.shape[0], cap, fill))
    if payload is not None and (payload.dtype != torch.int32
                                or payload.shape != bucket.shape):
        raise ValueError("payload must be an int32 tensor of bucket's "
                         "shape, got %s %s" % (payload.dtype,
                                                tuple(payload.shape)))


def bucket_compact(bucket: torch.Tensor, nbuckets: int, cap: int, fill: int,
                   payload: torch.Tensor | None = None):
    """Stable compaction of the elements by bucket: bucket is an (n,) bool
    mask (nbuckets 1, True kept) or uint8 bucket ids (ids >= nbuckets
    dropped), nbuckets <= 256. Returns (idx, pay, counts): idx (cap,)
    int32, the kept i ordered by (bucket id, i), cut to cap, fill past the
    kept ones; pay (cap,) int32, payload[idx] and 0 past the kept ones
    (None without a payload, an (n,) int32 tensor); counts (nbuckets,)
    int32, each bucket's full count, not cut by cap. n < 2^31. A call is
    counted as one launch: one kernel for a mask, two for ids up to 8
    buckets, three above."""
    _check_compact(bucket, nbuckets, cap, fill, payload)
    tensors = (bucket,) if payload is None else (bucket, payload)
    if not _on_cuda(*tensors):
        return bucket_compact_plain(bucket, nbuckets, cap, fill, payload)
    dev, n = bucket.device, bucket.shape[0]
    idx = torch.empty(cap, dtype=torch.int32, device=dev)
    pay = None if payload is None else torch.empty(cap, dtype=torch.int32,
                                                   device=dev)
    counts = torch.empty(nbuckets, dtype=torch.int32, device=dev)
    if n == 0:
        idx.fill_(fill)
        counts.zero_()
        return idx, None if pay is None else pay.zero_(), counts
    lib = _build.library()
    bucket = _aligned(bucket)
    payload = None if payload is None else _aligned(payload)
    is_mask = int(bucket.dtype == torch.bool)
    words = lib.repaq_bucket_compact_scratch_words(n, nbuckets, is_mask)
    scratch = (torch.empty(words, dtype=torch.int32, device=dev) if words
               else None)
    with torch.cuda.device(dev):
        stream = _stream(dev)
        status = _status_words(dev, stream,
                               lib.repaq_bucket_compact_status_words(
                                   n, nbuckets, is_mask))
        _launch("bucket_compact", lib.repaq_bucket_compact,
                bucket.data_ptr(), is_mask, n, nbuckets, cap, int(fill),
                None if payload is None else payload.data_ptr(),
                idx.data_ptr(), None if pay is None else pay.data_ptr(),
                counts.data_ptr(),
                None if scratch is None else scratch.data_ptr(),
                status.data_ptr(), stream)
    return idx, pay, counts
