"""The hand-written CUDA kernels of the port, each beside its plain torch
version; the counterpart of repaq_tpu/ops/pallas_tpu.py, and of the
run-boundary scans that the JAX package left to XLA.

Every wrapper decides by the device of the tensor it is given: a CPU
tensor runs the plain version, a CUDA tensor launches the kernel (built on
first use by ``_build``) and raises if the launch is refused. There is no
fallback from one to the other. ``launches`` counts kernel launches per
wrapper, so a run can show that its main path went through the kernels;
the rANS wrappers of ``rans_device`` count here too.
"""

from __future__ import annotations

import threading

import torch

from . import _build

_G, _A, _T, _C, _N = 71, 65, 84, 67, 78

launches = {"encode_frontend": 0, "encode_frontend_bytes": 0,
            "pack_bases": 0, "unpack_bases": 0, "token_start_mask": 0,
            "cummax": 0, "suffix_min": 0, "rans_encode": 0, "rans_layout": 0, "rans_decode": 0}
_launch_lock = threading.Lock()


def reset_launches() -> None:
    with _launch_lock:
        for k in launches:
            launches[k] = 0


def _counted(name: str) -> None:
    with _launch_lock:
        launches[name] += 1


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


def _frontend_launch(name: str, seq, qual, bins, major: int):
    """Launch the frontend kernel, counted under `name`."""
    n = seq.shape[0]
    packed = torch.empty((n + 3) // 4, dtype=torch.uint8, device=seq.device)
    meta = torch.empty(n, dtype=torch.uint8, device=seq.device)
    if n == 0:
        return packed, meta
    lib = _build.library()
    seq, qual, bins = _aligned(seq), _aligned(qual), bins.contiguous()
    with torch.cuda.device(seq.device):
        _launch(name, lib.repaq_encode_frontend, seq.data_ptr(),
                qual.data_ptr(), bins.data_ptr(), int(bins.shape[0]),
                int(major), packed.data_ptr(), meta.data_ptr(), n,
                _stream(seq.device))
    return packed, meta


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
    return _frontend_launch("encode_frontend", seq, qual, bins, int(major))


def _split_meta(packed, meta):
    return packed, meta >= 0x80, (meta & 0x7F).to(torch.int32)


def encode_frontend_bytes_plain(seq: torch.Tensor, qual: torch.Tensor,
                                bins: torch.Tensor, major: int):
    """Plain torch version of ``encode_frontend_bytes``."""
    return _split_meta(*encode_frontend_plain(seq, qual, bins, int(major)))


def encode_frontend_bytes(seq: torch.Tensor, qual: torch.Tensor,
                          bins: torch.Tensor, major: int):
    """The byte form of the frontend, with the signature and meaning of
    repaq_tpu.ops.pallas_tpu.encode_frontend_pallas: (seq (n,) u8, qual
    (n,) u8, bins (B,) u8, major) -> (packed ((n+3)//4,) u8, nmask (n,)
    bool, bid (n,) int32), any n. bid: 0..B-1 palette entry, B escape, B+1
    major. Launches the frontend kernel (counted as
    ``encode_frontend_bytes``) and splits its meta bytes; the engine reads
    the meta bytes of ``encode_frontend`` instead."""
    _check_frontend(seq, qual, bins, major)
    if not _on_cuda(seq, qual, bins):
        return encode_frontend_bytes_plain(seq, qual, bins, major)
    return _split_meta(*_frontend_launch(
        "encode_frontend_bytes", seq, qual, bins, int(major)))


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
# run-boundary scans (JAX: XLA's lax.cummax and flipped lax.cummin, in
# repaq_tpu/ops/device_streams.py `_cummax` / `_suffix_min`)
# ---------------------------------------------------------------------------


def scan_tile() -> int:
    """Elements per tile of the scan kernel, as the built library reports
    it; the card tests and chip_smoke.py place edge cases by it."""
    return int(_build.library().repaq_scan_tile())


def cummax_i32_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain torch version of ``cummax_i32``."""
    return torch.cummax(x, -1).values


def suffix_min_i32_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain torch version of ``suffix_min_i32``."""
    return torch.cummin(x.flip(-1), -1).values.flip(-1)


def _check_scan(x: torch.Tensor) -> None:
    if x.dtype != torch.int32 or x.dim() not in (1, 2):
        raise ValueError("the scans take a 1-D or 2-D int32 tensor, got %s "
                         "%s" % (x.dtype, tuple(x.shape)))


def _scan(name: str, x: torch.Tensor, suffix_min: bool) -> torch.Tensor:
    """Launch the scan kernel over the last dimension of x, counted under
    `name`."""
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return out
    lib = _build.library()
    dev = x.device
    x = _aligned(x)
    rows = 1 if x.dim() == 1 else x.shape[0]
    n = x.shape[-1]
    # the tiles' status words and the tile counter start at zero
    status = torch.zeros(lib.repaq_scan_status_words(rows, n),
                         dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        _launch(name, lib.repaq_scan_i32, x.data_ptr(), out.data_ptr(), rows,
                n, int(suffix_min), status.data_ptr(), _stream(dev))
    return out


def cummax_i32(x: torch.Tensor) -> torch.Tensor:
    """Inclusive running maximum of a (n,) or (rows, n) int32 tensor along
    its last dimension, exactly as ``cummax_i32_plain``."""
    _check_scan(x)
    if not _on_cuda(x):
        return cummax_i32_plain(x)
    return _scan("cummax", x, False)


def suffix_min_i32(x: torch.Tensor) -> torch.Tensor:
    """Inclusive running minimum from the end of a (n,) or (rows, n) int32
    tensor along its last dimension (out[..., i] = x[..., i:].min()),
    exactly as ``suffix_min_i32_plain``; the kernel reads backwards and
    copies nothing."""
    _check_scan(x)
    if not _on_cuda(x):
        return suffix_min_i32_plain(x)
    return _scan("suffix_min", x, True)
