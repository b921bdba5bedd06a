"""Build and load the package's CUDA kernels.

The sources in ``repaq_tpu_torch/csrc/*.cu`` have a plain C interface.
At first use each is compiled with ``nvcc`` for ``sm_90a`` to an object
file, all sources at once in parallel processes, and the objects are
linked into one shared library under ``repaq_tpu_torch/_build/``, loaded
with ``ctypes``: pointers and the CUDA stream travel as ``c_void_p``. The
library's name carries a hash of the sources and flags, so an edited
source is rebuilt and a current build is reused by every later process.

A failed build raises. Nothing here falls back to the plain versions.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
]

_lock = threading.Lock()  # CLI worker threads reach the first build together
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels of "
        "repaq_tpu_torch cannot be built"
    )


def _sources() -> list[str]:
    srcs = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    if not srcs:
        raise RuntimeError("no CUDA sources under %s" % CSRC)
    return srcs


def _build() -> str:
    """Compile the sources unless a build of exactly them exists; return
    the library's path."""
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        with open(s, "rb") as f:
            h.update(f.read())
    path = os.path.join(BUILD_DIR,
                        "librepaq_kernels-%s.so" % h.hexdigest()[:16])
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    stem = "%s.tmp%d" % (path[:-3], os.getpid())
    objs = ["%s.%d.o" % (stem, i) for i in range(len(srcs))]
    nvcc = _nvcc()
    try:
        # one nvcc per source, all started together, then one link
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", s, "-o", o],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(srcs, objs)]
        outs = [p.communicate()[0] for p in procs]
        failed = [(s, p.returncode, out)
                  for s, p, out in zip(srcs, procs, outs) if p.returncode]
        if not failed:
            r = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o",
                                stem + ".so", *objs],
                               capture_output=True, text=True)
            if r.returncode:
                failed = [("the link", r.returncode, r.stdout + r.stderr)]
        if failed:
            raise RuntimeError("nvcc failed building the CUDA kernels:\n"
                               + "\n".join("%s (rc %d):\n%s" % f
                                            for f in failed))
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    # atomic: a concurrent process sees all or nothing
    os.replace(stem + ".so", path)
    return path


def _bind(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.repaq_encode_frontend.argtypes = [vp, vp, vp, ci, ci, vp, vp, ll, vp]
    lib.repaq_encode_frontend.restype = ci
    lib.repaq_encode_frontend_bytes.argtypes = [vp, vp, vp, ci, ci, vp, vp,
                                                vp, ll, vp]
    lib.repaq_encode_frontend_bytes.restype = ci
    lib.repaq_pack_bases.argtypes = [vp, vp, ll, vp]
    lib.repaq_pack_bases.restype = ci
    lib.repaq_pack_wave_bases.argtypes = []
    lib.repaq_pack_wave_bases.restype = ll
    lib.repaq_frontend_bytes_wave_bases.argtypes = []
    lib.repaq_frontend_bytes_wave_bases.restype = ll
    lib.repaq_unpack_bases.argtypes = [vp, vp, ll, vp]
    lib.repaq_unpack_bases.restype = ci
    lib.repaq_token_start_mask.argtypes = [vp, ci, vp, ll, vp, vp, vp]
    lib.repaq_token_start_mask.restype = ci
    lib.repaq_token_fsm_status_words.argtypes = [ll]
    lib.repaq_token_fsm_status_words.restype = ll
    lib.repaq_token_fsm_tile.argtypes = []
    lib.repaq_token_fsm_tile.restype = ll
    lib.repaq_run_offsets.argtypes = [vp, vp, vp, ll, ll, vp, vp]
    lib.repaq_run_offsets.restype = ci
    lib.repaq_run_offsets_status_words.argtypes = [ll, ll]
    lib.repaq_run_offsets_status_words.restype = ll
    lib.repaq_run_offsets_tile.argtypes = []
    lib.repaq_run_offsets_tile.restype = ll
    lib.repaq_seg_positions.argtypes = [vp, vp, vp, ll, vp, vp]
    lib.repaq_seg_positions.restype = ci
    lib.repaq_seg_positions_status_words.argtypes = [ll]
    lib.repaq_seg_positions_status_words.restype = ll
    lib.repaq_seg_positions_tile.argtypes = []
    lib.repaq_seg_positions_tile.restype = ll
    lib.repaq_rans_encode.argtypes = [vp, ll, ci, vp, vp, ci, ll, vp, vp, vp,
                                      vp]
    lib.repaq_rans_encode.restype = ci
    lib.repaq_rans_encode_window.argtypes = []
    lib.repaq_rans_encode_window.restype = ll
    lib.repaq_rans_layout.argtypes = [vp, vp, vp, vp, ci, ll, vp, ll, vp,
                                      vp]
    lib.repaq_rans_layout.restype = ci
    lib.repaq_rans_layout_status_words.argtypes = [ci, ll]
    lib.repaq_rans_layout_status_words.restype = ll
    lib.repaq_rans_layout_tile_steps.argtypes = []
    lib.repaq_rans_layout_tile_steps.restype = ll
    lib.repaq_rans_layout_tile_lanes.argtypes = []
    lib.repaq_rans_layout_tile_lanes.restype = ll
    lib.repaq_rans_decode.argtypes = [vp, ll, vp, ci, ll, vp, vp, ci, ci, ci,
                                      vp, vp]
    lib.repaq_rans_decode.restype = ci
    lib.repaq_rans_decode_window.argtypes = []
    lib.repaq_rans_decode_window.restype = ll
    lib.repaq_rans_decode_shared_rows.argtypes = []
    lib.repaq_rans_decode_shared_rows.restype = ll
    lib.repaq_overlap_pairs.argtypes = [vp, ll, ci, vp, ll, ci, ll, vp, vp]
    lib.repaq_overlap_pairs.restype = ci
    lib.repaq_pe_pair_tile.argtypes = [ci, ci]
    lib.repaq_pe_pair_tile.restype = ll
    lib.repaq_pe_encode_pairs.argtypes = [vp, vp, ci, ll, ll, ci, ci, vp, vp]
    lib.repaq_pe_encode_pairs.restype = ci
    lib.repaq_pe_decode_rows.argtypes = [vp, ci, vp, vp, ll, ci, ci, vp, vp]
    lib.repaq_pe_decode_rows.restype = ci
    for entry in (lib.repaq_fill_runs_u8, lib.repaq_fill_runs_i32):
        entry.argtypes = [vp, ll, vp, vp, ci, vp, ci, vp, ll, vp]
        entry.restype = ci
    lib.repaq_sorted_runs_tile.argtypes = []
    lib.repaq_sorted_runs_tile.restype = ll
    lib.repaq_sorted_runs_scratch_words.argtypes = [ll, ci, ll]
    lib.repaq_sorted_runs_scratch_words.restype = ll
    lib.repaq_fill_sorted_runs.argtypes = [vp, ll, ci, vp, vp, ll, vp, vp, ci,
                                           vp, vp]
    lib.repaq_fill_sorted_runs.restype = ci
    lib.repaq_concat_row_spans.argtypes = [vp, ll, ci, vp, ll, ll, vp, vp, vp,
                                           ll, vp, vp]
    lib.repaq_concat_row_spans.restype = ci
    lib.repaq_bucket_compact.argtypes = [vp, ci, ll, ci, ll, ci, vp, vp, vp,
                                         vp, vp, vp, vp]
    lib.repaq_bucket_compact.restype = ci
    for entry in (lib.repaq_bucket_compact_scratch_words,
                  lib.repaq_bucket_compact_status_words):
        entry.argtypes = [ll, ci, ci]
        entry.restype = ll
    for entry in (lib.repaq_bucket_compact_tile,
                  lib.repaq_bucket_compact_wave):
        entry.argtypes = [ci, ci, ll]
        entry.restype = ll
    lib.repaq_bucket_compact_mask_switch.argtypes = []
    lib.repaq_bucket_compact_mask_switch.restype = ll
    lib.repaq_emit_tokens.argtypes = [vp, ll, vp, ci, vp, ll, ll, ll, vp, ll,
                                      vp, vp]
    lib.repaq_emit_tokens.restype = ci
    lib.repaq_emit_status_words.argtypes = [ll, ci]
    lib.repaq_emit_status_words.restype = ll
    lib.repaq_emit_tile.argtypes = [ci]
    lib.repaq_emit_tile.restype = ll
    lib.repaq_emit_wave.argtypes = [ci]
    lib.repaq_emit_wave.restype = ll
    lib.repaq_parse_tokens.argtypes = [vp, ll, ci, ll, ll, ll, vp, vp, vp, vp,
                                       vp, vp, ll, vp]
    lib.repaq_parse_tokens.restype = ci
    lib.repaq_parse_max_tiles.argtypes = [ll, ci, ll]
    lib.repaq_parse_max_tiles.restype = ll
    lib.repaq_parse_status_words.argtypes = [ll]
    lib.repaq_parse_status_words.restype = ll
    lib.repaq_parse_tile.argtypes = []
    lib.repaq_parse_tile.restype = ll
    lib.repaq_parse_wave.argtypes = []
    lib.repaq_parse_wave.restype = ll
    lib.repaq_coords_emit.argtypes = [vp, ll, ll, vp, ll, vp, vp, vp]
    lib.repaq_coords_emit.restype = ci
    lib.repaq_coords_status_words.argtypes = [ll]
    lib.repaq_coords_status_words.restype = ll
    lib.repaq_coords_tile.argtypes = []
    lib.repaq_coords_tile.restype = ll
    lib.repaq_qual_stats.argtypes = [vp, vp, ll, vp, vp]
    lib.repaq_qual_stats.restype = ci
    lib.repaq_stats_buffer_bytes.argtypes = [ll]
    lib.repaq_stats_buffer_bytes.restype = ll
    lib.repaq_stats_tile.argtypes = []
    lib.repaq_stats_tile.restype = ll
    lib.repaq_graph_nodes.argtypes = [vp, vp, vp, ll, ll]
    lib.repaq_graph_nodes.restype = ll
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(_build())
        return _lib
