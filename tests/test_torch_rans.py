"""The port's `.rfqz` rANS stage (repaq_tpu_torch/ops/rans_device.py) and
its CLI wiring against the JAX module (repaq_tpu/ops/rans_device.py), the
host oracle (repaq_tpu/codec/rans_np.py) and repaq_tpu.cli.

On the CPU the kernel wrappers run their plain torch versions; the CUDA
kernels are held against those in tests/test_torch_cuda.py. Inputs come
from seeds with numpy and go to both packages. Everything is integer: the
tolerance is exact equality."""

import functools
import io
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repaq_tpu.codec import rans_np as R
from repaq_tpu.codec import vectorized
from repaq_tpu.format import rfqz
from repaq_tpu.ops import rans_device as D
from repaq_tpu_torch import cli as tcli
from repaq_tpu_torch.codec import rans_np as TR
from repaq_tpu_torch.ops import _build
from repaq_tpu_torch.ops import kernels as TK
from repaq_tpu_torch.ops import rans_device as T

from test_device_engine import _mk_block

REPO = Path(__file__).resolve().parent.parent
ALPHABET = np.frombuffer(b"\x00\x01\x01\x01\x02\x05\x80\xff\x41\x41", np.uint8)


def _skewed(n, seed):
    return np.random.default_rng(seed).choice(ALPHABET, size=n)


def _markov(n, nsym, base, seed):
    """Strong context dependence over nsym symbols from `base`, as
    tests/test_rans.py::test_device_order1_compact_variants makes it."""
    rng = np.random.default_rng(seed)
    step = (rng.random(n) < 0.3).astype(np.int64)
    return (base + np.cumsum(step) % nsym).astype(np.uint8)


# the input of each branch of the JAX section coder, plus ragged and empty
BRANCHES = {
    "o0_fast_image": (lambda: _skewed(64 * 512, 3), 0, 64),
    "o0_wide": (lambda: np.random.default_rng(1).integers(
        0, 64, size=64 * 300, dtype=np.uint8), 0, 64),
    "o1_compact_no_zero": (lambda: _markov(48 * 256, 4, 65, 2), 1, 32),
    "o1_compact_with_zero": (lambda: _markov(48 * 256, 16, 0, 3), 1, 32),
    "o1_wide": (lambda: _markov(48 * 256, 24, 1, 4), 1, 32),
    "o1_skewed": (lambda: _skewed(64 * 512, 5), 1, 64),
    "single_symbol": (lambda: np.full(32 * 300, 0x42, np.uint8), 0, 32),
    "single_symbol_o1": (lambda: np.full(32 * 300, 0x42, np.uint8), 1, 32),
    "incompressible_o0": (lambda: np.random.default_rng(6).integers(
        0, 256, size=16 * 700, dtype=np.uint8), 0, 16),
    "incompressible_o1": (lambda: np.random.default_rng(7).integers(
        0, 256, size=16 * 700, dtype=np.uint8), 1, 16),
    "ragged_1003": (lambda: _skewed(1003, 4), 0, 64),
    "ragged_1003_o1": (lambda: _skewed(1003, 4), 1, 64),
    "ragged_more_lanes_than_bytes": (lambda: _skewed(37, 8), 1, 64),
    "empty": (lambda: np.zeros(0, np.uint8), 0, 64),
}


def _tables(data, order, lanes):
    """JAX's equal-split tables (build_luts_grid) for data."""
    grid = data.reshape(lanes, -1).T
    return D.build_luts_grid(grid, order)


# ---------------------------------------------------------------------------
# the kernel-level functions against JAX's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("lanes", [16, 64])
def test_encode_matches_jax(order, lanes):
    data = _skewed(lanes * 97, lanes + order)
    _h, freqs, cum, _s = _tables(data, order, lanes)
    words, emits, final = T.rans_encode_device(
        torch.from_numpy(data), torch.from_numpy(freqs),
        torch.from_numpy(cum), lanes, order)
    jw, je, jf = jax.jit(D.rans_encode_device, static_argnums=(3, 4))(
        jnp.asarray(data), jnp.asarray(freqs), jnp.asarray(cum), lanes,
        order)
    assert words.dtype == torch.uint16
    assert np.array_equal(words.numpy(), np.asarray(jw))
    assert np.array_equal(emits.numpy(), np.asarray(je))
    assert np.array_equal(final.numpy(), np.asarray(jf).astype(np.int64))


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("lanes", [16, 64])
def test_encode_payload_matches_jax(order, lanes):
    data = _skewed(lanes * 131, 2 * lanes + order)
    _h, freqs, cum, _s = _tables(data, order, lanes)
    out_cap = 2 * data.shape[0] + 4 * lanes + 8
    payload, lane_bytes, total = T.rans_encode_payload_device(
        torch.from_numpy(data), torch.from_numpy(freqs),
        torch.from_numpy(cum), lanes, order, out_cap)
    jp, jl, jt = jax.jit(D.rans_encode_payload_device,
                         static_argnums=(3, 4, 5))(
        jnp.asarray(data), jnp.asarray(freqs), jnp.asarray(cum), lanes,
        order, out_cap)
    assert np.array_equal(payload.numpy(), np.asarray(jp))
    assert np.array_equal(lane_bytes.numpy(), np.asarray(jl))
    assert int(total) == int(jt)


def test_encode_payload_cap_drops_the_tail():
    """Bytes at or past out_cap are dropped, as JAX drops them."""
    data = _skewed(16 * 50, 9)
    _h, freqs, cum, _s = _tables(data, 0, 16)
    args = (torch.from_numpy(data), torch.from_numpy(freqs),
            torch.from_numpy(cum), 16, 0)
    full, _l, total = T.rans_encode_payload_device(*args, 2 * 800 + 72)
    cut = int(total) - 5
    short, _l, _t = T.rans_encode_payload_device(*args, cut)
    jp, _jl, _jt = jax.jit(D.rans_encode_payload_device,
                           static_argnums=(3, 4, 5))(
        jnp.asarray(data), jnp.asarray(freqs), jnp.asarray(cum), 16, 0, cut)
    assert np.array_equal(short.numpy(), full.numpy()[:cut])
    assert np.array_equal(short.numpy(), np.asarray(jp))


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("lanes", [16, 64])
def test_decode_matches_jax_general_path(order, lanes):
    data = _skewed(lanes * 113, 3 * lanes + order)
    enc = R.encode_section(data, order=order, lanes=lanes)
    _h, freqs, cum, sym = _tables(data, order, lanes)
    body = len(_h) + 7
    plen = int.from_bytes(enc[body:body + 4], "little")
    counts = np.frombuffer(enc, "<u4", count=lanes, offset=body + 4)
    payload = np.frombuffer(enc, np.uint8, count=plen,
                            offset=body + 4 + 4 * lanes)
    steps = data.shape[0] // lanes
    grid = T.rans_decode_device(
        torch.from_numpy(payload.copy()),
        torch.from_numpy(counts.astype(np.int64)), torch.from_numpy(sym),
        torch.from_numpy(freqs), torch.from_numpy(cum), lanes, steps, order)
    padded = np.concatenate([payload, np.zeros(2, np.uint8)])
    want = jax.jit(D.rans_decode_device, static_argnums=(5, 6, 7))(
        jnp.asarray(padded), jnp.asarray(counts.astype(np.int32)),
        jnp.asarray(sym), jnp.asarray(freqs), jnp.asarray(cum), lanes,
        steps, order)
    assert np.array_equal(grid.numpy(), np.asarray(want))
    assert np.array_equal(grid.numpy(), data.reshape(lanes, steps).T)


@pytest.mark.parametrize("order", [0, 1])
def test_prologue_matches_build_luts_grid(order):
    """On the equal split the JAX-free prologue builds JAX's tables."""
    data = _skewed(64 * 200, 11 + order)
    head, freqs, cum = T.section_prologue(data, order, 64)
    jhead, jfreqs, jcum, _sym = _tables(data, order, 64)
    assert head[7:] == jhead
    assert np.array_equal(freqs, jfreqs) and np.array_equal(cum, jcum)


@pytest.mark.parametrize("n,lanes", [(1003, 64), (37, 8), (5000, 4096)])
def test_prologue_ragged_matches_host_section(n, lanes):
    """Ragged lanes: the host section's header and tables, with the
    order-1 corrections at the lane starts."""
    data = _skewed(n, n)
    lanes = min(lanes, n)
    head, _f, _c = T.section_prologue(data, 1, lanes)
    assert R.encode_section(data, order=1, lanes=lanes).startswith(head)


def test_lane_offsets_form():
    """Encode splits any n as rans_np.lane_slices does (the rows past a
    shorter lane's end are empty); decode with explicit offsets returns
    the flat bytes."""
    data = _skewed(1003, 12)  # 1003 = 43 * 16 + 21 * 15
    off = R.lane_slices(1003, 64)
    _h, freqs, cum = T.section_prologue(data, 1, 64)
    f, c = torch.from_numpy(freqs), torch.from_numpy(cum)
    d = torch.from_numpy(data)
    words, emits, _final = T.rans_encode_device(d, f, c, 64, 1)
    assert words.shape == (16, 64)
    assert emits[:15].any(0).all()
    assert not emits[15, 43:].any() and not words[15, 43:].any()
    payload, lane_bytes, total = T.rans_encode_payload_device(d, f, c, 64, 1,
                                                              3000)
    sym = np.zeros((256, R.SCALE), np.uint8)
    for k in np.flatnonzero(freqs.any(axis=1)):
        sym[k] = np.repeat(np.arange(256, dtype=np.uint8), freqs[k])
    out = T.rans_decode_device(payload[:int(total)], lane_bytes,
                               torch.from_numpy(sym), f, c, 64, 0, 1,
                               offsets=off)
    assert np.array_equal(out.numpy(), data)
    with pytest.raises(ValueError, match="offsets"):
        T.rans_decode_device(payload, lane_bytes, torch.from_numpy(sym), f, c,
                             64, 0, 1, offsets=off[:-1])


# ---------------------------------------------------------------------------
# section drivers: bytes of the host oracle and of JAX on every branch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_encode_section_bytes_match_host_and_jax(branch):
    make, order, lanes = BRANCHES[branch]
    data = make()
    got = T.encode_section_device(data, order=order, lanes=lanes,
                                  device="cpu")
    assert got == R.encode_section(data, order=order, lanes=lanes)
    assert got == D.encode_section_device(data, order=order, lanes=lanes)
    dec, off = T.decode_section_device(got, device="cpu")
    assert dec == data.tobytes() and off == len(got)
    assert D.decode_section_device(got) == (dec, off)


@pytest.mark.parametrize("nsym,base", [(4, 65), (16, 33), (16, 0), (24, 1)])
def test_decode_section_order1_compact_variants(nsym, base):
    """The four inputs of tests/test_rans.py::
    test_device_order1_compact_variants (JAX's compact1 branch with and
    without byte 0, and its gather fallback) through the port's decode."""
    rng = np.random.default_rng(nsym * 131 + base)
    n = 48 * 256
    syms = (base + np.arange(nsym)).astype(np.uint8)
    state = 0
    out = np.empty(n, np.uint8)
    r = rng.random(n)
    for i in range(n):
        state = (state + (1 if r[i] < 0.3 else 0)) % nsym
        out[i] = syms[state]
    enc = R.encode_section(out.tobytes(), order=1, lanes=32)
    dec, off = T.decode_section_device(b"\x07" + enc, 1, device="cpu")
    assert dec == out.tobytes() and off == len(enc) + 1
    assert (dec, off - 1) == D.decode_section_device(enc)


def test_decode_section_errors_match_jax():
    data = _skewed(64 * 40, 13)
    enc = R.encode_section(data, order=0, lanes=64)
    tbl = 7 + len(R.serialize_table(
        R.quantize_freqs(np.bincount(data, minlength=256))))
    for cut in (tbl + 4, len(enc) - 1):
        for dec in (D.decode_section_device,
                    functools.partial(T.decode_section_device,
                                      device="cpu")):
            with pytest.raises(ValueError, match="rANS section truncated"):
                dec(enc[:cut])
        with pytest.raises(TR.RansTruncated):
            T.decode_section_device(enc[:cut], device="cpu")
    bad = bytearray(enc)
    bad[tbl + 4] ^= 0x01  # lane 0's byte count, now odd
    for dec in (D.decode_section_device,
                functools.partial(T.decode_section_device, device="cpu")):
        with pytest.raises(ValueError, match="lane table corrupt"):
            dec(bytes(bad))
    with pytest.raises(TR.RansTruncated):
        T.decode_section_device(enc[:5], device="cpu")


def test_decode_reads_stay_in_bounds():
    """A payload that passed the lane-table checks but holds other bytes,
    and lane counts that run past the payload, decode without reading out
    of bounds (the kernel clamps each lane's reads the same way)."""
    data = _skewed(16 * 300, 14)
    _h, freqs, cum, sym = _tables(data, 1, 16)
    rng = np.random.default_rng(0)
    payload = torch.from_numpy(rng.integers(0, 256, size=700, dtype=np.uint8))
    counts = torch.full((16,), 100, dtype=torch.int64)  # 1600 > 700
    out = T.rans_decode_device(payload, counts, torch.from_numpy(sym),
                               torch.from_numpy(freqs), torch.from_numpy(cum),
                               16, 300, 1)
    assert out.shape == (300, 16)


def test_cpu_tensors_never_reach_the_build(monkeypatch):
    def no_build():
        raise AssertionError("a CPU tensor reached the kernel build")

    monkeypatch.setattr(_build, "library", no_build)
    TK.reset_launches()
    data = _skewed(2000, 15)
    enc = T.encode_section_device(data, order=1, lanes=16, device="cpu")
    assert T.decode_section_device(enc, device="cpu")[0] == data.tobytes()
    assert all(v == 0 for v in TK.launches.values())


def test_mixed_devices_raise():
    d = torch.zeros(10, dtype=torch.uint8, device="meta")
    f = torch.zeros(256, dtype=torch.int32)
    with pytest.raises(ValueError, match="one CUDA device"):
        T.rans_encode_device(d, f, f, 2, 0)


# ---------------------------------------------------------------------------
# the writer and the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pe", [False, True])
def test_writer_with_port_coder_matches_host(pe):
    """RfqzWriter over a real chunk's to_segments() with the port's coder
    on the CPU writes the host coder's bytes; every outer section that
    reached the coder was coded by the port."""
    block = _mk_block(2000, 150, seed=21 + pe, pe_overlap=0.5 if pe else 0)
    header = (vectorized.make_header_pe(block) if pe
              else vectorized.make_header_se(block))
    chunk = vectorized.encode_chunk(header, block, pe)
    calls = []

    def coder(arr, order=0, lanes=R.DEFAULT_LANES):
        calls.append((order, arr.shape[0], lanes))
        return T.encode_section_device(arr, order=order, lanes=lanes,
                                       device="cpu")

    outs = []
    for enc in (None, coder):
        buf = io.BytesIO()
        w = rfqz.RfqzWriter(buf, encode_section=enc)
        w.write(header.to_bytes())
        w.write_segments(chunk.to_segments())
        w.close()
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    assert len(calls) >= 2
    assert any(n % lanes for _o, n, lanes in calls)  # ragged sections too


def test_rfqz_section_coder_binds_the_device_only_under_engine_device():
    assert tcli.rfqz_section_coder("vectorized") is None
    assert tcli.rfqz_section_coder("auto") is None
    coder = tcli.rfqz_section_coder("device")
    assert coder.func is T.encode_section_device
    assert coder.keywords == {"device": "cuda:0"}


def _run(mod, *args):
    r = subprocess.run([sys.executable, "-m", mod, *map(str, args)],
                       env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin",
                            "JAX_PLATFORMS": "cpu"},
                       capture_output=True)
    return r


@pytest.mark.parametrize("pe", [False, True])
@pytest.mark.parametrize("extra", [[], ["-k", "100"]])
def test_cli_rfqz_matches_jax_cli(fixtures_dir, tmp_path, pe, extra):
    ins = (["-i", fixtures_dir / "pe_big_R1.fq", "-I",
            fixtures_dir / "pe_big_R2.fq"] if pe
           else ["-i", fixtures_dir / "se_big.fq"])
    ours, ref = tmp_path / "port.rfqz", tmp_path / "jax.rfqz"
    r = _run("repaq_tpu_torch.cli", "-c", *ins, "-o", ours, *extra,
             "--engine", "vectorized")
    assert r.returncode == 0, r.stderr
    r = _run("repaq_tpu.cli", "-c", *ins, "-o", ref, *extra)
    assert r.returncode == 0, r.stderr
    assert ours.read_bytes() == ref.read_bytes()
    outs = [tmp_path / "b1.fq", tmp_path / "b2.fq"][:1 + pe]
    dec = ["-o", outs[0]] + (["-O", outs[1]] if pe else [])
    r = _run("repaq_tpu_torch.cli", "-d", "-i", ours, *dec,
             "--engine", "vectorized")
    assert r.returncode == 0, r.stderr
    for back, src in zip(outs, ins[1::2]):
        assert back.read_bytes() == Path(src).read_bytes()
    r = _run("repaq_tpu_torch.cli", "-p", *ins, "-r", ours,
             "--engine", "vectorized")
    assert r.returncode == 0, r.stderr
    assert b'"result":"passed"' in r.stdout


def test_cli_rfqz_chunk_default(tmp_path):
    """Without -k a .rfqz output is cut in 16,000-kb chunks, as the JAX
    CLI cuts it; with the .rfq default of 1,000 kb the bytes differ."""
    rng = np.random.default_rng(31)
    reads, length = 11_000, 100  # 1.1 Mbase: two chunks at 1,000 kb
    seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=(reads, length))
    qual = rng.choice(np.frombuffer(b"F:,#", np.uint8), size=(reads, length))
    fq = tmp_path / "in.fq"
    fq.write_bytes(b"".join(b"@r%d\n%s\n+\n%s\n" % (i, s.tobytes(),
                                                    q.tobytes())
                            for i, (s, q) in enumerate(zip(seq, qual))))
    outs = {}
    for name, mod, extra in (("port", "repaq_tpu_torch.cli",
                              ["--engine", "vectorized"]),
                             ("jax", "repaq_tpu.cli", []),
                             ("k1000", "repaq_tpu_torch.cli",
                              ["--engine", "vectorized", "-k", "1000"])):
        out = tmp_path / (name + ".rfqz")
        r = _run(mod, "-c", "-i", fq, "-o", out, *extra)
        assert r.returncode == 0, r.stderr
        outs[name] = out.read_bytes()
    assert outs["port"] == outs["jax"]
    assert outs["port"] != outs["k1000"]


def test_cli_rfqz_engine_device_needs_cuda(fixtures_dir, tmp_path,
                                           monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        tcli.main(["-c", "-i", str(fixtures_dir / "se_big.fq"), "-o",
                   str(tmp_path / "x.rfqz"), "--engine", "device"])
    assert e.value.code != 0
