"""The port's own host `.rfqz` entropy layer: repaq_tpu_torch.codec.rans_np,
repaq_tpu_torch.format.rfqz (rANS, LZ and seq-LZ sections, the container
writer and its streaming reader), the LZ and rANS entry points of the
port's native library, and the port CLI's `.rfqz` path under ``--engine
vectorized``. These are the host cases of tests/test_rans.py, run against
the port's copy; where a case makes bytes, they are also held to the JAX
package's (its native code built for this CPU: test_torch_reference).
Everything is bytes: the tolerance is exact equality."""

import numpy as np
import pytest

from repaq_tpu import cli as jcli
from repaq_tpu.codec import kernels_np as JK
from repaq_tpu.codec import rans_np as JR
from repaq_tpu.format import rfqz as JZ
from repaq_tpu_torch import cli as tcli
from repaq_tpu_torch.codec import _native
from repaq_tpu_torch.codec import kernels_np as K
from repaq_tpu_torch.codec import rans_np as R
from repaq_tpu_torch.format import rfqz
from test_torch_reference import jax_native  # noqa: F401

# repaq_tpu's native code runs from its source built for this CPU
pytestmark = pytest.mark.usefixtures("jax_native")


def _skewed(n, seed=0):
    rng = np.random.default_rng(seed)
    return rng.choice(
        np.frombuffer(b"\x00\x01\x01\x01\x02\x05\x80\xff\x41\x41", np.uint8),
        size=n,
    )


def _needs_native():
    if not _native.available():
        pytest.skip("the port's native library did not build here (no "
                    "C++ compiler): the LZ parse has no numpy fallback")


def _write(mod, path, chunks=(), segments=None, **kw):
    """A container written by mod's RfqzWriter; its bytes."""
    w = mod.RfqzWriter(str(path), **kw)
    if segments is not None:
        w.write_segments(segments)
    for c in chunks:
        w.write(c)
    w.close()
    return path.read_bytes(), w


def _read_all(reader, step):
    got = bytearray()
    while True:
        b = reader.read(step)
        if not b:
            return bytes(got)
        got += b


# ---------------------------------------------------------------------------
# rANS sections (codec/rans_np.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("n,lanes", [(0, 8), (1, 8), (7, 8), (257, 16),
                                     (4096, 64), (100_000, 256)])
def test_roundtrip_host(order, n, lanes):
    data = _skewed(n).tobytes()
    enc = R.encode_section(data, order=order, lanes=lanes)
    assert enc == JR.encode_section(data, order=order, lanes=lanes)
    dec, off = R.decode_section(enc)
    assert dec == data
    assert off == len(enc)


def test_roundtrip_all_bytes():
    rng = np.random.default_rng(5)
    data = rng.integers(0, 256, size=50_000, dtype=np.uint8).tobytes()
    for order in (0, 1):
        enc = R.encode_section(data, order=order, lanes=128)
        assert enc == JR.encode_section(data, order=order, lanes=128)
        dec, _ = R.decode_section(enc)
        assert dec == data


def test_single_symbol():
    data = b"\x42" * 10_000
    enc = R.encode_section(data, order=0, lanes=32)
    assert enc == JR.encode_section(data, order=0, lanes=32)
    assert len(enc) < 600
    dec, _ = R.decode_section(enc)
    assert dec == data


def test_quantize_exact_sum():
    rng = np.random.default_rng(1)
    for _ in range(20):
        counts = rng.integers(0, 1000, size=256)
        counts[rng.random(256) < 0.7] = 0
        if counts.sum() == 0:
            counts[3] = 5
        f = R.quantize_freqs(counts)
        assert f.sum() == R.SCALE
        assert ((f > 0) == (counts > 0)).all()
        assert np.array_equal(f, JR.quantize_freqs(counts))


@pytest.mark.parametrize("lanes", [1, 64, 2048])
@pytest.mark.parametrize("order", [0, 1])
def test_native_rans_encode_equals_the_numpy_path(monkeypatch, order, lanes):
    """The port's native rans_encode gives its numpy path's bytes (and
    the JAX package's), and they decode to the input."""
    _needs_native()
    rng = np.random.default_rng(60 + order)
    data = rng.choice(np.frombuffer(b"F:,#", np.uint8), size=40_009,
                      p=[0.86, 0.09, 0.04, 0.01])
    data[-2000:] = rng.integers(0, 256, size=2000, dtype=np.uint8)
    calls = []
    encode = _native.rans_encode
    monkeypatch.setattr(_native, "rans_encode",
                        lambda *a: calls.append(1) or encode(*a))
    native = R.encode_section(data, order=order, lanes=lanes)
    assert calls, "the port's native rans_encode did not run"
    monkeypatch.setattr(_native, "available", lambda: False)
    assert R.encode_section(data, order=order, lanes=lanes) == native
    assert native == JR.encode_section(data, order=order, lanes=lanes)
    dec, end = R.decode_section(native)
    assert dec == data.tobytes() and end == len(native)


def test_decode_section_truncated_header_raises():
    """A 1-byte buffer raises RansTruncated, not a misparse of n=0 from a
    short slice; every strict prefix of a real section is truncated or
    decoded, never a silent short or garbled success."""
    with pytest.raises(R.RansTruncated):
        R.decode_section(b"\x00", 0)
    data = _skewed(5000, seed=21).tobytes()
    sec = R.encode_section(data, order=0, lanes=8)
    for cut in [0, 1, 3, 6, 7, 10, len(sec) // 2, len(sec) - 1]:
        with pytest.raises((R.RansTruncated, IndexError)):
            R.decode_section(sec[:cut], 0)
    out, end = R.decode_section(sec, 0)
    assert out == data and end == len(sec)


def test_decode_section_zero_lanes_rejected():
    """lanes=0 with n>0 is a clean ValueError, not a ZeroDivisionError
    escaping the reader's retry classification."""
    bad = bytes([0]) + (100).to_bytes(4, "little") + (0).to_bytes(2, "little")
    # order-0 table for a single symbol then empty payload tables
    bad += bytes([0, 65]) + R.SCALE.to_bytes(2, "little")
    bad += (0).to_bytes(4, "little")
    with pytest.raises(ValueError) as ei:
        R.decode_section(bad, 0)
    assert not isinstance(ei.value, R.RansTruncated)


# ---------------------------------------------------------------------------
# the container (format/rfqz.py)
# ---------------------------------------------------------------------------


def test_rfqz_container_roundtrip(tmp_path):
    rng = np.random.default_rng(9)
    blob = (
        _skewed(300_000, seed=2).tobytes()
        + rng.integers(0, 256, size=100_000, dtype=np.uint8).tobytes()
    )
    chunks = [blob[i:i + 37_777] for i in range(0, len(blob), 37_777)]
    kw = dict(block_size=64 * 1024, lanes=128)
    raw, w = _write(rfqz, tmp_path / "x.rfqz", chunks, **kw)
    assert raw == _write(JZ, tmp_path / "j.rfqz", chunks, **kw)[0]
    assert _read_all(rfqz.RfqzReader(str(tmp_path / "x.rfqz")),
                     10_000) == blob
    assert w.coded_bytes < len(blob)  # skewed part must compress


@pytest.mark.parametrize("head", [b"NOPE1234", b"RFQZ"],
                         ids=["bad_magic", "short_file"])
def test_reader_rejects_bad_header(tmp_path, head):
    """A wrong magic, or the magic with no version byte, is a clean
    RfqzFormatError."""
    p = tmp_path / "bad.rfqz"
    p.write_bytes(head)
    with pytest.raises(rfqz.RfqzFormatError):
        rfqz.RfqzReader(str(p))


def test_rfqz_corrupt_sections(tmp_path):
    """Truncated or bit-flipped containers fail cleanly, never crash or
    read out of bounds in the native decoder."""
    data = _skewed(200_000, seed=7).tobytes()
    blob, _w = _write(rfqz, tmp_path / "c.rfqz", [data], block_size=64 * 1024,
                      lanes=64)
    for cut in (6, 20, len(blob) // 2, len(blob) - 3):
        q = tmp_path / "t.rfqz"
        q.write_bytes(blob[:cut])
        try:
            _read_all(rfqz.RfqzReader(str(q)), 65536)
        except rfqz.RfqzFormatError:
            pass  # clean structured failure is acceptable
    for pos in range(6, min(len(blob), 600), 37):
        q = bytearray(blob)
        q[pos] ^= 0xFF
        f = tmp_path / "x.rfqz"
        f.write_bytes(bytes(q))
        try:
            _read_all(rfqz.RfqzReader(str(f)), 65536)
        except rfqz.RfqzFormatError:
            pass  # must not segfault / raise anything else


def test_stored_section_truncation_detected(tmp_path):
    rng = np.random.default_rng(12)
    data = rng.integers(0, 256, size=100_000, dtype=np.uint8).tobytes()
    blob, _w = _write(rfqz, tmp_path / "s.rfqz", [data])
    assert blob == _write(JZ, tmp_path / "j.rfqz", [data])[0]
    assert blob[5] == rfqz.MODE_STORED  # random bytes don't compress
    q = tmp_path / "trunc.rfqz"
    q.write_bytes(blob[: len(blob) // 2])
    with pytest.raises(rfqz.RfqzFormatError):
        _read_all(rfqz.RfqzReader(str(q)), 65536)


def test_reader_streams_from_pipe_like(tmp_path):
    """RfqzReader over a non-seekable, read-only stream object, pulling
    compressed bytes incrementally."""
    class Pipe:
        def __init__(self, raw):
            self.raw = raw
            self.i = 0

        def read(self, k=-1):
            if self.i >= len(self.raw):
                return b""
            step = min(k if k > 0 else 1 << 20, 7777)
            out = self.raw[self.i:self.i + step]
            self.i += len(out)
            return out

    data = _skewed(150_000, seed=13).tobytes()
    kw = dict(block_size=32 * 1024, lanes=64)
    raw, _w = _write(rfqz, tmp_path / "s.rfqz", [data], **kw)
    assert raw == _write(JZ, tmp_path / "j.rfqz", [data], **kw)[0]
    assert _read_all(rfqz.RfqzReader(Pipe(raw)), 12_345) == data


def test_reader_one_byte_section_boundary(tmp_path):
    """The reader's refill boundary lands with exactly 1 byte of the next
    section buffered: the stream still decodes losslessly."""
    data = _skewed(300_000, seed=22).tobytes()
    raw, _w = _write(rfqz, tmp_path / "b.rfqz", [data],
                     block_size=64 * 1024, lanes=64)
    # the first section boundary after the 5-byte container header; reads
    # are served so that a fetch ends exactly 1 byte past it
    _, end = rfqz.decode_block(memoryview(raw)[5:], 0)
    split = 5 + end + 1

    class TwoPhase:
        def __init__(self):
            self.i = 0

        def read(self, k=-1):
            if self.i >= len(raw):
                return b""
            stop = split if self.i < split else len(raw)
            out = raw[self.i:min(self.i + (k if k > 0 else 1 << 30), stop)]
            self.i += len(out)
            return out

    assert _read_all(rfqz.RfqzReader(TwoPhase()), 50_000) == data


# ---------------------------------------------------------------------------
# LZ and seq-LZ sections (format/rfqz.py over the native LZ entry points)
# ---------------------------------------------------------------------------


def _coverage_bases(n_reads=3000, glen=200_000, seed=5):
    """Reads sampled from a shared genome (the cross-read redundancy the
    LZ stage exists for), as bases."""
    rng = np.random.default_rng(seed)
    genome = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=glen)
    return np.concatenate(
        [genome[s:s + 150] for s in rng.integers(0, glen - 151, n_reads)])


def _coverage_reads(seed=5):
    """_coverage_bases packed 2 bits a base, by the port's pack_2bit (held
    to the JAX package's)."""
    bases = _coverage_bases(seed=seed)
    packed = K.pack_2bit(bases)
    assert np.array_equal(packed, JK.pack_2bit(bases))
    return packed


def _genome_sections(seed):
    """Two packed sections of 500-base reads from one 300 kb genome: the
    second matches the first only through the history dictionary."""
    rng = np.random.default_rng(seed)
    genome = rng.integers(0, 4, 300_000).astype(np.uint8)
    base = np.frombuffer(b"GATC", np.uint8)

    def reads(k):
        parts = [genome[rng.integers(0, 299_000):][:500] for _ in range(k)]
        return base[np.concatenate(parts)]

    return K.pack_2bit(reads(1200)), K.pack_2bit(reads(1200))


def test_seqlz_mode_roundtrip_and_wins():
    _needs_native()
    packed = _coverage_reads()
    rec = rfqz.encode_block(packed, label="seq")
    assert rec == JZ.encode_block(packed, label="seq")
    assert rec[0] == rfqz.MODE_SEQLZ, "seq coverage data must pick seq-LZ"
    out, end = rfqz.decode_block(memoryview(rec), 0)
    assert out == packed.tobytes() and end == len(rec)
    assert len(rec) < 0.8 * len(packed)
    # plain rANS would have stored this almost raw
    plain = rfqz.encode_block(packed, label="coords")
    assert len(rec) < len(plain)


def test_bytelz_mode_roundtrip():
    _needs_native()
    rng = np.random.default_rng(1)
    base = rng.integers(0, 255, 4096).astype(np.uint8)
    data = np.concatenate(
        [base[rng.integers(0, 3000):][:700] for _ in range(200)])
    rec = rfqz.encode_block(data, label="tail")
    assert rec == JZ.encode_block(data, label="tail")
    assert rec[0] == rfqz.MODE_LZ
    out, end = rfqz.decode_block(memoryview(rec), 0)
    assert out == data.tobytes() and end == len(rec)


def test_lz_incompressible_falls_back():
    rng = np.random.default_rng(2)
    data = rng.integers(0, 255, 200_000).astype(np.uint8)
    rec = rfqz.encode_block(data, label="seq")
    assert rec == JZ.encode_block(data, label="seq")
    assert rec[0] != rfqz.MODE_SEQLZ  # no matches -> rANS/store candidate


def test_lz_container_stream_roundtrip(tmp_path):
    """The container with labelled segments, an LZ-coded seq stream among
    them, streamed back through the incremental reader."""
    _needs_native()
    packed = _coverage_reads(seed=9)
    other = _skewed(150_000, seed=10)
    segs = [("seq", packed.tobytes()), ("qual", other.tobytes())]
    raw, _w = _write(rfqz, tmp_path / "lz.rfqz", segments=segs)
    assert raw == _write(JZ, tmp_path / "j.rfqz", segments=segs)[0]
    assert (_read_all(rfqz.RfqzReader(str(tmp_path / "lz.rfqz")), 37_777)
            == packed.tobytes() + other.tobytes())


def test_lz_corrupt_sections_clean_errors():
    _needs_native()
    packed = _coverage_reads(seed=11)
    rec = rfqz.encode_block(packed, label="seq")
    assert rec[0] == rfqz.MODE_SEQLZ
    # flip bytes across the record: decode raises cleanly, never crashes
    for pos in (5, 9, 13, 20, len(rec) // 2, len(rec) - 2):
        bad = bytearray(rec)
        bad[pos] ^= 0x55
        try:
            # silent success is fine only in dead padding
            rfqz.decode_block(memoryview(bytes(bad)), 0)
        except (ValueError, rfqz.RfqzFormatError, IndexError):
            continue


def test_seqlz_cross_section_history():
    """A section whose redundancy lives only in the previous section finds
    matches through the history dictionary and shrinks; decode mirrors the
    encoder's history; decoding with more history than the encoder had
    (a shard boundary) is byte-safe."""
    _needs_native()
    sec1, sec2 = _genome_sections(11)
    solo2 = rfqz.encode_block(sec2, label="seq")
    h, jh = rfqz.SeqLzHistory(), JZ.SeqLzHistory()
    rec1 = rfqz.encode_block(sec1, label="seq", seq_hist=h)
    rec2 = rfqz.encode_block(sec2, label="seq", seq_hist=h)
    assert rec1 == JZ.encode_block(sec1, label="seq", seq_hist=jh)
    assert rec2 == JZ.encode_block(sec2, label="seq", seq_hist=jh)
    assert rec1[0] == rfqz.MODE_SEQLZ
    assert rec2[0] == rfqz.MODE_SEQLZ
    assert len(rec2) < len(solo2) * 0.9, (len(rec2), len(solo2))

    hd = rfqz.SeqLzHistory()
    out1, _ = rfqz.decode_block(memoryview(rec1), 0, seq_hist=hd)
    out2, _ = rfqz.decode_block(memoryview(rec2), 0, seq_hist=hd)
    assert out1 == sec1.tobytes()
    assert out2 == sec2.tobytes()

    rec2_solo = rfqz.encode_block(sec2, label="seq",
                                  seq_hist=rfqz.SeqLzHistory())
    hd2 = rfqz.SeqLzHistory()
    rfqz.decode_block(memoryview(rec1), 0, seq_hist=hd2)
    out2b, _ = rfqz.decode_block(memoryview(rec2_solo), 0, seq_hist=hd2)
    assert out2b == sec2.tobytes()


def test_seqlz_history_decode_without_native(monkeypatch):
    """An archive whose second seq-LZ section matches into the first
    through the history dictionary decodes with the port's native library
    unavailable (SeqLzHistory.bases falls back to kernels_np)."""
    _needs_native()
    sec1, sec2 = _genome_sections(23)
    h = rfqz.SeqLzHistory()
    rec1 = rfqz.encode_block(sec1, label="seq", seq_hist=h)
    rec2 = rfqz.encode_block(sec2, label="seq", seq_hist=h)
    assert rec1[0] == rfqz.MODE_SEQLZ and rec2[0] == rfqz.MODE_SEQLZ

    monkeypatch.setattr(_native, "available", lambda: False)
    hd = rfqz.SeqLzHistory()
    out1, _ = rfqz.decode_block(memoryview(rec1), 0, seq_hist=hd)
    out2, _ = rfqz.decode_block(memoryview(rec2), 0, seq_hist=hd)
    assert out1 == sec1.tobytes()
    assert out2 == sec2.tobytes()


# ---------------------------------------------------------------------------
# the port CLI's .rfqz path (--engine vectorized)
# ---------------------------------------------------------------------------


def _cli(main, *args):
    assert main([*map(str, args)]) == 0


def test_cli_rfqz_roundtrip(fixtures_dir, tmp_path, capfd):
    fq = fixtures_dir / "se_big.fq"
    z, jz, back = (tmp_path / n for n in ("o.rfqz", "j.rfqz", "back.fq"))
    _cli(tcli.main, "-c", "-i", fq, "-o", z, "-k", "100",
         "--engine", "vectorized")
    _cli(jcli.main, "-c", "-i", fq, "-o", jz, "-k", "100")
    assert z.read_bytes() == jz.read_bytes()
    assert z.stat().st_size < fq.stat().st_size * 0.5
    _cli(tcli.main, "-d", "-i", z, "-o", back, "--engine", "vectorized")
    assert back.read_bytes() == fq.read_bytes()
    capfd.readouterr()
    _cli(tcli.main, "-p", "-i", fq, "-r", z, "--engine", "vectorized")
    assert '"result":"passed"' in capfd.readouterr().out


def test_cli_rfqz_pe_and_verify(fixtures_dir, tmp_path, capfd):
    r1, r2 = fixtures_dir / "pe_big_R1.fq", fixtures_dir / "pe_big_R2.fq"
    z, jz = tmp_path / "pe.rfqz", tmp_path / "j.rfqz"
    _cli(tcli.main, "-c", "-i", r1, "-I", r2, "-o", z, "-k", "100",
         "--verify", "--engine", "vectorized")
    _cli(jcli.main, "-c", "-i", r1, "-I", r2, "-o", jz, "-k", "100",
         "--verify")
    assert z.read_bytes() == jz.read_bytes()
    d1, d2 = tmp_path / "d1.fq", tmp_path / "d2.fq"
    _cli(tcli.main, "-d", "-i", z, "-o", d1, "-O", d2,
         "--engine", "vectorized")
    assert d1.read_bytes() == r1.read_bytes()
    assert d2.read_bytes() == r2.read_bytes()
    capfd.readouterr()
    _cli(tcli.main, "-p", "-i", r1, "-I", r2, "-r", z,
         "--engine", "vectorized")
    assert '"result":"passed"' in capfd.readouterr().out
