"""repaq_tpu_torch stands alone: no module of it, and not chip_smoke.py,
imports ``jax`` or the JAX package ``repaq_tpu``; the host layers it
carries (format, io, pipeline, codecs, the native library's source) are
copies that give the JAX package's bytes on every fixture; and its native
host library builds from its own source. Everything is bytes: the
tolerance is exact equality."""

import ast
import ctypes
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repaq_tpu import cli as jcli
from repaq_tpu.codec import rans_np as JR
from repaq_tpu.format import header as JH
from repaq_tpu_torch import cli as tcli
from repaq_tpu_torch.codec import _native
from repaq_tpu_torch.codec import rans_np as TR
from repaq_tpu_torch.format import header as TH
from test_torch_reference import jax_native  # noqa: F401

# repaq_tpu's native code runs from its source built for this CPU
pytestmark = pytest.mark.usefixtures("jax_native")

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted(
    str(p.relative_to(ROOT)) for p in (ROOT / "repaq_tpu_torch").rglob("*.py")
    if "_build" not in p.parts) + ["chip_smoke.py",
                                   "tools/profile_rans.py"]  # chip_smoke's

# (inputs, golden, compress flags): every SE and PE fixture with a golden
FIXTURES = [
    (["se_big.fq"], "se_big.ref.k100.rfq", ["-k", "100"]),
    (["se_big_nonl.fq"], "se_big_nonl.ref.k100.rfq", ["-k", "100"]),
    (["se_illumina.fq"], "se_illumina.ref.rfq", []),
    (["se_varlen.fq"], "se_varlen.ref.rfq", []),
    (["se_fewn.fq"], "se_fewn.ref.k100.rfq", ["-k", "100"]),
    (["se_manyq.fq"], "se_manyq.ref.k100.rfq", ["-k", "100"]),
    (["se_nonl.fq"], "se_nonl.ref.rfq", []),
    (["se_crlf.fq"], "se_crlf.ref.rfq", []),
    (["se_bgi.fq"], "se_bgi.ref.rfq", []),
    (["pe_R1.fq", "pe_R2.fq"], "pe.ref.rfq", []),
    (["pe_big_R1.fq", "pe_big_R2.fq"], "pe_big.ref.k100.rfq", ["-k", "100"]),
    (["pe_nov_R1.fq", "pe_nov_R2.fq"], "pe_nov.ref.rfq", []),
    (["pe_nl1.fq", "pe_nl2.fq"], "pe_nl.ref.rfq", ["-k", "100"]),
]


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in ("jax", "repaq_tpu")


@pytest.mark.parametrize("path", PORT_FILES)
def test_port_module_imports_no_jax_package(path):
    tree = ast.parse((ROOT / path).read_text(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif (isinstance(node, ast.ImportFrom) and node.level == 0
              and _forbidden(node.module or "")):
            bad.append(node.module)
    assert not bad, "%s imports %s" % (path, bad)


def test_importing_the_port_loads_no_jax_package():
    code = ("import sys\n"
            "import repaq_tpu_torch.cli, repaq_tpu_torch.codec.device_engine,"
            " repaq_tpu_torch.ops.rans_device,"
            " repaq_tpu_torch.parallel.torchdist\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repaq_tpu')))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


def _compress(main, fx, ins, out, flags):
    args = ["-i", str(fx / ins[0])]
    if len(ins) > 1:
        args += ["-I", str(fx / ins[1])]
    assert main(["-c", *args, "-o", str(out), *flags,
                 "--engine", "vectorized"]) == 0


@pytest.mark.parametrize("ins,golden,flags", FIXTURES,
                         ids=[g for _i, g, _f in FIXTURES])
def test_port_cli_gives_the_jax_package_bytes(fixtures_dir, tmp_path, ins,
                                              golden, flags):
    """The copies hold the JAX package's bytes: the port's CLI writes the
    .rfq of repaq_tpu.cli and of the reference encoder, decodes it back to
    the input, and writes repaq_tpu.cli's .rfqz."""
    port, jax_pkg = tmp_path / "port.rfq", tmp_path / "jax.rfq"
    _compress(tcli.main, fixtures_dir, ins, port, flags)
    _compress(jcli.main, fixtures_dir, ins, jax_pkg, flags)
    assert port.read_bytes() == jax_pkg.read_bytes()
    assert port.read_bytes() == (fixtures_dir / golden).read_bytes()

    backs = [tmp_path / ("back%d.fq" % m) for m in range(len(ins))]
    outs = ["-o", str(backs[0])] + (["-O", str(backs[1])] if len(ins) > 1
                                    else [])
    assert tcli.main(["-d", "-i", str(port), *outs,
                      "--engine", "vectorized"]) == 0
    for fq, back in zip(ins, backs):
        # the reference's decoder writes LF line ends for CRLF input
        want = (fixtures_dir / fq).read_bytes().replace(b"\r\n", b"\n")
        assert back.read_bytes() == want

    port_z, jax_z = tmp_path / "port.rfqz", tmp_path / "jax.rfqz"
    _compress(tcli.main, fixtures_dir, ins, port_z, flags)
    _compress(jcli.main, fixtures_dir, ins, jax_z, flags)
    assert port_z.read_bytes() == jax_z.read_bytes()


@pytest.mark.parametrize("order", [0, 1])
def test_rans_section_equals_the_jax_package(order):
    rng = np.random.default_rng(11 + order)
    data = rng.choice(np.frombuffer(b"F:,#", np.uint8), size=200_003,
                      p=[0.86, 0.09, 0.04, 0.01])
    data[-1000:] = rng.integers(0, 256, size=1000, dtype=np.uint8)
    for lanes in (64, 2048):
        assert (TR.encode_section(data, order=order, lanes=lanes)
                == JR.encode_section(data, order=order, lanes=lanes))


def test_quality_stats_equal_the_jax_package():
    rng = np.random.default_rng(12)
    n = 150_000
    seq = rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=n,
                     p=[0.25, 0.25, 0.25, 0.249, 0.001])
    qual = rng.choice(np.frombuffer(b"F:,#", np.uint8), size=n)
    qual[seq == ord("N")] = ord("#")
    got, want = TH.quality_stats(seq, qual), JH.quality_stats(seq, qual)
    assert got.keys() == want.keys()
    for k in want:
        assert np.array_equal(got[k], want[k]), k


def test_native_library_builds_from_the_port_source(tmp_path, monkeypatch):
    cxx = os.environ.get("CXX") or "c++"
    if shutil.which(cxx) is None:
        pytest.skip("no C++ compiler (%s) to build the native library" % cxx)
    monkeypatch.setattr(_native, "BUILD_DIR", str(tmp_path))
    path = _native.build()
    assert os.path.dirname(path) == str(tmp_path)
    assert _native.build() == path  # cached by source, compiler and flags
    lib = _native._bind(ctypes.CDLL(path))
    seq = np.frombuffer(b"ACGTNACGTTGCA" * 101, np.uint8)
    out = np.empty((seq.shape[0] + 3) // 4, dtype=np.uint8)
    lib.pack_2bit(seq.ctypes.data, seq.shape[0], out.ctypes.data)
    codes = np.zeros(256, np.uint8)
    codes[np.frombuffer(b"ATC", np.uint8)] = [1, 2, 3]
    c = np.concatenate([codes[seq], np.zeros(-seq.shape[0] % 4, np.uint8)])
    want = c[0::4] | (c[1::4] << 2) | (c[2::4] << 4) | (c[3::4] << 6)
    assert np.array_equal(out, want)


def test_native_library_name_is_keyed_on_the_cpu(tmp_path, monkeypatch):
    """The same CPU key gives the same path, another key another path."""
    monkeypatch.setattr(_native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_native, "cpu_key", lambda _cxx: "fpu sse2 avx2")
    path = _native.library_path()
    assert os.path.dirname(path) == str(tmp_path)
    assert _native.library_path() == path
    monkeypatch.setattr(_native, "cpu_key",
                        lambda _cxx: "fpu sse2 avx2 avx512_fp16")
    assert _native.library_path() != path


def test_native_library_of_another_cpu_is_never_loaded(tmp_path,
                                                       monkeypatch):
    """A library built for another CPU key sits in the build directory
    (a copied tree); on this CPU, with no compiler to build its own, the
    loader takes the numpy fallbacks and not that library."""
    cxx = os.environ.get("CXX") or "c++"
    if shutil.which(cxx) is None:
        pytest.skip("no C++ compiler (%s) to build the native library" % cxx)
    monkeypatch.setattr(_native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_native, "cpu_key", lambda _cxx: "another cpu")
    other = _native.build()
    monkeypatch.setattr(_native, "cpu_key", lambda _cxx: "this cpu")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    monkeypatch.delenv("REPAQ_TPU_NO_NATIVE", raising=False)
    monkeypatch.setattr(_native, "_LIB", None)
    monkeypatch.setattr(_native, "_TRIED", False)
    loaded = []
    monkeypatch.setattr(_native.ctypes, "CDLL",
                        lambda path, *a, **k: loaded.append(path))
    with pytest.raises(RuntimeError):
        _native.build()
    assert not _native.available()
    assert loaded == []
    assert os.listdir(tmp_path) == [os.path.basename(other)]
