"""The JAX package's native host library as the port's tests run it: built
from the JAX package's own source for the CPU at hand.

repaq_tpu loads repaq_tpu/native/librepaq_native.so, a committed build
that its Makefile makes with -march=native on whichever host built it
last, and rebuilds only when the .so is older than its source. On a CPU
that lacks one of that host's instructions its entry points die with
SIGILL and take the test process with them. So the port's tests never
load it: ``reference_library`` compiles repaq_tpu/native/repaq_native.cpp
with the Makefile's flags (-march=native first, without it if that fails)
into tests/.jaxref_build/, under a name that hashes the source, the
compiler, the flags and the CPU (repaq_tpu_torch.codec._native.cpu_key,
the key of the port's own build), once for all test processes. Nothing is
written under repaq_tpu/.

A port test module that reaches repaq_tpu's native code imports the
``jax_native`` fixture and marks its tests with it (``pytestmark``); it
binds repaq_tpu.codec._native to that build while the module's tests run
and restores it after, so the JAX package's own tests see the module as
they always did. A subprocess runs the JAX CLI through ``jax_cli_argv``.
REPAQ_TPU_NO_NATIVE does not apply to the reference: it runs the native
path that the JAX CLI takes. The tests here hold the build to the JAX
package's numpy path. Everything is bytes: the tolerance is exact
equality."""

import functools
import os
import sys
from pathlib import Path

import numpy as np
import pytest

from repaq_tpu.codec import _native as JN
from repaq_tpu.codec import rans_np as JR
from repaq_tpu_torch.codec import _native as TN

REPO = Path(__file__).resolve().parent.parent
JAX_SOURCE = REPO / "repaq_tpu" / "native" / "repaq_native.cpp"
BUILD_DIR = REPO / "tests" / ".jaxref_build"
# repaq_tpu/native/Makefile: CXX ?= g++, BASEFLAGS
MAKE_FLAGS = ["-std=c++17", "-O3", "-fPIC", "-Wall", "-shared", "-pthread"]


@functools.lru_cache(maxsize=None)
def reference_library() -> str:
    """The path of the JAX package's native library built for this CPU
    (built at the first call of any test process, reused after)."""
    path = TN.build(str(JAX_SOURCE), str(BUILD_DIR), MAKE_FLAGS,
                    os.environ.get("CXX") or "g++")
    # repaq_tpu's loader runs make in repaq_tpu/native/ when the library
    # it is given is older than the source: keep this one newer
    if os.path.getmtime(path) < os.path.getmtime(JAX_SOURCE):
        os.utime(path)
    return path


@pytest.fixture(scope="module")
def jax_native():
    """repaq_tpu.codec._native bound to reference_library() and loaded
    (whatever REPAQ_TPU_NO_NATIVE says) for the module's tests; its _SO,
    _LIB and _TRIED restored after."""
    saved = JN._SO, JN._LIB, JN._TRIED
    try:
        JN._SO, JN._LIB, JN._TRIED = reference_library(), None, False
        no_native = os.environ.pop("REPAQ_TPU_NO_NATIVE", None)
        try:
            lib = JN._load()
        finally:
            if no_native is not None:
                os.environ["REPAQ_TPU_NO_NATIVE"] = no_native
        assert lib is not None and lib._name == JN._SO, \
            "the JAX package's native library did not load from %s" % JN._SO
        yield JN._SO
    finally:
        JN._SO, JN._LIB, JN._TRIED = saved


_JAX_CLI = """
import os, runpy, sys
from repaq_tpu.codec import _native
os.environ.pop("REPAQ_TPU_NO_NATIVE", None)
_native._SO = sys.argv[1]
assert _native.available(), "no JAX native library at " + sys.argv[1]
sys.argv = ["repaq_tpu.cli", *sys.argv[2:]]
runpy.run_module("repaq_tpu.cli", run_name="__main__", alter_sys=True)
"""


def jax_cli_argv(*args) -> list:
    """The command line that runs ``python -m repaq_tpu.cli *args`` with
    repaq_tpu.codec._native bound to reference_library()."""
    return [sys.executable, "-c", _JAX_CLI, reference_library(),
            *map(str, args)]


pytestmark = pytest.mark.usefixtures("jax_native")


def test_reference_library_is_built_outside_the_jax_package(jax_native):
    assert JN._LIB._name == jax_native == reference_library()
    assert Path(jax_native).parent == BUILD_DIR
    assert JN.available()
    assert os.path.getmtime(jax_native) >= os.path.getmtime(JAX_SOURCE)


def test_reference_library_is_keyed_on_the_cpu(monkeypatch):
    """The reference's name carries the port's CPU key: this CPU's key
    names the bound build, another key another one, so a build carried
    from another host is never the one bound here."""
    args = (str(JAX_SOURCE), str(BUILD_DIR), MAKE_FLAGS,
            os.environ.get("CXX") or "g++")
    assert TN.library_path(*args) == reference_library()
    here = TN.cpu_key(args[3])
    monkeypatch.setattr(TN, "cpu_key", lambda _cxx: here + " avx512_fp16")
    assert TN.library_path(*args) != reference_library()


def _data(n, seed):
    """Skewed quality-like bytes with an incompressible tail."""
    rng = np.random.default_rng(seed)
    data = rng.choice(np.frombuffer(b"F:,#", np.uint8), size=n,
                      p=[0.86, 0.09, 0.04, 0.01])
    data[n - n // 20:] = rng.integers(0, 256, size=n // 20, dtype=np.uint8)
    return data


@pytest.mark.parametrize("lanes", [1, 64, 2048])
@pytest.mark.parametrize("order", [0, 1])
def test_reference_rans_encode_equals_the_numpy_path(monkeypatch, order,
                                                     lanes):
    """The built library's rans_encode gives the bytes of the JAX
    package's numpy path (tests/test_rans.py's cross-check, which cannot
    run where the committed binary dies), and both decode to the input."""
    data = _data(60_011, 40 + order)
    calls = []
    encode = JN.rans_encode
    monkeypatch.setattr(JN, "rans_encode",
                        lambda *a: calls.append(1) or encode(*a))
    native = JR.encode_section(data, order=order, lanes=lanes)
    assert calls, "the native rans_encode did not run"
    monkeypatch.setattr(JN, "available", lambda: False)
    numpy_path = JR.encode_section(data, order=order, lanes=lanes)
    assert native == numpy_path
    dec, end = JR.decode_section(native)
    assert dec == data.tobytes() and end == len(native)
