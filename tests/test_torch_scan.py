"""The run-boundary scans of the port (``kernels.cummax_i32`` and
``kernels.suffix_min_i32``, csrc/scan.cu) against the XLA scans of the
JAX package: ``jax.lax.cummax`` and ``jax.lax.cummin`` between two flips,
as repaq_tpu/ops/device_streams.py computes ``_cummax`` and
``_suffix_min``.

On the CPU the wrappers run their plain torch versions; the CUDA kernel
is held against those in tests/test_torch_cuda.py. The same seeded numpy
int32 inputs go through both sides, 1-D and as (2, B) rows. Everything
is integer: the tolerance is exact equality."""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repaq_tpu.ops import device_streams as D
from repaq_tpu_torch.ops import device_streams as T
from repaq_tpu_torch.ops import kernels as TK

I32_MIN, I32_MAX = -2**31, 2**31 - 1


def _jax_cummax(x):
    return np.asarray(jax.lax.cummax(jnp.asarray(x), axis=x.ndim - 1))


def _jax_suffix_min(x):
    a = x.ndim - 1
    return np.asarray(jnp.flip(jax.lax.cummin(jnp.flip(jnp.asarray(x), a),
                                              axis=a), a))


def _case(kind: str, n: int, rows: int, seed: int) -> np.ndarray:
    """(n,) when rows == 0, else (rows, n): int32 inputs of one kind."""
    rng = np.random.default_rng(seed)
    shape = (n,) if rows == 0 else (rows, n)
    i = np.broadcast_to(np.arange(n, dtype=np.int32), shape)
    marks = rng.random(shape) < 0.2
    if kind == "random":
        return rng.integers(I32_MIN, I32_MAX, size=shape, dtype=np.int32,
                            endpoint=True)
    if kind == "negative":
        return rng.integers(-5000, 0, size=shape, dtype=np.int32)
    if kind == "run_starts":  # _cummax(where(run_start, i, -1))
        return np.where(marks, i, -1).astype(np.int32)
    if kind == "run_ends":  # _suffix_min(where(~adj, i, m))
        return np.where(marks, i, n).astype(np.int32)
    if kind == "int32_max":  # INT32_MAX sentinels among positions
        return np.where(marks, i, I32_MAX).astype(np.int32)
    if kind == "identity_max":
        return np.full(shape, I32_MIN, dtype=np.int32)
    if kind == "identity_min":
        return np.full(shape, I32_MAX, dtype=np.int32)
    if kind == "decreasing":
        return (n - i).astype(np.int32)
    if kind == "increasing":
        return i.astype(np.int32).copy()
    raise ValueError(kind)


KINDS = ("random", "negative", "run_starts", "run_ends", "int32_max",
         "identity_max", "identity_min", "decreasing", "increasing")


def _check(x: np.ndarray) -> None:
    t = torch.from_numpy(np.ascontiguousarray(x))
    before = dict(TK.launches)
    got_max = TK.cummax_i32(t)
    got_min = TK.suffix_min_i32(t)
    assert TK.launches == before  # CPU tensors launch nothing
    for got, want in ((got_max, _jax_cummax(x)),
                      (got_min, _jax_suffix_min(x))):
        assert got.dtype == torch.int32 and got.shape == t.shape
        assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("rows", [0, 2])
def test_scans_match_jax(kind, rows):
    _check(_case(kind, 5003, rows, seed=len(kind) + rows))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 127, 129, 4095, 4097,
                               (1 << 16) - 1, (1 << 16) + 1])
def test_scans_match_jax_one_off_a_power_of_two(n):
    _check(_case("random", n, 0, seed=n))
    _check(_case("run_ends", n, 2, seed=n))


@pytest.mark.parametrize("shape", [(0,), (2, 0), (0, 7)])
def test_scans_of_nothing_are_empty(shape):
    _check(np.zeros(shape, dtype=np.int32))


def test_scans_of_one_element_are_the_element():
    for v in (I32_MIN, -1, 0, I32_MAX):
        x = torch.tensor([v], dtype=torch.int32)
        assert TK.cummax_i32(x).tolist() == [v]
        assert TK.suffix_min_i32(x).tolist() == [v]


def test_scans_of_a_strided_view():
    """A non-contiguous input (every other column) scans as its values."""
    x = _case("random", 2 * 999, 2, seed=3)
    t = torch.from_numpy(x)[:, ::2]
    want = np.ascontiguousarray(x[:, ::2])
    assert np.array_equal(TK.cummax_i32(t).numpy(), _jax_cummax(want))
    assert np.array_equal(TK.suffix_min_i32(t).numpy(), _jax_suffix_min(want))


@pytest.mark.parametrize("bad", [
    torch.zeros(8, dtype=torch.int64),
    torch.zeros(8, dtype=torch.uint8),
    torch.zeros((2, 2, 2), dtype=torch.int32),
    torch.tensor(3, dtype=torch.int32),
])
def test_scans_reject_other_types_and_ranks(bad):
    for fn in (TK.cummax_i32, TK.suffix_min_i32):
        with pytest.raises(ValueError):
            fn(bad)


def test_scans_dispatch_by_device():
    """CPU tensors run the plain versions and launch nothing; a tensor on
    neither the CPU nor a CUDA device, or a mix, raises instead of running
    either version."""
    x = torch.arange(10, dtype=torch.int32)
    before = dict(TK.launches)
    assert torch.equal(TK.cummax_i32(x), TK.cummax_i32_plain(x))
    assert torch.equal(TK.suffix_min_i32(x), TK.suffix_min_i32_plain(x))
    assert TK.launches == before
    meta = torch.empty(10, dtype=torch.int32, device="meta")
    for fn in (TK.cummax_i32, TK.suffix_min_i32):
        with pytest.raises(ValueError):
            fn(meta)
    with pytest.raises(ValueError):
        TK._on_cuda(x, meta)
    assert TK.launches == before


@pytest.mark.parametrize("rows", [0, 2])
def test_device_streams_helpers_match_jax(rows):
    """The port's `_cummax` / `_suffix_min` against the JAX package's, on
    the run-boundary inputs their callers build."""
    for kind in ("run_starts", "run_ends"):
        x = _case(kind, 3001, rows, seed=11)
        t = torch.from_numpy(x)
        if rows == 0:  # the JAX helpers scan 1-D arrays
            want_max = np.asarray(D._cummax(jnp.asarray(x)))
            want_min = np.asarray(D._suffix_min(jnp.asarray(x)))
        else:
            want_max, want_min = _jax_cummax(x), _jax_suffix_min(x)
        assert np.array_equal(T._cummax(t).numpy(), want_max)
        assert np.array_equal(T._suffix_min(t).numpy(), want_min)


def test_library_scans_only_in_the_plain_versions():
    """The port calls torch's cummax/cummin nowhere but in the two plain
    versions of ops/kernels.py."""
    pkg = pathlib.Path(T.__file__).resolve().parent.parent
    hits = []
    for path in sorted(pkg.rglob("*.py")):
        for line in path.read_text().splitlines():
            if "torch.cummax" in line or "torch.cummin" in line:
                hits.append((path.relative_to(pkg).as_posix(), line.strip()))
    assert hits == [
        ("ops/kernels.py", "return torch.cummax(x, -1).values"),
        ("ops/kernels.py", "return torch.cummin(x.flip(-1), -1).values"
                           ".flip(-1)"),
    ]
