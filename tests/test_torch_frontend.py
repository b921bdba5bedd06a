"""The pack and byte-form frontend kernels' arithmetic (repaq_tpu_torch/
csrc/frontend.cu) and the byte form's wrapper, on the CPU.

`pack_word`, `pack16` and `n_bytes` below are numpy models of the CUDA
functions of those names, operation for operation on uint32 words: the
word-wise classification that pack_kernel and frontend_bytes_kernel run.
They are held, exhaustively over each byte value in each lane of a word
and on 2^16 seeded words, against the host byte spec
(repaq_tpu.codec.kernels_np), the plain torch version and JAX's
pack_bases_pallas in interpret mode. The byte form's wrapper runs its
plain version here and is held against JAX's encode_frontend_pallas (in
interpret mode) at every ragged n % 16. Everything is integer: the
tolerance is exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repaq_tpu.codec import kernels_np as K
from repaq_tpu.ops import pallas_tpu as PT
from repaq_tpu_torch.ops import kernels as TK
from test_torch_reference import jax_native  # noqa: F401

# repaq_tpu's native code runs from its source built for this CPU
pytestmark = pytest.mark.usefixtures("jax_native")

_U = np.uint32
_LOW7, _HIGH = _U(0x7F7F7F7F), _U(0x80808080)


def _differs7(lo7, c4):
    return (lo7 ^ _U(c4)) + _LOW7


def pack_word(w):
    """frontend.cu's pack_word: the packed byte of each word's four bases
    in bits 24..31."""
    lo7 = w & _LOW7
    ac = _differs7(lo7 | _U(0x02020202), 0x43434343)
    t = _differs7(lo7, 0x54545454)
    c = _differs7(lo7, 0x43434343)
    bit0 = ~(ac | w) & _HIGH
    bit1 = ~((t & c) | w) & _HIGH
    return ((bit0 >> _U(1)) | bit1) * _U(0x00041041)


def _byte_perm(x, y, sel):
    """CUDA's __byte_perm for selectors whose nibbles are below 8."""
    pool = np.stack([x, y], -1).astype("<u4").view(np.uint8)
    out = np.zeros(x.shape, _U)
    for i in range(4):
        out |= pool[..., (sel >> (4 * i)) & 0xF].astype(_U) << _U(8 * i)
    return out


def pack16(words):
    """frontend.cu's pack16 over (m, 4) words: the 4 packed bytes of each
    16-base group as one little-endian word."""
    p = pack_word(words)
    lo = _byte_perm(p[:, 0], p[:, 1], 0x0073)
    hi = _byte_perm(p[:, 2], p[:, 3], 0x0073)
    return _byte_perm(lo, hi, 0x5410)


def n_bytes(w):
    """frontend.cu's n_bytes: 1 in each byte that is 'N', else 0."""
    return (~(_differs7(w & _LOW7, 0x4E4E4E4E) | w) & _HIGH) >> _U(7)


def _check_model(seq):
    """The models on seq (a multiple of 16 bytes) against the host spec,
    the plain torch pack and JAX's Pallas pack in interpret mode."""
    words = seq.view("<u4")
    want = K.pack_2bit(seq)
    assert np.array_equal((pack_word(words) >> _U(24)).astype(np.uint8), want)
    assert np.array_equal(pack16(words.reshape(-1, 4)).view(np.uint8), want)
    assert np.array_equal(n_bytes(words).view(np.uint8),
                          (seq == ord("N")).astype(np.uint8))
    assert np.array_equal(TK.pack_bases(torch.from_numpy(seq)).numpy(), want)
    assert np.array_equal(np.asarray(PT.pack_bases_pallas(jnp.asarray(seq))),
                          want)


@pytest.mark.parametrize("lane", range(4))
def test_word_model_every_byte_value_in_each_lane(lane):
    """Each of the 256 byte values in this lane of a word (0x80-0xFF, where
    a "has a zero byte" test would give false positives, included), 64
    times each beside seeded bytes in the other lanes."""
    rng = np.random.default_rng(lane)
    b = rng.integers(0, 256, size=(256 * 64, 4), dtype=np.uint8)
    b[:, lane] = np.repeat(np.arange(256, dtype=np.uint8), 64)
    _check_model(np.ascontiguousarray(b).reshape(-1))


@pytest.mark.parametrize("kind", ["uniform", "near"])
def test_word_model_on_random_words(kind):
    """2^16 seeded words: uniform bytes, and bytes one bit away from 'A',
    'T', 'C', 'N' (each of the 8 bits, the high bit included) mixed with
    the four themselves."""
    rng = np.random.default_rng(16)
    n = 4 << 16
    if kind == "uniform":
        seq = rng.integers(0, 256, size=n, dtype=np.uint8)
    else:
        near = np.array([c ^ (1 << k) for c in b"ATCN" for k in range(8)]
                        + list(b"ATCNG") * 8, np.uint8)
        seq = rng.choice(near, size=n)
    _check_model(seq)


def _bytes_case(n: int, nbins: int, seed: int):
    """seq and qual of n bytes, each holding all 256 values, and a palette
    of nbins distinct chars without the major."""
    rng = np.random.default_rng(seed)
    seq = rng.permutation(np.arange(n) % 256).astype(np.uint8)
    qual = rng.permutation(np.arange(n) % 256).astype(np.uint8)
    major = 70
    bins = rng.choice(np.setdiff1d(np.arange(256), [major]), size=nbins,
                      replace=False).astype(np.uint8)
    return seq, qual, bins, major


@pytest.mark.parametrize("nbins", [0, 63])
@pytest.mark.parametrize("tail", range(1, 16))
def test_frontend_bytes_at_ragged_n(tail, nbins):
    """encode_frontend_bytes at n % 16 = tail, every byte value in seq and
    qual: against JAX's encode_frontend_pallas in interpret mode (B = 63)
    or, as Pallas' interpreter refuses an empty palette, against the host
    spec (B = 0: every qual char an escape but the major); the packed
    bytes against kernels_np's pack, the output dtypes bool and int32."""
    n = 512 + tail
    seq, qual, bins, major = _bytes_case(n, nbins, tail)
    packed, nmask, bid = TK.encode_frontend_bytes(
        torch.from_numpy(seq), torch.from_numpy(qual), torch.from_numpy(bins),
        major)
    assert (packed.dtype, nmask.dtype, bid.dtype) == (
        torch.uint8, torch.bool, torch.int32)
    assert np.array_equal(packed.numpy(), K.pack_2bit(seq))
    if nbins:
        jp, jn, jb = PT.encode_frontend_pallas(
            jnp.asarray(seq), jnp.asarray(qual), jnp.asarray(bins), major)
        want = np.asarray(jp), np.asarray(jn), np.asarray(jb)
    else:
        want = (K.pack_2bit(seq), seq == ord("N"),
                np.where(qual == major, 1, 0).astype(np.int32))
    for got, w in zip((packed, nmask, bid), want):
        assert got.numpy().dtype == w.dtype
        assert np.array_equal(got.numpy(), w)
