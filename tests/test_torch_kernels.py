"""The port's kernel wrappers (repaq_tpu_torch/ops/kernels.py) against the
JAX package's Pallas kernels and the host byte spec.

On the CPU the wrappers run their plain torch versions, which are held
here against the Pallas kernels in interpret mode (as tests/test_pallas.py
runs them) and against kernels_np, on the same numpy inputs from a seed.
The CUDA kernels themselves are held against the plain versions in
tests/test_torch_cuda.py. Everything is integer:
the tolerance is exact equality."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repaq_tpu.codec import kernels_np as K
from repaq_tpu.ops import device_streams as D
from repaq_tpu.ops import pallas_tpu as PT
from repaq_tpu_torch.ops import _build
from repaq_tpu_torch.ops import kernels as TK

from test_torch_cuda import _frontend_case, _seq


@pytest.mark.parametrize("n_frac,esc", [(0.0, False), (0.001, True),
                                        (0.02, True)])
def test_frontend_plain_matches_pallas_and_host(n_frac, esc):
    n = 8192  # the meta32 form takes whole 512-byte groups
    seq, qual, table, major = _frontend_case(n, 3, n_frac, esc)
    packed, meta = TK.encode_frontend(
        torch.from_numpy(seq), torch.from_numpy(qual),
        torch.from_numpy(table), major)
    want_packed, meta32 = jax.jit(PT.encode_frontend_meta32)(
        jnp.asarray(seq.view("<u4")), jnp.asarray(qual.view("<u4")),
        jnp.asarray(table), jnp.uint32(major))
    assert np.array_equal(packed.numpy(), np.asarray(want_packed))
    assert np.array_equal(meta.numpy(),
                          np.asarray(meta32).astype("<u4").view(np.uint8))
    assert np.array_equal(packed.numpy(), K.pack_2bit(seq))


def test_frontend_plain_ragged_tail_and_bins():
    """n % 16 != 0 (the kernel's tail), a duplicated palette entry (the
    last match wins) and the major qual inside the palette."""
    rng = np.random.default_rng(8)
    n = 4 * 1001
    seq = _seq(n, rng, 0.05)
    bins = np.array([40, 41, 40, 70], dtype=np.uint8)
    qual = rng.choice(np.array([40, 41, 70, 90], np.uint8), size=n)
    packed, meta = TK.encode_frontend(
        torch.from_numpy(seq), torch.from_numpy(qual),
        torch.from_numpy(bins), 70)
    assert np.array_equal(packed.numpy(), K.pack_2bit(seq))
    lut = np.full(256, 4, dtype=np.uint8)
    lut[41], lut[40], lut[70] = 1, 2, 5
    want = lut[qual] | ((seq == ord("N")).astype(np.uint8) << 7)
    assert np.array_equal(meta.numpy(), want)


@pytest.mark.parametrize("n", [1, 2, 3, 4 * 257 + 1, 4 * 1001 + 2,
                               16 * 500 + 3])
def test_frontend_plain_at_ragged_n_matches_byte_form_and_pallas(n):
    """Any n, with 'N' and the major qual in the tail: the meta bytes that
    both encode paths read split into the byte form's (nmask, bid), and
    equal JAX's encode_frontend_pallas (interpret mode) and the host
    pack."""
    seq, qual, table, major = _frontend_case(n, n, 0.02, True)
    seq[-1], qual[-1] = ord("N"), major
    if n > 2:
        seq[-2], qual[-2] = ord("N"), table[0]
    args = [torch.from_numpy(a) for a in (seq, qual, table)]
    packed, meta = TK.encode_frontend(*args, major)
    want = TK.encode_frontend_bytes_plain(*args, major)
    assert torch.equal(packed, want[0])
    assert torch.equal(meta >= 0x80, want[1])
    assert torch.equal((meta & 0x7F).int(), want[2])
    jp, jn, jb = PT.encode_frontend_pallas(
        jnp.asarray(seq), jnp.asarray(qual), jnp.asarray(table), major)
    assert np.array_equal(packed.numpy(), np.asarray(jp))
    assert np.array_equal(want[1].numpy(), np.asarray(jn))
    assert np.array_equal(want[2].numpy(), np.asarray(jb))
    assert np.array_equal(packed.numpy(), K.pack_2bit(seq))


def test_frontend_rejects_bad_shapes():
    s = torch.zeros(10, dtype=torch.uint8)
    with pytest.raises(ValueError):  # any n, but one for seq and qual
        TK.encode_frontend(s, s[:9], torch.zeros(2, dtype=torch.uint8), 70)
    with pytest.raises(ValueError):
        TK.encode_frontend(s[:8], s[:8], torch.zeros(64, dtype=torch.uint8),
                           70)


# the kernel's tails: m % 4 bytes past its last word, m % 16 past a
# thread's four words
@pytest.mark.parametrize("m", [1, 1024, 10_001, 0, 15, 16, 17, 4096 + 13])
def test_unpack_plain_matches_pallas_and_host(m):
    rng = np.random.default_rng(m)
    packed = rng.integers(0, 256, size=m, dtype=np.uint8)
    got = TK.unpack_bases(torch.from_numpy(packed)).numpy()
    want = jax.jit(PT.unpack_bases_pallas)(jnp.asarray(packed))
    assert np.array_equal(got, np.asarray(want))
    assert np.array_equal(got, K.unpack_2bit(packed, 4 * m))


@pytest.mark.parametrize("m", [0, 17, 4096 + 13])
def test_unpack_into_a_larger_buffer(m):
    """out=: the chars fill the buffer's first 4m bytes and come back as
    that view; the rest of the buffer is untouched."""
    packed = torch.from_numpy(np.random.default_rng(m).integers(
        0, 256, size=m, dtype=np.uint8))
    buf = torch.full((4 * m + 5,), 7, dtype=torch.uint8)
    got = TK.unpack_bases(packed, out=buf)
    assert got.shape == (4 * m,)
    assert (got.untyped_storage().data_ptr()
            == buf.untyped_storage().data_ptr())
    assert torch.equal(got, TK.unpack_bases(packed))
    assert bool((buf[4 * m:] == 7).all())


def test_unpack_rejects_a_bad_out_buffer():
    packed = torch.zeros(8, dtype=torch.uint8)
    for bad in (torch.empty(31, dtype=torch.uint8),   # short
                torch.empty(33, dtype=torch.uint8)[1:],  # misaligned
                torch.empty(32, dtype=torch.int32),
                torch.empty(64, dtype=torch.uint8)[::2]):
        with pytest.raises(ValueError):
            TK.unpack_bases(packed, out=bad)


@pytest.mark.parametrize("n,force_p", [(1, 0.0), (5000, 0.0),
                                       (40_000, 0.002)])
def test_token_start_mask_plain_matches_jax(n, force_p):
    rng = np.random.default_rng(n)
    lens = rng.choice([1, 1, 2, 4], size=n).astype(np.int32)
    force = rng.random(n) < force_p if force_p else None
    got = TK.token_start_mask(
        torch.from_numpy(lens),
        None if force is None else torch.from_numpy(force)).numpy()
    want = np.asarray(jax.jit(D.token_start_mask)(
        jnp.asarray(lens), None if force is None else jnp.asarray(force)))
    assert np.array_equal(got, want)
    if force is None:  # the host token walk
        starts = K._token_starts(lens, lens.astype(np.int64))
        assert np.array_equal(np.flatnonzero(got), starts)


@pytest.mark.parametrize("n,force_p", [(1, 0.0), (1, 1.0), (8191, 0.0),
                                       (8193, 0.002), (40_000, 0.01)])
def test_token_start_mask_u8_lens_match_i32_and_jax(n, force_p):
    """The decode callers pass uint8 lengths: the same mask as int32 ones
    and as JAX's, out-of-range lengths (0, 5, 6) clamped alike."""
    rng = np.random.default_rng(n + 7)
    lens = rng.choice([0, 1, 1, 1, 2, 4, 4, 5, 6], size=n).astype(np.int32)
    force = rng.random(n) < force_p if force_p else None
    f = None if force is None else torch.from_numpy(force)
    got8 = TK.token_start_mask(torch.from_numpy(lens.astype(np.uint8)), f)
    got32 = TK.token_start_mask(torch.from_numpy(lens), f)
    got64 = TK.token_start_mask(torch.from_numpy(lens.astype(np.int64)), f)
    want = np.asarray(jax.jit(D.token_start_mask)(
        jnp.asarray(lens), None if force is None else jnp.asarray(force)))
    assert got8.dtype == torch.bool
    for got in (got8, got32, got64):
        assert np.array_equal(got.numpy(), want)


def test_token_start_mask_plain_matches_pallas_fsm():
    """One 16384-byte group through the Pallas lane-block FSM in interpret
    mode, as tests/test_pallas.py:127 runs it."""
    rng = np.random.default_rng(2)
    n = PT._FSM_K * PT._LANES
    lens = rng.choice([1, 1, 2, 4], size=n).astype(np.int32)
    force = rng.random(n) < 0.002
    code = (lens | (force.astype(np.int32) << 3)).astype(np.uint8)
    maps, mask4 = PT.token_fsm_pallas(jnp.asarray(code))
    maps, mask4 = np.asarray(maps), np.asarray(mask4)
    entry = np.zeros(maps.shape[0], dtype=np.int64)
    for j in range(1, maps.shape[0]):
        entry[j] = maps[j - 1, entry[j - 1]]
    want = ((mask4 >> entry[None, :]) & 1 == 1).T.reshape(-1)
    got = TK.token_start_mask(torch.from_numpy(lens),
                              torch.from_numpy(force)).numpy()
    assert np.array_equal(got, want)


def test_cpu_tensors_never_reach_the_build(monkeypatch):
    def no_build():
        raise AssertionError("a CPU tensor reached the kernel build")

    monkeypatch.setattr(_build, "library", no_build)
    TK.reset_launches()
    u8 = torch.zeros(64, dtype=torch.uint8)
    TK.encode_frontend(u8, u8, torch.zeros(2, dtype=torch.uint8), 70)
    TK.encode_frontend_bytes(u8[:7], u8[:7], torch.zeros(2, dtype=torch.uint8),
                             70)
    TK.pack_bases(u8[:7])
    TK.unpack_bases(u8)
    TK.token_start_mask(torch.ones(64, dtype=torch.int32))
    assert all(v == 0 for v in TK.launches.values())


def test_failed_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_nvcc", lambda: "false")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build._build()


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()
