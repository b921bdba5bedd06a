"""The port's stable bucket compaction and the stream coders that call it:
``kernels.bucket_compact``' plain version against a numpy reference
(chip_smoke.compact_ref: a stable argsort by bucket id, cut to cap, padded
with fill) on seeded cases, and the encode and decode coders that it and
``kernels.fill_runs`` took the sorts out of (``qualcol_encode_device``,
``encode_positions_from_meta``, ``coords_encode2_device``,
``qualcol_decode_device``) against their JAX twins, fed the same numpy
inputs. Everything is integer: the tolerance is exact equality."""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import (COMPACT_CALLS, COMPACT_CAPS, COMPACT_CASES,
                        COMPACT_FORMS, compact_args, compact_case,
                        compact_moved, compact_ref, compact_seeded,
                        compact_shapes)
from repaq_tpu.codec import kernels_np as K
from repaq_tpu.format.header import RfqHeader
from repaq_tpu.ops import device_streams as D
from repaq_tpu_torch.codec.device_engine import _bucket
from repaq_tpu_torch.ops import device_streams as T
from repaq_tpu_torch.ops import kernels as TK
from test_torch_reference import jax_native  # noqa: F401

# repaq_tpu's native code runs from its source built for this CPU
pytestmark = pytest.mark.usefixtures("jax_native")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _same_compact(got, ref):
    for g, r in zip(got, ref):
        assert (g is None) == (r is None)
        if g is not None:
            assert g.dtype == torch.int32
            assert np.array_equal(g.numpy(), r)


# ---------------------------------------------------------------------------
# bucket_compact's plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", COMPACT_CASES)
def test_compact_cases_at_a_small_tile(name):
    """chip_smoke's edge cases, placed by a 64-element tile (the card's
    tile is the built library's), through the wrapper on CPU tensors: its
    plain version, no launch."""
    case = compact_case(name, 64)
    assert (case[0].dtype == bool, case[1]) == COMPACT_FORMS[name]
    before = dict(TK.launches)
    got = TK.bucket_compact(*compact_args(case, "cpu"))
    assert TK.launches == before
    _same_compact(got, compact_ref(*case))


@pytest.mark.parametrize("payload", [False, True])
@pytest.mark.parametrize("cap_kind", COMPACT_CAPS)
@pytest.mark.parametrize("nbuckets", [1, 2, 3, 4, 8, 9, 64])
@pytest.mark.parametrize("n", [0, 1, 777, 100_003])
def test_compact_plain_matches_numpy(n, nbuckets, cap_kind, payload):
    """Masks and ids on each side of the register route's most (8 buckets;
    9 takes the match route on a card), n not a multiple of 16, and every
    cap kind: below, at and above the kept count, 0 and past n."""
    case = compact_seeded(n, nbuckets, cap_kind, payload)
    got = TK.bucket_compact_plain(*compact_args(case, "cpu"))
    _same_compact(got, compact_ref(*case))


@pytest.mark.parametrize("cap_kind", ["below", "at", "above", "zero"])
@pytest.mark.parametrize("form", ["mask", "mask_payload", "ids4", "ids8",
                                  "ids9"])
@pytest.mark.parametrize("n", [777, 100_003])
def test_compact_matches_jax_sorts(n, form, cap_kind):
    """bucket_compact against the sorts it replaces in the JAX package, on
    the same numpy inputs: the count >= 2 compaction's sort-slice of
    where(mask, i, n) (repaq_tpu/ops/device_streams.py:136), the token
    compaction's sort of (where(start, i, INF), window) pairs (:1094) and
    the grouping's sort of bid << 24 | i (:502), each cut to cap."""
    nbuckets = {"ids4": 4, "ids8": 8, "ids9": 9}.get(form, 1)
    bucket, _k, cap, _f, payload = compact_seeded(n, nbuckets, cap_kind,
                                                  form == "mask_payload")
    i_n = jnp.arange(n, dtype=jnp.int32)
    inf = jnp.int32(2**31 - 1)
    if form == "mask":
        fill = n
        want = jax.jit(lambda m: jnp.sort(jnp.where(m, i_n, n))[:cap])(
            jnp.asarray(bucket))
        want_pay = None
    elif form == "mask_payload":
        fill = 2**31 - 1
        want, want_pay = jax.jit(lambda m, w: tuple(
            x[:cap] for x in jax.lax.sort((jnp.where(m, i_n, inf), w),
                                          num_keys=1)))(
            jnp.asarray(bucket), jnp.asarray(payload))
        want_pay = jnp.where(want < inf, want_pay, 0)
    else:
        fill = n
        grouped = jax.jit(lambda b: jnp.sort(jnp.where(
            b < nbuckets, (b.astype(jnp.int32) << 24) | i_n, inf))[:cap])(
            jnp.asarray(bucket))
        want = jnp.where(grouped < inf, grouped & 0xFFFFFF, fill)
        want_pay = None
    idx, pay, counts = TK.bucket_compact(_t(bucket), nbuckets, cap, fill,
                                         None if payload is None
                                         else _t(payload))
    assert np.array_equal(idx.numpy(), np.asarray(want))
    assert (pay is None) == (want_pay is None)
    if pay is not None:
        assert np.array_equal(pay.numpy(), np.asarray(want_pay))
    ids = (~bucket).astype(np.int64) if bucket.dtype == bool else bucket
    assert np.array_equal(counts.numpy(), np.bincount(
        ids[ids < nbuckets], minlength=nbuckets)[:nbuckets])


@pytest.mark.parametrize("index", range(len(COMPACT_CALLS)))
def test_compact_shapes_of_a_chunk(index):
    """chip_smoke.compact_shapes on the CPU at 2,000 reads of phase 4's
    corpus (one chunk): each call of the device path recorded in its form
    (the grouping's ids, then masks; a payload riding the quality count
    >= 2 and the decode tokens), the plain version equal to compact_ref
    and to the parent's sort of the same keys (compact_library), as the
    card test holds the kernel at the full chunk."""
    label, bucket, k, cap, fill, payload, parent = compact_shapes(
        "cpu", reads=2000)[index]
    what = COMPACT_CALLS[index]
    assert label.startswith("SE %s: " % what)
    assert (bucket.dtype == torch.bool) == (what != "grouping")
    if what in ("quality count >= 2", "decode tokens"):
        assert payload is not None
    got = TK.bucket_compact(bucket, k, cap, fill, payload)
    _same_compact(got, compact_ref(bucket.numpy(), k, cap, fill,
                                   None if payload is None
                                   else payload.numpy()))
    sort = parent()
    if bucket.dtype != torch.bool:  # the grouping keys: bid << 24 | pos
        assert torch.equal(got[0], torch.where(sort < 2**31 - 1,
                                               sort & 0xFFFFFF, fill))
    elif payload is None:
        assert torch.equal(got[0], sort)
    else:
        keys, riding = sort
        assert torch.equal(got[0], keys[:cap])
        assert torch.equal(got[1], torch.where(keys[:cap] != fill,
                                               riding[:cap], 0))
    assert int(got[2].sum()) > 0


def test_compact_every_id_in_one_tile():
    """Every one of 256 ids, and nothing else, in one tile of 256: the
    kept indices come out grouped by id, each id's one index."""
    perm = np.random.default_rng(5).permutation(256).astype(np.uint8)
    idx, pay, counts = TK.bucket_compact(_t(perm), 256, 256, -1)
    assert pay is None
    assert np.array_equal(idx.numpy(), np.argsort(perm))
    assert np.array_equal(counts.numpy(), np.ones(256, np.int32))


@pytest.mark.parametrize("bad", ["int32_bucket", "bool_k2", "k0", "k257",
                                 "payload_dtype", "payload_shape",
                                 "bucket_2d", "cap_neg"])
def test_compact_rejects_bad_arguments(bad):
    args = dict(bucket=torch.zeros(8, dtype=torch.uint8), nbuckets=2,
                cap=8, fill=0, payload=None)
    args.update({
        "int32_bucket": dict(bucket=torch.zeros(8, dtype=torch.int32)),
        "bool_k2": dict(bucket=torch.zeros(8, dtype=torch.bool)),
        "k0": dict(nbuckets=0),
        "k257": dict(nbuckets=257),
        "payload_dtype": dict(payload=torch.zeros(8, dtype=torch.int64)),
        "payload_shape": dict(payload=torch.zeros(7, dtype=torch.int32)),
        "bucket_2d": dict(bucket=torch.zeros((2, 4), dtype=torch.uint8)),
        "cap_neg": dict(cap=-1),
    }[bad])
    with pytest.raises(ValueError):
        TK.bucket_compact(**args)


def test_compact_moved_counts_what_the_function_moves():
    """chip_smoke's bound: every bucket byte, idx (and pay) over cap, the
    payload read where kept within cap, the counts."""
    bucket = torch.zeros(1000, dtype=torch.uint8)
    assert compact_moved(bucket, 4, 300, None, 500) == 1000 + 1200 + 16
    assert compact_moved(bucket, 1, 300, bucket, 200) == (1000 + 1200 + 4
                                                          + 800 + 1200)


def test_no_sort_left_in_the_stream_coders():
    """The stream coders call no sort: the compactions are bucket_compact
    and the layouts fill_runs; the decode's two searchsorted (the bin of
    each token, and each bin's first token) are searches."""
    src = pathlib.Path(T.__file__).read_text()
    calls = [node.func.attr for node in ast.walk(ast.parse(src))
             if isinstance(node, ast.Call)
             and isinstance(node.func, ast.Attribute)]
    assert "sort" not in calls and "argsort" not in calls
    assert calls.count("searchsorted") == 2


# ---------------------------------------------------------------------------
# the coders against their JAX twins
# ---------------------------------------------------------------------------


def _palette_case(n, nbins, esc, n_frac, seed):
    """(meta, qual, table, major): qual drawn from a palette of nbins chars
    and a major one, escapes (chars outside it) where esc, 'N' flags in
    bit 7 of meta with probability n_frac."""
    rng = np.random.default_rng(seed)
    chars = rng.choice(np.arange(33, 127, dtype=np.uint8), size=nbins + 1,
                       replace=False)
    table, major = np.sort(chars[:nbins]), int(chars[nbins])
    qual = np.where(rng.random(n) < 0.6, major,
                    rng.choice(table, size=n)).astype(np.uint8)
    if esc:
        outside = np.setdiff1d(np.arange(33, 127, dtype=np.uint8), chars)
        qual[rng.integers(0, n, size=9)] = outside[0]
    lut = np.full(256, nbins, dtype=np.uint8)
    lut[table] = np.arange(nbins)
    lut[major] = nbins + 1
    nflag = (rng.random(n) < n_frac).astype(np.uint8) << 7
    return lut[qual] | nflag, qual, table, major


@pytest.mark.parametrize("esc", [False, True])
@pytest.mark.parametrize("nbins", [1, 3, 7, 8, 17, 63])
def test_qualcol_encode_matches_jax(nbins, esc):
    """The grouping by bin (nbins + 1 buckets: 8 for 7 bins, the register
    route's most on a card, and 9 for 8 bins, the match route's least),
    the escapes indexed in the escape bucket's run (esc_cap 0 without
    escapes) and the direct layout writes against JAX's sorts."""
    n = 12288
    meta, qual, table, major = _palette_case(n, nbins, esc, 0.01, nbins)
    n_esc = int((meta & 0x7F == nbins).sum())
    assert (n_esc > 0) == esc
    esc_cap = _bucket(n_esc, lo=8) if esc else 0
    nm_cap = _bucket(int((qual != major).sum()))
    out_size = 4 * nbins + n + 8
    got, ln = T.qualcol_encode_device(_t(meta), _t(qual), nbins,
                                      esc_cap=esc_cap, nonmajor_cap=nm_cap,
                                      out_size=out_size)
    want, wln = jax.jit(lambda tb, m32, q32: D.qualcol_encode_device(
        None, tb, major, None, esc_cap=esc_cap, nonmajor_cap=nm_cap,
        out_size=out_size, meta32=m32, qual32=q32, n=n))(
        jnp.asarray(table), jnp.asarray(meta.view("<u4")),
        jnp.asarray(qual.view("<u4")))
    assert int(ln) == int(wln)
    assert np.array_equal(got.numpy(), np.asarray(want))
    host = K.encode_qual_by_col(qual, table, major)
    assert bytes(got.numpy()[: int(ln)]) == host.tobytes()


@pytest.mark.parametrize("n_frac", [0.0005, 0.004, 0.25])
def test_positions_from_meta_matches_jax(n_frac):
    """Sparse flags (JAX compacts groups of 4 words, then sorts) and
    dense ones (one sort): one compaction gives the same stream."""
    n = 32768
    meta, *_rest = _palette_case(n, 3, False, n_frac, 40)
    npos = int((meta >= 0x80).sum())
    pos_cap = _bucket(npos, lo=8)
    out_size = _bucket(min(4 * npos, npos + n // 64) + 16, lo=64)
    got, ln = T.encode_positions_from_meta(_t(meta), n, out_size, pos_cap)
    want, wln = jax.jit(lambda m32: D.encode_positions_from_meta32(
        m32, n, out_size, pos_cap=pos_cap))(jnp.asarray(meta.view("<u4")))
    assert int(ln) == int(wln)
    assert np.array_equal(got.numpy(), np.asarray(want))
    host = K.encode_positions(np.flatnonzero(meta >= 0x80))
    assert bytes(got.numpy()[: int(ln)]) == host.tobytes()


@pytest.mark.parametrize("n_valid", [1, 300, 511, 512])
def test_coords_encode2_matches_jax(n_valid):
    """Rows of B = 512 valid up to n_valid, a repeat run across the valid
    edge (the entries past it emit nothing and end the run), each row's
    tail left zero by the direct writes (JAX: filler keys)."""
    rng = np.random.default_rng(n_valid)
    b = 512
    xy = np.zeros((2, b), dtype=np.int32)
    xy[0] = np.cumsum(rng.integers(0, 70, size=b)) + 900
    xy[1] = rng.integers(0, 1 << 20, size=b)
    xy[:, max(0, n_valid - 40): n_valid + 40] = 4242  # across the edge
    out_cap = 3 * b + 8
    got, xl, yl = T.coords_encode2_device(_t(xy), out_cap, n_valid=n_valid)
    want, wxl, wyl = jax.jit(lambda v: D.coords_encode2_device(
        v, out_cap, n_valid=n_valid))(jnp.asarray(xy))
    assert (int(xl), int(yl)) == (int(wxl), int(wyl))
    assert np.array_equal(got.numpy(), np.asarray(want))
    for row, ln, base in ((0, int(xl), 0), (1, int(yl), out_cap)):
        host = K.encode_coords(xy[row, :n_valid].astype(np.int64))
        assert bytes(got.numpy()[base: base + ln]) == host.tobytes()
        assert not got.numpy()[base + ln: base + out_cap].any()


def _decode_case(n, nbins, esc, seed):
    rng = np.random.default_rng(seed)
    h = RfqHeader()
    table = rng.choice(np.arange(33, 100, dtype=np.uint8), size=nbins + 1,
                       replace=False)
    qual = rng.choice(table, size=n)
    qual[(np.arange(n) // 50) % 7 == 0] = table[0]  # runs
    if esc:
        qual[rng.integers(0, n, size=6)] = 120
    seq = rng.choice(np.frombuffer(b"GATC", dtype=np.uint8),
                     size=2 * len(table))
    h.make_quality_table(seq, np.sort(table.repeat(2)))
    return qual, h.normal_qual_buf(), h.major_qual()


@pytest.mark.parametrize("esc", [False, True])
@pytest.mark.parametrize("nbins", [1, 3, 20])
def test_qualcol_decode_matches_jax(nbins, esc):
    """The token compaction (each token's window riding) against JAX's
    sort, with the engine's exact token cap and a cap of the buffer."""
    n = 9000
    qual, bins, major = _decode_case(n, nbins, esc, 60 + nbins)
    enc = K.encode_qual_by_col(qual, bins, major)
    buf = np.zeros(enc.shape[0] + 64, dtype=np.uint8)
    buf[: enc.shape[0]] = enc
    tokens, _pos, n_esc = K.qualcol_decode_counts(enc, len(bins))
    for tok_cap in (tokens, buf.shape[0]):
        caps = dict(tok_cap=tok_cap, pos_cap=n, esc_cap=_bucket(n_esc, lo=8)
                    if n_esc else 0, run_cap=None)
        got = T.qualcol_decode_device(_t(buf), len(bins), _t(bins), major,
                                      n, enc.shape[0], **caps)
        want = jax.jit(lambda b, bn, ln: D.qualcol_decode_device(
            b, len(bins), bn, jnp.uint8(major), n, ln, **caps))(
            jnp.asarray(buf), jnp.asarray(bins), jnp.int32(enc.shape[0]))
        assert np.array_equal(got.numpy(), np.asarray(want))
        assert np.array_equal(got.numpy(), qual)


def test_multi_cap_below_the_count_differs_from_jax():
    """ROADMAP C5: a multi_cap below the count of multi-byte tokens. JAX's
    layout sort places bytes by rank, so the bytes after a cut tail shift
    left into its place; the port writes every byte it keeps at its offset
    and leaves the cut tails 0. With the caps the engine gives (the
    chunk's counts) both equal the host's bytes."""
    m = 50
    delta = np.full(m, 200, np.int32)  # 2-byte gap tokens: 0x80, 199
    counts = np.full(m, 2, np.int32)
    b0 = (((delta - 1) >> 8) | 0x80).astype(np.int32)
    cum = np.cumsum(counts).astype(np.int32)
    fields = (delta << 2) | 1
    outs = {}
    for cap in (m, 20):
        got = T._emit_sort_pay(_t(b0), _t(counts), 120, _t(cum - counts),
                               int(cum[-1]), cap, _t(fields), 4)[0].numpy()
        want = np.asarray(jax.jit(lambda *a: D._emit_sort_pay(
            a[0], a[1], 120, a[2], a[3], cap, a[4], 4)[0])(
            jnp.asarray(b0), jnp.asarray(counts), jnp.asarray(cum - counts),
            jnp.int32(cum[-1]), jnp.asarray(fields)))
        outs[cap] = got, want
    full, jfull = outs[m]
    assert np.array_equal(full, jfull)
    assert bytes(full[:100]) == bytes([0x80, 199]) * 50
    cut, jcut = outs[20]
    assert bytes(cut[:100]) == bytes([0x80, 199]) * 20 + bytes([0x80, 0]) * 30
    assert bytes(jcut[:40]) == bytes([0x80, 199]) * 20
    assert bytes(jcut[40:70]) == bytes([0x80]) * 30
