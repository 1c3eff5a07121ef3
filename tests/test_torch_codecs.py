"""The port's generic codecs (adacom_tpu_torch.ops.codecs) against the JAX
package's (adacom_tpu.ops.codecs), on the CPU: for every codec, the same
host values give the same meta, byte-identical packed words, the same
decoder arguments and the same nbytes; decode and gather are exact (ALP
included: both divide in IEEE f64); analyze and detect_best_codec agree; a
segment encoded by the JAX package decodes in the port. Template:
tests/test_codecs.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import adacom_tpu
import adacom_tpu_torch
from adacom_tpu import types as jtt
from adacom_tpu.ops import codecs as jcodecs
from adacom_tpu_torch import types as ttt
from adacom_tpu_torch.ops import bitpack, codecs

_RNG = np.random.default_rng(0xC0DEC)
_I64 = np.iinfo(np.int64)


def _datasets():
    n = 9000
    wrap = (np.arange(1000, dtype=np.uint64) + np.uint64(_I64.max - 500))
    return {
        "constant_i32": ("constant", "INTEGER", np.full(5000, 42, np.int32)),
        "constant_f64": ("constant", "DOUBLE", np.full(777, -2.5)),
        "rle_i32": ("rle", "INTEGER",
                    np.repeat(np.arange(37, dtype=np.int32), 173)),
        "rle_one_run": ("rle", "BIGINT", np.full(4097, -(1 << 40), np.int64)),
        "rle_f64": ("rle", "DOUBLE", np.repeat(
            np.asarray([1.5, -2.25, 0.0, 3.125]), 500)),
        "rle_u32": ("rle", "UINTEGER", np.repeat(
            np.asarray([0, 1 << 31, (1 << 32) - 1], np.uint32), 700)),
        "delta_i64": ("delta", "BIGINT", np.arange(10_000, dtype=np.int64) * 3 + 17),
        "delta_i64_wrap": ("delta", "BIGINT", wrap.view(np.int64)),
        "delta_i32_wrap": ("delta", "INTEGER", np.tile(np.asarray(
            [0, 2**31 - 1, -2**31, 5, -5], np.int32), 100)),
        "delta_u32": ("delta", "UINTEGER", (np.arange(3000, dtype=np.uint32)
                                           * 7 + (1 << 31))),
        "dictionary_i32": ("dictionary", "INTEGER", _RNG.choice(
            np.asarray([5, 900, 31, 77, 123456], np.int32), size=n)),
        "dictionary_2": ("dictionary", "BIGINT", _RNG.choice(
            np.asarray([-(1 << 50), 1 << 50], np.int64), size=n)),
        "dictionary_4096": ("dictionary", "INTEGER", _RNG.choice(
            _RNG.integers(-10**9, 10**9, 4096).astype(np.int32), size=65536)),
        "alp_e2_neg": ("alp", "DOUBLE",
                       _RNG.integers(-10_000, 10_000, 8000) / 100.0),
        "alp_e0": ("alp", "DOUBLE",
                   _RNG.integers(-(1 << 40), 1 << 40, 3000).astype(np.float64)),
        "alp_e14": ("alp", "DOUBLE",
                    _RNG.integers(-10**6, 10**6, 2000) / 1e14),
        "alp_f32": ("alp", "FLOAT", (_RNG.integers(-10**4, 10**4, 5000)
                                     / 100.0).astype(np.float32)),
    }


DATASETS = _datasets()


def _encode_both(codec, tname, values):
    enc_j = jcodecs.encode(codec, values, getattr(jtt, tname),
                           adacom_tpu.DBConfig())
    enc_t = codecs.encode(codec, values, getattr(ttt, tname),
                          adacom_tpu_torch.DBConfig())
    return enc_j, enc_t


def _word_args(meta):
    """Positions of packed-word arguments in a codec's arguments."""
    name = meta[0]
    if name in ("delta", "dictionary"):
        return {0}
    if name == "alp":
        return set(range(sum(1 for w in meta[1] if w > 0)))
    return set()


def _host(a) -> np.ndarray:
    return np.asarray(a)


@pytest.mark.parametrize("name", sorted(DATASETS))
def test_encode_matches_reference(name):
    codec, tname, values = DATASETS[name]
    enc_j, enc_t = _encode_both(codec, tname, values)
    assert enc_t.meta == enc_j.meta
    assert enc_t.nbytes == enc_j.nbytes
    assert enc_t.count == enc_j.count == len(values)
    assert len(enc_t.arrays) == len(enc_j.arrays)
    words = _word_args(enc_t.meta)
    for k, (ja, ta) in enumerate(zip(enc_j.arrays, enc_t.arrays)):
        ja, ta = _host(ja), ta.numpy()
        if k in words:  # byte for byte
            assert ta.dtype == np.int32
            np.testing.assert_array_equal(ta.view(np.uint32), ja)
        elif ja.dtype == np.uint64:  # the delta base of a 64-bit column
            assert ta.tobytes() == ja.tobytes()
        else:
            np.testing.assert_array_equal(ta, ja)


@pytest.mark.parametrize("name", sorted(DATASETS))
def test_decode_and_gather_exact(name):
    codec, tname, values = DATASETS[name]
    enc_j, enc_t = _encode_both(codec, tname, values)
    got = codecs.decode_full(enc_t, values.dtype).numpy()
    assert got.dtype == values.dtype
    assert got.tobytes() == values.tobytes()
    assert got.tobytes() == np.asarray(
        jcodecs.decode_full_host(enc_j, values.dtype)).tobytes()
    np.testing.assert_array_equal(
        codecs.decode_full_host(enc_t, values.dtype), values)
    idx = np.random.default_rng(7).integers(0, len(values), 97)
    t_rows = codecs.gather(enc_t, torch.from_numpy(idx)).numpy()
    j_rows = np.asarray(jcodecs.gather(enc_j, jnp.asarray(idx)))
    np.testing.assert_array_equal(t_rows.astype(values.dtype), values[idx])
    np.testing.assert_array_equal(t_rows.astype(values.dtype), j_rows)


@pytest.mark.parametrize("name", sorted(DATASETS))
def test_reference_encoding_decodes_in_the_port(name):
    """A segment the JAX package encoded, moved as its host arrays (words
    as int32 bit-views), decodes in the port to the same values."""
    codec, tname, values = DATASETS[name]
    enc_j = jcodecs.encode(codec, values, getattr(jtt, tname),
                           adacom_tpu.DBConfig())
    words = _word_args(enc_j.meta)
    arrays = tuple(
        codecs._words(np.asarray(a), "cpu") if k in words
        else codecs._to_device(np.asarray(a), "cpu")
        for k, a in enumerate(enc_j.arrays))
    moved = codecs.Encoded(enc_j.codec, enc_j.meta, arrays, enc_j.count,
                           enc_j.nbytes)
    assert codecs.decode_full(moved, values.dtype).numpy().tobytes() == \
        values.tobytes()


def test_pool_decode_stacks_segments():
    """The batched decoders take a pool of same-meta segments stacked along
    a leading axis; each row equals that segment's own decode."""
    rng = np.random.default_rng(3)
    for codec, tname, make in [
        ("delta", "BIGINT", lambda s: np.arange(4096, dtype=np.int64) * 5 + s),
        ("dictionary", "INTEGER", lambda s: rng.choice(
            np.asarray([1, 2, 3, 4 + s], np.int32), 4096)),
        ("rle", "INTEGER", lambda s: np.repeat(
            np.arange(8, dtype=np.int32) + s, 512)),
        ("alp", "DOUBLE", lambda s: rng.integers(0, 10**5 + s, 4096) / 100.0),
    ]:
        encs, vals = [], []
        for s in range(3):
            v = make(s)
            e = codecs.encode(codec, v, getattr(ttt, tname),
                              adacom_tpu_torch.DBConfig())
            if encs and e.meta != encs[0].meta:
                continue
            encs.append(e)
            vals.append(v)
        assert len(encs) >= 2, codec
        dec = codecs.make_decoder(encs[0].meta, vals[0].dtype)
        out = dec(tuple(torch.stack([e.arrays[k] for e in encs])
                        for k in range(len(encs[0].arrays))))
        assert out.shape == (len(encs), bitpack.ROWS * bitpack.lanes_for(4096))
        for row, v in zip(out, vals):
            np.testing.assert_array_equal(row[:len(v)].numpy(), v)


@pytest.mark.parametrize("name", sorted(DATASETS))
def test_analyze_matches_reference(name):
    _codec, tname, values = DATASETS[name]
    jcfg, tcfg = adacom_tpu.DBConfig(), adacom_tpu_torch.DBConfig()
    jl, tl = getattr(jtt, tname), getattr(ttt, tname)
    assert codecs.analyze_all(values, tl, tcfg) == \
        jcodecs.analyze_all(values, jl, jcfg)
    for succ in (None, 1, values.nbytes // 3, values.nbytes):
        assert codecs.detect_best_codec(values, tl, tcfg, succ) == \
            jcodecs.detect_best_codec(values, jl, jcfg, succ)


def test_registry_matches_reference():
    assert codecs.AUTO_ORDER == jcodecs.AUTO_ORDER
    assert sorted(codecs.REGISTRY) == sorted(jcodecs.REGISTRY)


def test_alp_rejects_irrational():
    v = np.random.default_rng(5).standard_normal(4096)
    assert codecs.REGISTRY["alp"].analyze(
        v, ttt.DOUBLE, adacom_tpu_torch.DBConfig()) is None
