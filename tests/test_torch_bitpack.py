"""Port bit-packing (adacom_tpu_torch.ops.bitpack) against the JAX package's
codec and the NumPy golden encoder: words must be byte-identical.

The JAX codec runs op by op (jax.disable_jit): the same functions, without
one XLA compile per width and shape."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adacom_tpu.ops import bitpack as jbp
from adacom_tpu_torch.ops import bitpack as tbp


def _codes(rng, n, width):
    return (rng.integers(0, 1 << 32, size=n, dtype=np.uint64)
            & ((1 << width) - 1)).astype(np.uint32)


def _torch_pack(codes: np.ndarray, width: int) -> torch.Tensor:
    L = tbp.lanes_for(len(codes))
    rows = tbp.pad_codes(torch.from_numpy(codes.astype(np.int64)), L)
    return tbp.pack(rows, width=width)


@pytest.mark.parametrize("width", range(1, 33))
def test_pack_words_identical(width, rng):
    for n in (33, 4096 + 7):  # ragged counts
        codes = _codes(rng, n, width)
        words = _torch_pack(codes, width)
        assert words.dtype == torch.int32 and words.shape == (width, tbp.lanes_for(n))
        got = words.numpy().view(np.uint32)
        np.testing.assert_array_equal(got, tbp.pack_numpy(codes, width))
        L = jbp.lanes_for(n)
        with jax.disable_jit():
            ref = np.asarray(jbp.pack(jbp.pad_codes(codes, L), width=width))
            jflat = np.asarray(jbp.unpack_flat(jnp.asarray(ref), n, width=width))
        np.testing.assert_array_equal(got, ref)
        # unpack: identical to the JAX unpack and to the codes
        flat = tbp.unpack_flat(words, n, width=width).numpy()
        np.testing.assert_array_equal(flat, codes.astype(np.int64))
        np.testing.assert_array_equal(flat, jflat.astype(np.int64))


@pytest.mark.parametrize("width", [1, 2, 7, 13, 17, 19, 31, 32])
def test_gather_codes_matches_reference(width, rng):
    n = 5000
    codes = _codes(rng, n, width)
    L = tbp.lanes_for(n)
    words = _torch_pack(codes, width)
    idx = rng.integers(0, n, size=257)
    got = tbp.gather_codes(words, torch.from_numpy(idx), width=width, n_lanes=L)
    np.testing.assert_array_equal(got.numpy(), codes[idx].astype(np.int64))
    with jax.disable_jit():
        ref = jbp.gather_codes(jnp.asarray(words.numpy().view(np.uint32)),
                               jnp.asarray(idx), width=width, n_lanes=L)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref).astype(np.int64))


def test_unpack_stacked_segments(rng):
    width, n = 11, 2048
    segs = [_codes(rng, n, width) for _ in range(3)]
    stk = torch.stack([_torch_pack(c, width) for c in segs])
    out = tbp.unpack(stk, width=width)
    assert out.shape == (3, tbp.ROWS, tbp.lanes_for(n))
    for k, c in enumerate(segs):
        np.testing.assert_array_equal(out[k].reshape(-1).numpy(), c.astype(np.int64))
