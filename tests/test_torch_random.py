"""The port's threefry keys and uniforms (quiver_tpu_torch.random) against
jax.random (threefry2x32, partitionable): key, fold_in, split, 32-bit
random bits and float32 uniforms must be bit-equal, at several shapes
including odd ones. The sampler's bit parity stands on this."""

import numpy as np
import pytest

import jax
import torch

from quiver_tpu_torch import random as qrandom

# tiny shapes: one intra-op thread leaves the cores to the other test workers
torch.set_num_threads(1)


@pytest.mark.parametrize("seed", [0, 3, 7, 2**31 - 1, -5, 2**32 - 1])
def test_key_and_fold_in_bit_equal(seed):
    jk, tk = jax.random.key(seed), qrandom.key(seed)
    assert np.array_equal(jax.random.key_data(jk), qrandom.key_data(tk))
    for data in (0, 1, 12345, 2**31 + 7):
        assert np.array_equal(jax.random.key_data(jax.random.fold_in(jk, data)),
                              qrandom.key_data(qrandom.fold_in(tk, data)))


@pytest.mark.parametrize("num", [2, 3, 5])
def test_split_bit_equal(num):
    jk = jax.random.fold_in(jax.random.key(3), 17)
    tk = qrandom.fold_in(qrandom.key(3), 17)
    want = np.asarray(jax.random.key_data(jax.random.split(jk, num)))
    got = np.stack([qrandom.key_data(k) for k in qrandom.split(tk, num)])
    assert np.array_equal(want, got)


def test_sampler_key_stream_bit_equal():
    """The per-call fold_in then the per-hop ``key, sub = split(key)``."""
    jk, tk = jax.random.key(3), qrandom.key(3)
    for call in range(4):
        jkey, tkey = jax.random.fold_in(jk, call), qrandom.fold_in(tk, call)
        for _hop in range(3):
            jkey, jsub = jax.random.split(jkey)
            tkey, tsub = qrandom.split(tkey)
            assert np.array_equal(jax.random.key_data(jsub), qrandom.key_data(tsub))
            assert np.array_equal(jax.random.key_data(jkey), qrandom.key_data(tkey))


@pytest.mark.parametrize("shape", [(1,), (7,), (15, 64), (5, 11264), (3, 4, 5), (10, 1023)])
def test_bits_and_uniform_bit_equal(shape):
    jk = jax.random.split(jax.random.fold_in(jax.random.key(11), 2))[1]
    tk = qrandom.split(qrandom.fold_in(qrandom.key(11), 2))[1]
    bits = np.asarray(jax.random.bits(jk, shape, np.uint32))
    got_bits = qrandom.random_bits_32(tk, shape).numpy().astype(np.uint32)
    assert np.array_equal(bits, got_bits)
    u = np.asarray(jax.random.uniform(jk, shape))
    tu = qrandom.uniform(tk, shape)
    assert tu.dtype == torch.float32 and tu.shape == shape
    assert np.array_equal(u.view(np.uint32), tu.numpy().view(np.uint32))
    assert float(tu.min()) >= 0.0 and float(tu.max()) < 1.0
