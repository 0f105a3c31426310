"""The port's spiking core against the JAX reference, on the CPU.

Inputs are made with numpy from a seed and go through both packages.
Packing, activity maps and LIF spike words are bit-exact by construction
(integer ops; the LIF recurrence runs the reference's op order in the same
dtype, f32 or bf16), so they are compared with equality.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import ftp as j_ftp
from repro.core import lif as j_lif
from repro.core import packing as j_pack
from repro_torch.bridge import to_torch, words_to_numpy, words_to_torch
from repro_torch.core import ftp as t_ftp
from repro_torch.core import lif as t_lif
from repro_torch.core import packing as t_pack

# The suite runs in parallel worker processes that share the cores; these
# tests are small, so one intra-op thread keeps torch from oversubscribing
# them.
torch.set_num_threads(1)


def _spikes(rng, T, *shape, density=0.3):
    return (rng.random((T,) + shape) < density).astype(np.float32)


def _words(rng, T, *shape, density=0.3):
    s = _spikes(rng, T, *shape, density=density)
    return np.array(j_pack.pack_spikes(jnp.asarray(s)))


@pytest.mark.parametrize("T", [1, 4, 8, 31, 32])
def test_pack_unpack_bit_exact(T):
    """Packing at every T, bit 31 included: same words, same planes."""
    rng = np.random.default_rng(T)
    s = _spikes(rng, T, 6, 37, density=0.5)
    want = np.asarray(j_pack.pack_spikes(jnp.asarray(s)))
    got = t_pack.pack_spikes(torch.from_numpy(s))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(words_to_numpy(got), want)
    planes = t_pack.unpack_spikes(words_to_torch(want), T)
    np.testing.assert_array_equal(
        planes.numpy(), np.asarray(j_pack.unpack_spikes(jnp.asarray(want), T)))


def test_popcount_and_mask_low_activity_bit_exact():
    rng = np.random.default_rng(1)
    w = _words(rng, 8, 32, 64, density=0.15)
    tw = words_to_torch(w)
    np.testing.assert_array_equal(
        t_pack.popcount(tw).numpy(), np.asarray(j_pack.popcount(jnp.asarray(w))))
    for m in (1, 2, 3):
        np.testing.assert_array_equal(
            words_to_numpy(t_pack.mask_low_activity(tw, m)),
            np.asarray(j_pack.mask_low_activity(jnp.asarray(w), m)))


def test_popcount_counts_bit_31():
    w = np.array([[0x80000001, 0xFFFFFFFF, 0]], np.uint32)
    np.testing.assert_array_equal(
        t_pack.popcount(words_to_torch(w)).numpy(), [[2, 32, 0]])


@pytest.mark.parametrize("bm,bk", [(8, 16), (4, 128), (16, 64)])
def test_block_activity_map_bit_exact(bm, bk):
    rng = np.random.default_rng(bm + bk)
    w = _words(rng, 4, 32, 256, density=0.01)
    w[:bm] = 0  # one all-silent row tile
    np.testing.assert_array_equal(
        t_pack.block_activity_map(words_to_torch(w), bm, bk).numpy(),
        np.asarray(j_pack.block_activity_map(jnp.asarray(w), bm, bk)))


def test_lif_forward_f32_spikes_and_potential_exact():
    """Same op order in f32: identical spike trains and membranes."""
    rng = np.random.default_rng(2)
    o = (rng.normal(size=(4, 16, 48)) * 1.2).astype(np.float32)
    js, ju = j_lif.lif_forward(jnp.asarray(o))
    ts, tu = t_lif.lif_forward(torch.from_numpy(o))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(
        words_to_numpy(t_pack.pack_spikes(ts)),
        np.asarray(j_pack.pack_spikes(js)))


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
def test_direct_encode_words_exact(dtype):
    """direct_encode of f32 and of bf16 activations (the serving FFN runs
    its encode in bf16) gives the reference's words bit for bit, against
    the jitted reference."""
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(64, 96)) * 1.5).astype(dtype)
    enc = jax.jit(lambda a: j_pack.pack_spikes(j_lif.direct_encode(a, 4)))
    want = np.asarray(enc(jnp.asarray(x)))
    got = t_pack.pack_spikes(t_lif.direct_encode(to_torch(x), 4))
    np.testing.assert_array_equal(words_to_numpy(got), want)


def test_spike_fn_surrogate_gradient():
    """ATan surrogate: forward 1[x > 0], backward alpha / (2 (1 + (pi/2
    alpha x)^2)); f32 elementwise, so within 1e-6."""
    x = np.linspace(-2, 2, 41).astype(np.float32)
    jg = jax.grad(lambda a: jnp.sum(j_lif.spike_fn(a) * jnp.arange(41.0)))(
        jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    y = t_lif.spike_fn(tx)
    (y * torch.arange(41.0)).sum().backward()
    np.testing.assert_array_equal(y.detach().numpy(),
                                  np.asarray(j_lif.spike_fn(jnp.asarray(x))))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-6)


def test_rate_decode():
    s = _spikes(np.random.default_rng(4), 4, 8, 8)
    np.testing.assert_array_equal(
        t_lif.rate_decode(torch.from_numpy(s)).numpy(),
        np.asarray(j_lif.rate_decode(jnp.asarray(s))))


def test_ftp_layer_and_spmspm_match_reference():
    """Plain FTP reference: full sums within 1e-5 (f32 sums of K terms in
    another order), and no spike word may differ at this size."""
    rng = np.random.default_rng(5)
    T, M, K, N = 4, 24, 80, 40
    w = _words(rng, T, M, K)
    b = (rng.normal(size=(K, N)) / 4).astype(np.float32)
    o_j = np.asarray(j_ftp.ftp_spmspm(jnp.asarray(w), jnp.asarray(b), T))
    o_t = t_ftp.ftp_spmspm(words_to_torch(w), torch.from_numpy(b), T)
    np.testing.assert_allclose(o_t.numpy(), o_j, rtol=1e-5, atol=1e-5)
    c_j, u_j = j_ftp.ftp_layer(jnp.asarray(w), jnp.asarray(b), T)
    c_t, u_t = t_ftp.ftp_layer(words_to_torch(w), torch.from_numpy(b), T)
    assert int((words_to_numpy(c_t) != np.asarray(c_j)).sum()) == 0
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), rtol=1e-5, atol=1e-5)
    s = _spikes(rng, T, M, K)
    np.testing.assert_allclose(
        t_ftp.ftp_spmspm_unpacked(torch.from_numpy(s), torch.from_numpy(b)).numpy(),
        np.asarray(j_ftp.ftp_spmspm_unpacked(jnp.asarray(s), jnp.asarray(b))),
        rtol=1e-5, atol=1e-5)
