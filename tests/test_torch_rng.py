"""PyTorch port's counter RNG (mlmcpathintegral_tpu_torch/ops/rng.py)
against the JAX one (mlmcpathintegral_tpu/ops/pallas_rng.py): identical
uint32 bits and uniforms over sites, chains, steps and counters, normals
to 1e-12 in f64.  Runs on the CPU; the CUDA twin (csrc/rng.cuh) is held
against the plain version by chip_smoke.py on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlmcpathintegral_tpu.ops import pallas_rng as jrng
from mlmcpathintegral_tpu_torch.ops import rng as trng

# the port's tests run small tensors: one thread per worker process
# avoids oversubscribing the cores the parallel test workers share
torch.set_num_threads(1)

N_SITES, N_CHAINS = 48, 24


def _ids():
    site = np.arange(N_SITES, dtype=np.uint32)[None, :]
    chain = np.arange(N_CHAINS, dtype=np.uint32)[:, None] + 1000
    return site, chain


# (seed, seed2, step): negative int32 seeds wrap as astype(uint32) does
CASES = [(12345, None, None), (-7, 99, None), (2**31 - 1, -2**31, 3),
         (0, 0, 0), (-123456789, 42, 4095)]


@pytest.mark.parametrize("seed,seed2,step", CASES)
def test_bits_and_uniforms_identical(seed, seed2, step):
    site, chain = _ids()
    jr = jrng.CounterRng(
        jnp.asarray(np.int32(seed)).astype(jnp.uint32), jnp.asarray(site),
        jnp.asarray(chain),
        None if seed2 is None
        else jnp.asarray(np.int32(seed2)).astype(jnp.uint32),
        step=None if step is None else jnp.uint32(step))
    tr = trng.CounterRng(seed, torch.from_numpy(site.astype(np.int64)),
                         torch.from_numpy(chain.astype(np.int64)),
                         seed2, step=step)
    n = 7
    jb = np.stack([np.asarray(jr.bits()) for _ in range(n)])
    tb = tr.bits(n).numpy()
    np.testing.assert_array_equal(tb, jb.astype(np.int64))
    ju = np.stack([np.asarray(jr.uniform(jnp.float64)) for _ in range(n)])
    tu = tr.uniform(torch.float64, n).numpy()
    np.testing.assert_array_equal(tu, ju)
    # single-word draws continue the same stream
    np.testing.assert_array_equal(tr.bits().numpy(),
                                  np.asarray(jr.bits()).astype(np.int64))


def test_normals_match():
    site, chain = _ids()
    jr = jrng.CounterRng(jnp.uint32(5), jnp.asarray(site),
                         jnp.asarray(chain), jnp.uint32(6), step=2)
    tr = trng.CounterRng(5, torch.from_numpy(site.astype(np.int64)),
                         torch.from_numpy(chain.astype(np.int64)), 6,
                         step=2)
    for _ in range(3):
        np.testing.assert_allclose(tr.normal(torch.float64).numpy(),
                                   np.asarray(jr.normal(jnp.float64)),
                                   rtol=0, atol=1e-12)


def test_fmix32_and_mul32_full_range():
    rs = np.random.default_rng(0)
    h = rs.integers(0, 2**32, size=4096, dtype=np.uint64).astype(np.uint32)
    h[:4] = [0, 1, 2**31, 2**32 - 1]
    want = np.asarray(jrng.fmix32(jnp.asarray(h))).astype(np.int64)
    got = trng.fmix32(torch.from_numpy(h.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want)
    c = 0xC2B2AE3D
    np.testing.assert_array_equal(
        trng._mul32(torch.from_numpy(h.astype(np.int64)), c).numpy(),
        (h.astype(np.uint64) * np.uint64(c) % np.uint64(2**32))
        .astype(np.int64))


def test_rng_fill_plain_matches_stream():
    """rng_fill's plain version lays out the same words as CounterRng
    (with element_ids and step = step0 + st)."""
    bits, uni, nrm = trng.rng_fill_plain((3, -4), n_sites=5, n_chains=3,
                                         n_steps=2, n_ctr=6, step0=10,
                                         device="cpu")
    assert bits.shape == (2, 6, 3, 5) and nrm.shape == (2, 3, 3, 5)
    site = jnp.arange(5, dtype=jnp.uint32)[None, :]
    chain = jnp.arange(3, dtype=jnp.uint32)[:, None]
    jr = jrng.CounterRng(jnp.uint32(3), site, chain,
                         jnp.asarray(np.int32(-4)).astype(jnp.uint32),
                         step=jnp.uint32(11))
    for k in range(6):
        np.testing.assert_array_equal(bits[1, k].numpy(),
                                      np.asarray(jr.bits()).astype(np.int64))
    jr.ctr = 0
    for k in range(3):
        np.testing.assert_allclose(nrm[1, k].numpy(),
                                   np.asarray(jr.normal(jnp.float32)),
                                   rtol=0, atol=1e-6)
    np.testing.assert_array_equal(
        uni.numpy(), ((((bits.numpy() >> 9) | 0x3F800000).astype(np.uint32)
                       .view(np.float32) * -1) + np.float32(2.0)))


def test_counters_stay_zero_on_cpu():
    from mlmcpathintegral_tpu_torch import ops
    before = [(c.launches, c.plain_cuda_calls) for c in ops.counters()]
    trng.rng_fill((1, 2), n_sites=4, n_chains=2, n_steps=1, n_ctr=2,
                  device="cpu")
    assert [(c.launches, c.plain_cuda_calls)
            for c in ops.counters()] == before


@pytest.mark.parametrize("grid, want", [
    # (sites, chains, steps, counters): (threads, blocks x, blocks y)
    ((64, 1024, 4, 8), (256, 256, 4)),          # the kernel table's grid
    ((64, 4096, 4, 32), (256, 1024, 4)),        # 33.5M words, stepped
    ((256, 4096, 1, 32), (256, 4096, 1)),       # 33.5M words, step-less
    ((16, 4, 2304, 320), (64, 1, 2304)),        # the long parity grid
    ((64, 512, 1, 3), (256, 128, 1)),           # the JAX probe's grid
    ((5, 3, 2, 6), (32, 1, 2)),                 # a ragged plane
    ((1, 1, 70000, 1), (32, 1, 65535)),         # steps looped along y
])
def test_rng_fill_launch_layout(grid, want):
    threads, bx, by = trng.fill_launch(*grid)
    assert (threads, bx, by) == want
    plane = grid[0] * grid[1]
    assert threads % 32 == 0 and bx * threads >= plane > (bx - 1) * threads
    assert by <= trng.MAX_GRID_Y


@pytest.mark.parametrize("grid", [(2**16, 2**15, 1, 1),     # plane 2^31
                                  (64, 4096, 16, 512),       # 2^31 words
                                  (64, 4096, 1, 8193)])      # 2^31 + 2^18
def test_rng_fill_refuses_what_32_bit_indices_would_wrap(grid):
    with pytest.raises(ValueError, match="32 bits"):
        trng.fill_launch(*grid)


@pytest.mark.parametrize("step0, n_steps", [(None, 1), (0, 3), (4093, 2)])
def test_rng_fill_plain_matches_jax_grid(step0, n_steps):
    """The whole grid of rng_fill's plain version against JAX's
    CounterRng, stream by stream: bits and uniforms identical, normals of
    the word pairs to 1e-6 (float32), for the step-less streams (the GFF
    sweep's, P2) and stepped ones."""
    S, Cn, K = 6, 5, 7
    bits, uni, nrm = trng.rng_fill_plain((77, -5), n_sites=S, n_chains=Cn,
                                         n_steps=n_steps, n_ctr=K,
                                         step0=step0, device="cpu")
    site = jnp.arange(S, dtype=jnp.uint32)[None, :]
    chain = jnp.arange(Cn, dtype=jnp.uint32)[:, None]
    for st in range(n_steps):
        jr = jrng.CounterRng(
            jnp.uint32(77), site, chain,
            jnp.asarray(np.int32(-5)).astype(jnp.uint32),
            step=None if step0 is None else jnp.uint32(step0 + st))
        jb = np.stack([np.asarray(jr.bits()) for _ in range(K)])
        np.testing.assert_array_equal(bits[st].numpy(), jb.astype(np.int64))
        jr.ctr = 0
        ju = np.stack([np.asarray(jr.uniform(jnp.float32))
                       for _ in range(K)])
        np.testing.assert_array_equal(uni[st].numpy(), ju)
        jr.ctr = 0
        jn = np.stack([np.asarray(jr.normal(jnp.float32))
                       for _ in range(K // 2)])
        np.testing.assert_allclose(nrm[st].numpy(), jn, rtol=0, atol=1e-6)
