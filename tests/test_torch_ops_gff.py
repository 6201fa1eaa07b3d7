"""Plain PyTorch versions of the GFF sweep kernel (K9), the neighbour-sum
probe kernel (P1) and the step-less RNG streams (P2), against the JAX
package: K9 against ``ops/pallas_gff.py::gff_sweep`` in interpret mode,
P1 against the probe's Pallas body run through ``pl.pallas_call`` in
interpret mode, P2 against ``CounterRng`` with ``step=None``.  Inputs come
from numpy seeds; two chain blocks (C = 256, block_chains = 128) make the
global chain ids count.  Tolerances: 1e-12 in f64, and in f32 1e-6
relative to max(|phi|, 1): XLA on the CPU rewrites the kernel's
``2 nb / kappa - phi`` as a multiply by the reciprocal contracted with the
subtract into one fused multiply-add, so interpret mode rounds the f32
intermediates (of size up to ~8) otherwise than the source arithmetic that
the plain version and the CUDA kernel repeat; the transcendentals of the
normals are rounded by two libraries.  Also the
launch-shape logic of the two sweep kernels whose fields may leave shared
memory, with the device's limit given."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from mlmcpathintegral_tpu.ops import pallas_gff as jpg
from mlmcpathintegral_tpu.ops.pallas_rng import CounterRng, element_ids
from mlmcpathintegral_tpu_torch.ops import gff as tpg
from mlmcpathintegral_tpu_torch.ops import rng as trng
from mlmcpathintegral_tpu_torch.ops import schwinger as tps

torch.set_num_threads(1)

C, BLOCK = 256, 128
H100_SMEM_OPTIN = 232448
TOL = {np.float64: 1e-12, np.float32: 1e-6}


def _phi(Mx, Mt, dtype, seed=0):
    return np.random.default_rng(seed).normal(
        size=(C, Mx * Mt)).astype(dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("n_or, n_hb", [(1, 0), (0, 1), (1, 1), (0, 2)])
@pytest.mark.parametrize("Mt, Mx", [(8, 8), (16, 8), (8, 16)])
def test_sweep_plain_matches_pallas(Mt, Mx, n_or, n_hb, dtype):
    phi = _phi(Mx, Mt, dtype, Mt * Mx + n_or)
    # one-word and two-word seeds
    seed = (np.array([-123457], np.int32) if (Mt + n_hb) % 2
            else np.array([123456, -98765], np.int32))
    kappa = 4.0 + (2.0 / Mt) ** 2
    kw = dict(kappa=kappa, Mt=Mt, Mx=Mx, n_overrelax=n_or, n_heatbath=n_hb)
    want = np.asarray(jpg.gff_sweep(jnp.asarray(phi), jnp.asarray(seed),
                                    block_chains=BLOCK, interpret=True, **kw))
    got = tpg.gff_sweep(torch.from_numpy(phi), torch.from_numpy(seed), **kw)
    assert got.dtype == torch.from_numpy(phi).dtype
    scale = np.maximum(np.abs(want), 1.0)
    assert np.max(np.abs(got.numpy() - want) / scale) <= TOL[dtype]
    # the sweeps moved every site
    assert (got.numpy() != phi).mean() > 0.99


def _nb_kernel(x_ref, o_ref, *, Mt):
    # the probe's body (tools/perf_probe.py probe_verify_gff.nb_kernel)
    o_ref[:] = jpg._nbsum(x_ref[:], Mt)


@pytest.mark.parametrize("Mt, Mx", [(8, 8), (16, 16), (16, 8), (8, 16)])
def test_nbsum_plain_matches_pallas_probe(Mt, Mx):
    phi = _phi(Mx, Mt, np.float32, 7 * Mt + Mx)
    g = jnp.asarray(phi).reshape(C, Mx, Mt).transpose(1, 2, 0)
    nb = pl.pallas_call(
        functools.partial(_nb_kernel, Mt=Mt),
        out_shape=jax.ShapeDtypeStruct((Mx, Mt, C), jnp.float32),
        interpret=True)(g)
    want = np.asarray(nb.transpose(2, 0, 1).reshape(C, Mx * Mt))
    got = tpg.gff_nbsum(torch.from_numpy(phi), Mt, Mx)
    np.testing.assert_array_equal(got.numpy(), want)


def test_stepless_rng_fill_matches_jax():
    """P2: the probe's intended body, the step-less stream at seed 42 over
    an (8, 8, 512) grid: site = 8 a + b, chain the last axis."""
    shape = (8, 8, 512)
    site, chain = element_ids(shape, shape[-1], jnp.int32(0))
    rng = CounterRng(jnp.uint32(42), site, chain)
    want_bits = np.stack([np.asarray(rng.bits()) for _ in range(3)])
    rng = CounterRng(jnp.uint32(42), site, chain)
    u1 = np.asarray(rng.uniform(jnp.float32))
    n23 = np.asarray(rng.normal(jnp.float32))
    bits, uni, nrm = trng.rng_fill(42, n_sites=64, n_chains=512, n_steps=1,
                                   n_ctr=3, step0=None, device="cpu")

    def grid(t):      # [n_chains, n_sites] -> the probe's (8, 8, 512)
        return t.numpy().T.reshape(shape)

    for k in range(3):
        np.testing.assert_array_equal(grid(bits[0, k]),
                                      want_bits[k].astype(np.int64))
    np.testing.assert_array_equal(grid(uni[0, 0]), u1)
    # the normal of words 2-3, from the fill's uniforms of those words
    u2, u3 = uni[0, 1], uni[0, 2]
    n = torch.sqrt(-2.0 * torch.log(u2)) * torch.cos(trng.TWO_PI * u3)
    np.testing.assert_allclose(grid(n), n23, rtol=0, atol=1e-6)
    # the fill's own normals are words 1-2, and a step-less stream is not
    # step 0 of the stepped ones
    assert nrm.shape == (1, 1, 512, 64)
    stepped = trng.rng_fill_plain(42, n_sites=64, n_chains=512, n_steps=1,
                                  n_ctr=1, device="cpu", step0=0)[0]
    assert (stepped[0, 0] != bits[0, 0]).float().mean() > 0.99
    with pytest.raises(ValueError, match="one step"):
        trng.rng_fill(42, n_sites=4, n_chains=4, n_steps=2, n_ctr=1,
                      step0=None, device="cpu")


@pytest.mark.parametrize("launch, Mx, n_chains, in_global", [
    (tps.sweep_launch, 4, 1024, False),      # the main path's coarsest level
    (tps.sweep_launch, 128, 64, False),      # 128 KB of links + 8 KB
    (tps.sweep_launch, 256, 64, True),       # 512 KB per chain
    (tpg.sweep_launch, 16, 4096, False),     # path E: 1 KB per chain
    (tpg.sweep_launch, 128, 64, False),      # 64 KB, with the opt-in
    (tpg.sweep_launch, 256, 64, True),       # 256 KB per chain
])
def test_sweep_launch_moves_large_fields_to_global_memory(launch, Mx,
                                                          n_chains,
                                                          in_global):
    tpc, cpb, smem, glob = launch(Mx, Mx, n_chains, H100_SMEM_OPTIN)
    # both sweeps name their branch: the warp design, a block, or global
    # memory
    glob = glob == "global"
    assert glob is in_global
    assert tpc & (tpc - 1) == 0 and tpc <= 1024 and smem <= H100_SMEM_OPTIN
    if launch is tps.sweep_launch:
        # the shared-memory branch is the launch with the field in it
        full = tps.sweep_smem_bytes(Mx, Mx, n_chains)
        if glob:
            assert full[2] > H100_SMEM_OPTIN
            # one chain a block, the word table and Q/E scratch alone
            assert (cpb, smem) == (1, 4 * (tps.SWEEP_WORDS + 2 * tpc))
        else:
            assert (tpc, cpb, smem) == full
    else:
        assert smem == (0 if glob else 4 * cpb * Mx * Mx)
        assert cpb == 1 or not glob
