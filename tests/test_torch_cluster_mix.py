"""The hybrid Schwinger cluster draw with ``use_pallas``: its mixing sweep
on the fused sweep kernel (K2; here its plain version) against the JAX
package composed on identical inputs (the JAX sampler's link
reconstruction and path rebuild given the same gauge, phase and rotation
noise, then JAX's Pallas ``schwinger_sweep`` in interpret mode on the same
seed words; f64, 1e-9); the draw's freedom from the host-read rejection
loop; the chunk generator's CPU twin for kernel seeds; and the 32x32
heat-bath chain at the 128x128 row's coarsest coupling, frozen from a hot
start in both packages, beside the hybrid chain, which reaches chit_exact
at the same level."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlmcpathintegral_tpu.lattice2d import CoarseningType as JCT
from mlmcpathintegral_tpu.lattice2d import Lattice2D as JLattice2D
from mlmcpathintegral_tpu.models.qft.schwinger import (
    QuenchedSchwingerAction as JAction,
)
from mlmcpathintegral_tpu.ops import pallas_schwinger as jps
from mlmcpathintegral_tpu.qoi import qoi_2d_susceptibility as j_qoi_2d
from mlmcpathintegral_tpu.samplers import (
    OverrelaxedHeatBathSampler as JHeatBath,
)
from mlmcpathintegral_tpu.samplers import (
    QuenchedSchwingerClusterSampler as JQSCluster,
)
from mlmcpathintegral_tpu_torch.distributions import expcos, rejection
from mlmcpathintegral_tpu_torch.lattice2d import CoarseningType, Lattice2D
from mlmcpathintegral_tpu_torch.mc import twolevel
from mlmcpathintegral_tpu_torch.models.base import RenormalisationType
from mlmcpathintegral_tpu_torch.models.qft.schwinger import (
    QuenchedSchwingerAction,
)
from mlmcpathintegral_tpu_torch.qoi import qoi_2d_susceptibility
from mlmcpathintegral_tpu_torch.samplers import (
    OverrelaxedHeatBathSampler, QuenchedSchwingerClusterSampler,
    schwingercluster,
)
from mlmcpathintegral_tpu_torch.samplers.base import kernel_seed
from mlmcpathintegral_tpu_torch.samplers.schwingercluster import (
    SchwingerClusterState,
)
from mlmcpathintegral_tpu_torch.utils import statistics as stats_mod
from mlmcpathintegral_tpu_torch.utils.statistics import Statistics

# the port's tests run small tensors: one thread per worker process
# avoids oversubscribing the cores the parallel test workers share
torch.set_num_threads(1)

TOL = 1e-9
MT, MX, C, BETA = 8, 4, 8, 2.0


def _hybrid(use_pallas=True, n_mix_sweeps=1):
    act = QuenchedSchwingerAction(Lattice2D(MT, MX, CoarseningType.BOTH),
                                  beta=BETA)
    return QuenchedSchwingerClusterSampler(act, n_burnin=0, n_updates=5,
                                           n_mix_sweeps=n_mix_sweeps,
                                           use_pallas=use_pallas)


def _state(sampler, seed=0):
    rs = np.random.default_rng(seed)
    psi = torch.from_numpy(rs.uniform(-np.pi, np.pi, (C, MT * MX)))
    return SchwingerClusterState(x=sampler._reconstruct(
        torch.Generator().manual_seed(seed), psi), psi=psi)


@pytest.mark.parametrize("n_mix_sweeps", [1])
def test_kernel_mixed_draw_matches_jax_composed(monkeypatch, n_mix_sweeps):
    """One ``use_pallas`` draw of the port (the cluster kernel's and the
    sweep kernel's plain versions) against the JAX package's arithmetic on
    the port's cluster output: JAX's ``_reconstruct`` with the port's gauge
    and phase noise, ``n_mix_sweeps`` JAX Pallas sweeps (interpret mode) on
    the port's seed words at step offsets 0, 1, ..., JAX's
    ``_psi_from_links`` with the port's rotation."""
    ts = _hybrid(n_mix_sweeps=n_mix_sweeps)
    state = _state(ts)
    seen = {}
    real = {"reconstruct": ts.reconstruct,
            "psi_from_links": ts.psi_from_links,
            "kernel_seed": schwingercluster.kernel_seed}

    def reconstruct(psi, th, u):
        seen.update(psi=psi, th=th, u=u)
        return real["reconstruct"](psi, th, u)

    def psi_from_links(x, c):
        seen["c"] = c
        return real["psi_from_links"](x, c)

    def seed_words(generator):
        seen["seed"] = real["kernel_seed"](generator)
        return seen["seed"]

    monkeypatch.setattr(ts, "reconstruct", reconstruct)
    monkeypatch.setattr(ts, "psi_from_links", psi_from_links)
    monkeypatch.setattr(schwingercluster, "kernel_seed", seed_words)
    out, acc = ts.draw(torch.Generator().manual_seed(4), state)
    assert acc.all()

    js = JQSCluster(JAction(JLattice2D(MT, MX, JCT.BOTH), beta=BETA),
                    n_burnin=0, n_updates=5, n_mix_sweeps=n_mix_sweeps)
    injected = {(C, MX, MT): seen["th"], (C, 1, 1, 2): seen["u"],
                (C, 1): seen["c"]}
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape, *a, **k: jnp.asarray(
                            injected[tuple(shape)].numpy()))
    key = jax.random.PRNGKey(0)
    x = js._reconstruct(key, jnp.asarray(seen["psi"].numpy()))
    for i in range(n_mix_sweeps):
        x = jps.schwinger_sweep(x, jnp.asarray(seen["seed"].numpy()),
                                beta=BETA, Mt=MT, Mx=MX, k_rej=6,
                                step_offset=i, block_chains=C,
                                interpret=True)
    psi = js._psi_from_links(key, x)
    np.testing.assert_allclose(out.x.numpy(), np.asarray(x), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(out.psi.numpy(), np.asarray(psi), rtol=0,
                               atol=TOL)
    # the draw moved the links: the heat bath is not the identity
    assert not np.allclose(np.asarray(x), js._reconstruct(
        key, jnp.asarray(seen["psi"].numpy())))


def _count_rejection_loops(monkeypatch):
    calls = []
    real = rejection.batched_rejection_sample_mask

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    for mod in (rejection, expcos):
        monkeypatch.setattr(mod, "batched_rejection_sample_mask", counted)
    return calls


def test_kernel_mixed_draw_runs_no_host_read_rejection_loop(monkeypatch):
    """With ``use_pallas`` the mixing sweep is the kernel's (its plain
    version here): the plain heat bath's rejection loop, which reads the
    host each round, is not called; without it, it is (a control of the
    counter)."""
    calls = _count_rejection_loops(monkeypatch)
    g = torch.Generator().manual_seed(1)
    ts = _hybrid()
    ts.draw(g, _state(ts))
    assert len(calls) == 0
    plain = _hybrid(use_pallas=False)
    plain.draw(g, _state(plain))
    assert len(calls) == 4          # one ExpCos loop a link group


def test_chunk_generator_twin_and_kernel_seed():
    """On the CPU a chunk's kernel seeds come from the chunk generator
    itself (the words of a plain generator with its seed); on another
    device from a CPU twin seeded from the same words, whose draws leave
    the device generator's stream alone."""
    gen = twolevel.chunk_generator((3, 4), "cpu")
    assert gen.host is None
    ref = torch.Generator().manual_seed((3 << 32) | 4)
    assert torch.equal(kernel_seed(gen), torch.randint(
        -2**31, 2**31 - 1, (2,), generator=ref, dtype=torch.int32))
    # a twin: the seeds come from it, the noise stream stays the same
    twin = twolevel.chunk_generator((3, 4), "cpu")
    twin.host = torch.Generator().manual_seed(
        ((3 << 32) | 4) ^ twolevel.HOST_SEED_MIX)
    s = kernel_seed(twin)
    assert s.device.type == "cpu" and s.dtype == torch.int32
    ref = torch.Generator().manual_seed((3 << 32) | 4)
    assert torch.equal(torch.rand(5, generator=twin),
                       torch.rand(5, generator=ref))
    # ranks draw different streams
    assert not torch.equal(
        torch.rand(3, generator=twolevel.chunk_generator((3, 4), "cpu", 1)),
        torch.rand(3, generator=twolevel.chunk_generator((3, 4), "cpu")))


def _coarsest_beta_of_128_row():
    """beta of the 128x128 scale row's coarsest level (32x32): beta = 256,
    two nonperturbative matchings."""
    act = QuenchedSchwingerAction(
        Lattice2D(128, 128, CoarseningType.BOTH), beta=256.0,
        renormalisation=RenormalisationType.NONPERTURBATIVE)
    return act.coarse_action().coarse_action().beta


def test_heatbath_chain_at_128_rows_coarsest_level_freezes_in_both():
    """Fault 3 of the 128x128 heat-bath row, in both packages: the plain
    heat-bath chain at 32x32, beta_c 16.49, started hot (16 chains, f64),
    keeps its topological charges, so its V chi_t after draw 50 equals
    that after draw 1 to 1e-9, far above chit_exact."""
    beta = _coarsest_beta_of_128_row()
    assert abs(beta - 16.49) < 0.01
    act = QuenchedSchwingerAction(Lattice2D(32, 32, CoarseningType.BOTH),
                                  beta=beta)
    oracle = act.chit_exact()
    q = qoi_2d_susceptibility(act)
    s = OverrelaxedHeatBathSampler(act, n_burnin=0)
    g = torch.Generator().manual_seed(0)
    st = s.init(g, 16, torch.float64, "cpu")
    st, _ = s.draw(g, st)
    first = float(q(st.x).mean())
    for _ in range(49):
        st, _ = s.draw(g, st)
    assert abs(float(q(st.x).mean()) - first) <= TOL * first
    assert first > 10 * oracle

    jact = JAction(JLattice2D(32, 32, JCT.BOTH), beta=beta)
    js = JHeatBath(jact, n_burnin=0)
    jq = j_qoi_2d(jact)
    draw = jax.jit(js.draw)
    key = jax.random.PRNGKey(0)
    key, sub = jax.random.split(key)
    jst = js.init(sub, 16, jnp.float64)
    key, sub = jax.random.split(key)
    jst, _ = draw(sub, jst)
    jfirst = float(jnp.mean(jq(jst.x)))
    for _ in range(49):
        key, sub = jax.random.split(key)
        jst, _ = draw(sub, jst)
    assert abs(float(jnp.mean(jq(jst.x))) - jfirst) <= TOL * jfirst
    assert jfirst > 10 * oracle


def test_hybrid_chain_at_128_rows_coarsest_level_reaches_chit_exact():
    """The hybrid chain with ``use_pallas`` (the kernels' plain versions,
    f64) at the same level, from the same hot start, decorrelates the
    charge: 32 chains, 32 draws after 8 (the charge falls from ~30 to its
    equilibrium in ~6), V chi_t within 4 tau-corrected sigma of
    chit_exact."""
    act = QuenchedSchwingerAction(Lattice2D(32, 32, CoarseningType.BOTH),
                                  beta=_coarsest_beta_of_128_row())
    q = qoi_2d_susceptibility(act)
    s = QuenchedSchwingerClusterSampler(act, n_burnin=8, use_pallas=True)
    g = torch.Generator().manual_seed(0)
    st = s.prepare(g, 32, torch.float64, "cpu")
    for _ in range(8):
        st, _ = s.draw(g, st)
    ys = []
    for _ in range(32):
        st, _ = s.draw(g, st)
        ys.append(q(st.x))
    stats = Statistics("V chi_t", 10)
    state = stats_mod.record_block(stats.init(32, torch.float64, "cpu"),
                                   torch.stack(ys))
    avg, err = stats.average(state), stats.error(state)
    assert math.isfinite(err) and err > 0
    assert abs(avg - act.chit_exact()) < 4.0 * err
