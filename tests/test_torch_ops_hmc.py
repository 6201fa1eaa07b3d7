"""The port's HMC trajectory kernel (mlmcpathintegral_tpu_torch/ops/hmc.py):
its plain version against the Pallas kernel in interpret mode (f64, 1e-9,
accept bits identical) for the three actions on the same x, p, u; the
sampler's two trajectory branches against each other on the CPU; and the
wrapper's CPU dispatch."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlmcpathintegral_tpu.ops.pallas_hmc import hmc_trajectory as j_hmc
from mlmcpathintegral_tpu_torch import ops
from mlmcpathintegral_tpu_torch.lattice import Lattice1D
from mlmcpathintegral_tpu_torch.models import (
    HarmonicOscillatorAction, QuarticOscillatorAction, RotorAction,
)
from mlmcpathintegral_tpu_torch.ops.hmc import (
    action_kernel_params, hmc_trajectory, hmc_trajectory_plain,
)
from mlmcpathintegral_tpu_torch.samplers import HMCSampler

torch.set_num_threads(1)

C, M, NT, DT = 8, 16, 5, 0.3
TOL = 1e-9
KINDS = {
    "harmonic": dict(m0=1.0, mu2=1.3),
    "quartic": dict(m0=0.8, mu2=-1.0, lam=1.0, x0=0.2),
    "rotor": dict(m0=1.2),
}


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_trajectory_plain_matches_pallas(kind):
    rs = np.random.default_rng(3)
    x = rs.normal(size=(C, M))
    p = 1.5 * rs.normal(size=(C, M))
    u = rs.uniform(size=C)
    want_x, want_acc = j_hmc(jnp.asarray(x), jnp.asarray(p), jnp.asarray(u),
                             DT, kind=kind, a_lat=0.25, nt=NT,
                             block_chains=C, interpret=True, **KINDS[kind])
    got_x, got_acc = hmc_trajectory_plain(
        torch.from_numpy(x), torch.from_numpy(p), torch.from_numpy(u), DT,
        kind=kind, a_lat=0.25, nt=NT, **KINDS[kind])
    np.testing.assert_array_equal(got_acc.numpy(), np.asarray(want_acc))
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), rtol=0,
                               atol=TOL)
    # both outcomes occur over the three kinds at this step size
    assert got_acc.dtype == torch.bool


def test_trajectories_accept_and_reject():
    rs = np.random.default_rng(3)
    accs = []
    for kind in sorted(KINDS):
        x = torch.from_numpy(rs.normal(size=(64, M)))
        p = torch.from_numpy(1.5 * rs.normal(size=(64, M)))
        u = torch.from_numpy(rs.uniform(size=64))
        accs.append(hmc_trajectory_plain(x, p, u, DT, kind=kind, a_lat=0.25,
                                         nt=NT, **KINDS[kind])[1])
    rate = float(torch.cat(accs).double().mean())
    assert 0.05 < rate < 0.95, rate


@pytest.mark.parametrize("action", [
    HarmonicOscillatorAction(Lattice1D(M, 4.0), m0=1.0, mu2=1.3),
    QuarticOscillatorAction(Lattice1D(M, 4.0), m0=0.8, mu2=-1.0, lam=1.0,
                            x0=0.2),
    RotorAction(Lattice1D(M, 4.0), m0=1.2),
], ids=["harmonic", "quartic", "rotor"])
def test_sampler_kernel_branch_matches_generic_leapfrog(action):
    """HMCSampler's fused branch (the plain kernel on the CPU) and its
    generic leapfrog on the action's force and evaluate draw the same
    noise and reach the same chains."""
    kind, params = action_kernel_params(action)
    assert kind is not None
    out = []
    for use_pallas in (True, False):
        s = HMCSampler(action, nt=NT, dt=0.2, n_burnin=0,
                       use_pallas=use_pallas)
        g = torch.Generator().manual_seed(5)
        st = s.init(g, 32, torch.float64, "cpu")
        st = st._replace(x=torch.randn(32, M, generator=g,
                                       dtype=torch.float64))
        accs = []
        for _ in range(4):
            st, acc = s.draw(g, st)
            accs.append(acc)
        out.append((st.x, torch.stack(accs)))
    assert torch.equal(out[0][1], out[1][1])
    np.testing.assert_allclose(out[0][0].numpy(), out[1][0].numpy(),
                               rtol=0, atol=1e-10)


def test_wrapper_runs_plain_version_on_cpu():
    ops.reset_counters()
    x = torch.zeros(2, 4, dtype=torch.float32)
    hmc_trajectory(x, x, torch.ones(2), 0.1, kind="harmonic", m0=1.0,
                   mu2=1.0, a_lat=0.5, nt=2)
    assert (ops.HMC.launches, ops.HMC.plain_cuda_calls) == (0, 0)
    with pytest.raises(ValueError, match="unsupported device"):
        hmc_trajectory(x.to("meta"), x.to("meta"), torch.ones(2), 0.1,
                       kind="harmonic", m0=1.0, a_lat=0.5, nt=2)
    with pytest.raises(ValueError, match="no fused kernel"):
        HMCSampler(object(), use_pallas=True)
