"""The frozen reference against the port's plain versions it was copied
from: the same draws, bit for bit, and the same couplings."""

import math

import pytest
import torch

from perfbench.reference import physics
from perfbench.reference import schwinger as ref

SEED = torch.tensor([7, -9], dtype=torch.int32)


def links(g, C, n, dtype):
    return (torch.rand(C, n, generator=g, dtype=torch.float64)
            * 2 * math.pi - math.pi).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_sweep_chain_equals_the_ports(dtype):
    from mlmcpathintegral_tpu_torch.ops import schwinger as port
    th = links(torch.Generator().manual_seed(3), 5, 2 * 8 * 8, dtype)
    kw = dict(beta=2.0, Mt=8, Mx=8, n_steps=3, with_energy=True, chain0=4)
    for a, b in zip(ref.sweep_chain(th, SEED, **kw),
                    port.schwinger_sweep_chain_plain(th, SEED, **kw)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("beta", [4.0, 16.0])
def test_twolevel_chain_equals_the_ports(beta):
    from mlmcpathintegral_tpu_torch.ops import schwinger_twolevel as port
    g = torch.Generator().manual_seed(4)
    f32 = torch.float32
    args = (links(g, 5, 2 * 8 * 8, f32), links(g, 5, 2 * 4 * 4, f32),
            torch.rand(5, generator=g), torch.rand(5, generator=g), SEED)
    kw = dict(beta=beta, beta_c=beta / 4, Mt=8, Mx=8, n_steps=3, t_sub=2)
    for a, b in zip(ref.twolevel_chain(*args, **kw),
                    port.schwinger_twolevel_chain_plain(*args, **kw)):
        assert torch.equal(a, b)
    assert ref.fill_constants(beta) == port.fill_constants(beta)


def test_couplings_equal_the_ports():
    from mlmcpathintegral_tpu_torch.lattice2d import (
        CoarseningType, Lattice2D,
    )
    from mlmcpathintegral_tpu_torch.models.base import RenormalisationType
    from mlmcpathintegral_tpu_torch.models.qft.schwinger import (
        QuenchedSchwingerAction,
    )
    act = QuenchedSchwingerAction(
        Lattice2D(32, 32, CoarseningType.BOTH), beta=16.0,
        renormalisation=RenormalisationType.NONPERTURBATIVE)
    want = [act.beta]
    for _ in range(2):
        act = act.coarse_action()
        want.append(act.beta)
    assert physics.level_couplings(16.0, 32, 32, 3) == pytest.approx(
        want, rel=1e-12)
    assert physics.chit_analytical(4.0, 64) == pytest.approx(
        0.48201592952347727, rel=1e-12)


@pytest.mark.parametrize("blocks", [(3, 5), (7, 2, 9)])
def test_statistics_record_by_definition_and_the_ports(blocks):
    """Blocks shorter and longer than the ring, recorded one after the
    other: the reference's running mean, S_k and ring are the definitions'
    over the whole series, and the port's update in float64 agrees."""
    from mlmcpathintegral_tpu_torch.utils import statistics as st
    from perfbench.reference import statistics as stats_ref
    C, K = 3, 4
    g = torch.Generator().manual_seed(6)
    series = torch.randn(sum(blocks), C, generator=g, dtype=torch.float64)
    n, avg = 0, torch.zeros(C, dtype=torch.float64)
    ring, S = torch.zeros(C, K, dtype=torch.float64), \
        torch.zeros(C, K, dtype=torch.float64)
    port = st.init(C, K, torch.float64, "cpu")
    t0 = 0
    for T in blocks:
        Y = series[t0:t0 + T]
        n, avg, ring, S = stats_ref.record(n, avg, ring, S, Y)
        port = st.record_block(port, Y)
        t0 += T
    q = series.T
    assert n == t0 == int(port.n_lt)
    assert torch.allclose(avg, q.mean(dim=1), rtol=0, atol=1e-13)
    for k in range(K):
        want = (q[:, k:] * q[:, :t0 - k]).sum(dim=1) / (t0 - k)
        assert torch.allclose(S[:, k], want, rtol=0, atol=1e-13)
    assert torch.equal(ring, q[:, t0 - 1 - torch.arange(K)])
    assert torch.allclose(port.avg_lt, avg, rtol=0, atol=1e-13)
    assert torch.allclose(port.S_k, S, rtol=0, atol=1e-13)
    assert torch.equal(port.ring, ring)
