"""Chain-parallel multilevel and two-level methods of the port on gloo
ranks (the port's counterpart of tests/test_multilevel_sharded.py): the
same run on one process and with its chains split over W = 2 and W = 4
ranks (``mesh=``) must give the same numbers — the analog of the
reference's mpirun invariant, applied to the multilevel method the
reference cannot parallelise (driver_qm.cc:382-386).

4x4 Schwinger, beta = 2, heat-bath coarse chains, 16 chains, float64 on
the CPU.  The fused levels (the plain K3/K4) hash the global chain index,
so the per-chain final states are equal bit for bit and the estimate,
its error, t_sub and n_target exactly; so are the fused QM two-level
run's (the plain K6) states, estimates and acceptance.  The Schwinger
two-level run screens on the unfused path, whose plain noise each rank
draws from its own generator: it is held in distribution.  The adaptive
(epsilon) mode must reach one n_target on every rank and finish.  One
world of four ranks serves every case: ranks {0, 1} and {2, 3} run the
W = 2 cases side by side on two subgroups, then all four the W = 4 ones.
"""

import math

import pytest
import torch
import torch.distributed as dist

from _torch_dist import run_world
from mlmcpathintegral_tpu_torch.conditioned import (
    make_conditioned_fine_action,
)
from mlmcpathintegral_tpu_torch.conditioned.schwinger import (
    make_schwinger_conditioned_fine_action,
)
from mlmcpathintegral_tpu_torch.lattice import Lattice1D
from mlmcpathintegral_tpu_torch.lattice2d import CoarseningType, Lattice2D
from mlmcpathintegral_tpu_torch.mc import (
    MonteCarloMultiLevel, MonteCarloTwoLevel,
)
from mlmcpathintegral_tpu_torch.models import HarmonicOscillatorAction
from mlmcpathintegral_tpu_torch.models.qft.schwinger import (
    QuenchedSchwingerAction,
)
from mlmcpathintegral_tpu_torch.parallel import chain_mesh, gather_chains
from mlmcpathintegral_tpu_torch.qoi import (
    qoi_2d_susceptibility, qoi_x_squared,
)
from mlmcpathintegral_tpu_torch.samplers import (
    HMCSampler, OverrelaxedHeatBathSampler,
)

C = 16
F64 = torch.float64


def _schwinger():
    return QuenchedSchwingerAction(Lattice2D(4, 4, CoarseningType.BOTH),
                                   beta=2.0)


def _mlmc(**kw):
    args = dict(n_level=2, n_burnin=16, n_samples=64, chunk_size=8)
    args.update(kw)
    return MonteCarloMultiLevel(
        _schwinger(), qoi_2d_susceptibility,
        lambda a: OverrelaxedHeatBathSampler(a, n_burnin=10),
        make_schwinger_conditioned_fine_action, **args)


def _twolevel_schwinger():
    return MonteCarloTwoLevel(
        _schwinger(), qoi_2d_susceptibility,
        lambda a: OverrelaxedHeatBathSampler(a, n_burnin=10),
        make_schwinger_conditioned_fine_action,
        n_burnin=16, n_samples=64, chunk_size=8)


def _twolevel_qm():
    """The fused QM two-level path (the plain K6 on the CPU)."""
    act = HarmonicOscillatorAction(Lattice1D(16, 4.0), m0=1.0, mu2=1.0)
    return MonteCarloTwoLevel(
        act, qoi_x_squared, lambda a: HMCSampler(a, nt=8, dt=0.1,
                                                 n_burnin=2),
        make_conditioned_fine_action, n_burnin=16, n_samples=128,
        chunk_size=8, use_pallas=True)


def _stats_numbers(stats_obj, st):
    return (stats_obj.average(st), stats_obj.error(st),
            stats_obj.tau_int(st), stats_obj.samples(st))


def _qm_chains(carry):
    """The fused QM carry with its chains leading on every leaf."""
    fine, xc, sc = carry[:3]
    return (fine.transpose(0, 1), xc, sc.transpose(0, 1)) + tuple(carry[3:])


def _cases(mesh, adaptive=False):
    """Every case's numbers on one process (mesh None) or on a mesh; the
    adaptive run only where asked (it is compared across ranks)."""
    out = {}
    mc = _mlmc()
    stats = mc.evaluate(11, n_chains=C, dtype=F64, device="cpu", mesh=mesh)
    out["mlmc"] = dict(
        result=mc.numerical_result(), error=mc.statistical_error(),
        t_sub=list(mc._t_sub), n_target=list(mc.n_target),
        levels=[_stats_numbers(mc.stats_qoi[ell], stats[ell])
                for ell in range(2)],
        states=gather_chains(mesh, mc.final_carries))
    tl = _twolevel_qm()
    s = tl.evaluate_difference(5, n_chains=C, dtype=F64, device="cpu",
                               mesh=mesh)
    carry = _qm_chains(tl.final_carry)
    out["twolevel_qm"] = dict(
        fine=_stats_numbers(tl.stats_fine, s["fine"]),
        coarse=_stats_numbers(tl.stats_coarse, s["coarse"]),
        diff=_stats_numbers(tl.stats_diff, s["diff"]),
        p_accept=tl.p_accept, t_sub=tl.t_indep,
        states=carry if mesh is None else gather_chains(mesh, carry))
    tl = _twolevel_schwinger()
    s = tl.evaluate_difference(13, n_chains=C, dtype=F64, device="cpu",
                               mesh=mesh)
    out["twolevel_schwinger"] = dict(
        fine=_stats_numbers(tl.stats_fine, s["fine"]),
        diff=_stats_numbers(tl.stats_diff, s["diff"]),
        p_accept=tl.p_accept)
    if not adaptive:
        return out
    mc = _mlmc(n_samples=0, epsilon=0.2, n_min_samples_qoi=32)
    mc.evaluate(3, n_chains=C, dtype=F64, device="cpu", mesh=mesh)
    out["adaptive"] = dict(n_target=list(mc.n_target),
                           result=mc.numerical_result())
    return out


def _world(rank, world):
    pair_a = dist.new_group([0, 1])
    pair_b = dist.new_group([2, 3])
    pair = chain_mesh(group=pair_a if rank < 2 else pair_b)
    return {2: _cases(pair), 4: _cases(chain_mesh(), adaptive=True)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    torch.set_num_threads(1)
    ranks, one = run_world(4, _world, tmp_path_factory.mktemp("world"),
                           during=lambda: _cases(None))
    return one, ranks


def _equal_states(a, b):
    la = [x for x in _leaves(a)]
    lb = [x for x in _leaves(b)]
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.shape == y.shape and torch.equal(x, y)
        else:
            assert x == y


def _leaves(tree):
    from mlmcpathintegral_tpu_torch.utils.tree import tree_flatten
    return tree_flatten(tree)[0]


W_RANKS = [(2, 0), (2, 1), (2, 2), (2, 3), (4, 0), (4, 3)]


@pytest.mark.parametrize("W, rank", W_RANKS)
def test_mlmc_sharded_matches_one_process(runs, W, rank):
    one, ranks = runs
    a, b = one["mlmc"], ranks[rank][W]["mlmc"]
    _equal_states(a["states"], b["states"])
    assert b["result"] == a["result"] and b["error"] == a["error"]
    assert b["t_sub"] == a["t_sub"] and b["n_target"] == a["n_target"]
    assert b["levels"] == a["levels"]


@pytest.mark.parametrize("W, rank", W_RANKS)
def test_fused_twolevel_sharded_matches_one_process(runs, W, rank):
    one, ranks = runs
    a, b = one["twolevel_qm"], ranks[rank][W]["twolevel_qm"]
    _equal_states(a["states"], b["states"])
    for k in ("fine", "coarse", "diff", "p_accept", "t_sub"):
        assert b[k] == a[k], k
    assert 0.0 < a["p_accept"] < 1.0


@pytest.mark.parametrize("W", [2, 4])
def test_unfused_twolevel_sharded_agrees_in_distribution(runs, W):
    """The Schwinger two-level screen draws its fill and accept noise from
    a generator seeded by the chunk and the rank: the estimates of the
    one-process and the W-rank run agree within their errors, and every
    rank reports the same gathered numbers."""
    one, ranks = runs
    a = one["twolevel_schwinger"]
    b = ranks[0][W]["twolevel_schwinger"]
    for r in range(4 if W == 4 else 2):
        assert ranks[r][W]["twolevel_schwinger"] == b
    for k in ("fine", "diff"):
        sigma = math.hypot(a[k][1], b[k][1])
        assert abs(a[k][0] - b[k][0]) < 4.0 * sigma, (k, a[k], b[k])
        assert a[k][3] == b[k][3]
    assert abs(a["p_accept"] - b["p_accept"]) < 0.2


@pytest.mark.parametrize("rank", [1, 2, 3])
def test_adaptive_mode_agrees_on_every_rank(runs, rank):
    """The adaptive N_ell loop decides from gathered statistics and the
    slowest rank's cost: every rank reaches rank 0's targets and estimate,
    and the world finishes (run_world's timeout)."""
    _, ranks = runs
    first = ranks[0][4]["adaptive"]
    assert all(t >= 32 for t in first["n_target"])
    assert math.isfinite(first["result"])
    assert ranks[rank][4]["adaptive"] == first
