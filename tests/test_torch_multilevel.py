"""The port's fused MLMC driver (mlmcpathintegral_tpu_torch/mc/multilevel.py)
against the JAX one: one fused chunk of the fine level and one of the
coarsest level from the same carry (carried across by convert.py) with the
JAX chunk's own seed pair, the JAX side in Pallas interpret mode, f64, to
1e-9; the port's whole evaluate on the CPU against the analytic oracle;
and the port's independence from JAX."""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlmcpathintegral_tpu.conditioned.schwinger import (
    make_schwinger_conditioned_fine_action as j_cond_factory,
)
from mlmcpathintegral_tpu.lattice2d import CoarseningType as JCT
from mlmcpathintegral_tpu.lattice2d import Lattice2D as JLattice2D
from mlmcpathintegral_tpu.mc import MonteCarloMultiLevel as JMLMC
from mlmcpathintegral_tpu.mc.twolevelstep import TwoLevelState as JTLState
from mlmcpathintegral_tpu.models.qft.schwinger import (
    QuenchedSchwingerAction as JAction,
)
from mlmcpathintegral_tpu.qoi import qoi_2d_susceptibility as j_qoi
from mlmcpathintegral_tpu.samplers import OverrelaxedHeatBathSampler as JHB
from mlmcpathintegral_tpu.samplers.heatbath import HeatBathState as JHBState
from mlmcpathintegral_tpu.utils import statistics as jstats
from mlmcpathintegral_tpu_torch import convert, ops
from mlmcpathintegral_tpu_torch.conditioned.schwinger import (
    make_schwinger_conditioned_fine_action,
)
from mlmcpathintegral_tpu_torch.lattice2d import CoarseningType, Lattice2D
from mlmcpathintegral_tpu_torch.mc import MonteCarloMultiLevel
from mlmcpathintegral_tpu_torch.models.base import RenormalisationType
from mlmcpathintegral_tpu_torch.models.qft.schwinger import (
    QuenchedSchwingerAction,
)
from mlmcpathintegral_tpu_torch.qoi import qoi_2d_susceptibility
from mlmcpathintegral_tpu_torch.samplers import (
    OverrelaxedHeatBathSampler, QuenchedSchwingerClusterSampler,
)

# the port's tests run small tensors: one thread per worker process
# avoids oversubscribing the cores the parallel test workers share
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
BETA = 10.0          # the large-beta fill: the cheapest interpret compile
C, T_SUB, N_ACTIVE = 8, 2, 5
TOL = 1e-9


def _jax_mc():
    act = JAction(JLattice2D(8, 8, JCT.BOTH), beta=BETA)
    return JMLMC(act, j_qoi, coarse_sampler_factory=lambda a: JHB(a),
                 conditioned_fine_action_factory=j_cond_factory,
                 n_level=2, n_burnin=0, n_samples=100, chunk_size=8,
                 use_pallas=True, pallas_interpret=True)


def _port_mc(**kw):
    act = QuenchedSchwingerAction(Lattice2D(8, 8, CoarseningType.BOTH),
                                  beta=kw.pop("beta", BETA),
                                  renormalisation=kw.pop(
                                      "renormalisation",
                                      RenormalisationType.NONE))
    args = dict(n_level=2, n_burnin=0, n_samples=100, chunk_size=8)
    args.update(kw)
    return MonteCarloMultiLevel(
        act, qoi_2d_susceptibility,
        coarse_sampler_factory=lambda a: OverrelaxedHeatBathSampler(a),
        conditioned_fine_action_factory=make_schwinger_conditioned_fine_action,
        **args)


def _jax_carries(mc):
    """Level-0 and coarsest carries from numpy seeds, with some history
    already recorded in every accumulator."""
    rs = np.random.default_rng(3)
    lat, clat = mc.actions[0].lattice, mc.actions[1].lattice
    x_c = jnp.asarray(rs.uniform(-np.pi, np.pi, (C, clat.nedges)))
    x_f = jnp.asarray(rs.uniform(-np.pi, np.pi, (C, lat.nedges)))
    x_L = jnp.asarray(rs.uniform(-np.pi, np.pi, (C, clat.nedges)))

    def st(k_max=20):
        s = jstats.init(C, k_max, jnp.float64)
        return jstats.record_block(s, jnp.asarray(rs.normal(size=(7, C))))
    def acc():
        # own buffers per carry: the JAX chunks donate their carry
        return (jnp.asarray(3.0), jnp.asarray(1.5))
    carry = (JHBState(x=x_c), mc.twolevel_steps[0].init(x_f), st(), st(),
             st(), acc())
    carry_L = (JHBState(x=x_L), st(), st(), st(), acc())
    return carry, carry_L


def _assert_trees_close(got, want, what):
    gl, wl = [], []

    def flat(t, out):
        if isinstance(t, (tuple, list)):
            for x in t:
                flat(x, out)
        else:
            out.append(np.asarray(t))
    flat(convert.to_numpy(got), gl)
    flat(want, wl)
    assert len(gl) == len(wl), what
    for i, (g, w) in enumerate(zip(gl, wl)):
        assert g.shape == w.shape, (what, i)
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL,
                                   err_msg=f"{what} leaf {i}")


@pytest.fixture(scope="module")
def chunk_runs():
    """One interpret-mode chunk of each level, from the same carries."""
    mc = _jax_mc()
    carry, carry_L = _jax_carries(mc)
    in0 = convert.to_numpy(carry)
    inL = convert.to_numpy(carry_L)
    key0, keyL = jax.random.PRNGKey(5), jax.random.PRNGKey(6)
    seeds = [np.array(jax.random.randint(k, (2,), -2**31, 2**31 - 1,
                                         jnp.int32))
             for k in (key0, keyL)]
    chunk, _ = mc._make_fused_chunk(0, T_SUB, C)
    out0 = chunk(key0, carry, jnp.asarray(N_ACTIVE, jnp.int32))
    chunk_L, _ = mc._make_fused_chunk_L(T_SUB, C)
    outL = chunk_L(keyL, carry_L, jnp.asarray(N_ACTIVE, jnp.int32))
    return {"in": (in0, inL), "seeds": seeds,
            "out": (convert.to_numpy(out0), convert.to_numpy(outL))}


def test_fine_level_chunk_matches_jax(chunk_runs):
    mc = _port_mc()
    carry = convert.to_torch(chunk_runs["in"][0], "cpu")
    assert isinstance(carry[1], convert.PORT_TYPES["TwoLevelState"])
    chunk = mc._make_fused_chunk(0, T_SUB)
    got = chunk(torch.from_numpy(chunk_runs["seeds"][0]), carry, N_ACTIVE)
    _assert_trees_close(got, chunk_runs["out"][0], "fine-level chunk")


def test_coarsest_level_chunk_matches_jax(chunk_runs):
    mc = _port_mc()
    carry = convert.to_torch(chunk_runs["in"][1], "cpu")
    chunk_L = mc._make_fused_chunk_L(T_SUB)
    got = chunk_L(torch.from_numpy(chunk_runs["seeds"][1]), carry, N_ACTIVE)
    _assert_trees_close(got, chunk_runs["out"][1], "coarsest-level chunk")


def test_convert_round_trip_and_constants():
    mc = _jax_mc()
    carry, _ = _jax_carries(mc)
    back = convert.to_numpy(convert.to_torch(carry, "cpu"),
                            types={"HeatBathState": JHBState,
                                   "TwoLevelState": JTLState,
                                   "StatsState": jstats.StatsState})
    assert type(back[1]) is JTLState and type(back[2]) is jstats.StatsState
    _assert_trees_close(convert.to_torch(carry, "cpu"),
                        convert.to_numpy(back), "round trip")
    for beta in (4.0, 10.0):
        ja = JAction(JLattice2D(8, 8, JCT.BOTH), beta=beta)
        ta = QuenchedSchwingerAction(Lattice2D(8, 8, CoarseningType.BOTH),
                                     beta=beta)
        jc = convert.action_constants(ja, j_cond_factory(ja))
        tc = convert.action_constants(
            ta, make_schwinger_conditioned_fine_action(ta))
        assert jc.keys() == tc.keys()
        for k in jc:
            np.testing.assert_allclose(tc[k], jc[k], rtol=1e-12, atol=0)


def test_evaluate_on_cpu_matches_oracle():
    """The headline configuration (8x8, BOTH, beta=4 nonperturbative,
    heat-bath coarse chains) at CPU size, through the plain versions."""
    ops.reset_counters()
    mc = _port_mc(beta=4.0,
                  renormalisation=RenormalisationType.NONPERTURBATIVE,
                  n_burnin=100, n_samples=2000, chunk_size=16)
    stats = mc.evaluate(torch.Generator().manual_seed(1), n_chains=64,
                        dtype=torch.float64, device="cpu")
    num, err = mc.numerical_result(), mc.statistical_error()
    oracle = mc.actions[0].chit_exact()
    assert abs(num - oracle) < 4 * err, (num, err, oracle)
    assert all(mc.stats_qoi[ell].samples(stats[ell]) >= 2000
               for ell in range(2))
    assert set(mc.timings) == {"prepare_s", "compile_burnin_s", "burnin_s",
                               "tsub_update_s", "compile_cost_s",
                               "cost_measure_s", "sampling_s"}
    assert mc._t_sub == [8, 8] and len(mc.reliability) == 2
    # CPU tensors never launch a kernel, and the plain versions ran on
    # the CPU only
    assert all(c.launches == 0 and c.plain_cuda_calls == 0
               for c in ops.counters())


@pytest.mark.parametrize("kind", ["not_fused", "not_both", "not_heatbath"])
def test_unported_configurations_raise(kind):
    """Without the fused kernels or with another coarse sampler the levels
    build on the unfused path; with coarsening other than BOTH (the
    semi-coarsened fill) the fine level does."""
    if kind == "not_fused":
        mc = _port_mc(use_pallas=False)
        assert sorted(mc._unfused) == [0, 1]
        assert not mc._is_fused(0) and not mc._is_fused(1)
    elif kind == "not_both":
        act = QuenchedSchwingerAction(
            Lattice2D(8, 8, CoarseningType.TEMPORAL), beta=4.0)
        mc = MonteCarloMultiLevel(
            act, qoi_2d_susceptibility,
            coarse_sampler_factory=OverrelaxedHeatBathSampler,
            conditioned_fine_action_factory=(
                make_schwinger_conditioned_fine_action), n_level=2)
        # the fine level unfused, the coarsest on the sweep-chain kernel
        assert sorted(mc._unfused) == [0]
        assert not mc._is_fused(0) and mc._is_fused(1)
        assert type(mc.twolevel_steps[0].conditioned_fine_action).__name__ \
            == "QuenchedSchwingerSemiConditionedFineAction"
    else:
        act = QuenchedSchwingerAction(Lattice2D(8, 8, CoarseningType.BOTH),
                                      beta=4.0)
        mc = MonteCarloMultiLevel(
            act, qoi_2d_susceptibility,
            coarse_sampler_factory=lambda a: QuenchedSchwingerClusterSampler(
                a, n_burnin=0, n_updates=5, use_pallas=True),
            conditioned_fine_action_factory=(
                make_schwinger_conditioned_fine_action), n_level=2)
        assert sorted(mc._unfused) == [0, 1]
        assert isinstance(mc.coarse_samplers[0],
                          QuenchedSchwingerClusterSampler)
        assert mc._level_chunk(0) == mc.chunk_size


def test_port_never_imports_jax():
    mods = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        .removesuffix(".__init__")
        for p in (REPO / "mlmcpathintegral_tpu_torch").rglob("*.py"))
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "assert 'jax' not in sys.modules, 'jax imported'\n"
            "assert 'mlmcpathintegral_tpu' not in sys.modules\n"
            "print(len(sys.modules))")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert len(mods) >= 20


def test_kernel_wrappers_use_plain_versions_on_cpu():
    from mlmcpathintegral_tpu_torch.ops.schwinger import schwinger_sweep
    from mlmcpathintegral_tpu_torch.ops.schwinger_twolevel import (
        schwinger_twolevel_chain,
    )
    ops.reset_counters()
    th = torch.zeros(2, 2 * 4 * 4, dtype=torch.float32)
    schwinger_sweep(th, 1, beta=1.0, Mt=4, Mx=4)
    schwinger_twolevel_chain(th, torch.zeros(2, 8), torch.zeros(2),
                             torch.zeros(2), 1, beta=4.0, beta_c=1.0, Mt=4,
                             Mx=4, n_steps=1, t_sub=1)
    assert [(c.launches, c.plain_cuda_calls) for c in ops.counters()] == \
        [(0, 0)] * len(ops.counters())
    with pytest.raises(ValueError, match="unsupported device"):
        schwinger_sweep(th.to("meta"), 1, beta=1.0, Mt=4, Mx=4)


def test_level_whose_fused_block_does_not_fit_runs_unfused(monkeypatch):
    """With the device's shared-memory limit between the coarsest level's
    sweep block and the fine level's two-level block, the fine level runs
    unfused with the factory's coarse sampler, the coarsest stays fused,
    and evaluate completes; without a limit (the CPU) both are fused."""
    from mlmcpathintegral_tpu_torch.ops.schwinger import sweep_smem_bytes
    from mlmcpathintegral_tpu_torch.ops.schwinger_twolevel import (
        twolevel_smem_bytes,
    )
    limit = twolevel_smem_bytes(8, 8)[2] - 4
    assert sweep_smem_bytes(4, 4)[2] <= limit
    mc = _port_mc(beta=4.0, n_burnin=16, n_samples=256, chunk_size=8)
    assert mc._unfused == {} and mc._is_fused(0) and mc._is_fused(1)
    monkeypatch.setattr(MonteCarloMultiLevel, "_smem_limit_of",
                        staticmethod(lambda device: limit))
    ops.reset_counters()
    stats = mc.evaluate(torch.Generator().manual_seed(1), n_chains=16,
                        dtype=torch.float64, device="cpu")
    assert sorted(mc._unfused) == [0]
    assert not mc._is_fused(0) and mc._is_fused(1)
    assert type(mc.coarse_samplers[0]) is OverrelaxedHeatBathSampler
    assert not mc.coarse_samplers[0].use_pallas
    assert np.isfinite(mc.numerical_result(stats))
    assert all(mc.stats_qoi[ell].samples(stats[ell]) >= 256
               for ell in range(2))
    assert mc.tau_slow[0] is None and mc.tau_slow[1] is not None
