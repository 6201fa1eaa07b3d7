"""The port's fused QM two-level chain (mlmcpathintegral_tpu_torch/ops/
qm_twolevel.py): its plain version against the Pallas kernel in interpret
mode on the same inputs and seed pair, f64, all eight outputs to 1e-9, for
the harmonic (lam = 0) and the quartic action, with and without the clock
traces; and the wrapper's CPU dispatch."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlmcpathintegral_tpu.ops.pallas_qm_twolevel import (
    qm_twolevel_chain as j_chain,
)
from mlmcpathintegral_tpu_torch import convert, ops
from mlmcpathintegral_tpu_torch.conditioned.qm import (
    GaussianConditionedFineAction,
)
from mlmcpathintegral_tpu_torch.lattice import Lattice1D
from mlmcpathintegral_tpu_torch.models import QuarticOscillatorAction
from mlmcpathintegral_tpu_torch.ops.qm_twolevel import (
    qm_twolevel_chain, qm_twolevel_chain_plain, qm_twolevel_launch,
)

torch.set_num_threads(1)

C, MC, TOL = 64, 8, 1e-9
SEED = (3, -5)
ACTIONS = {"harmonic": dict(m0=1.0, mu2=1.0, lam=0.0, x0=0.0),
           "quartic": dict(m0=1.0, mu2=1.0, lam=1.0, x0=1.0)}


def _inputs(params, seed=0):
    """A coarse path and the fine path prolongated from it and filled from
    the Gaussian conditional, with its cached (S_fine, S_cond)."""
    act = QuarticOscillatorAction(Lattice1D(2 * MC, 4.0), **params)
    rs = np.random.default_rng(seed)
    xc = torch.from_numpy(params["x0"] + 0.5 * rs.normal(size=(C, MC)))
    cond = GaussianConditionedFineAction(act)
    x = act.prolongate(xc, torch.zeros(C, 2 * MC, dtype=torch.float64))
    x = cond.fill_fine_points(torch.Generator().manual_seed(seed), x)
    return (convert.qm_planes(x), xc + 0.1 * torch.from_numpy(
        rs.normal(size=(C, MC))), convert.qm_s_cache(act, cond, x))


@pytest.mark.parametrize("with_traces", [True, False])
@pytest.mark.parametrize("kind", sorted(ACTIONS))
def test_chain_plain_matches_pallas(kind, with_traces):
    params = ACTIONS[kind]
    fine, xc, sc = _inputs(params)
    kw = dict(params, a_lat=0.25, nt=5, n_steps=4, t_sub=2,
              with_traces=with_traces)
    want = j_chain(jnp.asarray(fine.numpy()), jnp.asarray(xc.numpy()),
                   jnp.asarray(sc.numpy()), 0.2,
                   jnp.asarray(SEED, jnp.int32), block_chains=C,
                   interpret=True, **kw)
    got = qm_twolevel_chain_plain(fine, xc, sc, 0.2, SEED, **kw)
    assert len(got) == len(want) == 8
    for i, (g, w) in enumerate(zip(got, want)):
        assert tuple(g.shape) == tuple(w.shape), i
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=TOL, err_msg=f"output {i}")
    acc = got[7]
    # the screen accepts and rejects; the coarse chain moved
    assert 0.0 < float(acc.mean()) < 1.0
    assert not torch.equal(got[1], xc)
    if not with_traces:
        assert got[5].shape == (1, C) and not got[5].any()


def test_wrapper_runs_plain_version_on_cpu():
    ops.reset_counters()
    fine, xc, sc = _inputs(ACTIONS["harmonic"])
    out = qm_twolevel_chain(fine, xc, sc, 0.2, 1, m0=1.0, mu2=1.0,
                            a_lat=0.25, nt=2, n_steps=1, t_sub=1)
    assert out[5].shape == (1, C)
    assert (ops.QM_TWOLEVEL.launches, ops.QM_TWOLEVEL.plain_cuda_calls) \
        == (0, 0)
    with pytest.raises(ValueError, match="unsupported device"):
        qm_twolevel_chain(fine.to("meta"), xc, sc, 0.2, 1, m0=1.0, mu2=1.0,
                          a_lat=0.25, nt=2, n_steps=1, t_sub=1)


@pytest.mark.parametrize("Mc,C,want", [
    # path C's launch: one site a lane, a warp a chain
    (32, 4096, (32, 1, 4)),
    # ragged: a quarter-warp chain; 2 and 4 sites a lane with idle lanes
    (8, 4096, (8, 1, 16)),
    (48, 4096, (32, 2, 4)),
    (100, 4096, (32, 4, 4)),
    # a last lane holding fewer sites than the others; few chains
    (33, 4096, (32, 2, 4)),
    (8, 5, (8, 1, 8)),
    (1024, 1, (32, 32, 1)),
])
def test_launch_layout(Mc, C, want):
    """(lanes per chain, sites per lane, chains per block) of the two-level
    kernel, which uses no shared memory: whole warps a block, every site
    in a lane's registers, the sites a lane a power of two (the kernel's
    template parameter)."""
    lanes, sites, cpb, smem = qm_twolevel_launch(Mc, C)
    assert (lanes, sites, cpb) == want and smem == 0
    assert sites & (sites - 1) == 0 and lanes * sites >= Mc
    assert (lanes * cpb) % 32 == 0 and lanes * cpb <= 128
    with pytest.raises(NotImplementedError, match="at most 1024"):
        qm_twolevel_launch(1025, C)
