"""Plain PyTorch versions of the Schwinger sweep kernels
(mlmcpathintegral_tpu_torch/ops/schwinger.py) against the Pallas kernels
of mlmcpathintegral_tpu/ops/pallas_schwinger.py run in interpret mode, on
equal inputs (numpy seeds) and equal kernel seeds, in f64.  Equal RNG
bits make the two agree to rounding; the tolerance is 1e-9."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlmcpathintegral_tpu.ops import pallas_schwinger as jps
from mlmcpathintegral_tpu_torch.ops import schwinger as tps

# the port's tests run small tensors: one thread per worker process
# avoids oversubscribing the cores the parallel test workers share
torch.set_num_threads(1)

MT, MX, C = 8, 4, 8
SEED = np.array([123456, -98765], np.int32)
TOL = 1e-9


def _theta(seed=0):
    rs = np.random.default_rng(seed)
    return rs.uniform(-np.pi, np.pi, (C, 2 * MT * MX))


@pytest.fixture(scope="module")
def jax_chain():
    """One interpret-mode K3 call per configuration, shared by the tests:
    (n_overrelax, n_heatbath) -> (theta, qsum, esum)."""
    th = jnp.asarray(_theta())
    out = {}
    for n_or, n_hb in ((1, 0), (1, 1)):
        t, q, e = jps.schwinger_sweep_chain(
            th, jnp.asarray(SEED), beta=2.0, Mt=MT, Mx=MX, n_steps=3,
            n_overrelax=n_or, n_heatbath=n_hb, block_chains=C,
            with_energy=True, interpret=True)
        out[(n_or, n_hb)] = tuple(np.asarray(a) for a in (t, q, e))
    return out


@pytest.mark.parametrize("n_or,n_hb", [(1, 0), (1, 1)])
def test_chain_plain_matches_pallas(jax_chain, n_or, n_hb):
    t, q, e = tps.schwinger_sweep_chain(
        torch.from_numpy(_theta()), torch.from_numpy(SEED), beta=2.0, Mt=MT,
        Mx=MX, n_steps=3, n_overrelax=n_or, n_heatbath=n_hb,
        with_energy=True)
    jt, jq, je = jax_chain[(n_or, n_hb)]
    np.testing.assert_allclose(t.numpy(), jt, rtol=0, atol=TOL)
    np.testing.assert_allclose(q.numpy(), jq, rtol=0, atol=TOL)
    np.testing.assert_allclose(e.numpy(), je, rtol=0, atol=TOL)


def test_single_sweep_plain_matches_pallas():
    th = _theta(1)
    want = np.asarray(jps.schwinger_sweep(
        jnp.asarray(th), jnp.asarray(SEED), beta=1.0, Mt=MT, Mx=MX,
        step_offset=5, block_chains=C, interpret=True))
    got = tps.schwinger_sweep(torch.from_numpy(th), torch.from_numpy(SEED),
                              beta=1.0, Mt=MT, Mx=MX, step_offset=5)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def test_chain_equals_stepwise_sweeps():
    """K3 with n_steps = N is N K2 calls with step_offset = 0..N-1, bit for
    bit, and qsum/esum are the plaquette sums after each step."""
    th = torch.from_numpy(_theta(2))
    seed = torch.from_numpy(SEED)
    t3, q3, e3 = tps.schwinger_sweep_chain(th, seed, beta=3.0, Mt=MT, Mx=MX,
                                           n_steps=4, with_energy=True)
    t = th
    for s in range(4):
        t = tps.schwinger_sweep(t, seed, beta=3.0, Mt=MT, Mx=MX,
                                step_offset=s)
        plaq = tps._plaquettes(*t.reshape(C, MX, MT, 2).unbind(-1))
        assert torch.equal(q3[s], plaq.sum(dim=(1, 2)))
        assert torch.equal(e3[s], torch.cos(plaq).sum(dim=(1, 2)))
    assert torch.equal(t3, t)


def test_two_call_signature_and_f32():
    th = torch.from_numpy(_theta(3)).float()
    out = tps.schwinger_sweep_chain(th, 7, beta=1.0, Mt=MT, Mx=MX,
                                    n_steps=2)
    assert len(out) == 2 and out[0].dtype == torch.float32
    assert out[1].shape == (2, C)
    assert torch.isfinite(out[0]).all()
    assert (out[0].abs() <= np.pi + 1e-6).all()
