"""The port's chain-parallel layer (parallel/chains.py, parallel/multihost.py)
and the global chain offset of its kernels (the port's counterpart of
tests/test_parallel.py).

Every kernel's plain version takes ``chain0``: a launch over chains
[k, C) with chain0 = k must equal rows [k, C) of the whole launch, bit for
bit (the whole launch at chain0 = 0 is held against the JAX Pallas kernel
in interpret mode by the tests/test_torch_ops_*.py files; here rng_fill's
offset ids are also held against JAX's CounterRng with the same global
ids).  Then, on two gloo ranks joined through ``initialize_multihost``:
``per_host_chains`` and its refusal, ``global_chain_mesh`` spanning both
ranks, ``shard_chains``/``gather_chains`` round trips, the collective
helpers, and a kernel-seeded sampler stepped on a rank's block with its
chain offset equal to that block of the global step, with the gathered
statistics' tau_int and variance equal to the one-process ones.
"""

import numpy as np
import pytest
import torch

from _torch_dist import run_world
from mlmcpathintegral_tpu_torch.lattice import Lattice1D
from mlmcpathintegral_tpu_torch.lattice2d import CoarseningType, Lattice2D
from mlmcpathintegral_tpu_torch.models import RotorAction
from mlmcpathintegral_tpu_torch.models.qft.gff import GFFAction
from mlmcpathintegral_tpu_torch.models.qft.schwinger import (
    QuenchedSchwingerAction,
)
from mlmcpathintegral_tpu_torch.ops import gff, qm_twolevel, rng, rotor
from mlmcpathintegral_tpu_torch.ops import schwinger
from mlmcpathintegral_tpu_torch.ops import schwinger_twolevel
from mlmcpathintegral_tpu_torch.parallel import (
    chain_mesh, distribute_n, gather_chains, global_chain_mesh,
    per_host_chains, shard_chains,
)
from mlmcpathintegral_tpu_torch.parallel import chains as pchains
from mlmcpathintegral_tpu_torch.qoi import (
    qoi_2d_phi_squared, qoi_2d_susceptibility, qoi_susceptibility,
)
from mlmcpathintegral_tpu_torch.samplers import (
    ClusterSampler, OverrelaxedHeatBathSampler,
)
from mlmcpathintegral_tpu_torch.utils import statistics as stats_mod
from mlmcpathintegral_tpu_torch.utils.statistics import Statistics

C, K = 6, 2          # chains of the whole launch; the offset launch's first
F64 = torch.float64


def _angles(rs, *shape):
    return torch.from_numpy(rs.uniform(-np.pi, np.pi, shape))


def _launches():
    """name -> fn(chain_lo, chain0) running one plain version on chains
    [chain_lo, C) of fixed numpy inputs (float64)."""
    rs = np.random.default_rng(3)
    th8 = _angles(rs, C, 2 * 4 * 4)
    thc = _angles(rs, C, 2 * 2 * 2)
    caches = torch.from_numpy(rs.normal(size=(2, C)))
    planes = torch.from_numpy(rs.normal(size=(2, C, 8)))
    xc = torch.from_numpy(rs.normal(size=(C, 8)))
    x10 = _angles(rs, C, 10)
    phi = torch.from_numpy(rs.normal(size=(C, 16)))
    return {
        "K3 schwinger_sweep_chain": lambda lo, c0: schwinger.
        schwinger_sweep_chain_plain(th8[lo:], (5, -6), beta=2.0, Mt=4, Mx=4,
                                    n_steps=3, with_energy=True, chain0=c0),
        "K4 schwinger_twolevel_chain": lambda lo, c0: schwinger_twolevel.
        schwinger_twolevel_chain_plain(
            th8[lo:], thc[lo:], caches[0, lo:], caches[1, lo:], (1, 2),
            beta=2.0, beta_c=1.0, Mt=4, Mx=4, n_steps=2, t_sub=2,
            chain0=c0),
        "K6 qm_twolevel_chain": lambda lo, c0: qm_twolevel.
        qm_twolevel_chain_plain(
            planes[:, lo:].contiguous(), xc[lo:],
            caches[:, lo:].contiguous(), 0.1, (7, 8), m0=1.0, mu2=1.0,
            a_lat=0.25, nt=3, n_steps=2, t_sub=2, chain0=c0),
        "K7 rotor_cluster_chain": lambda lo, c0: rotor.
        rotor_cluster_chain_plain(x10[lo:], (3, 4), kappa2=4.0, M=10,
                                  n_steps=2, n_updates=2, chain0=c0),
        "K8 rotor_sweep_chain": lambda lo, c0: rotor.rotor_sweep_chain_plain(
            x10[lo:], (9, 1), kappa=2.0, M=10, n_steps=2, chain0=c0),
        "K9 gff_sweep": lambda lo, c0: gff.gff_sweep_plain(
            phi[lo:], (4, 4), kappa=5.0, Mt=4, Mx=4, n_overrelax=1,
            n_heatbath=2, chain0=c0),
        "rng_fill": lambda lo, c0: rng.rng_fill_plain(
            (11, -3), n_sites=5, n_chains=C - lo, n_steps=2, n_ctr=3,
            device="cpu", chain0=c0),
        "rng_fill step-less": lambda lo, c0: rng.rng_fill_plain(
            (11, -3), n_sites=5, n_chains=C - lo, n_steps=1, n_ctr=3,
            device="cpu", step0=None, chain0=c0),
    }


def _chain_rows(t, lo, n):
    """Rows [lo, n) of t along its one axis of size n."""
    axes = [d for d, s in enumerate(t.shape) if s == n]
    assert len(axes) == 1, t.shape
    return t.narrow(axes[0], lo, n - lo)


@pytest.mark.parametrize("name", list(_launches()))
def test_chain_offset_launch_equals_rows_of_whole_launch(name):
    def run(lo, c0):
        out = _launches()[name](lo, c0)
        return (out,) if isinstance(out, torch.Tensor) else out

    whole, part = run(0, 0), run(K, K)
    shifted = run(K, 0)     # the same chains hashed from 0: other draws
    assert len(whole) == len(part)
    differs = False
    for w, p, s in zip(whole, part, shifted):
        if p is None:
            continue
        assert torch.equal(_chain_rows(w, K, C), p), name
        differs |= not torch.equal(p, s)
    assert differs, f"{name}: chain0 changed nothing"


def test_rng_fill_offset_ids_match_jax_global_ids():
    """rng_fill's words with chain0 = k are JAX CounterRng's for the chain
    ids k .. k+C-1 (the Pallas kernels' lane + block_chains * program)."""
    import jax.numpy as jnp

    from mlmcpathintegral_tpu.ops import pallas_rng as jrng
    S, n, k0 = 5, 4, 1000
    bits, uni, _ = rng.rng_fill_plain((77, -5), n_sites=S, n_chains=n,
                                      n_steps=1, n_ctr=3, step0=2,
                                      device="cpu", chain0=k0)
    jr = jrng.CounterRng(jnp.uint32(77), jnp.arange(S, dtype=jnp.uint32)[
        None, :], jnp.arange(k0, k0 + n, dtype=jnp.uint32)[:, None],
        jnp.asarray(np.int32(-5)).astype(jnp.uint32), step=jnp.uint32(2))
    jb = np.stack([np.asarray(jr.bits()) for _ in range(3)])
    np.testing.assert_array_equal(bits[0].numpy(), jb.astype(np.int64))


def test_chain_offset_refused_beyond_id_range():
    with pytest.raises(ValueError, match="chains"):
        rng.check_element_capacity(4, 8, rng.MAX_CHAINS - 4)
    with pytest.raises(ValueError, match="chain0"):
        rng.check_element_capacity(4, 8, -1)


def test_distribute_n():
    assert distribute_n(100, 8) == 13
    assert distribute_n(96, 8) == 12
    assert distribute_n(1, 8) == 1


def test_one_process_mesh():
    """Without a process group: a one-rank mesh, identity shard and
    gather, scalars unreduced, no host staging."""
    m = chain_mesh()
    assert (m.rank, m.world_size, m.group) == (0, 1, None)
    tree = {"x": torch.arange(6.0), "n": torch.tensor(3)}
    assert torch.equal(shard_chains(m, tree)["x"], tree["x"])
    assert gather_chains(m, tree) is tree
    assert pchains.all_reduce_scalar(m, 2.5, "sum") == 2.5
    assert not pchains.host_staged(None)
    assert per_host_chains(12) == 12
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        chain_mesh(2)
    with pytest.raises(ValueError, match="no axis 'space'"):
        m.axis("space")


# -- two gloo ranks ------------------------------------------------------------

def _samplers():
    """(name, sampler, qoi) of kernel-seeded samplers, on their plain
    versions here."""
    sch = QuenchedSchwingerAction(Lattice2D(4, 4, CoarseningType.BOTH),
                                  beta=2.0)
    rot = RotorAction(Lattice1D(10, 2.0), m0=0.5)
    g = GFFAction(Lattice2D(4, 4, CoarseningType.BOTH), mass=1.0)
    return [("heatbath K3", OverrelaxedHeatBathSampler(sch, use_pallas=True),
             qoi_2d_susceptibility(sch)),
            ("heatbath K8", OverrelaxedHeatBathSampler(rot, use_pallas=True),
             qoi_susceptibility(rot.lattice)),
            ("heatbath K9", OverrelaxedHeatBathSampler(g, use_pallas=True),
             qoi_2d_phi_squared(g)),
            ("cluster K7", ClusterSampler(rot, n_updates=2, use_pallas=True),
             qoi_susceptibility(rot.lattice))]


def _steps(sampler, qoi, state, n_chains):
    gen = torch.Generator().manual_seed(17)
    stats = Statistics("Q", 4)
    st = stats.init(n_chains, F64, "cpu")
    for _ in range(6):
        state, _ = sampler.draw(gen, state)
        st = stats_mod.record(st, qoi(sampler.x_of(state)))
    return state, st


def _sharded_step(rank, world):
    mesh = global_chain_mesh()
    out = {}
    n = 8
    for name, sampler, qoi in _samplers():
        init = sampler.init(torch.Generator().manual_seed(1), n, F64, "cpu")
        sampler.chain0 = 0
        whole, st_whole = _steps(sampler, qoi, init, n)
        sampler.chain0 = pchains.chain_offset(mesh, n)
        block, st_block = _steps(sampler, qoi, shard_chains(mesh, init),
                                 n // world)
        st_g = gather_chains(mesh, st_block)
        out[name] = dict(
            block_equal=torch.equal(sampler.x_of(block),
                                    sampler.x_of(whole)[
                                        sampler.chain0:
                                        sampler.chain0 + n // world]),
            tau=(float(stats_mod.tau_int_device(st_g)),
                 float(stats_mod.tau_int_device(st_whole))),
            var=(Statistics("Q", 4).variance(st_g),
                 Statistics("Q", 4).variance(st_whole)),
            gathered_equal=all(torch.equal(a, b)
                               for a, b in zip(st_g, st_whole)))
    return out


def _multihost(rank, world):
    mesh = global_chain_mesh()
    out = {"mesh": (mesh.rank, mesh.world_size, mesh.ranks),
           "per_host": per_host_chains(8),
           "host_staged": pchains.host_staged(mesh.group)}
    try:
        per_host_chains(7)
    except ValueError as e:
        out["per_host_error"] = str(e)
    try:
        shard_chains(mesh, torch.zeros(5, 2))
    except ValueError as e:
        out["shard_error"] = str(e)
    x = torch.arange(24, dtype=F64).reshape(8, 3)
    tree = (x, torch.tensor(4), {"b": x[:, 0] > 3})
    back = gather_chains(mesh, shard_chains(mesh, tree))
    out["round_trip"] = (torch.equal(back[0], x) and int(back[1]) == 4
                         and torch.equal(back[2]["b"], x[:, 0] > 3))
    out["max"] = pchains.all_reduce_scalar(mesh, float(rank + 1), "max")
    out["sum"] = pchains.all_reduce_scalar(mesh, float(rank + 1), "sum")
    out["steps"] = _sharded_step(rank, world)
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    ranks, _ = run_world(2, _multihost, tmp_path_factory.mktemp("world"),
                         init="multihost")
    return ranks


@pytest.mark.parametrize("rank", [0, 1])
def test_multihost_mesh_spans_both_ranks(world, rank):
    r = world[rank]
    assert r["mesh"] == (rank, 2, (0, 1))
    assert r["per_host"] == 4
    assert r["per_host_error"] == ("global chain count 7 must divide "
                                   "evenly over 2 hosts")
    assert "must be a multiple of the 2 ranks" in r["shard_error"]
    assert r["host_staged"] is True
    assert r["round_trip"]
    assert (r["max"], r["sum"]) == (2.0, 3.0)


@pytest.mark.parametrize("name", [s[0] for s in _samplers()])
@pytest.mark.parametrize("rank", [0, 1])
def test_sharded_step_matches_one_process(world, rank, name):
    """The rank's block stepped with its chain offset equals that block of
    the global step, bit for bit, and the gathered statistics equal the
    one-process ones (JAX: test_sharded_step_matches_single_device)."""
    r = world[rank]["steps"][name]
    assert r["block_equal"] and r["gathered_equal"]
    assert r["tau"][0] == r["tau"][1] and r["var"][0] == r["var"][1]
