"""Spatially sharded sweeps with halo exchange (parallel/spatial.py; the
port's counterpart of tests/test_spatial_sharding.py).

On the same numpy noise the port's dense noise-driven GFF and Schwinger
heat-bath sweeps equal the JAX package's ``gff_heatbath_sweep_noise`` and
``schwinger_heatbath_sweep_noise`` to 1e-12 (float64).  On gloo ranks the
sharded sweeps equal the port's dense ones bit for bit: rows split over
W = 2 (ranks {0, 1} and {2, 3} side by side) and W = 4, and a 2 x 2
chains x space mesh.  The keyed sharded heat bath's mean plaquette agrees
with the dense heat bath's within 4 sigma.  JAX's refusals keep their
texts.  One world of four ranks serves every sharded case.
"""

import math

import numpy as np
import pytest
import torch
import torch.distributed as dist

from _torch_dist import run_world
from mlmcpathintegral_tpu_torch.lattice2d import CoarseningType, Lattice2D
from mlmcpathintegral_tpu_torch.models.base import RenormalisationType
from mlmcpathintegral_tpu_torch.models.qft.gff import GFFAction
from mlmcpathintegral_tpu_torch.models.qft.schwinger import (
    QuenchedSchwingerAction,
)
from mlmcpathintegral_tpu_torch.parallel import chain_mesh, make_mesh
from mlmcpathintegral_tpu_torch.parallel.chains import ChainMesh
from mlmcpathintegral_tpu_torch.parallel.spatial import (
    gather_field, gff_heatbath_sweep_noise, make_schwinger_sweep_noise,
    make_sharded_gff_sweep, make_sharded_schwinger_heatbath,
    make_sharded_schwinger_sweep, schwinger_group_shapes,
    schwinger_heatbath_sweep_noise, shard_field, shard_sweep_noise,
)

F64 = torch.float64
C = 8


def _gff(Mt=8, Mx=8):
    return GFFAction(Lattice2D(Mt, Mx, CoarseningType.BOTH), mass=2.0)


def _schwinger(Mt=8, Mx=8, beta=2.0):
    return QuenchedSchwingerAction(Lattice2D(Mt, Mx, CoarseningType.BOTH),
                                   beta=beta,
                                   renormalisation=RenormalisationType.NONE)


def _numpy_noise(rs, act, n_chains, R=6):
    """One sweep's noise rounds, as numpy arrays, in the JAX layout."""
    return [(rs.uniform(-np.pi, np.pi, (R,) + s), rs.normal(size=(R,) + s),
             rs.uniform(size=(R,) + s))
            for s in schwinger_group_shapes(act, n_chains)]


def _torch_noise(noise):
    return [tuple(torch.from_numpy(a) for a in nz) for nz in noise]


# -- the dense sweeps against JAX -----------------------------------------------

def test_dense_gff_sweep_matches_jax():
    import jax.numpy as jnp

    from mlmcpathintegral_tpu.lattice2d import CoarseningType as JCT
    from mlmcpathintegral_tpu.lattice2d import Lattice2D as JLattice2D
    from mlmcpathintegral_tpu.models.qft import GFFAction as JGFF
    from mlmcpathintegral_tpu.parallel import spatial as jspatial
    rs = np.random.default_rng(0)
    phi = rs.normal(size=(6, 64))
    xi = rs.normal(size=(6, 64))
    want = np.asarray(jspatial.gff_heatbath_sweep_noise(
        JGFF(JLattice2D(8, 8, JCT.BOTH), mass=2.0), jnp.asarray(phi),
        jnp.asarray(xi)))
    got = gff_heatbath_sweep_noise(_gff(), torch.from_numpy(phi),
                                   torch.from_numpy(xi)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_dense_schwinger_sweep_matches_jax():
    import jax.numpy as jnp

    from mlmcpathintegral_tpu.lattice2d import CoarseningType as JCT
    from mlmcpathintegral_tpu.lattice2d import Lattice2D as JLattice2D
    from mlmcpathintegral_tpu.models.base import RenormalisationType as JR
    from mlmcpathintegral_tpu.models.qft.schwinger import (
        QuenchedSchwingerAction as JSchwinger,
    )
    from mlmcpathintegral_tpu.parallel import spatial as jspatial
    jact = JSchwinger(JLattice2D(8, 8, JCT.BOTH), beta=2.0,
                      renormalisation=JR.NONE)
    act = _schwinger()
    rs = np.random.default_rng(1)
    theta = rs.uniform(-np.pi, np.pi, (6, act.ndof))
    t_port, t_jax = torch.from_numpy(theta), jnp.asarray(theta)
    for _ in range(2):   # the second sweep starts from real staples
        noise = _numpy_noise(rs, act, 6)
        t_jax = jspatial.schwinger_heatbath_sweep_noise(
            jact, t_jax, [tuple(jnp.asarray(a) for a in nz)
                          for nz in noise])
        t_port = schwinger_heatbath_sweep_noise(act, t_port,
                                                _torch_noise(noise))
        np.testing.assert_allclose(t_port.numpy(), np.asarray(t_jax),
                                   rtol=0, atol=1e-12)


def test_invalid_configs():
    rot = GFFAction(Lattice2D(8, 8, CoarseningType.ROTATE,
                              coarsening_level=1), mass=1.0)
    space2 = ChainMesh(None, 0, 2, "space")
    space4 = ChainMesh(None, 0, 4, "space")
    with pytest.raises(ValueError, match="unrotated"):
        make_sharded_gff_sweep(rot, space2, axis="space")
    with pytest.raises(ValueError, match="Mx=6 must be a multiple of 2\\*4"):
        make_sharded_gff_sweep(_gff(8, 6), space4, axis="space")
    with pytest.raises(ValueError, match="Mx=6 must be a multiple of 2\\*4"):
        make_sharded_schwinger_sweep(_schwinger(8, 6), space4, axis="space")
    with pytest.raises(ValueError, match="Mx=6 must be a multiple of 2\\*4"):
        make_sharded_schwinger_heatbath(_schwinger(8, 6), space4,
                                        axis="space")


def test_one_rank_sweeps_equal_dense():
    """At one rank the halo is the block's own wrapped row (the noise from
    ``make_schwinger_sweep_noise``: four groups of R=6 rounds)."""
    mesh = chain_mesh(axis_name="space")
    rs = np.random.default_rng(2)
    phi, xi = (torch.from_numpy(rs.normal(size=(3, 64))) for _ in range(2))
    assert torch.equal(make_sharded_gff_sweep(_gff(), mesh)(phi, xi),
                       gff_heatbath_sweep_noise(_gff(), phi, xi))
    act = _schwinger()
    theta = torch.from_numpy(rs.uniform(-np.pi, np.pi, (3, act.ndof)))
    noise = make_schwinger_sweep_noise(torch.Generator().manual_seed(3),
                                       act, 3)
    assert [tuple(a.shape) for a in noise[0]] == [(6, 3, 4, 8)] * 3
    assert [tuple(a.shape) for a in noise[2]] == [(6, 3, 8, 4)] * 3
    assert float(noise[0][0].abs().max()) <= math.pi
    assert torch.equal(make_sharded_schwinger_sweep(act, mesh)(theta, noise),
                       schwinger_heatbath_sweep_noise(act, theta, noise))


# -- sharded sweeps on gloo ranks ---------------------------------------------

def _sharded_cases(mesh, chain_axis=None):
    """(GFF equal, Schwinger equal over two sweeps) of the sharded sweeps
    against the dense ones on the same inputs."""
    rs = np.random.default_rng(4)
    g = _gff()
    phi = torch.from_numpy(rs.normal(size=(C, 64)))
    xi = torch.from_numpy(rs.normal(size=(C, 64)))
    sweep = make_sharded_gff_sweep(g, mesh, axis="space",
                                   chain_axis=chain_axis)
    Mx_loc = 8 // mesh.axis("space").world_size
    loc = sweep(shard_field(mesh, phi, 8, chain_axis=chain_axis),
                shard_field(mesh, xi, 8, chain_axis=chain_axis))
    gff_ok = torch.equal(gather_field(mesh, loc, Mx_loc,
                                      chain_axis=chain_axis),
                         gff_heatbath_sweep_noise(g, phi, xi))
    act = _schwinger()
    sweep = make_sharded_schwinger_sweep(act, mesh, axis="space",
                                         chain_axis=chain_axis)
    theta = torch.from_numpy(rs.uniform(-np.pi, np.pi, (C, act.ndof)))
    sch_ok = True
    for _ in range(2):
        noise = _torch_noise(_numpy_noise(rs, act, C))
        dense = schwinger_heatbath_sweep_noise(act, theta, noise)
        loc = sweep(shard_field(mesh, theta, 8, chain_axis=chain_axis),
                    shard_sweep_noise(mesh, noise, chain_axis=chain_axis))
        sch_ok &= torch.equal(gather_field(mesh, loc, Mx_loc,
                                           chain_axis=chain_axis), dense)
        theta = dense
    return gff_ok, sch_ok


def _plaquette_chain_means(act, theta, sweep, n_sweeps=24, n_skip=8):
    """Per-chain mean of <cos theta_P> over the sweeps after n_skip."""
    acc = torch.zeros(theta.shape[0], dtype=F64)
    for i in range(n_sweeps):
        theta = sweep(i, theta)
        if i >= n_skip:
            acc += torch.mean(torch.cos(act.plaquette_angles(theta)),
                              dim=(-2, -1))
    return acc / (n_sweeps - n_skip)


def _keyed(rank, world):
    """Chain means of the keyed sharded heat bath on the full 4-rank space
    axis (each rank's rows; gathered so every rank holds the fields)."""
    mesh = chain_mesh(axis_name="space")
    act = _schwinger(beta=1.0)
    theta = torch.from_numpy(np.random.default_rng(5).uniform(
        -np.pi, np.pi, (256, act.ndof)))
    sweep = make_sharded_schwinger_heatbath(act, mesh, axis="space")

    def step(i, th):
        loc = sweep(100 + i, shard_field(mesh, th, 8))
        return gather_field(mesh, loc, 2)

    return _plaquette_chain_means(act, theta, step)


def _world(rank, world):
    pair = chain_mesh(group=(dist.new_group([0, 1]), dist.new_group(
        [2, 3]))[rank // 2], axis_name="space")
    grid = make_mesh((2, 2), ("chains", "space"))
    return {"W=2": _sharded_cases(pair),
            "W=4": _sharded_cases(chain_mesh(axis_name="space")),
            "2x2": _sharded_cases(grid, chain_axis="chains"),
            "keyed": _keyed(rank, world)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    def dense():
        act = _schwinger(beta=1.0)
        theta = torch.from_numpy(np.random.default_rng(6).uniform(
            -np.pi, np.pi, (256, act.ndof)))
        gen = torch.Generator().manual_seed(7)
        return _plaquette_chain_means(
            act, theta, lambda i, th: act.heatbath_sweep(gen, th))

    ranks, dense_means = run_world(4, _world,
                                   tmp_path_factory.mktemp("world"),
                                   during=dense)
    return ranks, dense_means


@pytest.mark.parametrize("layout", ["W=2", "W=4", "2x2"])
@pytest.mark.parametrize("rank", [0, 1, 2, 3])
def test_sharded_sweeps_equal_dense(world, layout, rank):
    gff_ok, sch_ok = world[0][rank][layout]
    assert gff_ok, "GFF"
    assert sch_ok, "Schwinger"


def test_keyed_heatbath_plaquette_agrees_with_dense(world):
    """The keyed sharded heat bath (noise per rank from a generator seeded
    by the sweep's seed and the rank's position) samples the plaquette the
    dense heat bath samples: chain means within 4 sigma of each other and
    of I1(beta)/I0(beta)."""
    from scipy.special import i0e, i1e
    ranks, dense = world
    keyed = ranks[0]["keyed"]
    assert all(torch.equal(r["keyed"], keyed) for r in ranks)

    def mean_err(m):
        return float(m.mean()), float(m.std() / math.sqrt(m.numel()))

    (a, ea), (b, eb) = mean_err(keyed), mean_err(dense)
    assert abs(a - b) < 4.0 * math.hypot(ea, eb), (a, ea, b, eb)
    exact = i1e(1.0) / i0e(1.0)
    assert abs(a - exact) < 4.0 * ea, (a, ea, exact)
