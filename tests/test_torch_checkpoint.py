"""Checkpoint / resume of the port (utils/checkpoint.py; the port's
counterpart of tests/test_checkpoint.py): full MC state round-trips and a
resumed chain continues bit for bit; the file format is the JAX package's,
so a JAX-written StatsState loads into the port and gives JAX's getters;
``torch.Generator`` states round-trip; a two-level carry saved after
burn-in and resumed gives the uninterrupted run's next chunk, bit for
bit."""

import numpy as np
import pytest
import torch

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
from mlmcpathintegral_tpu_torch.qoi import qoi_2d_susceptibility
from mlmcpathintegral_tpu_torch.samplers import (
    HMCSampler, OverrelaxedHeatBathSampler,
)
from mlmcpathintegral_tpu_torch.utils import statistics as stats_mod
from mlmcpathintegral_tpu_torch.utils.checkpoint import (
    checkpoint_metadata, load_checkpoint, save_checkpoint,
)
from mlmcpathintegral_tpu_torch.utils.statistics import Statistics
from mlmcpathintegral_tpu_torch.utils.tree import tree_flatten

F64 = torch.float64


def _equal(a, b):
    la, lb = tree_flatten(a)[0], tree_flatten(b)[0]
    return len(la) == len(lb) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        for x, y in zip(la, lb))


def test_roundtrip_and_identical_continuation(tmp_path):
    lat = Lattice1D(16, 4.0)
    action = HarmonicOscillatorAction(lat, m0=1.0, mu2=1.0)
    sampler = HMCSampler(action, nt=8, dt=0.1)
    stats = Statistics("Q", 10)
    C = 16
    gen = torch.Generator().manual_seed(0)
    sstate = sampler.init(gen, C, F64, "cpu")
    st = stats.init(C, F64, "cpu")
    for _ in range(5):
        sstate, _ = sampler.draw(gen, sstate)
        st = stats_mod.record(st, torch.mean(sstate.x ** 2, dim=-1))

    ckpt = tmp_path / "chain.npz"
    save_checkpoint(ckpt, {"sampler": sstate, "stats": st, "gen": gen},
                    metadata={"step": 5})
    assert checkpoint_metadata(ckpt)["step"] == 5

    other = torch.Generator().manual_seed(9)
    template = {"sampler": sampler.init(other, C, F64, "cpu"),
                "stats": stats.init(C, F64, "cpu"),
                "gen": torch.Generator().manual_seed(9)}
    restored = load_checkpoint(ckpt, template)
    assert torch.equal(restored["sampler"].x, sstate.x)
    assert torch.equal(restored["stats"].S_k, st.S_k)
    assert restored["stats"].n.dtype == torch.int32
    assert restored["stats"].n.shape == st.n.shape == ()
    # the restored generator is the template's, set to the saved state
    assert restored["gen"] is template["gen"]

    # continuation from the restored state and generator is bit-identical
    s_a, acc_a = sampler.draw(gen, sstate)
    s_b, acc_b = sampler.draw(restored["gen"], restored["sampler"])
    assert torch.equal(s_a.x, s_b.x) and torch.equal(acc_a, acc_b)


def test_shape_mismatch_raises(tmp_path):
    ckpt = tmp_path / "x.npz"
    save_checkpoint(ckpt, {"a": torch.zeros(4, 4)})
    with pytest.raises(ValueError, match="shape mismatch"):
        load_checkpoint(ckpt, {"a": torch.zeros(2, 2)})
    with pytest.raises(ValueError, match="leaves"):
        load_checkpoint(ckpt, {"a": torch.zeros(4, 4), "b": torch.zeros(3)})


def test_restored_leaf_takes_template_dtype(tmp_path):
    ckpt = tmp_path / "d.npz"
    save_checkpoint(ckpt, (torch.arange(4, dtype=F64), [torch.tensor(3)]))
    out = load_checkpoint(ckpt, (torch.zeros(4, dtype=torch.float32),
                                 [torch.tensor(0, dtype=torch.int64)]))
    assert out[0].dtype == torch.float32 and out[1][0].dtype == torch.int64
    assert torch.equal(out[0], torch.arange(4, dtype=torch.float32))
    assert isinstance(out[1], list) and int(out[1][0]) == 3


def test_generator_state_round_trips(tmp_path):
    gen = torch.Generator().manual_seed(123)
    torch.rand(7, generator=gen)
    ckpt = tmp_path / "g.npz"
    save_checkpoint(ckpt, {"state": gen.get_state()})
    fresh = torch.Generator()
    fresh.set_state(load_checkpoint(
        ckpt, {"state": torch.Generator().get_state()})["state"])
    assert torch.equal(torch.rand(5, generator=fresh),
                       torch.rand(5, generator=gen))


def test_jax_written_stats_state_loads_with_jax_getters(tmp_path):
    """A StatsState written by the JAX package's save_checkpoint loads into
    the port's StatsState, whose getters give JAX's numbers."""
    import jax.numpy as jnp

    from mlmcpathintegral_tpu.utils import checkpoint as jckpt
    from mlmcpathintegral_tpu.utils import statistics as jstats
    C, k = 8, 6
    jst_obj = jstats.Statistics("Q", k)
    jst = jst_obj.init(C, jnp.float64)
    rs = np.random.default_rng(4)
    x = np.zeros(C)
    for _ in range(40):           # an autocorrelated series per chain
        x = 0.8 * x + rs.normal(size=C)
        jst = jstats.record(jst, jnp.asarray(x))
    ckpt = tmp_path / "jax_stats.npz"
    jckpt.save_checkpoint(ckpt, jst, metadata={"from": "jax"})

    st_obj = Statistics("Q", k)
    st = load_checkpoint(ckpt, st_obj.init(C, F64, "cpu"))
    assert checkpoint_metadata(ckpt) == {"from": "jax"}
    for name in ("average", "tau_int", "variance", "error"):
        assert getattr(st_obj, name)(st) == pytest.approx(
            getattr(jst_obj, name)(jst), rel=0, abs=1e-12), name
    assert st_obj.samples(st) == jst_obj.samples(jst)


def _schwinger():
    return QuenchedSchwingerAction(Lattice2D(4, 4, CoarseningType.BOTH),
                                   beta=2.0)


def _twolevel_chunk():
    """(carry, chunk) of MonteCarloTwoLevel's batched (unfused) path."""
    mc = MonteCarloTwoLevel(
        _schwinger(), qoi_2d_susceptibility,
        lambda a: OverrelaxedHeatBathSampler(a, n_burnin=5),
        make_schwinger_conditioned_fine_action, n_burnin=8, n_samples=32,
        chunk_size=4)
    return (lambda gen: mc.init_carry(gen, 8, F64, "cpu")), mc._chunk


def _multilevel_chunk():
    """(carry, chunk) of MonteCarloMultiLevel's fused fine level (the
    plain K4)."""
    mc = MonteCarloMultiLevel(
        _schwinger(), qoi_2d_susceptibility,
        lambda a: OverrelaxedHeatBathSampler(a, n_burnin=5),
        make_schwinger_conditioned_fine_action, n_level=2, n_burnin=8,
        n_samples=32, chunk_size=8)
    return (lambda gen: mc.init_carries(gen, 8, F64, "cpu")[0][0]), \
        mc._chunk(0)


@pytest.mark.parametrize("make", [_twolevel_chunk, _multilevel_chunk],
                         ids=["twolevel_unfused", "multilevel_fused_K4"])
def test_resumed_carry_continues_bit_for_bit(tmp_path, make):
    """Burn in, save the carry, restore it into a fresh template: the
    next chunk equals the uninterrupted run's, bit for bit."""
    init, chunk = make()
    carry = init(torch.Generator().manual_seed(1))
    for s in range(2):                                # burn-in chunks
        carry, _ = chunk(torch.tensor([s, 7], dtype=torch.int32), carry, 4)
    save_checkpoint(tmp_path / "carry.npz", carry)
    restored = load_checkpoint(tmp_path / "carry.npz",
                               init(torch.Generator().manual_seed(2)))
    assert _equal(restored, carry)
    seed = torch.tensor([5, 9], dtype=torch.int32)
    a, out_a = chunk(seed, carry, 4)
    b, out_b = chunk(seed, restored, 4)
    assert _equal(a, b) and torch.equal(out_a, out_b)
