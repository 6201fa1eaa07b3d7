"""The program's recorder (``utils/timer.py``): off without a profiler (a
chunk records nothing and allocates no counts), on under
``torch.profiler``; spans nest (parent, chunk); the chunks' outputs are
the same bits with it on and off; and the plain K3's and K4's counts of
their rejection loops (draws, rounds needed, rounds evaluated) against a
sequential loop written out here."""

import math

import pytest
import torch

from mlmcpathintegral_tpu_torch.conditioned.schwinger import (
    make_schwinger_conditioned_fine_action,
)
from mlmcpathintegral_tpu_torch.lattice2d import CoarseningType, Lattice2D
from mlmcpathintegral_tpu_torch.mc import MonteCarloMultiLevel
from mlmcpathintegral_tpu_torch.models.base import RenormalisationType
from mlmcpathintegral_tpu_torch.models.qft.schwinger import (
    QuenchedSchwingerAction,
)
from mlmcpathintegral_tpu_torch.ops import schwinger as sw
from mlmcpathintegral_tpu_torch.ops import schwinger_twolevel as tl
from mlmcpathintegral_tpu_torch.qoi import qoi_2d_susceptibility
from mlmcpathintegral_tpu_torch.samplers import OverrelaxedHeatBathSampler
from mlmcpathintegral_tpu_torch.utils import timer

torch.set_num_threads(1)

SEED = torch.tensor([20240611, -777], dtype=torch.int32)
C = 4


def _profiled():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.fixture
def record():
    timer.clear()
    yield
    timer.clear()


@pytest.fixture(scope="module")
def chunks():
    """A two-level 8x8 MLMC set up on the CPU (plain K3 and K4), its level
    chunk functions, finest first, with their carries, and (steps a
    chunk, t_sub) of each level."""
    act = QuenchedSchwingerAction(
        Lattice2D(8, 8, CoarseningType.BOTH), beta=4.0,
        renormalisation=RenormalisationType.NONPERTURBATIVE)

    def factory(a):
        return OverrelaxedHeatBathSampler(a, n_sweep_heatbath=1,
                                          n_sweep_overrelax=1, n_burnin=4)
    mc = MonteCarloMultiLevel(
        act, qoi_2d_susceptibility, coarse_sampler_factory=factory,
        conditioned_fine_action_factory=make_schwinger_conditioned_fine_action,
        n_level=2, n_burnin=4, n_samples=C, n_autocorr_window=4,
        n_min_samples_qoi=4, chunk_size=4)
    mc.evaluate(torch.Generator().manual_seed(3), n_chains=C,
                dtype=torch.float64, device="cpu")
    carries, carry_L = mc.final_carries
    shape = [(mc._level_chunk(ell), mc._t_sub[ell]) for ell in (0, 1)]
    return [mc._chunk(0), mc._chunk(1)], [carries[0], carry_L], shape


def _leaves(out):
    return [t for t in torch.utils._pytree.tree_leaves(out)
            if isinstance(t, torch.Tensor)]


def test_recorder_off_without_a_profiler(record, chunks, monkeypatch):
    fns, carries, _ = chunks

    def no_counts(*a, **k):
        raise AssertionError("counts allocated with the recorder off")
    monkeypatch.setattr(timer, "new_round_counts", no_counts)
    assert not timer.recording()
    for fn, carry in zip(fns, carries):
        fn(SEED, carry, 4)
    assert timer.spans() == [] and timer.dropped() == 0


def test_recorder_on_under_the_profiler(record, chunks):
    fns, carries, ((n0, t0), (n1, t1)) = chunks
    with _profiled():
        assert timer.recording()
        for fn, carry in zip(fns, carries):
            fn(SEED, carry, 4)
    assert not timer.recording()
    rec = timer.spans()
    assert [s.name for s in rec] == ["k4.launch", "level0.stats",
                                     "level0.chunk", "k3.launch",
                                     "level1.stats", "level1.chunk"]
    by = {s.name: s for s in rec}
    fine, coarse = by["level0.chunk"], by["level1.chunk"]
    assert fine.attrs["screens"] == n0 * C
    assert 0 < fine.attrs["accepts"] < n0 * C
    assert "screens" not in coarse.attrs
    for name, root in (("k4.launch", fine), ("level0.stats", fine),
                       ("k3.launch", coarse), ("level1.stats", coarse)):
        s = by[name]
        assert s.parent == root.id and s.chunk == root.id
        assert root.start_ns <= s.start_ns <= s.end_ns <= root.end_ns
    # the CPU records through the plain version: no kernel launch
    assert by["level0.stats"].attrs == {"stats_launches": 0}
    assert by["level1.stats"].attrs == {"stats_launches": 0}
    assert fine.parent is None and fine.chunk == fine.id
    # the counts: draws are every link or cell of every sweep or fill
    k4 = by["k4.launch"].attrs["rounds"]
    assert [row[0] for row in k4] == [C * n0 * t0 * 16 * 2, C * n0 * 16,
                                      C * n0 * 32]
    k3, = by["k3.launch"].attrs["rounds"]
    assert k3[0] == C * n1 * t1 * 32
    for d, need, ev in k4 + [k3]:
        assert d < need < ev


def test_chunks_same_bits_recorder_on_and_off(record, chunks):
    fns, carries, _ = chunks
    off = [fn(SEED, carry, 4) for fn, carry in zip(fns, carries)]
    with _profiled():
        on = [fn(SEED, carry, 4) for fn, carry in zip(fns, carries)]
    for a, b in zip(_leaves(off), _leaves(on)):
        assert torch.equal(a, b)


def test_spans_nest(record):
    with _profiled():
        with timer.span("a", x=1) as a:
            with a.child("b") as b:
                with timer.span("c") as c:
                    c.set(n=torch.tensor([[1, 2], [3, 4]]))
            with timer.span("d", y=torch.tensor(2.5)) as d:
                pass
        with timer.span("e") as e:
            pass
    rec = {s.name: s for s in timer.spans()}
    assert [s.name for s in timer.spans()] == ["c", "b", "d", "a", "e"]
    assert (rec["a"].parent, rec["b"].parent, rec["c"].parent,
            rec["d"].parent, rec["e"].parent) == (None, a.id, b.id, a.id,
                                                   None)
    assert {rec[n].chunk for n in "abcd"} == {a.id} and e.chunk == e.id
    assert rec["c"].attrs["n"] == [[1, 2], [3, 4]]
    assert rec["d"].attrs["y"] == 2.5 and rec["a"].attrs["x"] == 1
    assert rec["a"].start_ns <= rec["b"].start_ns <= rec["c"].start_ns \
        <= rec["c"].end_ns <= rec["b"].end_ns <= rec["a"].end_ns
    # off: a false span that records nothing
    sp = timer.span("off")
    with sp as s, s.child("child"):
        s.set(z=1)
    assert not sp and len(timer.spans()) == 5


def test_record_is_bounded(record, monkeypatch):
    monkeypatch.setattr(timer, "MAX_SPANS", 3)
    with _profiled():
        for _ in range(5):
            with timer.span("s"):
                pass
    assert len(timer.spans()) == 3 and timer.dropped() == 2


def _sequential(oks, k):
    """(draws, rounds needed, rounds evaluated) of the rejection loops
    whose rounds' accept flags ``oks`` holds (rounds on dim 0), run
    sequentially: round after round until one accepts."""
    draws = needed = 0
    for ok in oks:
        assert ok.shape[0] == k
        for flags in ok.reshape(k, -1).T.tolist():
            draws += 1
            needed += next((r + 1 for r, f in enumerate(flags) if f), k)
    return [draws, needed, draws * k]


def _capture(monkeypatch):
    """The accept flags of every round each plain rejection loop
    evaluates, by loop kind (its k: K3's 6, K4's coarse 8, fill 16,
    BesselProduct 48)."""
    seen = {}
    for module in (sw, tl):
        def keep(prop, ok, _first=module._first_accepted):
            seen.setdefault(ok.shape[0], []).append(ok.clone())
            return _first(prop, ok)
        monkeypatch.setattr(module, "_first_accepted", keep)
    return seen


@pytest.mark.parametrize("beta", [4.0, 0.25])
def test_plain_k4_counts_match_a_sequential_loop(monkeypatch, beta):
    seen = _capture(monkeypatch)
    g = torch.Generator().manual_seed(7)
    M, n_steps, t_sub = 4, 3, 2
    fine = 2 * math.pi * torch.rand((C, 2 * M * M), generator=g) - math.pi
    coarse = 2 * math.pi * torch.rand((C, M * M // 2), generator=g) - math.pi
    rounds = timer.new_round_counts(3, "cpu")
    tl.schwinger_twolevel_chain_plain.__wrapped__(
        fine, coarse, torch.zeros(C), torch.zeros(C), SEED, beta=beta,
        beta_c=1.0, Mt=M, Mx=M, n_steps=n_steps, t_sub=t_sub, k_rej=8,
        k_rej_fill=16, k_rej_bessel=48, rounds=rounds)
    assert rounds.tolist() == [_sequential(seen[8], 8),
                               _sequential(seen[48], 48),
                               _sequential(seen[16], 16)]
    assert rounds[0, 0] == C * n_steps * t_sub * M * M // 2


def test_plain_k3_counts_match_a_sequential_loop(monkeypatch):
    seen = _capture(monkeypatch)
    g = torch.Generator().manual_seed(8)
    M, n_steps = 4, 5
    x = 2 * math.pi * torch.rand((C, 2 * M * M), generator=g) - math.pi
    rounds = timer.new_round_counts(1, "cpu")
    sw.schwinger_sweep_chain_plain.__wrapped__(
        x, SEED, beta=4.58, Mt=M, Mx=M, n_steps=n_steps, k_rej=6,
        rounds=rounds)
    assert rounds.tolist() == [_sequential(seen[6], 6)]
    assert rounds[0, 0] == C * n_steps * 2 * M * M


def test_every_nth_recorded_launch_is_counted(record):
    seen = []

    @timer.recorded_launch("x.launch", 2, every=3)
    def launch(t, rounds=None):
        seen.append(rounds is not None)
        if rounds is not None:
            rounds[1, 0] += 5
        return t

    launch(torch.zeros(1))               # not recorded: not a call counted
    with _profiled():
        for _ in range(7):
            launch(torch.zeros(1))
    assert seen == [False, True, False, False, True, False, False, True]
    rec = timer.spans()
    assert [s.attrs.get("rounds") for s in rec][:2] == [
        [[0, 0, 0], [5, 0, 0]], None]
    assert timer.COUNT_EVERY >= 1


def test_each_launch_shape_is_counted_on_its_own(record):
    """Two levels whose launches take turns (a round runs one chunk a
    level) are each counted one launch in ``every``, and both levels'
    counts are kept."""
    seen = []

    @timer.recorded_launch("x.launch", 1, every=timer.COUNT_EVERY)
    def launch(t, rounds=None):
        seen.append((t.shape[1], rounds is not None))
        if rounds is not None:
            rounds[0, 0] += t.shape[1]
        return t

    n = 2 * timer.COUNT_EVERY
    with _profiled():
        for _ in range(n):
            launch(torch.zeros(2, 32))       # the mid level
            launch(torch.zeros(2, 128))      # the fine level
    for size in (32, 128):
        counted = [c for s, c in seen if s == size]
        assert len(counted) == n
        assert [i for i, c in enumerate(counted) if c] == [
            0, timer.COUNT_EVERY]
    rounds = [s.attrs["rounds"] for s in timer.spans()
              if "rounds" in s.attrs]
    assert sorted(r[0][0] for r in rounds) == [32, 32, 128, 128]
