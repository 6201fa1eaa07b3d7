"""On the card: K3's and K4's counted kernels, which launch while the
program records, against their uncounted kernels and their plain
versions.  Every output bit equals the uncounted launch's, in the warp
and the block designs and in each branch of their rejection loops; the
draws and rounds needed equal the plain version's at the same inputs,
over the chains that have not departed from their plain twin through a
float-rounding flip.  The counted kernels keep the uncounted ones'
resident warps an SM.  The program's recorder (utils/timer.py) hands
the counts to its spans; the benchmark's metrics read them there."""

import math

import pytest
import torch

from mlmcpathintegral_tpu_torch.ops import _cuda
from mlmcpathintegral_tpu_torch.ops import schwinger as sw
from mlmcpathintegral_tpu_torch.ops import schwinger_twolevel as tl
from mlmcpathintegral_tpu_torch.utils import timer

SEED = torch.tensor([1234567, -7654321], dtype=torch.int32)
#: (name, fine Mt = Mx, chains, steps, t_sub, beta): the warp design (8x8)
#: and the block design's branches: W lanes a link (32x32), the heat
#: bath pooled across the warp and the fill one cell a thread at a time
#: (64x64); beta <= 8 runs the exact BesselProduct fill
K4_LAUNCHES = [("warp 8x8", 8, 1024, 4, 8, 4.0),
               ("warp 8x8 exact, odd chains", 8, 333, 4, 8, 4.0),
               ("block 32x32 exact", 32, 128, 2, 4, 4.0),
               ("block 64x64", 64, 64, 1, 4, 64.0)]
#: (name, Mt = Mx, chains, steps, beta): the warp design (4x4, 8x8) and
#: the block design with W lanes a link (16x16), pooled (32x32) and a
#: thread's links in turn (64x64)
K3_LAUNCHES = [("warp 4x4", 4, 1024, 16, 4.58),
               ("warp 8x8", 8, 333, 8, 4.58),
               ("block 16x16", 16, 256, 4, 4.58),
               ("block 32x32", 32, 128, 2, 16.49),
               ("block 64x64", 64, 64, 1, 64.38)]
TOL = 1e-3


@pytest.fixture(scope="module")
def built():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _cuda.build()
    return torch.device("cuda")


def _links(shape, gen, dev):
    return (2 * math.pi * torch.rand(shape, generator=gen, dtype=torch.float64)
            - math.pi).to(torch.float32).to(dev)


def _k4_inputs(M, C, beta, dev):
    g = torch.Generator().manual_seed(M * 1000 + C)
    fine = _links((C, 2 * M * M), g, dev)
    coarse = _links((C, M * M // 2), g, dev)
    f = tuple(tl.split_parity(fine.reshape(C, M, M, 2)))
    exact, alphas, _, _ = tl.fill_constants(beta)
    sf = tl.s_fine(f, beta)
    sq = tl.s_cond(f, beta, alphas) if exact else tl.s_cond_approx(f, beta)
    return fine, coarse, sf, sq


def _k4(inputs, C, M, steps, t_sub, beta, rounds):
    fine, coarse, sf, sq = (t[:C] for t in inputs)
    kw = dict(beta=beta, beta_c=beta / 4, Mt=M, Mx=M, n_steps=steps,
              t_sub=t_sub, n_overrelax_c=1, n_heatbath_c=1, k_rej=8,
              k_rej_fill=16, k_rej_bessel=48, chain0=0)
    if rounds == "plain":
        rounds = timer.new_round_counts(3, fine.device)
        out = tl.schwinger_twolevel_chain_plain.__wrapped__(
            fine, coarse, sf, sq, SEED, rounds=rounds, **kw)
    else:
        out = tl._twolevel_cuda.__wrapped__(fine, coarse, sf, sq, SEED,
                                            rounds=rounds, **kw)
    return out, rounds


def _k3(x, C, M, steps, beta, rounds):
    kw = dict(beta=beta, Mt=M, Mx=M, n_steps=steps, n_overrelax=1,
              n_heatbath=1, k_rej=6, with_energy=True, step_offset=0,
              chain0=0)
    if rounds == "plain":
        rounds = timer.new_round_counts(1, x.device)
        out = sw.schwinger_sweep_chain_plain.__wrapped__(x[:C], SEED,
                                                         rounds=rounds, **kw)
    else:
        out = sw._sweep_cuda.__wrapped__(x[:C], SEED, want_q=True,
                                         rounds=rounds, **kw)
    return out, rounds


def _angles_agree(a, b):
    d = torch.remainder(a.double() - b.double() + math.pi, 2 * math.pi) \
        - math.pi
    return (d.abs() <= TOL).reshape(a.shape[0], -1).all(dim=1)


def _values_agree(a, b):
    """[C] of [steps, C] or [C] values: relative to max(1, |b|)."""
    d = (a.double() - b.double()).abs() / b.double().abs().clamp(min=1.0)
    return (d <= TOL).all(dim=0) if d.dim() == 2 else d <= TOL


def _first_departed(agree):
    off = torch.nonzero(~agree)
    return int(off[0]) if len(off) else agree.numel()


def _check_counts(run, C, agree_of):
    """The counted kernel's draws and rounds needed against the plain
    version's: over all chains where none departs from its plain twin,
    else over the chains before the first that does (run again on them
    alone: a chain's draws do not depend on the others)."""
    rounds = torch.zeros((3, 3), dtype=torch.int64, device="cuda")
    out, _ = run(C, rounds)
    ref, plain = run(C, "plain")
    n = _first_departed(agree_of(out, ref))
    assert n >= C // 4, f"chain {n} of {C} departs from its plain twin"
    if n < C:
        rounds.zero_()
        run(n, rounds)
        _, plain = run(n, "plain")
    got = rounds[:plain.shape[0]]
    assert torch.equal(got[:, :2], plain[:, :2]), (got, plain)
    # rounds run W at a time: at least the rounds needed, at most k each
    assert (got[:, 2] >= got[:, 1]).all()
    assert (got[:, 2] <= plain[:, 2]).all()
    return got


@pytest.mark.chip
@pytest.mark.parametrize("name, M, C, steps, t_sub, beta", K4_LAUNCHES)
def test_k4_counted_bits_and_counts(built, name, M, C, steps, t_sub, beta):
    inputs = _k4_inputs(M, C, beta, built)
    rounds = torch.zeros((3, 3), dtype=torch.int64, device=built)
    uncounted, _ = _k4(inputs, C, M, steps, t_sub, beta, None)
    counted, _ = _k4(inputs, C, M, steps, t_sub, beta, rounds)
    torch.cuda.synchronize()
    for a, b in zip(uncounted, counted):
        assert torch.equal(a, b)
    assert int(rounds[0, 0]) == C * steps * t_sub * M * M // 2

    def agree(out, ref):
        ok = _angles_agree(out[0], ref[0]) & _angles_agree(out[1], ref[1])
        for k in (4, 5, 6, 7):
            ok &= _values_agree(out[k], ref[k])
        return ok

    got = _check_counts(
        lambda c, r: _k4(inputs, c, M, steps, t_sub, beta, r), C, agree)
    exact = tl.fill_constants(beta)[0]
    assert (int(got[1, 0]) > 0) == exact


@pytest.mark.chip
@pytest.mark.parametrize("name, M, C, steps, beta", K3_LAUNCHES)
def test_k3_counted_bits_and_counts(built, name, M, C, steps, beta):
    g = torch.Generator().manual_seed(M * 100 + C)
    x = _links((C, 2 * M * M), g, built)
    rounds = torch.zeros((1, 3), dtype=torch.int64, device=built)
    uncounted, _ = _k3(x, C, M, steps, beta, None)
    counted, _ = _k3(x, C, M, steps, beta, rounds)
    torch.cuda.synchronize()
    for a, b in zip(uncounted, counted):
        assert torch.equal(a, b)
    assert int(rounds[0, 0]) == C * steps * 2 * M * M

    def agree(out, ref):
        return (_angles_agree(out[0], ref[0]) & _values_agree(out[1], ref[1])
                & _values_agree(out[2], ref[2]))

    _check_counts(lambda c, r: _k3(x, c, M, steps, beta, r), C, agree)


def _attrs(kernel, M, C, counted):
    """Registers, local bytes and resident warps of K3's or K4's counted
    or uncounted kernel at its launch for C chains of an M x M field."""
    if kernel == "K4":
        lanes, cpb, smem, branch = tl.twolevel_launch(M, M, C)
        fn = "mlmc_schwinger_twolevel_attrs"
    else:
        lanes, cpb, smem, branch = sw.sweep_launch(M, M, C,
                                                   _cuda.max_smem_optin(0))
        fn = "mlmc_schwinger_sweep_attrs"
    return _cuda.kernel_attrs(fn, lanes * cpb, smem, int(branch == "warp"),
                              int(counted))


@pytest.mark.chip
@pytest.mark.parametrize("kernel, M, C", [("K4", 8, 8192), ("K4", 64, 1024),
                                          ("K4", 32, 1024), ("K3", 4, 8192),
                                          ("K3", 16, 1024)])
def test_counted_kernels_keep_occupancy(built, kernel, M, C):
    """The counted instantiations at the cells' launches keep the
    uncounted ones' resident warps an SM (their registers and local bytes
    are printed)."""
    off, on = _attrs(kernel, M, C, False), _attrs(kernel, M, C, True)
    public = (tl.twolevel_attrs if kernel == "K4" else sw.sweep_attrs)(M, M,
                                                                       C)
    print(kernel, M, C, "uncounted", off, "counted", on)
    assert off == public
    assert on["warps_per_sm"] == off["warps_per_sm"], (off, on)


def test_attrs_wrappers_pass_every_argument(monkeypatch):
    """The public attrs wrappers (the uncounted kernels) hand the library's
    C function every argument it takes (checked without a card)."""
    seen = {}

    def fake(fn, *args):
        seen[fn] = args
        return {}
    monkeypatch.setattr(_cuda, "kernel_attrs", fake)
    monkeypatch.setattr(_cuda, "max_smem_optin", lambda device: 232448)
    sw.sweep_attrs(16, 16, 1024)
    tl.twolevel_attrs(8, 8, 1024)
    assert sorted(seen) == ["mlmc_schwinger_sweep_attrs",
                            "mlmc_schwinger_twolevel_attrs"]
    for fn, args in seen.items():
        assert len(args) + 1 == len(_cuda._SIGNATURES[fn]), fn
        assert args[-1] == 0                 # the uncounted kernel
