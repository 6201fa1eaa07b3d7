"""The comparison that decides a run's ``correct``.

The window's chains are followed against the plain reference
(``reference/``) from the program's own state, a chunk at a time: the
reference cannot run a whole MCMC run beside the program, because one
float rounding flip in an accept test or a rejection round sends a chain
on another path for good.  One chunk of each level is checked, drawn from
the seed among the window's rounds (``harness``).  From the state that
chunk started from, with its seed, the reference replays its first
``steps`` steps on every chain in float64 with couplings it works out
itself, and reads the chunk's end state:

* ``sweep0_departed``: the share of chains whose first coarse sweep (its
  Q and plaquette energy) differs from the reference's;
* ``prefix_departed``: the share of chains that depart from the reference
  within the replayed steps: on a fine level (K4) each step's t_sub
  coarse sweeps (Q, energy), the fill and accept (the accept bit) and Y;
  on the coarsest level (K3) the sweeps' Q and energy;
* ``end_disagree``: the share of chains whose end state disagrees with
  itself as the reference reads it: on a fine level the cached S_fine and
  S_cond against the reference's actions of the output fine links, the
  last Y, and the newest Y in the statistics' ring, against the
  reference's Y of the output links, the last coarse Q and energy against
  the output coarse links; on the coarsest level the last Q, energy and
  the ring's newest Y against the output links;
* ``stats_disagree``: the share of chains whose Y statistics disagree
  after the chunk with the reference's update (``reference/statistics``)
  of the statistics as they were before it by the chunk's Y (on the
  coarsest level worked out from the kernel's Q): the running mean, the
  lagged products S_k of every lag and the ring, each against the
  level's scale (the root of the mean of S_0 for the mean and the ring,
  the mean of S_0 for S_k), within STATS_RTOL, and the count of samples;
* ``samples_missing``: the share of the samples the window ran that the
  Y statistics did not record (an exact comparison).

Each is the largest over the levels, and each has its limit in the
configuration's file.  Two values agree within ATOL + RTOL |reference|.

This is the fused path's check (``paths/fused.py``).  ``stats_level``,
``samples_missing`` and ``verdict`` serve every path: another path's
``judge`` reuses the first two, and ``verdict`` reads the numbers that
the configuration's ``check.limits`` names.
"""

from __future__ import annotations

import math

import torch

from perfbench.reference import physics
from perfbench.reference import schwinger as ref
from perfbench.reference import statistics as stats_ref

#: two values agree within ATOL + RTOL |reference|: float32 sums of a few
#: thousand plaquette terms round by ~1e-4 at most, while a chain that
#: took another accept or rejection round differs by O(1) in Q, the
#: energy or an action
ATOL, RTOL = 1e-3, 1e-4
FOURPI2_INV = 1.0 / (4.0 * math.pi ** 2)
#: a chain's statistics agree within STATS_RTOL of the level's scale: the
#: float32 update of a chunk departs by at most ~1e-6 of it, a bfloat16
#: one by ~1e-2
STATS_RTOL = 5e-5

SHARES = ("sweep0_departed", "prefix_departed", "end_disagree",
          "stats_disagree")
NUMBERS = SHARES + ("samples_missing",)


def _agree(prog, want):
    return (prog.double() - want).abs() <= ATOL + RTOL * want.abs()


def _fine_fields(theta, Mt, Mx):
    C = theta.shape[0]
    return tuple(ref.split_parity(theta.reshape(C, Mx, Mt, 2)))


def _coarse_fields(theta, Mtc, Mxc):
    g = theta.reshape(theta.shape[0], Mxc, Mtc, 2)
    return g[..., 0], g[..., 1]


def _by_step(ok):
    """The share of chains departed within the first s steps, for each s,
    from ``ok`` [steps, C]."""
    gone = (~ok).to(torch.int32).cumsum(dim=0) > 0
    return [float(g) for g in gone.double().mean(dim=1)]


def _k4_level(call, ring_newest, Mt, Mx, beta, beta_c, t_sub, steps):
    """(sweep0 disagree [C], departed within steps [C], end disagree [C],
    departed share by step) of one two-level chunk on an Mt x Mx fine
    lattice."""
    (thf, thc, sf, sq, seed), kw, out = call
    fo, co, sfo, sqo, y, qc, ec, acc = out
    H = min(steps, y.shape[0])
    f64 = torch.float64
    r = ref.twolevel_chain(
        thf.to(f64), thc.to(f64), sf.to(f64), sq.to(f64), seed, beta=beta,
        beta_c=beta_c, Mt=Mt, Mx=Mx, n_steps=H, t_sub=t_sub,
        chain0=kw.get("chain0", 0))
    ry, rqc, rec, racc = r[4], r[5], r[6], r[7]
    C = y.shape[1]
    sweep0 = ~(_agree(qc[0], rqc[0]) & _agree(ec[0], rec[0]))
    ok = (_agree(y[:H], ry) & (acc[:H] == racc.to(acc.dtype))
          & _agree(qc[:H * t_sub], rqc).reshape(H, t_sub, C).all(dim=1)
          & _agree(ec[:H * t_sub], rec).reshape(H, t_sub, C).all(dim=1))
    departed = ~ok.all(dim=0)
    by_step = _by_step(ok)

    exact, alphas, _, _ = ref.fill_constants(float(beta))
    f = _fine_fields(fo.to(f64), Mt, Mx)
    Tc, Xc = _coarse_fields(co.to(f64), Mt // 2, Mx // 2)
    s_f = ref.s_fine(f, beta)
    s_q = ref.s_cond(f, beta, alphas) if exact else ref.s_cond_approx(f, beta)
    qf, qcr = ref.q_topological(f), ref.q_coarse(Tc, Xc)
    y_end = FOURPI2_INV * (qf * qf - qcr * qcr)
    ecr = torch.sum(torch.cos(ref.coarse_plaquettes(Tc, Xc)), dim=(-2, -1))
    end_ok = (_agree(sfo, s_f) & _agree(sqo, s_q) & _agree(y[-1], y_end)
              & _agree(ring_newest, y_end) & _agree(qc[-1], qcr)
              & _agree(ec[-1], ecr))
    return sweep0, departed, ~end_ok, by_step


def _k3_level(call, ring_newest, Mt, Mx, beta, t_sub, steps):
    """The same for one sweep-chain chunk of the coarsest level, on an
    Mt x Mx lattice (a step is its t_sub sweeps, the Y it records)."""
    (x, seed), kw, out = call
    xo, qsum, esum = out
    n = min(steps * t_sub, qsum.shape[0])
    f64 = torch.float64
    _, rq, re = ref.sweep_chain(x.to(f64), seed, beta=beta, Mt=Mt, Mx=Mx,
                                n_steps=n, with_energy=True,
                                chain0=kw.get("chain0", 0))
    sweep0 = ~(_agree(qsum[0], rq[0]) & _agree(esum[0], re[0]))
    ok = (_agree(qsum[:n], rq) & _agree(esum[:n], re)).reshape(
        n // t_sub, t_sub, -1).all(dim=1)
    departed = ~ok.all(dim=0)

    T, X = _coarse_fields(xo.to(f64), Mt, Mx)
    plaq = ref._plaquettes(T, X)
    q_end = torch.sum(plaq, dim=(1, 2))
    e_end = torch.sum(torch.cos(plaq), dim=(1, 2))
    end_ok = (_agree(qsum[-1], q_end) & _agree(esum[-1], e_end)
              & _agree(ring_newest, FOURPI2_INV * q_end * q_end))
    return sweep0, departed, ~end_ok, _by_step(ok)


def stats_level(y, before, after):
    """(disagree [C], the largest deviation over the chains as a share of
    the scale) of the Y statistics' update by the chunk's samples ``y``
    [T, C], from the state ``before`` the chunk to the state ``after``
    it."""
    f64 = torch.float64
    n0 = int(before.n_lt)
    n, avg, ring, S = stats_ref.record(
        n0, before.avg_lt.to(f64), before.ring.to(f64), before.S_k.to(f64),
        y.to(f64))
    scale2 = float(S[:, 0].abs().mean()) or 1.0
    scale = math.sqrt(scale2)
    dev = torch.stack([
        (after.avg_lt.to(f64) - avg).abs() / scale,
        ((after.ring.to(f64) - ring).abs() / scale).amax(dim=1),
        ((after.S_k.to(f64) - S).abs() / scale2).amax(dim=1)]).amax(dim=0)
    dev = torch.nan_to_num(dev, nan=math.inf)
    disagree = dev > STATS_RTOL
    if int(after.n_lt) != n:
        disagree = torch.ones_like(disagree)
    return disagree, float(dev.max())


def judge(cfg: dict, t_sub: list, kept: dict, recorded: list,
          expected: list):
    """The check's numbers: {name: value}.  ``t_sub``: each level's
    subsampling rate in the window; ``kept``: per level its checked
    chunk, ``{"call": (args, kwargs, outputs) of its kernel call,
    "before": and "after": the level's Y statistics around it}``;
    ``recorded``/``expected``: per level the samples the Y statistics hold
    and the samples the window ran.  A level with no checked chunk reads
    1.0 on every share.  Returns the numbers (each the largest over the
    levels) and each level's own, with the departed share after each
    replayed step and the statistics' largest deviation."""
    mlmc = cfg["multilevelmc"]
    L = mlmc["n_level"]
    betas = physics.level_couplings(cfg["beta"], cfg["Mt_lat"],
                                    cfg["Mx_lat"], L)
    steps = cfg["check"]["steps"]
    per_level = []
    for ell in range(L):
        lv = dict.fromkeys(NUMBERS, 0.0)
        per_level.append(lv)
        if ell not in kept:
            lv.update(dict.fromkeys(SHARES, 1.0))
            continue
        k = kept[ell]
        ring_newest = k["after"].ring[:, 0]
        Mt, Mx = cfg["Mt_lat"] >> ell, cfg["Mx_lat"] >> ell
        with torch.no_grad():
            if ell == L - 1:
                s0, dep, end, by_step = _k3_level(
                    k["call"], ring_newest, Mt, Mx, betas[ell], t_sub[ell],
                    steps)
                q = k["call"][2][1].double()
                y = FOURPI2_INV * (q * q)[t_sub[ell] - 1::t_sub[ell]]
            else:
                s0, dep, end, by_step = _k4_level(
                    k["call"], ring_newest, Mt, Mx, betas[ell],
                    betas[ell + 1], t_sub[ell], steps)
                y = k["call"][2][4]
            st, lv["stats_dev"] = stats_level(y, k["before"], k["after"])
        for name, v in zip(SHARES, (s0, dep, end, st)):
            lv[name] = float(v.double().mean())
        lv["prefix_by_step"] = by_step
    for lv, missing in zip(per_level, samples_missing(recorded, expected)):
        lv["samples_missing"] = missing
    return {k: max(lv[k] for lv in per_level) for k in NUMBERS}, per_level


def samples_missing(recorded: list, expected: list) -> list:
    """Per level the share of the samples the window ran (``expected``)
    that its Y statistics did not record (``recorded``); 1.0 where the
    window ran none."""
    return [1.0 if want == 0 else max(0, want - have) / want
            for have, want in zip(recorded, expected)]


def verdict(numbers: dict, per_level: list, limits: dict):
    """(correct, {name: [value, limit]}, levels failed): correct when
    every number is at or under its limit.  The names are those of
    ``limits``, in their order; a name that ``numbers`` or a level lacks,
    or a number with no limit, raises ``harness.CellError``, so that no
    number passes unread."""
    names = list(limits)
    unread = (set(numbers) ^ set(names)).union(
        *(set(names) - set(lv) for lv in per_level))
    if unread:
        from perfbench.harness import CellError
        raise CellError(f"the check's numbers and limits differ: "
                        f"{sorted(unread)}")
    table = {k: [numbers[k], limits[k]] for k in names}
    failed = sum(1 for lv in per_level
                 if any(lv[k] > limits[k] for k in names))
    return failed == 0, table, failed
