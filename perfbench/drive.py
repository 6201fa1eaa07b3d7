"""The fused path's names of the program, and the two that every path
shares.

The program is ``mlmcpathintegral_tpu_torch``, the PyTorch and CUDA port.
A cell reaches it through its run path (``paths/<name>.py``, the fused
one where its configuration names none).  The fused path, every level
on K4 or K3 (``paths/fused.py``), reaches it only through the functions
below, so a change of the program that renames or reshapes one of these
names breaks the yardstick here and nowhere else.  Its names:

* ``lattice2d.Lattice2D``, ``lattice2d.CoarseningType``,
  ``models.base.RenormalisationType``,
  ``models.qft.schwinger.QuenchedSchwingerAction``,
  ``qoi.qoi_2d_susceptibility``, ``samplers.OverrelaxedHeatBathSampler``,
  ``conditioned.schwinger.make_schwinger_conditioned_fine_action``,
  ``mc.MonteCarloMultiLevel`` (its constructor, ``evaluate``,
  ``final_carries``, ``timings``, ``_t_sub``, ``_level_chunk``,
  ``_is_fused``, ``_chunk``, ``stats_qoi[l].init``, ``actions[l].beta``
  and ``actions[l].lattice``);
* the level chunk carries: ``(cstate, tl, st_y, st_cs, st_slow, t_accum)``
  on a fused fine level (``tl.theta``, ``tl.S_fine``, ``tl.S_cond``,
  ``cstate.x``) and ``(cstate, st_y, st_cs, st_slow, t_accum)`` on the
  fused coarsest level; a statistics state's ``n_lt``, ``avg_lt``,
  ``S_k`` and ``ring``;
* ``ops.schwinger_twolevel.schwinger_twolevel_chain`` (K4) and
  ``ops.schwinger.schwinger_sweep_chain`` (K3), the module attributes
  that ``_chunk`` binds when it builds a level's chunk function.

Shared by every path: ``build_kernels`` (``ops._cuda.build``, which
builds the kernel library into the package's ``_build/``, keyed by a
hash of the sources) and ``record_replaced``
(``utils.statistics.record_block``, the statistics' update, which a
control or a fault replaces for a run).
"""

from __future__ import annotations

import contextlib

import torch

PROGRAM = "mlmcpathintegral_tpu_torch"

#: the kernel each fused level's chunk launches, by the module attribute
#: its chunk function binds: (module, attribute)
K4_OP = (f"{PROGRAM}.ops.schwinger_twolevel", "schwinger_twolevel_chain")
K3_OP = (f"{PROGRAM}.ops.schwinger", "schwinger_sweep_chain")


def build_kernels() -> float:
    """Build the kernel library unless it is built; its build seconds (0.0
    when it was already built in this checkout)."""
    from mlmcpathintegral_tpu_torch.ops import _cuda
    return _cuda.build()[1]


def make_mlmc(cfg: dict, n_samples: int):
    """The configuration's ``MonteCarloMultiLevel`` with a fixed target of
    ``n_samples`` samples a level: the quenched Schwinger action on its
    lattice, the V chi_t observable, heat-bath coarse chains and the
    Schwinger conditioned fill."""
    from mlmcpathintegral_tpu_torch.conditioned.schwinger import (
        make_schwinger_conditioned_fine_action,
    )
    from mlmcpathintegral_tpu_torch.lattice2d import (
        CoarseningType, Lattice2D,
    )
    from mlmcpathintegral_tpu_torch.mc import MonteCarloMultiLevel
    from mlmcpathintegral_tpu_torch.models.base import RenormalisationType
    from mlmcpathintegral_tpu_torch.models.qft.schwinger import (
        QuenchedSchwingerAction,
    )
    from mlmcpathintegral_tpu_torch.qoi import qoi_2d_susceptibility
    from mlmcpathintegral_tpu_torch.samplers import (
        OverrelaxedHeatBathSampler,
    )

    act = QuenchedSchwingerAction(
        Lattice2D(cfg["Mt_lat"], cfg["Mx_lat"],
                  CoarseningType(cfg["coarsening"])),
        beta=cfg["beta"],
        renormalisation=RenormalisationType(cfg["renormalisation"]))
    hb = cfg["heatbath"]

    def factory(a):
        return OverrelaxedHeatBathSampler(
            a, n_sweep_heatbath=hb["n_sweep_heatbath"],
            n_sweep_overrelax=hb["n_sweep_overrelax"],
            n_burnin=hb["n_burnin"], use_pallas=True)

    if cfg["coarsesampler"] != "heatbath":
        from perfbench.harness import CellError
        raise CellError(f"coarse sampler {cfg['coarsesampler']!r}: the "
                        f"fused path builds heat-bath coarse chains only")
    mlmc = cfg["multilevelmc"]
    return MonteCarloMultiLevel(
        act, qoi_2d_susceptibility, coarse_sampler_factory=factory,
        conditioned_fine_action_factory=make_schwinger_conditioned_fine_action,
        n_level=mlmc["n_level"], n_burnin=mlmc["n_burnin"],
        epsilon=mlmc["epsilon"], n_samples=n_samples,
        n_autocorr_window=cfg["n_autocorr_window"],
        n_min_samples_qoi=cfg["n_min_samples_qoi"],
        chunk_size=mlmc["chunk_size"], use_pallas=True)


def set_up(mc, seed: int, n_chains: int, dtype, device):
    """``evaluate`` to its fixed per-level target: the set-up a user's run
    pays (prepare, warm chunks, burn-in, the t_sub update, the cost probe,
    one fixed pass).  Returns the generator it drew from and the carries
    of every level, finest first."""
    gen = torch.Generator().manual_seed(int(seed))
    mc.evaluate(gen, n_chains=n_chains, dtype=dtype, device=device)
    carries, carry_L = mc.final_carries
    return gen, list(carries) + [carry_L]


def levels(mc):
    """Per level, finest first: its kernel ("k4" on a fine level, "k3" on
    the coarsest), fine lattice (Mt, Mx), beta, t_sub and recorded samples
    a launch.  Raises ``harness.CellError`` where a level does not run
    fused: the fused path measures the fused kernels."""
    out = []
    L = mc.n_level
    for ell in range(L):
        if not mc._is_fused(ell):
            from perfbench.harness import CellError
            raise CellError(f"level {ell} does not run fused on this "
                            f"device: not the fused path")
        lat = mc.actions[ell].lattice
        out.append({"kind": "k3" if ell == L - 1 else "k4",
                    "Mt": lat.Mt_lat, "Mx": lat.Mx_lat,
                    "beta": mc.actions[ell].beta,
                    "t_sub": mc._t_sub[ell if ell < L - 1 else -1],
                    "chunk": mc._level_chunk(ell)})
    return out


def chunk_functions(mc, wrap):
    """The chunk function of every level, finest first, each as ``_chunk``
    builds it, with its kernel replaced by ``wrap(ell, kind, kernel)`` for
    the function's lifetime (the harness taps the kernel's inputs and
    outputs through it; a control or a fault replaces it).  Each is
    ``chunk(seed, carry, n_active) -> (carry, ybar)``."""
    import importlib
    L = mc.n_level
    fns = []
    for ell in range(L):
        kind = "k3" if ell == L - 1 else "k4"
        mod_name, attr = K3_OP if kind == "k3" else K4_OP
        mod = importlib.import_module(mod_name)
        kernel = getattr(mod, attr)
        setattr(mod, attr, wrap(ell, kind, kernel))
        try:
            fns.append(mc._chunk(ell))
        finally:
            setattr(mod, attr, kernel)
    return fns


def with_fresh_y(mc, ell: int, carry, n_chains: int, dtype, device):
    """The carry with level ell's Y statistics started empty: the window's
    variance and tau come from its own samples alone."""
    st_y = mc.stats_qoi[ell].init(n_chains, dtype, device)
    if ell == mc.n_level - 1:
        return (carry[0], st_y, *carry[2:])
    return (carry[0], carry[1], st_y, *carry[3:])


@contextlib.contextmanager
def record_replaced(make):
    """While the block runs, the program's statistics update
    ``record_block(state, Qs, n_valid=None)`` is ``make(record_block)``
    (nothing is replaced where ``make`` is None).  The level chunks look
    it up at each call."""
    if make is None:
        yield
        return
    from mlmcpathintegral_tpu_torch.utils import statistics
    original = statistics.record_block
    statistics.record_block = make(original)
    try:
        yield
    finally:
        statistics.record_block = original


def y_stats(mc, ell: int, carry):
    """Level ell's Y statistics state in its carry."""
    return carry[1] if ell == mc.n_level - 1 else carry[2]


def timings(mc) -> dict:
    """``evaluate``'s wall seconds by phase."""
    return dict(mc.timings)
