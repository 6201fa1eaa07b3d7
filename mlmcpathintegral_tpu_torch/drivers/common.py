"""Shared driver wiring: sampler factories, parallel setup (PyTorch port of
``mlmcpathintegral_tpu/drivers/common.py``).

The analog of ``construct_sampler_factory`` in the reference drivers
(driver_qm.cc:37-95): builds per-action sampler factories from the parsed
config sections so that the multilevel method can instantiate samplers on
any level.
"""

from __future__ import annotations

import warnings

import torch

from mlmcpathintegral_tpu_torch.ops import _cuda
from mlmcpathintegral_tpu_torch.samplers.cluster import ClusterSampler
from mlmcpathintegral_tpu_torch.samplers.exact import ExactSampler
from mlmcpathintegral_tpu_torch.samplers.heatbath import (
    OverrelaxedHeatBathSampler,
)
from mlmcpathintegral_tpu_torch.samplers.hierarchical import (
    HierarchicalSampler,
)
from mlmcpathintegral_tpu_torch.samplers.hmc import HMCSampler
from mlmcpathintegral_tpu_torch.samplers.multilevel import MultilevelSampler
from mlmcpathintegral_tpu_torch.utils.config import Section

SAMPLER_CHOICES = {"HMC", "heatbath", "cluster", "exact", "hierarchical",
                   "multilevel"}


def parallel_setup(config, device="cuda"):
    """(n_chains, dtype, device) from the optional ``parallel`` section
    (the analogue of choosing the number of MPI ranks).  The chains live
    on the card unless the caller asks for the CPU; the card's kernels
    take float32."""
    sec = Section(config, "parallel",
                  defaults={"n_chains": 128, "dtype": "float32"})
    dtype_name = sec.get_string("dtype", {"float32", "float64"})
    n_chains = sec.get_int("n_chains", positive=True)
    dtype = torch.float64 if dtype_name == "float64" else torch.float32
    return n_chains, dtype, _cuda.run_device(device)


def make_sampler_factory(name: str, config, cond_factory=None,
                         cluster_cls=ClusterSampler, qoi_factory=None):
    """Return ``factory(action) -> Sampler`` for the named sampler type.

    ``cond_factory`` (needed for the hierarchical/multilevel samplers)
    builds the conditioned fine action per level; ``cluster_cls`` lets the
    QFT driver substitute the Schwinger cluster sampler; ``qoi_factory``
    supplies the per-level QoI the multilevel sampler's tau-adaptive walk
    tracks."""
    if name == "HMC":
        sec = Section(config, "hmc",
                      defaults={"nt": 100, "dt": 0.1, "n_rep": 1,
                                "n_burnin": 100, "use_pallas": False})
        return lambda action: HMCSampler(
            action, nt=sec.get_int("nt", positive=True),
            dt=sec.get_float("dt", positive=True),
            n_rep=sec.get_int("n_rep", positive=True),
            n_burnin=sec.get_int("n_burnin", positive=True),
            use_pallas=sec.get_bool("use_pallas"))
    if name == "heatbath":
        sec = Section(config, "heatbath",
                      defaults={"n_sweep_heatbath": 1,
                                "n_sweep_overrelax": 1,
                                "n_burnin": 100, "random_order": True,
                                "use_pallas": False})
        # the reference's random_order shuffles its sequential site loop
        # (overrelaxedheatbathsampler.cc:8-31); the sweep here is
        # checkerboard-coloured (all conflict-free sites update at once),
        # which supersedes any site ordering: validate the key and say it
        # has no effect
        if "random_order" in config.get("heatbath", {}):
            sec.get_bool("random_order")
            warnings.warn(
                "heatbath.random_order has no effect: the sweep is "
                "checkerboard-coloured (samplers/heatbath.py), which "
                "replaces the reference's sequential site ordering",
                stacklevel=2)
        return lambda action: OverrelaxedHeatBathSampler(
            action,
            n_sweep_heatbath=sec.get_int("n_sweep_heatbath", positive=True),
            n_sweep_overrelax=sec.get_int("n_sweep_overrelax",
                                          positive=True),
            n_burnin=sec.get_int("n_burnin", positive=True),
            use_pallas=sec.get_bool("use_pallas"))
    if name == "cluster":
        sec = Section(config, "clusteralgorithm",
                      defaults={"n_burnin": 100, "n_updates": 10})
        return lambda action: cluster_cls(
            action, n_burnin=sec.get_int("n_burnin", positive=True),
            n_updates=sec.get_int("n_updates", positive=True))
    if name == "exact":
        return ExactSampler
    if name in ("hierarchical", "multilevel"):
        sec = Section(config, "hierarchical",
                      defaults={"n_max_level": 3, "coarsesampler": "HMC"})
        coarse_name = sec.get_string("coarsesampler", SAMPLER_CHOICES)
        coarse_factory = make_sampler_factory(coarse_name, config,
                                              cond_factory, cluster_cls,
                                              qoi_factory)
        n_max_level = sec.get_int("n_max_level", positive=True)
        if name == "hierarchical":
            if cond_factory is None:
                raise ValueError("hierarchical sampler needs a conditioned "
                                 "fine action factory")
            return lambda action: HierarchicalSampler(
                action, coarse_factory, cond_factory,
                n_max_level=n_max_level)
        if cond_factory is None or qoi_factory is None:
            raise ValueError("multilevel sampler needs conditioned fine "
                             "action and QoI factories")
        return lambda action: MultilevelSampler(
            action, qoi_factory, coarse_factory, cond_factory,
            n_max_level=n_max_level)
    raise ValueError(f"unknown sampler '{name}'")


# ---------------------------------------------------------------------------
# the methods' runs and the report, shared by drivers/qm.py and
# drivers/qft.py
# ---------------------------------------------------------------------------

def statistics_settings(config):
    """(n_autocorr_window, n_min_samples_qoi) of the statistics section."""
    sec = Section(config, "statistics",
                  defaults={"n_autocorr_window": 20,
                            "n_min_samples_qoi": 100})
    return (sec.get_int("n_autocorr_window", positive=True),
            sec.get_int("n_min_samples_qoi", positive=True))


def run_singlelevel(config, sec, action, qoi, sampler, generator, n_chains,
                    dtype, device, sampling_scope=None):
    """The single-level method from its section ``sec``: runs, prints the
    statistics (and the hierarchical sampler's per-level acceptance) and
    returns (numerical, error, result fields).  ``sampling_scope``, here
    and in the other methods' runs: the method's (a context manager
    entered around the phase that records the estimate's samples)."""
    from mlmcpathintegral_tpu_torch.mc.singlelevel import (
        MonteCarloSingleLevel,
    )
    n_autocorr, n_min_samples = statistics_settings(config)
    mc = MonteCarloSingleLevel(
        action, qoi, sampler,
        n_burnin=sec.get_int("n_burnin", positive=True),
        n_samples=sec.get_int("n_samples", non_negative=True),
        epsilon=sec.get_float("epsilon", positive=True),
        n_autocorr_window=n_autocorr,
        n_min_samples_qoi=n_min_samples,
        qoi_log_path=config.get("singlelevelmc", {}).get("qoi_log_path"),
        save_states_path=config.get("singlelevelmc", {}).get(
            "save_states_path"))
    sstate, stats = mc.evaluate(generator, n_chains, dtype, device,
                                verbose=True, sampling_scope=sampling_scope)
    mc.show_statistics(stats)
    print(f" sampler acceptance p = {mc.p_accept:.5f}")
    result = dict(tau_int=mc.stats_Q.tau_int(stats),
                  variance=mc.stats_Q.variance(stats),
                  samples=mc.stats_Q.samples(stats),
                  sampling_draws=mc.n_sampling_draws, p_accept=mc.p_accept,
                  timings=dict(mc.timings))
    if hasattr(mc.sampler, "show_stats"):
        # per-level acceptance of the hierarchical sampler
        # (hierarchicalsampler.cc:90-117)
        print("=== Per-level sampler statistics ===")
        mc.sampler.show_stats(sstate)
        result["level_acceptance"] = mc.sampler.acceptance(sstate)
    if hasattr(mc.sampler, "t_indep"):
        result["level_t_indep"] = mc.sampler.t_indep(sstate).tolist()
    return mc.numerical_result(stats), mc.statistical_error(stats), result


def run_twolevel(sec, action, qoi_factory, sampler_factory, cond_factory,
                 generator, n_chains, dtype, device, sampling_scope=None,
                 **windows):
    """The two-level method (``windows``: the autocorrelation windows
    MonteCarloTwoLevel takes): runs, prints the statistics and returns
    (mean of the fine QoI, its error, result fields)."""
    from mlmcpathintegral_tpu_torch.mc.twolevel import MonteCarloTwoLevel
    mc = MonteCarloTwoLevel(
        action, qoi_factory, sampler_factory, cond_factory,
        n_burnin=sec.get_int("n_burnin", positive=True),
        n_samples=sec.get_int("n_samples", positive=True), **windows)
    stats = mc.evaluate_difference(generator, n_chains, dtype, device,
                                   verbose=True,
                                   sampling_scope=sampling_scope)
    mc.show_statistics(stats)
    fine = stats["fine"]
    result = dict(tau_int=mc.stats_fine.tau_int(fine),
                  variance=mc.stats_fine.variance(fine),
                  samples=mc.stats_fine.samples(fine),
                  sampling_draws=mc.n_sampling_draws,
                  p_accept=mc.p_accept, t_indep=mc.t_indep,
                  diff=(mc.stats_diff.average(stats["diff"]),
                        mc.stats_diff.error(stats["diff"])),
                  timings=dict(mc.timings))
    return mc.stats_fine.average(fine), mc.stats_fine.error(fine), result


def run_multilevel(config, action, qoi_factory, coarse_factory,
                   cond_factory, generator, n_chains, dtype, device,
                   sampling_scope=None):
    """The multilevel method from the ``multilevelmc`` section: runs,
    prints the estimate (and with ``show_detailed_stats`` each level's
    statistics) and returns (numerical, error, result fields)."""
    from mlmcpathintegral_tpu_torch.mc.multilevel import MonteCarloMultiLevel
    sec = Section(config, "multilevelmc",
                  defaults={"n_level": 3, "n_burnin": 100, "epsilon": 1.0,
                            "n_samples": 0, "show_detailed_stats": False,
                            "sampler": "hierarchical"})
    n_autocorr, n_min_samples = statistics_settings(config)
    mc = MonteCarloMultiLevel(
        action, qoi_factory, coarse_factory, cond_factory,
        n_level=sec.get_int("n_level", positive=True),
        epsilon=sec.get_float("epsilon", positive=True),
        n_burnin=sec.get_int("n_burnin", positive=True),
        n_samples=sec.get_int("n_samples", non_negative=True),
        n_autocorr_window=n_autocorr,
        n_min_samples_qoi=n_min_samples)
    stats = mc.evaluate(generator, n_chains, dtype, device, verbose=True,
                        sampling_scope=sampling_scope)
    numerical, stat_err = mc.numerical_result(), mc.statistical_error()
    mc.show_statistics()
    if sec.get_bool("show_detailed_stats"):
        mc.show_detailed_statistics()
    result = dict(timings=dict(mc.timings),
                  level_tau_int=[mc.stats_qoi[ell].tau_int(stats[ell])
                                 for ell in range(mc.n_level)],
                  level_samples=[mc.stats_qoi[ell].samples(stats[ell])
                                 for ell in range(mc.n_level)])
    return numerical, stat_err, result


def report(analytic: dict, qoi_name: str, numerical: float,
           stat_err: float) -> dict:
    """The analytic lines and |numerical - analytical| in units of the
    statistical error (driver_qm.cc:411-425); returns {"numerical",
    "error", "analytical", "sigma_dev"} (None where the model has no
    analytic value)."""
    print()
    for label, value in analytic.items():
        print(f" {qoi_name} [{label}]  = {value:.6f}")
    ana = analytic.get("analytical")
    dev = None
    if ana is not None:
        dev = abs(numerical - ana) / stat_err
        print(f" |numerical - analytical| = {abs(numerical - ana):.6f}"
              f" = {dev:.2f} * statistical error")
    return dict(numerical=numerical, error=stat_err, analytical=ana,
                sigma_dev=dev)


def banner(action, method, n_chains, dtype, device) -> None:
    print("+--------------------------------+")
    print("! multilevel MCMC (PyTorch)      !")
    print("+--------------------------------+")
    print(f"action  : {action.info_string()}")
    print(f"method  : {method}")
    print(f"chains  : {n_chains}  dtype: {dtype}  device: {device}")
    print()
