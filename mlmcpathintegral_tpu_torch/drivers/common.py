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
from mlmcpathintegral_tpu_torch.samplers.hmc import HMCSampler
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


def make_sampler_factory(name: str, config, cluster_cls=ClusterSampler):
    """Return ``factory(action) -> Sampler`` for the named sampler type;
    ``cluster_cls`` lets the QFT driver substitute the Schwinger cluster
    sampler."""
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
        raise NotImplementedError(
            f"the {name} sampler (samplers/hierarchical.py, "
            f"samplers/multilevel.py) is not ported yet (ROADMAP.md, open "
            f"item 13)")
    raise ValueError(f"unknown sampler '{name}'")
