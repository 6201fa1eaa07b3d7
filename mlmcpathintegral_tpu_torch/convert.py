"""State conversion between the JAX package and the PyTorch port.

The two packages hold the same state in the same layouts — link fields
[C, 2*Mx*Mt] in the reference's linear order, GFF fields [C, N] (vertex
l = Mt*j + i, or the rotated lattice's order), sigma-model angle states
[C, 2N] ((theta, phi) a vertex, the same vertex order), rotor paths [C, M],
``TwoLevelState``, ``StatsState``, the sampler states (``HeatBathState``,
``ClusterState``, ``Cluster2DState``, ``SchwingerClusterState(x, psi)``,
``HMCState(x, dt)``, ``ExactState``), the per-level chunk carries (nested
tuples of those and of 0-d counters) — as JAX arrays and as torch
tensors.  This module
carries such state across, as numpy arrays, in both directions:
:func:`to_torch` takes any nesting of tuples/lists/NamedTuples with
array-like leaves (numpy or JAX arrays) and returns the port's types;
:func:`to_numpy` returns numpy leaves, rebuilding NamedTuples as the
classes given in ``types`` (by class name), e.g. the JAX package's own.
It is the port's analogue of carrying weights across, and what lets a
test start both packages from the same state.  It imports no JAX.

State also crosses on disk: ``utils/checkpoint.py`` writes and reads the
JAX package's checkpoint format (``leaf_i`` arrays and a ``__meta__``
record, leaves in the JAX leaf order), so ``load_checkpoint`` restores a
file the JAX package's ``save_checkpoint`` wrote of a ``StatsState`` or
of a sampler state with the same fields into the port's template.
"""

from __future__ import annotations

import numpy as np
import torch

from mlmcpathintegral_tpu_torch.mc.twolevelstep import TwoLevelState
from mlmcpathintegral_tpu_torch.samplers.cluster import ClusterState
from mlmcpathintegral_tpu_torch.samplers.cluster2d import Cluster2DState
from mlmcpathintegral_tpu_torch.samplers.exact import ExactState
from mlmcpathintegral_tpu_torch.samplers.heatbath import HeatBathState
from mlmcpathintegral_tpu_torch.samplers.hmc import HMCState
from mlmcpathintegral_tpu_torch.samplers.schwingercluster import (
    SchwingerClusterState,
)
from mlmcpathintegral_tpu_torch.utils.statistics import StatsState

#: the port's state classes, by the class name both packages use
PORT_TYPES = {cls.__name__: cls
              for cls in (HeatBathState, ClusterState, SchwingerClusterState,
                          TwoLevelState, StatsState, HMCState, ExactState,
                          Cluster2DState)}


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def to_torch(tree, device="cuda", dtype=None):
    """Array-like leaves -> torch tensors on ``device`` (floating leaves
    cast to ``dtype`` if given; integer leaves keep their type);
    NamedTuples -> the port's class of the same name."""
    if _is_namedtuple(tree):
        cls = PORT_TYPES.get(type(tree).__name__)
        if cls is None:
            raise TypeError(f"no port type for {type(tree).__name__}")
        return cls(*[to_torch(x, device, dtype) for x in tree])
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_torch(x, device, dtype) for x in tree)
    if isinstance(tree, (int, float)):
        return tree
    t = torch.from_numpy(np.array(tree))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def to_numpy(tree, types=None):
    """Tensor and array-like leaves -> numpy arrays (copies); NamedTuples
    rebuilt as
    ``types[class name]`` when given (else kept as the port's class)."""
    if _is_namedtuple(tree):
        cls = (types or {}).get(type(tree).__name__, type(tree))
        return cls(*[to_numpy(x, types) for x in tree])
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_numpy(x, types) for x in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if hasattr(tree, "__array__"):
        return np.array(tree)
    return tree


def action_constants(action, conditioned=None) -> dict:
    """The constants a fused level bakes in: beta, the coarse beta_c and,
    for the exact (beta <= 8) fill, the BesselProduct normalisation series
    ``alphaZ``, ``log_I0_twobeta`` and ``sigma_beta``.  Works on either
    package's QuenchedSchwingerAction and conditioned fine action (they
    share attribute names); values are plain floats / numpy arrays."""
    out = {"beta": float(action.beta),
           "beta_c": float(action.beta_coarse())}
    bessel = getattr(conditioned, "bessel", None)
    if bessel is not None:
        out.update(alphaZ=np.asarray(bessel.alphaZ, np.float64),
                   log_I0_twobeta=float(bessel.log_I0_twobeta),
                   sigma_beta=float(bessel.sigma_beta))
    return out


def qm_planes(x):
    """[C, M] QM paths -> the two-level kernel's [2, C, M/2] even and odd
    site planes, for torch tensors and for numpy or JAX arrays (numpy
    out)."""
    if isinstance(x, torch.Tensor):
        return torch.stack([x[..., ::2], x[..., 1::2]])
    x = np.asarray(x)
    return np.stack([x[..., ::2], x[..., 1::2]])


def qm_paths(fine):
    """[2, C, Mc] even/odd planes -> [C, 2 Mc] paths (torch or numpy)."""
    if isinstance(fine, torch.Tensor):
        return torch.stack([fine[0], fine[1]], dim=-1).flatten(-2)
    fine = np.asarray(fine)
    return np.stack([fine[0], fine[1]], axis=-1).reshape(
        *fine.shape[1:-1], -1)


def qm_s_cache(fine_action, conditioned, x):
    """The two-level kernel's [2, C] cache (S_fine, S_cond) of paths x,
    with either package's fine action and conditioned fill (x of that
    package's array type; numpy out for the JAX package)."""
    s_f, s_q = fine_action.evaluate(x), conditioned.evaluate(x)
    if isinstance(x, torch.Tensor):
        return torch.stack([s_f, s_q])
    return np.stack([np.asarray(s_f), np.asarray(s_q)])
