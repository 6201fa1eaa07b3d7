"""Action interface (PyTorch port of ``mlmcpathintegral_tpu/models/base.py``).

An action is a plain object whose methods are batched tensor functions:
states are tensors ``[..., ndof]`` with all leading axes treated as chain
batch dimensions.  Parameters (beta, ...) are Python floats fixed per
multigrid level, as the reference instantiates one Action per level via
``coarse_action()``.  The default force is the autograd gradient of
``evaluate``, as the JAX package's is ``jax.grad`` of it; the actions with
a force of their own (the HMC models, the Schwinger action) override it.
"""

from __future__ import annotations

import abc
from enum import Enum

import torch

from mlmcpathintegral_tpu_torch.distributions.rejection import normal


class RenormalisationType(Enum):
    """Parameter renormalisation between multigrid levels
    (src/action/renormalisation.hh:17-41)."""
    NONE = "none"
    PERTURBATIVE = "perturbative"
    NONPERTURBATIVE = "nonperturbative"


class Action(abc.ABC):
    """Abstract action over batched states ``x: [..., ndof]``."""

    #: lattice descriptor (static metadata)
    lattice = None

    @property
    def ndof(self) -> int:
        """Number of degrees of freedom (action/action.hh sample_size)."""
        return self.lattice.ndof

    @property
    def evaluation_cost(self) -> int:
        return self.ndof

    @abc.abstractmethod
    def evaluate(self, x: torch.Tensor) -> torch.Tensor:
        """S[x] for batched states: [..., ndof] -> [...]."""

    def force(self, x: torch.Tensor) -> torch.Tensor:
        """dS/dx, batched.  Default: autograd of evaluate."""
        with torch.enable_grad():
            y = x.detach().requires_grad_(True)
            (grad,) = torch.autograd.grad(torch.sum(self.evaluate(y)), y)
        return grad

    @abc.abstractmethod
    def coarse_action(self) -> "Action":
        """Action on the next-coarser lattice with renormalised parameters."""

    @abc.abstractmethod
    def initialise_state(self, generator: torch.Generator, n_chains: int,
                         dtype: torch.dtype,
                         device: torch.device) -> torch.Tensor:
        """Fresh batched initial states [n_chains, ndof]."""

    @abc.abstractmethod
    def prolongate(self, x_coarse: torch.Tensor,
                   x_fine: torch.Tensor) -> torch.Tensor:
        """Inject coarse dofs into a fine state (copy_from_coarse)."""

    @abc.abstractmethod
    def restrict(self, x_fine: torch.Tensor) -> torch.Tensor:
        """Restrict a fine state to the coarse lattice (copy_from_fine)."""

    def info_string(self) -> str:
        return f"lattice = {self.ndof}"


class QMAction(Action):
    """Base for 1-D quantum-mechanics actions on ``Lattice1D``: the
    single-site conditioned-action geometry W (minimum + curvature given
    the two neighbours; action/qmaction.hh:79-215) used by heat-bath
    updates, and even-site injection/restriction (qmaction.cc:7-24)."""

    def __init__(self, lattice, renormalisation: RenormalisationType,
                 m0: float):
        self.lattice = lattice
        self.renormalisation = renormalisation
        self.m0 = float(m0)

    @property
    def a_lat(self) -> float:
        return self.lattice.a_lat

    @property
    def M_lat(self) -> int:
        return self.lattice.M_lat

    @abc.abstractmethod
    def getWminimum(self, x_m, x_p):
        """Minimum of the single-site conditioned action W_{x-,x+}(x)."""

    @abc.abstractmethod
    def getWcurvature(self, x_m, x_p):
        """Curvature W'' at the minimum."""

    def heatbath_site(self, generator, x_m, x_p, x_cur=None):
        """New site values from N(Wminimum, 1/Wcurvature) given the
        neighbours: exact for actions quadratic in one site (harmonic
        oscillator), the reference's Gaussian approximation for the
        quartic one (qmaction.hh:150-170).  ``x_cur`` is for rejection
        samplers that truncate their loops; the Gaussian draw ignores it."""
        mean = self.getWminimum(x_m, x_p)
        curv = self.getWcurvature(x_m, x_p)
        xi = normal(generator, mean.shape, mean.dtype, mean.device)
        return mean + xi / torch.sqrt(curv)

    def overrelax_site(self, x, x_m, x_p):
        """Overrelaxation: reflect x about the W minimum."""
        return 2.0 * self.getWminimum(x_m, x_p) - x

    def initialise_state(self, generator, n_chains, dtype, device):
        """Cold start: all sites zero."""
        return torch.zeros((n_chains, self.M_lat), dtype=dtype,
                           device=device)

    def prolongate(self, x_coarse, x_fine):
        """x_fine[..., 2j] = x_coarse[..., j] (qmaction.cc:7-15)."""
        out = x_fine.clone()
        out[..., ::2] = x_coarse
        return out

    def restrict(self, x_fine):
        """x_coarse[..., j] = x_fine[..., 2j] (qmaction.cc:17-24)."""
        return x_fine[..., ::2]
