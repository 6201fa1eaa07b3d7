from mlmcpathintegral_tpu_torch.models.base import (
    Action, QMAction, RenormalisationType,
)
from mlmcpathintegral_tpu_torch.models.qft.schwinger import (
    QuenchedSchwingerAction,
)
from mlmcpathintegral_tpu_torch.models.rotor import RotorAction
