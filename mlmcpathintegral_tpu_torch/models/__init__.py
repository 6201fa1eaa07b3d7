from mlmcpathintegral_tpu_torch.models.base import Action, RenormalisationType
from mlmcpathintegral_tpu_torch.models.qft.schwinger import (
    QuenchedSchwingerAction,
)
