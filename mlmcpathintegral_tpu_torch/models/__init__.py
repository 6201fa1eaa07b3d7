from mlmcpathintegral_tpu_torch.models.base import (
    Action, QMAction, RenormalisationType,
)
from mlmcpathintegral_tpu_torch.models.harmonic import (
    HarmonicOscillatorAction,
)
from mlmcpathintegral_tpu_torch.models.qft.gff import GFFAction
from mlmcpathintegral_tpu_torch.models.qft.schwinger import (
    QuenchedSchwingerAction,
)
from mlmcpathintegral_tpu_torch.models.quartic import (
    QuarticOscillatorAction,
)
from mlmcpathintegral_tpu_torch.models.rotor import RotorAction
