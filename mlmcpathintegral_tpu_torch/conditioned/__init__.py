from mlmcpathintegral_tpu_torch.conditioned.base import ConditionedFineAction
from mlmcpathintegral_tpu_torch.conditioned.gff import (
    GFFConditionedFineAction,
)
from mlmcpathintegral_tpu_torch.conditioned.qm import (
    GaussianConditionedFineAction, RotorConditionedFineAction,
    make_conditioned_fine_action,
)
from mlmcpathintegral_tpu_torch.conditioned.schwinger import (
    QuenchedSchwingerConditionedFineAction,
    QuenchedSchwingerGaussianConditionedFineAction,
    QuenchedSchwingerSemiConditionedFineAction,
    make_schwinger_conditioned_fine_action,
)
from mlmcpathintegral_tpu_torch.conditioned.sigma import (
    NonlinearSigmaConditionedFineAction,
)
