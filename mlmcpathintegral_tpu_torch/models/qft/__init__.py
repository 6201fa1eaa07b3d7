from mlmcpathintegral_tpu_torch.models.qft.gff import GFFAction
from mlmcpathintegral_tpu_torch.models.qft.nonlinearsigma import (
    NonlinearSigmaAction, qoi_magnetic_susceptibility,
)
from mlmcpathintegral_tpu_torch.models.qft.schwinger import (
    QuenchedSchwingerAction, chit_analytical,
)
