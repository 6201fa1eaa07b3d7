from mlmcpathintegral_tpu_torch.mc.multilevel import MonteCarloMultiLevel
from mlmcpathintegral_tpu_torch.mc.singlelevel import MonteCarloSingleLevel
from mlmcpathintegral_tpu_torch.mc.twolevel import MonteCarloTwoLevel
from mlmcpathintegral_tpu_torch.mc.twolevelstep import (
    TwoLevelMetropolisStep, TwoLevelState,
)
