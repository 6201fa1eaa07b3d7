from mlmcpathintegral_tpu_torch.samplers.base import Sampler
from mlmcpathintegral_tpu_torch.samplers.heatbath import (
    HeatBathState, OverrelaxedHeatBathSampler,
)
