from mlmcpathintegral_tpu_torch.distributions.approxbesselproduct import (
    ApproximateBesselProductDistribution,
)
from mlmcpathintegral_tpu_torch.distributions.besselproduct import (
    BesselProductDistribution,
)
from mlmcpathintegral_tpu_torch.distributions.compactexp import (
    CompactExpDistribution,
)
from mlmcpathintegral_tpu_torch.distributions.expcos import (
    ExpCosDistribution,
)
from mlmcpathintegral_tpu_torch.distributions.expsin2 import (
    ExpSin2Distribution,
)
from mlmcpathintegral_tpu_torch.distributions.gaussianfillin import (
    GaussianFillinDistribution,
)
from mlmcpathintegral_tpu_torch.distributions.rejection import (
    batched_rejection_sample,
)
