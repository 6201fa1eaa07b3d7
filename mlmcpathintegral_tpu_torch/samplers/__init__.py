from mlmcpathintegral_tpu_torch.samplers.base import Sampler
from mlmcpathintegral_tpu_torch.samplers.cluster import (
    ClusterSampler, ClusterState,
)
from mlmcpathintegral_tpu_torch.samplers.cluster2d import (
    Cluster2DSampler, Cluster2DState,
)
from mlmcpathintegral_tpu_torch.samplers.exact import (
    ExactSampler, ExactState,
)
from mlmcpathintegral_tpu_torch.samplers.heatbath import (
    HeatBathState, OverrelaxedHeatBathSampler,
)
from mlmcpathintegral_tpu_torch.samplers.hierarchical import (
    HierarchicalSampler, HierarchicalState,
)
from mlmcpathintegral_tpu_torch.samplers.hmc import HMCSampler, HMCState
from mlmcpathintegral_tpu_torch.samplers.multilevel import (
    MultilevelSampler, MultilevelSamplerState,
)
from mlmcpathintegral_tpu_torch.samplers.schwingercluster import (
    QuenchedSchwingerClusterSampler, SchwingerClusterState,
)
