from mlmcpathintegral_tpu_torch.parallel.chains import (
    ChainMesh, Mesh, chain_mesh, chain_offset, distribute_n, gather_chains,
    make_mesh, shard_chains,
)
from mlmcpathintegral_tpu_torch.parallel.multihost import (
    global_chain_mesh, initialize_multihost, per_host_chains,
)
