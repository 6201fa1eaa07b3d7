from mlmcpathintegral_tpu_torch.utils.special import (
    Phi_chit, Phi_chit_perturbative, Sigma_hat, compute_In, fast_i0_scaled,
    gff_phi_squared_analytical, i0_scaled, log_2pi_i0_scaled, log_factorial,
    log_i0, log_nCk, mod_2pi, mod_pi,
)
from mlmcpathintegral_tpu_torch.utils.statistics import Statistics
from mlmcpathintegral_tpu_torch.utils.config import (
    Section, read_parameter_file,
)
from mlmcpathintegral_tpu_torch.utils.checkpoint import (
    checkpoint_metadata, load_checkpoint, save_checkpoint,
)
