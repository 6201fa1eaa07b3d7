from mlmcpathintegral_tpu_torch.utils.special import (
    Phi_chit, Sigma_hat, compute_In, fast_i0_scaled, i0_scaled, log_factorial,
    log_i0, log_nCk, mod_2pi,
)
from mlmcpathintegral_tpu_torch.utils.statistics import Statistics
from mlmcpathintegral_tpu_torch.utils.timer import Timer
