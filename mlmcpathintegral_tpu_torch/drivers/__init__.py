"""Config-file drivers of the port (the analogs of the reference's
``driver_qm`` / ``driver_qft`` executables); run one with
``python -m mlmcpathintegral_tpu_torch.drivers.qm <parameters.in>`` or
``python -m mlmcpathintegral_tpu_torch.drivers.qft <parameters.in>``."""
