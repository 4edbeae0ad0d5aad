"""repro_torch.kernels.ssm_scan"""
