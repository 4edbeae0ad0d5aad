"""repro_torch.kernels"""
