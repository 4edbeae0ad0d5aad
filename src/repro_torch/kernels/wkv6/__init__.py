"""repro_torch.kernels.wkv6"""
