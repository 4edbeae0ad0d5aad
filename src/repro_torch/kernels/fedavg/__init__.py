"""repro_torch.kernels.fedavg"""
