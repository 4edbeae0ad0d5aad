"""repro_torch.kernels.quant8"""
