"""repro_torch.kernels.flash_attn"""
