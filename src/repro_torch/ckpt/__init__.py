"""repro_torch.ckpt"""
