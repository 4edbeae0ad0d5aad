"""repro_torch.optim"""
