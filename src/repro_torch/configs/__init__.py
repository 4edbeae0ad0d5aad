"""repro_torch.configs"""
