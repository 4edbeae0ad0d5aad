"""repro_torch.train"""
