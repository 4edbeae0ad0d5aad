"""repro_torch.dist"""
