"""repro_torch.serve"""
