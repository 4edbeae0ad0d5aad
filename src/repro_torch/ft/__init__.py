"""repro_torch.ft"""
