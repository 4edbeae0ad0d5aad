"""repro_torch.examples"""
