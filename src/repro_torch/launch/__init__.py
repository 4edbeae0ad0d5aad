"""repro_torch.launch"""
