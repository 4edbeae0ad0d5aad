"""The benchmark of the PyTorch/CUDA port of SDFLMQ: federated rounds of
the port's trainer on the card, measured over a window of seconds and
checked against a plain reference.  ``run.py`` runs one cell once."""
