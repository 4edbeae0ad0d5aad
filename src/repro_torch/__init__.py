"""repro_torch — the SDFLMQ federated round in PyTorch, with hand-written
CUDA kernels for NVIDIA Hopper (``sm_90a``).

Module paths mirror the JAX package ``repro`` (``repro_torch/core/fl_step.py``
↔ ``repro/core/fl_step.py``), and parameters are the same nested dicts with
the same ``"/"``-joined leaf names, so ParamFilter globs and wire names mean
the same thing in both.  The numpy-only control plane (``api``, ``core``
brokers/coordinator/clients, ``configs``, ``data``, ``ft``) is a verbatim
copy with its imports pointed here; this package imports nothing of
``repro`` and nothing of JAX.

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``; on the CPU every kernel wrapper takes its plain PyTorch
version, on a CUDA tensor it launches the kernel or raises.
"""
