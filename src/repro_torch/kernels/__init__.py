"""Hand-written CUDA kernels (``csrc/``), their launch wrappers and their
plain PyTorch versions (:mod:`repro_torch.kernels.ref`).  Nothing here
builds or loads a kernel at import time."""
