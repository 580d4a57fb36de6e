"""PyTorch/CUDA port of the BrainScaleS-2 analog-inference reproduction.

The package mirrors the JAX package ``repro`` file for file
(``repro/X/Y.py`` -> ``repro_torch/X/Y.py``).  Plain tensor code is
PyTorch; every kernel the JAX package wrote in Pallas is a CUDA kernel
written by hand for Hopper (``csrc/*.cu``), built at first use by
:mod:`repro_torch.kernels._build`.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; on CPU tensors every kernel wrapper runs its plain
PyTorch version instead.  The package never imports JAX or ``repro``.
"""
