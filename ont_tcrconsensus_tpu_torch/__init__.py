"""PyTorch/CUDA port of the ONT TCR UMI consensus pipeline.

A package beside the JAX reference (``ont_tcrconsensus_tpu``) that imports
nothing of it: the host modules it needs are its own copies, the device
passes are PyTorch, and the JAX package's two Pallas kernels are
hand-written CUDA C++ for Hopper (``csrc/``), each beside its plain
PyTorch version. Entry point: ``python -m ont_tcrconsensus_tpu_torch
<run_config.json> [--cpu]``.
"""
