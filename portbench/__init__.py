"""portbench: the benchmark of the PyTorch and CUDA port (``posetpu_torch``)
on NVIDIA GPUs. See portbench/README.md."""
