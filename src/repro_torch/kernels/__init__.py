"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (``ref.py``) and its wrapper (``ops.py``). Sources live in
``repro_torch/csrc``; ``_build`` compiles them at first use."""
