"""repro_torch — the PyTorch + CUDA port of ``repro`` for NVIDIA Hopper.

The JAX package ``repro`` stays the reference; this package keeps its module
names (``models.gnn``, ``kernels.egnn_edge``, ``serve.engine``, ...) so a
reader can find each counterpart, and it imports neither ``jax`` nor
``repro``. Every Pallas TPU kernel on a ported path is a hand-written CUDA
C++ kernel under ``csrc/`` (built for ``sm_90a`` at first use, see
``kernels/_build.py``); its plain PyTorch version sits beside it and is what
runs for CPU tensors.

Entry points take an explicit ``device=``. Left as None they run on
``cuda`` and raise when no GPU is present — a CPU run must be asked for.
"""
from __future__ import annotations

import torch

# fp32 parity: the port is held to the JAX reference at 1e-5 (kernels) and
# 2e-5 (model) in fp32. TF32 keeps ~10 mantissa bits (~3 decimal digits), so
# a TF32 matmul in the φ_h MLP or the heads would break those tolerances on
# the card. PyTorch's matmul default is already fp32, cuDNN's is not; both
# are pinned here so the choice is explicit.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
# bf16 GEMMs sum in f32, as repro's `dense` (a bf16 `x @ w` that XLA
# accumulates in f32) does. At this flag's default (True) cuBLAS may add
# the split-K partial sums of a bf16 product in bf16, rounding the LM's
# q/k/v/o and SwiGLU products more often than the reference does.
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means ``cuda`` and raises when
    no GPU is available (a CPU run must be requested with ``device="cpu"``)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        return torch.device("cuda")
    return torch.device(device)
