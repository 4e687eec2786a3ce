"""Seeded KRN001: a launch whose error code is dropped."""
from repro_torch.kernels import _build


def scale(x, out):
    lib = _build.load("scale")
    lib.scale_launch(x.data_ptr(), out.data_ptr(), x.numel(),
                     _build.stream_ptr(x))
    _build.count_launch(scale)
    return out


scale.launches = 0
