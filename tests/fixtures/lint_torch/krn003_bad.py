"""Seeded KRN003: a failed kernel build hidden behind the plain path."""
from repro_torch.kernels import _build


def scale(x, out):
    try:
        lib = _build.load("scale")
    except RuntimeError:
        return x * 2
    code = lib.scale_launch(x.data_ptr(), out.data_ptr(), x.numel(),
                            _build.stream_ptr(x))
    _build.check(lib, code, "scale_launch")
    _build.count_launch(scale)
    return out


scale.launches = 0
