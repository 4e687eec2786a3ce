"""Clean twin of KRN001: the launch's code through ``_build.check``."""
from repro_torch.kernels import _build


def scale(x, out):
    lib = _build.load("scale")
    code = lib.scale_launch(x.data_ptr(), out.data_ptr(), x.numel(),
                            _build.stream_ptr(x))
    _build.check(lib, code, "scale_launch")
    _build.count_launch(scale)
    return out


scale.launches = 0
