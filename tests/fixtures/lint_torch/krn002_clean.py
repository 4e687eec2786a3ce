"""Clean twin of KRN002: the launch counted on its wrapper."""
from .. import _build


def _lib():
    return _build.load("scale")


def scale(x, out):
    lib = _lib()
    code = lib.scale_launch(x.data_ptr(), out.data_ptr(), x.numel(),
                            _build.stream_ptr(x))
    _build.check(lib, code, "scale_launch")
    _build.count_launch(scale)
    return out


scale.launches = 0
