"""Seeded KRN002: a launch no counter sees."""
from .. import _build


def _lib():
    return _build.load("scale")


def scale(x, out):
    lib = _lib()
    code = lib.scale_launch(x.data_ptr(), out.data_ptr(), x.numel(),
                            _build.stream_ptr(x))
    _build.check(lib, code, "scale_launch")
    return out
