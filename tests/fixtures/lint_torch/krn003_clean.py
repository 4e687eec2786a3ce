"""Clean twin of KRN003: the plain path chosen by the tensor's device; a
failed build raises, with context."""
from repro_torch.kernels import _build


def scale(x, out):
    if not x.is_cuda:
        return x * 2
    try:
        lib = _build.load("scale")
    except RuntimeError as e:
        raise RuntimeError("the scale kernel did not build") from e
    code = lib.scale_launch(x.data_ptr(), out.data_ptr(), x.numel(),
                            _build.stream_ptr(x))
    _build.check(lib, code, "scale_launch")
    _build.count_launch(scale)
    return out


scale.launches = 0
