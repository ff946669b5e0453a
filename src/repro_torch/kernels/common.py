"""What the CUDA kernel wrappers share: input checks, the ctypes call and
its error check."""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

# A block may use at most this much dynamic shared memory on Hopper
# (227 KB of the SM's 256 KB, after cudaFuncSetAttribute).
MAX_SMEM_BYTES = 232448


def check_inputs(name: str, floats: dict, ints: dict, *, strided=(),
                 int_dtype=torch.int32) -> torch.device:
    """Raise unless every tensor is a CUDA tensor on one device, ``floats``
    fp32 and ``ints`` of ``int_dtype``, each contiguous, or for the names in
    ``strided`` at least unit-strided on its last dimension with every
    element offset within a C int. Returns the device."""
    dev = next(iter(floats.values())).device
    for arg, t in {**floats, **ints}.items():
        want = torch.float32 if arg in floats else int_dtype
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: {arg} is on {t.device}; every input "
                             f"must lie on the CUDA device {dev}")
        if t.dtype != want:
            raise ValueError(f"{name}: {arg} is {t.dtype}; the kernel takes "
                             f"{want}")
        if arg in strided:
            span = sum((n - 1) * st for n, st in zip(t.shape, t.stride()))
            if t.stride(-1) != 1 or span >= 2 ** 31:
                raise ValueError(f"{name}: {arg} needs a unit stride on its "
                                 "last dimension and offsets below 2**31")
        elif not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    return dev


# C entries already bound, with their argument types: binding costs more
# host time per call than the rest of the call
_entries: dict = {}


def launch(name: str, entry: str, *args) -> None:
    """Call the C entry ``entry`` of ``csrc/<name>.cu`` on the current
    stream: tensors pass as device pointers, ints as C ints, and the
    stream last. Raises if the launch reports a CUDA error."""
    fn = _entries.get((name, entry))
    if fn is None:
        fn = getattr(build.load(name), entry)
        fn.argtypes = [ctypes.c_void_p if isinstance(a, torch.Tensor)
                       else ctypes.c_int for a in args] + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _entries[name, entry] = fn
    err = fn(*[a.data_ptr() if isinstance(a, torch.Tensor) else int(a)
               for a in args], torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry}: CUDA error {err} at launch")


@functools.lru_cache(maxsize=4096)
def query(name: str, entry: str, *args: int) -> int:
    """What a kernel's source says a launch needs, such as bytes of shared
    memory or workspace: the host-side C entry ``entry`` of
    ``csrc/<name>.cu``, which takes ints and returns a long long. Cached
    by its arguments (call ``query.cache_clear()`` after swapping the
    library)."""
    fn = getattr(build.load(name), entry)
    fn.argtypes = [ctypes.c_int] * len(args)
    fn.restype = ctypes.c_longlong
    return int(fn(*args))

