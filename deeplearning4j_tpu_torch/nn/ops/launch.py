"""What every kernel wrapper of the port shares: the launch counter, the
ctypes binding of a built library, argument checks and the launch itself.

Each wrapper adds one to ``launch_counts[name]`` where it launches its
kernel, and nowhere else, so a run can show that its main path went
through the kernels: callers reset the counter to 0 around the work they
want to attribute. Every kernel module of ``nn/ops`` counts into this
counter.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import Dict, Tuple

import torch

from deeplearning4j_tpu_torch.nn.ops import build

#: kernel launches in this process, by kernel name; callers reset it to 0
#: around the work they want to attribute
launch_counts: "collections.Counter[str]" = collections.Counter()


class KernelLaunchError(RuntimeError):
    """A kernel launch was refused (the C function returned a nonzero
    ``cudaGetLastError``)."""


def reset_launch_counts() -> None:
    launch_counts.clear()


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


class KernelLibrary:
    """ctypes binding of one ``csrc/<name>.cu``, loaded (and built) on the
    first kernel call. ``signatures``: C function -> (pointer args, int
    args[, float args]), in that order, followed by the stream; every
    function returns a ``cudaError_t`` as int. ``tiles``: a C function
    ``int f(int which)`` giving the kernel's tile sizes, read into ``tile``
    by the keys of ``tile_keys``."""

    def __init__(self, name: str, signatures: Dict[str, Tuple[int, ...]],
                 tiles: str, tile_keys: str = "mnk"):
        self.name, self.signatures, self.tiles = name, signatures, tiles
        self.tile_keys = tile_keys
        self.handle = None
        self.tile: Dict[str, int] = {}

    def get(self):
        if self.handle is None:
            lib = build.load(self.name)
            for fn, (n_ptr, n_int, *n_float) in self.signatures.items():
                getattr(lib, fn).argtypes = ([_P] * n_ptr + [_I] * n_int
                                             + [_F] * sum(n_float) + [_P])
                getattr(lib, fn).restype = _I
            query = getattr(lib, self.tiles)
            query.argtypes, query.restype = [_I], _I
            self.tile = {k: int(query(i)) for i, k in enumerate(self.tile_keys)}
            self.handle = lib
        return self.handle


def check_kernel_args(op: str, x, specs) -> None:
    """``specs``: (name, tensor, dtype, shape) for every tensor the kernel
    reads; the kernel takes CUDA tensors of one device, of those types and
    shapes, contiguous."""
    if x.device.type != "cuda":
        raise ValueError(f"{op}: the kernel takes CUDA tensors, got {x.device}")
    for name, t, dt, shape in specs:
        if t.device != x.device:
            raise ValueError(f"{op}: {name} is on {t.device}, x on {x.device}")
        if t.dtype != dt:
            raise TypeError(f"{op}: {name} must be {dt}, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{op}: {name} must have shape {tuple(shape)}, "
                             f"got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(
                f"{op}: {name} must be contiguous (strides {t.stride()}); "
                "a strided view such as x[:, ::2, ::2, :] needs .contiguous()")


def launch(fn, op: str, args) -> None:
    """Call the C launcher ``fn`` on the current stream; raise if the launch
    was refused, else count it."""
    rc = fn(*args, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if rc != 0:
        raise KernelLaunchError(f"{op} kernel launch failed: cudaError {rc}")
    launch_counts[op] += 1


def ptrs(*ts):
    return tuple(t.data_ptr() for t in ts)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count
