"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into ``build/lib<name>-<hash>.so``, a shared library with a plain C
interface that the op modules load with ``ctypes``. The hash covers the
source and the compiler flags, so an edited source builds afresh and an
unchanged one is reused. The build directory is listed in ``.gitignore``.

Nothing is built at import: the first call of :func:`load` (or of
:func:`build_all`) builds. All sources compile in parallel, one ``nvcc``
process each. A missing ``nvcc`` or a failed build raises
:class:`KernelBuildError`; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().with_name("build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v", "-lineinfo")


class KernelBuildError(RuntimeError):
    """``nvcc`` is missing, or a kernel source failed to compile or load."""


class _Libraries:
    """The built libraries of this process: name -> ``ctypes.CDLL``, plus
    each build's compiler log (register and shared-memory use)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.paths: Dict[str, Path] = {}
        self.logs: Dict[str, str] = {}
        self.handles: Dict[str, ctypes.CDLL] = {}


_LIBS = _Libraries()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise KernelBuildError(
        "nvcc not found (PATH, CUDA_HOME): the CUDA kernels are built from "
        "source at first use and need the CUDA toolkit")


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    for extra in sorted(CSRC.glob("*.cuh")):
        h.update(extra.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every ``csrc/*.cu`` not yet built, all at once; returns
    name -> library path. Raises :class:`KernelBuildError` on failure."""
    with _LIBS.lock:
        todo = {}
        for src in sorted(CSRC.glob("*.cu")):
            if src.stem in _LIBS.paths:
                continue
            out = _target(src)
            if out.is_file():
                _LIBS.paths[src.stem] = out
            else:
                todo[src.stem] = (src, out)
        if not todo:
            return dict(_LIBS.paths)
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for name, (src, out) in todo.items():
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True), tmp, out)
        failed = []
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            _LIBS.logs[name] = log
            if proc.returncode != 0:
                failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
                tmp.unlink(missing_ok=True)
                continue
            os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
            _LIBS.paths[name] = out
        if failed:
            raise KernelBuildError("kernel build failed:\n" + "\n".join(failed))
        return dict(_LIBS.paths)


def build_log(name: str) -> str:
    """The compiler output of this process's build of ``name`` ("" when the
    library was already built by an earlier process)."""
    return _LIBS.logs.get(name, "")


def load(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built on first use)."""
    lib = _LIBS.handles.get(name)
    if lib is not None:
        return lib
    path = build_all().get(name)
    if path is None:
        raise KernelBuildError(f"no kernel source csrc/{name}.cu")
    with _LIBS.lock:
        if name not in _LIBS.handles:
            try:
                _LIBS.handles[name] = ctypes.CDLL(str(path))
            except OSError as e:
                raise KernelBuildError(f"cannot load {path}: {e}") from e
        return _LIBS.handles[name]
