"""Build and bind the port's hand-written CUDA kernels.

Each kernel is one CUDA C++ source under `csrc/` with a plain C entry point.
It is compiled at first use by `nvcc` for `sm_90a` into a shared library
under `build/` beside this package (listed in `.gitignore`), named by a hash
of its source and flags so an edited source is rebuilt, and loaded with
`ctypes`. Nothing here runs when the module is imported: the CPU tests
import it on machines without `nvcc` or a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Callable, Iterable, Optional

_PACKAGE = pathlib.Path(__file__).resolve().parent.parent
CSRC_DIR = _PACKAGE / "csrc"
BUILD_DIR = _PACKAGE / "build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int

# kernel name -> (source under csrc/, C symbol, argtypes). Pointers and the
# stream are c_void_p: left to ctypes' default they would pass as 32-bit ints.
KERNELS = {
    "flash_attention": (
        "flash_attention.cu", "flash_attention_fwd",
        [_I32, _P, _P, _P, _P, _P] + [_I64] * 12
        + [_I32] * 5 + [ctypes.c_float, _I32, _I32, _P]),
}

_lock = threading.Lock()
_loaded: dict[str, Callable[..., int]] = {}


def source_path(name: str) -> pathlib.Path:
    return CSRC_DIR / KERNELS[name][0]


def library_path(name: str) -> pathlib.Path:
    digest = hashlib.sha256(
        source_path(name).read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the port's CUDA "
        "kernels are compiled from csrc/ at first use")


def build(names: Optional[Iterable[str]] = None) -> dict[str, str]:
    """Compile the named kernels (all by default) that are not built yet,
    one nvcc process per source, all started together. Returns
    {name: compiler output} for the kernels compiled by this call
    (register and shared-memory use, from `-Xptxas -v`)."""
    names = list(KERNELS if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    try:
        for name in names:
            out = library_path(name)
            if out.exists():
                continue
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source_path(name))]
            jobs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, out)
        logs, failed = {}, []
        for name, (proc, tmp, out) in jobs.items():
            logs[name] = proc.communicate()[0]
            if proc.returncode == 0:
                os.replace(tmp, out)  # atomic: a reader never sees half a file
            else:
                failed.append(name)
    finally:
        for proc, _, _ in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"--- {name}\n{logs[name]}" for name in failed))
    return logs


def entry(name: str) -> Callable[..., int]:
    """The kernel's C entry point, building and loading it on first use."""
    with _lock:
        fn = _loaded.get(name)
        if fn is None:
            build([name])
            _, symbol, argtypes = KERNELS[name]
            fn = getattr(ctypes.CDLL(str(library_path(name))), symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _loaded[name] = fn
        return fn
