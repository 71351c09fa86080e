"""Build, load and count the port's hand-written CUDA kernels.

The sources are ``csrc/*.cu``: plain C entry points, compiled at first use
with ``nvcc`` for ``sm_90a`` (one process a source, all at once, then one
link) into one shared library under ``_build/``
(named by a hash of the sources and flags, so an edited source is never
served a stale build) and bound with :mod:`ctypes`.  Every entry point
launches on the caller's CUDA stream and returns ``cudaGetLastError()``;
:func:`check` raises on anything but 0.

:data:`launches` counts kernel launches by wrapper name.  A wrapper adds
one where it launches its kernel on the card, and nowhere else, so a run
can show which kernels its path went through; :data:`batched_launches`
counts, in the same places, the launches that took a batch of more than
one sample, so a run can show that its samples went through a kernel
together.  Both are the counters of :mod:`.tracing`, the same objects.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import subprocess
import threading

from .tracing import batched_launches, launches, reset_launches

__all__ = [
    "build",
    "build_log",
    "check",
    "batched_launches",
    "int_array",
    "launches",
    "lib",
    "require_cuda",
    "reset_launches",
    "stream_of",
]

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
_BUILD = os.path.join(_HERE, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "nt_expand_to_grid": (_P, _P, _P, ctypes.POINTER(_I), _I, _P),
    "nt_collapse_from_grid": (_P, _P, _P, _P, _I, _I, _P, _I, _P, ctypes.POINTER(_I), _I, _P),
    "nt_collapse_from_grid_rows": (_P, _P, _P, _P, _P, _I, _I, _P, _I, _P, _I, ctypes.POINTER(_I),
                                   _I, _P),
    "nt_hartley_rows": (_P, _P, _I, _I, _I, _P, _P, ctypes.POINTER(_I), _I, _I, _P),
    "nt_hartley_cols": (
        _P, _P, _I, _I, _I, ctypes.c_longlong, ctypes.c_longlong, _I, _I, _P, _P,
        ctypes.POINTER(_I), _I, _I, _I, _I, _I, _I, _P
    ),
    "nt_legendre_contract": (_P,) * 7 + (_I,) * 10 + (_P,),
    "nt_legendre_contract_t": (_P,) * 8 + (_I,) * 10 + (_P,),
    "nt_philox_normal": (_P, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_uint, ctypes.c_uint,
                         ctypes.c_uint, _I, _P),
}

_lock = threading.Lock()
_lib = None
_build_log = ""


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (nvcc is needed to build the kernels)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build(verbose: bool = False) -> str:
    """Compile ``csrc/*.cu`` into the kernel library unless a build of the
    same sources exists; return its path.  ``verbose`` adds ``-Xptxas -v``
    (registers, shared memory and spills per kernel), readable afterwards
    through :func:`build_log`."""
    global _build_log
    sources = sorted(glob.glob(os.path.join(_CSRC, "*.cu")))
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())  # -Xptxas -v changes no code
    for src in sources:
        with open(src, "rb") as f:
            h.update(f.read())
    path = os.path.join(_BUILD, f"libnifty_tpu_torch_{h.hexdigest()[:16]}.so")
    if os.path.exists(path):
        return path
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    report = ("-Xptxas", "-v") if verbose else ()
    # one nvcc a source, all started together, then one link
    objs = [f"{tmp}.{os.path.basename(src)}.o" for src in sources]
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    procs = [subprocess.Popen([_nvcc(), *compile_flags, *report, "-c", "-o", obj, src],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objs)]
    logs = [pr.communicate()[0] for pr in procs]
    _build_log = "".join(logs)
    bad = [(src, pr.returncode) for src, pr in zip(sources, procs) if pr.returncode != 0]
    if not bad:
        res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *objs], capture_output=True,
                             text=True)
        _build_log += res.stdout + res.stderr
        bad = [("link", res.returncode)] if res.returncode != 0 else []
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    if bad:
        raise RuntimeError(f"nvcc failed ({bad}):\n{_build_log}")
    os.replace(tmp, path)
    return path


def build_log() -> str:
    """The compiler's output from the last build in this process."""
    return _build_log


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            handle.nt_error_string.argtypes = (ctypes.c_int,)
            handle.nt_error_string.restype = ctypes.c_char_p
            _lib = handle
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if err != 0:
        msg = lib().nt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def require_cuda(t, what: str, dtype, shape_ok: bool) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` whose
    shape the kernel takes (``shape_ok``)."""
    if t.device.type != "cuda":
        raise ValueError(f"{what}: tensor on {t.device}; CPU or CUDA expected")
    if t.dtype != dtype:
        raise TypeError(f"{what}: dtype {t.dtype}; {dtype} expected")
    if not shape_ok:
        raise ValueError(f"{what}: shape {tuple(t.shape)} outside the kernel's domain")
    if not t.is_contiguous():
        raise ValueError(f"{what}: tensor must be contiguous")


def stream_of(t) -> int:
    """The current CUDA stream of tensor ``t``'s device, as an integer."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def int_array(values):
    """A ctypes int array (kept alive by the caller) from a sequence."""
    return (ctypes.c_int * len(values))(*values)
