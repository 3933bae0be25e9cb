"""Build, load and count the port's CUDA kernels.

Each source in ``repro_torch/csrc/*.cu`` is compiled by its own ``nvcc``
process (all started together) into a shared library with a plain C
interface, for ``sm_90a``, under ``build/repro_torch_kernels/`` at the
repository root.  A library's file name carries a hash of its sources,
so an edit rebuilds it and an unchanged tree reuses the last build.  The
libraries are loaded with ``ctypes``; every pointer and the stream pass
as ``c_void_p``.  Nothing is built or loaded at import: the first kernel
launch (or an explicit :func:`build_all`) does it.

Each wrapper counts its launches in :data:`LAUNCHES` (a plain integer per
kernel), so a run can show that it went through the kernels.  K5
(``fused_aggregate``) launches nothing of its own; its count is the sum
of the K1, selection and K4 launches it made.  ``grouped_gemm`` counts
the grouped GEMM's forward, dX and dW launches (the dropless expert
layer); ``decode_attention`` one per call of the cached attention's op
(its kernel, and with a split length the combining kernel after it).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import Dict

import torch

__all__ = ["LAUNCHES", "build_all", "check", "count", "library",
           "reset_launches", "stream_of"]

_CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
_BUILD = (pathlib.Path(__file__).resolve().parents[3] / "build"
          / "repro_torch_kernels")
_SOURCES = ("pairwise_gram", "fused_agg", "bulyan_select", "coord_stats",
            "grouped_gemm", "decode_attention")
_ARCH = "arch=compute_90a,code=sm_90a"

_VP, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: C entry points per library: name -> argtypes (all return int)
_SIGNATURES = {
    "pairwise_gram": {
        "gram_partial_f32": [_VP, _I, _LL, _LL, _I, _VP, _VP, _VP, _VP,
                             _VP],
        "gram_partial_bf16": [_VP, _I, _LL, _LL, _I, _VP, _VP, _VP, _VP,
                              _VP],
    },
    "fused_agg": {
        "select_weights_f32": [_VP, _I, _I, _I, _VP, _VP, _VP, _VP],
        "combine_f32": [_VP, _I, _LL, _VP, _I, _I, _I, _VP, _VP],
        "combine_bf16": [_VP, _I, _LL, _VP, _I, _I, _I, _VP, _VP],
    },
    "bulyan_select": {
        "bulyan_select_f32": [_VP, _I, _LL, _I, _VP, _VP],
        "bulyan_select_bf16": [_VP, _I, _LL, _I, _VP, _VP],
    },
    "coord_stats": {
        "coord_stats_f32": [_VP, _I, _LL, _I, _VP, _VP, _VP],
        "coord_stats_bf16": [_VP, _I, _LL, _I, _VP, _VP, _VP],
    },
    "grouped_gemm": {
        "gmm_rows_f32": [_VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _VP, _I,
                         _VP, _I, _I, _VP],
        "gmm_dw_f32": [_VP, _VP, _VP, _VP, _I, _I, _I, _VP, _VP],
    },
    "decode_attention": {
        "decode_attention_run": [_I, _VP, _LL, _LL, _VP, _LL, _LL, _VP, _LL,
                                 _LL, _VP, _VP, _VP] + [_I] * 11 + [_VP],
    },
}

#: kernel name -> launches since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {"pairwise_gram_partial": 0,
                            "select_weights": 0, "fused_coordinate": 0,
                            "fused_aggregate": 0, "bulyan_select": 0,
                            "coord_stats": 0, "grouped_gemm": 0,
                            "decode_attention": 0}

_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on "
                           "PATH to build the CUDA kernels")
    return path


def _target(name: str) -> pathlib.Path:
    h = hashlib.sha256()
    for src in (_CSRC / f"{name}.cu", *sorted(_CSRC.glob("*.cuh"))):
        h.update(src.read_bytes())
    return _BUILD / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all() -> float:
    """Compile every missing library, one ``nvcc`` per source in parallel.

    Returns:
      Seconds spent building (0.0 when every library was current).
      Raises ``RuntimeError`` with the compiler's output on a failure.
      The ``-Xptxas -v`` report (registers, shared memory, spills) of
      each build lands beside its library as ``<name>.log``.
    """
    todo = {n: _target(n) for n in _SOURCES if not _target(n).exists()}
    if not todo:
        return 0.0
    _BUILD.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name, out in todo.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), "-gencode", _ARCH, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(_CSRC),
               "-o", str(tmp), str(_CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        (_BUILD / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu ---\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one source, building it if needed.

    Args:
      name: source stem, one of ``_SOURCES``.

    Returns:
      The ``ctypes.CDLL`` with ``argtypes`` / ``restype`` declared.
    """
    if name not in _LIBS:
        build_all()
        lib = ctypes.CDLL(str(_target(name)))
        for fn, argtypes in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return _LIBS[name]


def check(err: int, what: str) -> None:
    """Raise when a C entry point reported a CUDA error.

    Args:
      err: the ``cudaGetLastError()`` value the entry point returned.
      what: kernel name for the message.

    Returns:
      None.  Raises ``RuntimeError`` when ``err`` is nonzero.
    """
    if err:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def count(name: str, launches: int = 1) -> None:
    """Add launches to a kernel's counter.

    Args:
      name: a key of :data:`LAUNCHES`.
      launches: how many to add.

    Returns:
      None.
    """
    LAUNCHES[name] += launches


def reset_launches() -> None:
    """Set every launch counter to 0.

    Returns:
      None.
    """
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def stream_of(t: torch.Tensor) -> int:
    """PyTorch's current CUDA stream on a tensor's device, as an int.

    Args:
      t: a CUDA tensor.

    Returns:
      The ``cudaStream_t`` handle for ``c_void_p``.
    """
    return torch.cuda.current_stream(t.device).cuda_stream
