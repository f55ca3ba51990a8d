"""Build and bind the package's CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` into its own shared
library with a plain C interface and loaded with ``ctypes``. Nothing
happens at import time: the first call to :func:`load` builds every
source that is not yet built (one ``nvcc`` process per source, all
started together) into ``build/kernels/`` at the root of the checkout,
keyed by a hash of the source, the shared ``*.cuh`` headers and the flags,
so an edited source rebuilds and an unchanged one is reused.

Every C entry point launches on the stream it is given, allocates
nothing, and returns ``cudaGetLastError()``; :func:`check` raises on a
non-zero code.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import inspect
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Tuple

__all__ = ["build_all", "build_dir", "check", "counted", "load", "stream_handle"]

_CSRC = Path(__file__).resolve().parent / "csrc"

_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# name -> (source, extra nvcc flags, {C function: argtypes}).
# -fmad=false keeps each float operation rounded on its own, as the plain
# PyTorch versions round them, so NMS keep masks agree bit for bit, the
# RoIAlign sample positions (forward and backward) agree to the last place,
# and the deformable convolution's columns are the plain version's bits.
_KERNELS: Dict[str, Tuple[str, List[str], Dict[str, list]]] = {
    "matmul_stats": (
        "matmul_stats.cu", [],
        {"vt_matmul_stats": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                             _P],
         "vt_matmul_stats_tile_m": []},
    ),
    "matmul_stats_fma": (
        "matmul_stats_fma.cu", [],
        {"vt_matmul_stats_fma": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                 _L, _L, _L, _P],
         "vt_matmul_stats_fma_tile_m": [_I, _I]},
    ),
    "matmul_stats_wgmma": (
        "matmul_stats_wgmma.cu", [],
        {"vt_matmul_stats_wgmma": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                   _L, _L, _L, _P],
         "vt_matmul_stats_wgmma_tile_m": [_I, _I]},
    ),
    "nms": (
        "nms.cu", ["-fmad=false"],
        {"vt_nms_keep": [_P, _P, _P, _P, _I, _I, _F, _P]},
    ),
    "nms_rowscan": (
        "nms_rowscan.cu", ["-fmad=false"],
        {"vt_nms_rowscan": [_P, _P, _P, _I, _I, _F, _P]},
    ),
    "roi_align": (
        "roi_align.cu", ["-fmad=false"],
        {"vt_roi_align_forward": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                  _F, _I, _I, _I, _P]},
    ),
    "roi_align_backward": (
        "roi_align_backward.cu", ["-fmad=false"],
        {"vt_roi_align_backward": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                   _I, _F, _I, _I, _I, _P],
         "vt_roi_align_backward_scratch": [_I, _I, _I, _I, _I, _I, _I]},
    ),
    "deform_conv": (
        "deform_conv.cu", ["-fmad=false"],
        {"vt_deform_im2col": [_P] * 4 + [_I] * 15 + [_I] * 6 + [_I, _P]},
    ),
    "deform_conv_backward": (
        "deform_conv_backward.cu", ["-fmad=false"],
        {"vt_deform_scatter_keys": [_P] * 4 + [_I] * 15 + [_P],
         "vt_deform_backward": [_P] * 12 + [_I] * 15 + [_I] * 6 + [_I, _P]},
    ),
    # no -fmad=false: these aim at a stated tolerance, not at the plain
    # versions' bits (exp2 with log2 e folded into the scale rounds
    # otherwise than torch.exp)
    "flash_attention": (
        "flash_attention.cu", [],
        {"vt_flash_attention_forward": [_P] * 5 + [_I] * 4 + [_L] * 9
         + [_F, _I, _P]},
    ),
    "flash_attention_backward": (
        "flash_attention_backward.cu", [],
        {"vt_flash_attention_dkv": [_P] * 8 + [_I] * 4 + [_L] * 12
         + [_F, _I, _P],
         "vt_flash_attention_dq": [_P] * 7 + [_I] * 4 + [_L] * 12
         + [_F, _I, _P]},
    ),
    "window_pool": (
        "window_pool.cu", [],
        {"vt_window_pool": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                            _I, _I, _F, _I, _P]},
    ),
    "window_pool_backward": (
        "window_pool_backward.cu", [],
        {"vt_window_pool_backward": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                     _I, _I, _I, _I, _I, _I, _I, _F, _I, _P],
         "vt_window_pool_backward_scratch": [_I, _I]},
    ),
}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def build_dir() -> Path:
    """``build/kernels`` at the root of the checkout (listed in
    ``.gitignore``)."""
    return Path(__file__).resolve().parent.parent / "build" / "kernels"


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if cuda_home and (Path(cuda_home) / "bin" / "nvcc").exists():
        return str(Path(cuda_home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found: set CUDA_HOME or put nvcc on PATH to build the "
        "vision_tpu_torch CUDA kernels"
    )


def _lib_path(name: str) -> Path:
    source, extra, _ = _KERNELS[name]
    headers = b"".join(p.read_bytes() for p in sorted(_CSRC.glob("*.cuh")))
    digest = hashlib.sha256(
        (_CSRC / source).read_bytes() + headers
        + " ".join(_NVCC_FLAGS + extra).encode()
    ).hexdigest()[:16]
    return build_dir() / f"lib{name}-{digest}.so"


def build_all() -> float:
    """Compile every kernel library that is missing, all in parallel.
    Returns the seconds spent (0.0 when all were built already)."""
    todo = [n for n in _KERNELS if not _lib_path(n).exists()]
    if not todo:
        return 0.0
    t0 = time.perf_counter()
    build_dir().mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in todo:
        source, extra, _ = _KERNELS[name]
        out = _lib_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *_NVCC_FLAGS, *extra, "-o", str(tmp), str(_CSRC / source)]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all()
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn, argtypes in _KERNELS[name][2].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def stream_handle(tensor) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on the
    tensor's device."""
    import torch

    return torch.cuda.current_stream(tensor.device).cuda_stream


def counted(wrapper):
    """Give a kernel wrapper a launch count: ``wrapper.launches``, a plain
    integer that grows by one each time the wrapper's kernel has been
    launched without error, and ``wrapper.launches_by_dtype``, the same
    count split by the type of the wrapper's first argument (``"float32"``,
    ``"bfloat16"``), which picks the kernel's variant. The counts live on
    the returned function, so they survive callers rebinding the
    module-level name."""

    first_name = next(iter(inspect.signature(wrapper).parameters))

    @functools.wraps(wrapper)
    def launch(*args, **kwargs):
        out = wrapper(*args, **kwargs)
        launch.launches += 1
        first = args[0] if args else kwargs[first_name]
        dtype = str(first.dtype).replace("torch.", "")
        launch.launches_by_dtype[dtype] = launch.launches_by_dtype.get(dtype, 0) + 1
        return out

    launch.launches = 0
    launch.launches_by_dtype = {}
    return launch
