"""Build and load the port's hand-written native code.

Each source under `dotaclient_tpu_torch/csrc/` compiles into its own
shared library with a plain C interface and is loaded with ctypes: the
CUDA kernels (`*.cu`) with `nvcc` for `sm_90a` (no PyTorch headers, so a
build takes seconds), the host C++ (`*.cc`: the batch packer, CUPTI's
activity buffers) with `g++`.
Libraries land in `build/torch_kernels/` at the repository root
(git-ignored), named by a hash of the source and flags, so an edited
source rebuilds. Nothing is built at import: the first call that needs a
library builds it, and `build_all()` builds every source at once, one
compiler process each. A failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = [
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas=-v",  # registers / shared memory / spills, printed by build_all's log
]
# Host code: no -march=native, so a library built on one x86-64 host
# loads on any other.
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# library name -> (source file, {C function: (argtypes, restype)})
KERNELS = {
    "lstm_recurrence": (
        "lstm_recurrence.cu",
        {
            "lstm_recurrence_fwd": ([_P] * 8 + [_I] * 10 + [_P], _I),
            "lstm_recurrence_device_limits": ([ctypes.POINTER(_I)] * 3, _I),
            "lstm_recurrence_error_string": ([_I], ctypes.c_char_p),
        },
    ),
    # CUPTI's activity buffers (obs/cupti.py): the two callbacks CUPTI calls
    # are passed by address; the rest are called from Python
    "cupti_buffers": (
        "cupti_buffers.cc",
        {
            "dt_cupti_held": ([], _I64),
            "dt_cupti_take": ([_P, _P, _I64], _I64),
            "dt_cupti_release": ([_P], None),
            # next_record, buffer, valid, cap, 8 column outputs
            "dt_cupti_parse": ([_P, _P, ctypes.c_uint64, _I64] + [_P] * 8, _I64),
        },
    ),
    "packer": (
        "packer.cc",
        {
            # frames, frame_lens, n, row_offset, T, H, want_aux, obs_bf16,
            # 5 schema dims, row_strides, 20 outputs, 3 metadata outputs
            "dt_pack_batch": ([_P, _P] + [_I64] * 11 + [_P] + [_P] * 20 + [_P] * 3, _I64),
            # frames, frame_lens, n, 5 schema dims, 8 outputs
            "dt_frame_headers": ([_P, _P] + [_I64] * 6 + [_P] * 8, _I64),
            # frame, len, 5 schema dims, 7 outputs
            "dt_frame_header": ([_P] + [_I64] * 6 + [_P] * 7, _I64),
        },
    ),
}

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put the CUDA toolkit's nvcc on PATH")
    return found


def _is_cuda(name: str) -> bool:
    return KERNELS[name][0].endswith(".cu")


def _flags(name: str) -> List[str]:
    return NVCC_FLAGS if _is_cuda(name) else GXX_FLAGS


def _compiler(name: str) -> str:
    if _is_cuda(name):
        return _nvcc()
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError(f"g++ not found: {KERNELS[name][0]} needs a C++17 compiler on PATH")
    return found


def lib_path(name: str) -> Path:
    src = CSRC / KERNELS[name][0]
    digest = hashlib.sha256(src.read_bytes() + " ".join(_flags(name)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build_all(names=None) -> Dict[str, str]:
    """Compile every named library that is missing, all compiler processes
    started together; returns each build's compiler log. Raises (after
    every process has ended) if any build failed."""
    names = list(KERNELS) if names is None else list(names)
    jobs = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_compiler(name), *_flags(name), "-o", str(tmp), str(CSRC / KERNELS[name][0])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in jobs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(name)
    if failed:
        raise RuntimeError("build failed for " + ", ".join(f"{n}:\n{logs[n]}" for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The library, built on first use, with every C function's
    argtypes/restype declared (pointers and the stream as c_void_p)."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(lib_path(name)))
        for fn, (argtypes, restype) in KERNELS[name][1].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _loaded[name] = lib
    return lib
