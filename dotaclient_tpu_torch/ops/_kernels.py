"""Build and load the port's hand-written CUDA kernels.

Each source under `dotaclient_tpu_torch/csrc/` compiles with `nvcc` for
`sm_90a` into its own shared library with a plain C interface (no PyTorch
headers, so a build takes seconds) and is loaded with ctypes. Libraries
land in `build/torch_kernels/` at the repository root (git-ignored), named
by a hash of the source and flags, so an edited source rebuilds. Nothing
is built at import: the first call that needs a kernel builds it, and
`build_all()` builds every source at once, one `nvcc` process each.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

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

_P, _I = ctypes.c_void_p, ctypes.c_int
# kernel name -> (source file, {C function: (argtypes, restype)})
KERNELS = {
    "lstm_recurrence": (
        "lstm_recurrence.cu",
        {
            "lstm_recurrence_fwd": ([_P] * 8 + [_I] * 10 + [_P], _I),
            "lstm_recurrence_device_limits": ([ctypes.POINTER(_I)] * 3, _I),
            "lstm_recurrence_error_string": ([_I], ctypes.c_char_p),
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


def lib_path(name: str) -> Path:
    src = CSRC / KERNELS[name][0]
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build_all(names=None) -> Dict[str, str]:
    """Compile every named kernel whose library is missing, all `nvcc`
    processes started together; returns each build's compiler log.
    Raises (after every process has ended) if any build failed."""
    names = list(KERNELS) if names is None else list(names)
    jobs = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / KERNELS[name][0])]
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
        raise RuntimeError("nvcc failed for " + ", ".join(f"{n}:\n{logs[n]}" for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The kernel's library, built on first use, with every C function's
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
