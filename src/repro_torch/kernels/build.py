"""Build and load the port's CUDA kernels (``src/repro_torch/csrc``).

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, and loaded with ``ctypes``. All
sources build in parallel (one ``nvcc`` per source, started together) on the
first call to :func:`library`, into ``build/repro_torch/<hash>/`` at the root
of the checkout, where the hash covers every source and header and the
compiler flags, so an edited kernel rebuilds and an unchanged one loads at
once.

Nothing here runs when a module is imported: the CPU tests import every
module of the port on a machine without ``nvcc``.

Launch counts: every kernel wrapper adds one to ``LAUNCHES[name]`` where it
launches its kernel, and nowhere else, so a run can show that its main path
went through the kernels (``reset_launches`` before, read after).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo")
SOURCES = ("qmatmul", "qmlp", "decode_attn")

LAUNCHES = {"qmatmul": 0, "qkv": 0, "qmlp": 0, "decode_attn": 0}

_libs: dict = {}
BUILD_INFO: dict = {}

_P, _I = ctypes.c_void_p, ctypes.c_int
# C signatures: every pointer and the stream as c_void_p (a bare Python int
# would be passed as a 32-bit int and cut), every size as c_int.
_SIGNATURES = {
    "qmatmul": {
        "repro_qmatmul": [_P, _I, _I, _I, _I, _I, _P, _P, _P, _I, _P],
        "repro_qkv": [_P, _I, _I, _I, _I, _I,
                      _P, _P, _P, _I, _P, _P, _P, _I, _P, _P, _P, _I, _P],
    },
    "qmlp": {
        "repro_qmlp_tiles": [_I],
        "repro_qmlp": [_P, _I, _I, _I, _I, _I, _I, _I,
                       _P, _P, _P, _P, _P, _P, _P, _P, _P],
    },
    "decode_attn": {
        "repro_decode_attn_smem": [_I, _I],
        "repro_decode_attn": [_P, _P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _I, _I, _I, _I, _P],
    },
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "with nvcc on a machine with an NVIDIA GPU")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> dict:
    """Compile every source that is not built yet (in parallel), load all
    libraries, and return them by name. Raises on any compiler error."""
    if len(_libs) == len(SOURCES):
        return _libs
    out_dir = BUILD_ROOT / _source_hash()
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name in SOURCES:
        target = out_dir / f"lib{name}.so"
        if target.exists():
            continue
        tmp = out_dir / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    errors = []
    for name, (proc, tmp, target) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
        else:
            os.replace(tmp, target)
    if errors:
        raise RuntimeError("\n".join(errors))
    BUILD_INFO.update(seconds=time.perf_counter() - t0,
                      built=sorted(procs), directory=str(out_dir))
    for name in SOURCES:
        lib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
        for fn, argtypes in _SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _libs[name] = lib
    return _libs


def library(name: str):
    return build_all()[name]


def check(err: int, what: str) -> None:
    """Raise if a kernel entry point reported a CUDA error at launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream
