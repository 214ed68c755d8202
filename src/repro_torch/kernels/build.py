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

Each source is compiled with ``-Xptxas -v``; the compiler's report is kept
beside its library (``lib<name>.ptxas.txt``), and :func:`ptxas_report`
reads from it each kernel's registers, shared memory and spill bytes.

Launch counts: every kernel wrapper adds one to ``LAUNCHES[name]`` where it
launches its kernel, and nowhere else, so a run can show that its main path
went through the kernels (``reset_launches`` before, read after).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v")
SOURCES = ("qmatmul", "qmlp", "decode_attn", "entropy", "quantize")

# qmlp: the swiglu form of the fused MLP; qmlp_gelu: its gelu form.
# decode_attn_window: a multi-query (verify) window, causal or not;
# decode_attn_fresh: with fresh rows (fused draft propose); decode_attn: the
# causal single-query step; decode_attn_cross: the single-query step with
# causal=False over a dense cache (every cached row visible, as an encoder's
# K/V are); the _paged counters count the single-query, window and fresh
# forms over a paged KV pool.
LAUNCHES = {"qmatmul": 0, "qkv": 0, "qmlp": 0, "qmlp_gelu": 0,
            "decode_attn": 0, "decode_attn_window": 0,
            "decode_attn_fresh": 0, "decode_attn_cross": 0,
            "decode_attn_paged": 0, "decode_attn_paged_window": 0,
            "decode_attn_paged_fresh": 0, "entropy": 0, "quantize_int8": 0}

_libs: dict = {}
BUILD_INFO: dict = {}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C signatures: every pointer and the stream as c_void_p (a bare Python int
# would be passed as a 32-bit int and cut), every size as c_int, an element
# count that may pass 2^31 as c_longlong.
_SIGNATURES = {
    "qmatmul": {
        "repro_qmatmul": [_P, _I, _I, _I, _I, _I, _P, _P, _P, _I, _P],
        "repro_qkv": [_P, _I, _I, _I, _I, _I,
                      _P, _P, _P, _I, _P, _P, _P, _I, _P, _P, _P, _I, _P],
        "repro_qmatmul_plan": [_I, _I, _I, _I, _I, _P],
    },
    "qmlp": {
        "repro_qmlp_tiles": [_I],
        "repro_qmlp": [_P, _I, _I, _I, _I, _I, _I, _I, _I,
                       _P, _P, _P, _P, _P, _P, _P, _P, _P],
    },
    "decode_attn": {
        "repro_decode_attn_smem": [_I, _I, _I],
        "repro_decode_attn": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                              _P, _P, _P, _L, _L, _L, _I, _I, _I, _I, _I, _I,
                              _I, _I, _I, _I, _I, _I, _I, _I, _P],
    },
    "entropy": {
        "repro_entropy_parts": [_L],
        "repro_entropy": [_P, _I, _L, _I, _I, _P, _P, _P],
    },
    "quantize": {
        "repro_quantize_int8": [_P, _I, _I, _I, _I, _P, _P, _P],
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
            (out_dir / f"lib{name}.ptxas.txt").write_text(log)
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


def parse_ptxas(text: str) -> list:
    """``nvcc -Xptxas -v`` output -> one dict per kernel: ``kernel`` (its
    mangled name), ``registers``, ``smem_bytes`` (static), ``spill_stores``
    and ``spill_loads`` (bytes)."""
    rows, cur = [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = {"kernel": m.group(1)}
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"] = int(m.group(1))
            cur["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["smem_bytes"] = int(sm.group(1)) if sm else 0
    return rows


def ptxas_report(name: str) -> list:
    """Each kernel of source ``name`` as the compiler reported it at its
    build in this checkout (``parse_ptxas``), its name demangled where
    ``cu++filt`` is found."""
    text = (BUILD_ROOT / _source_hash() / f"lib{name}.ptxas.txt").read_text()
    rows = parse_ptxas(text)
    filt = shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
    if rows and os.path.exists(filt):
        names = subprocess.run(
            [filt], input="\n".join(r["kernel"] for r in rows),
            capture_output=True, text=True).stdout.split("\n")
        for r, n in zip(rows, names):
            r["kernel"] = n.strip() or r["kernel"]
    return rows


def check(err: int, what: str) -> None:
    """Raise if a kernel entry point reported a CUDA error at launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream
