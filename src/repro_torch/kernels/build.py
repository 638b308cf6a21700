"""Build and load the hand-written CUDA kernels; count their launches.

The sources are ``repro_torch/csrc/*.cu``, each with a plain C interface.
At first use every compilation unit (a source, or for the attention
source each of its two dtype halves) is compiled by its own ``nvcc``
process (all started together) for ``sm_90a``, and the objects are linked
into one shared library that :mod:`ctypes` loads.  The library's file name carries
a hash of the sources and flags, so an edited source is never served from a
stale build.  The build directory is ``repro_torch/_build`` (git-ignored);
nothing is compiled when this module is imported.

``LAUNCHES`` counts, per kernel, the launches its wrapper made; each wrapper
adds one right after a launch that the runtime accepted, and nowhere else,
under ``LAUNCH_LOCK`` (engines behind a ``ReplicaRouter`` launch from
threads of their own).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
# (source, its -D flags) of each compilation unit: decode_attention.cu's
# float and bfloat16 kernels compile in parallel units (csrc: REPRO_DA_UNIT)
UNITS = (("quantize.cu", ()), ("int8_matmul.cu", ()), ("int4_matmul.cu", ()),
         ("decode_attention.cu", ("-DREPRO_DA_UNIT=0",)),
         ("decode_attention.cu", ("-DREPRO_DA_UNIT=1",)))
SOURCES = tuple(dict.fromkeys(name for name, _ in UNITS))
# no --use_fast_math: the quantizers need IEEE division and rint
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES: Dict[str, int] = {"quantize_static": 0, "quantize_rowwise": 0,
                            "int8_matmul": 0, "int8_matmul_accumulate": 0,
                            "int8_matmul_epilogue": 0,
                            "int8_matmul_batched": 0,
                            "int4_matmul": 0,
                            "decode_attention": 0,
                            "decode_attention_paged": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    "repro_quantize_static": [_P, _P, _L, _F, _I, _I, _I, _I, _P],
    "repro_quantize_rowwise": [_P, _P, _P, _L, _L, _I, _I, _I, _I, _P],
    "repro_int8_matmul": [_P, _P, _P, _F, _I, _P, _P, _F, _I, _P, _P, _I, _I,
                          _I, _I, _I, _I, _I, _P, _I, _P],
    "repro_int8_matmul_accumulate": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P,
                                     _I, _P],
    "repro_int8_matmul_epilogue": [_P, _P, _F, _I, _P, _P, _F, _I, _P, _P, _I,
                                   _I, _I, _I, _P],
    "repro_int8_matmul_batched": [_P, _P, _P, _F, _I, _P, _P, _I, _I, _I, _I,
                                  _I, _I, _I, _I, _P, _I, _P],
    "repro_int4_matmul": [_P, _P, _P, _F, _I, _P, _P, _I, _P, _F, _I, _P, _P,
                          _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _I, _P],
    "repro_decode_attention": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                               _F, _I, _I, _I, _I, _P],
    "repro_decode_attention_smem_bytes": [_I, _I, _I, _I, _I, _I],
    "repro_decode_attention_chunk": [],
    "repro_decode_attention_paged": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                     _I, _I, _I, _I, _I, _F, _I, _I, _I, _I,
                                     _P],
}

LAUNCH_LOCK = threading.Lock()


def count(kernel: str) -> None:
    """Add one launch of ``kernel`` to ``LAUNCHES``."""
    with LAUNCH_LOCK:
        LAUNCHES[kernel] += 1


_lib: Optional[ctypes.CDLL] = None
# compiler messages of the last build, per source (ptxas register/smem use)
build_log: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")


def library_path(defines: Tuple[str, ...] = ()) -> Path:
    """Where the build for the current sources (and ``defines``, extra
    ``-D`` flags) lives, built or not."""
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    h.update(repr(UNITS).encode())
    h.update(" ".join(NVCC_FLAGS + tuple(defines)).encode())
    return BUILD_DIR / f"librepro_torch_{h.hexdigest()[:16]}.so"


def build(defines: Tuple[str, ...] = ()) -> Path:
    """Compile the units (one nvcc each, in parallel) and link the library.

    ``defines`` are extra ``-D`` flags (a tool's variant of a kernel; the
    port itself builds with none).  Returns the library path; a library
    already built from the same sources and flags is reused.  Raises with
    the compiler's output if any step fails.
    """
    so = library_path(defines)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{so.stem}.{os.getpid()}"
    objs, procs = [], []
    for i, (name, unit_defines) in enumerate(UNITS):
        obj = BUILD_DIR / f"{Path(name).stem}.{i}.{tag}.o"
        objs.append(obj)
        procs.append((" ".join((name, *unit_defines)), subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *unit_defines, *defines, "-c",
             str(CSRC_DIR / name), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, proc in procs:          # wait for every compiler, failed or not
        out, _ = proc.communicate()
        build_log[name] = out
        if proc.returncode:
            failed.append(f"--- {name} (exit {proc.returncode})\n{out}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = BUILD_DIR / f"{tag}.so.tmp"
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if link.returncode:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, so)
    for obj in objs:
        obj.unlink()
    return so


def load(path: Path) -> ctypes.CDLL:
    """A built library with its entry points' signatures set."""
    loaded = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(loaded, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return loaded


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    if _lib is None:
        _lib = load(build())
    return _lib


def check(err: int, kernel: str) -> None:
    """Raise if a launch was refused (the C entry returns cudaGetLastError)."""
    if err:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {err}")


def build_seconds() -> float:
    """Build (or find) and load the library; return the seconds it took."""
    t0 = time.perf_counter()
    lib()
    return time.perf_counter() - t0
