"""Build the hand-written CUDA kernels and load them with ``ctypes``.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` into an object, all
sources at once in parallel, then links them into one shared library with
a plain C interface. Nothing includes PyTorch's headers, so a cold build
takes seconds. The library lands in ``kernels/_build/`` (git-ignored),
named by a hash of the sources and flags, so an edited source rebuilds and
an unchanged one is reused; a file lock keeps concurrent processes from
building the same library twice. The build happens at first use, never at
import.
"""
from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# dtype codes of the C interface (csrc/common.cuh)
DTYPE_CODES = {"float32": 0, "bfloat16": 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_FLASH = [_P] * 6 + [_I] * 9 + [_F, _F, _P]
ARGTYPES = {
    # q, k, v, o, q_offset, kv_len, B, Sq, Sk, H, Hkv, Dk, Dv, causal,
    # window, softcap, scale, stream
    "flash_attention_fwd_bf16": _FLASH,  # tensor cores (flash_attention_bf16.cu)
    "flash_attention_fwd_fp32": _FLASH,  # CUDA cores (flash_attention.cu)
    # q, k, v, o, q_offset, kv_len, part, counters, B, Smax, H, Hkv, Dk, Dv,
    # window, n_splits, split_len, softcap, scale, dtype, stream
    "decode_attention_fwd": [_P] * 8 + [_I] * 9 + [_F, _F, _I, _P],
    # x, dA, dt, Bm, Cm, y, h_out, B, S, H, P, N, Q, dtype, stream
    "ssd_scan_fwd": [_P] * 7 + [_I] * 7 + [_P],
}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the repro_torch kernels "
                       "are built from source on the machine with the card")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    cus, headers = _sources()
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for p in cus + headers:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"librepro_torch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile and link the kernels unless this exact build exists.
    Returns the library's path; the compiler's output (``-Xptxas -v``:
    registers, shared memory, spills per kernel) goes to ``build.log``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():
            return out
        nvcc = nvcc_path()
        cus, _ = _sources()
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            objs = [Path(tmp) / (cu.stem + ".o") for cu in cus]
            procs = [subprocess.Popen([nvcc, *COMPILE_FLAGS, "-c", str(cu), "-o", str(obj)],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                     for cu, obj in zip(cus, objs)]
            logs = [(cu.name, p.communicate()[0], p.returncode) for cu, p in zip(cus, procs)]
            (BUILD_DIR / "build.log").write_text(
                "".join(f"== {name} (rc {rc})\n{text}" for name, text, rc in logs))
            failed = [(name, text) for name, text, rc in logs if rc != 0]
            if failed:
                raise RuntimeError("nvcc failed:\n" + "\n".join(f"{n}:\n{t}" for n, t in failed))
            so = Path(tmp) / out.name
            link = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(so), *map(str, objs)],
                                  capture_output=True, text=True)
            if link.returncode != 0:
                raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
            os.replace(so, out)
    return out


@functools.cache
def load_library() -> ctypes.CDLL:
    """The process's handle on the kernel library, built on first use."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(rc: int, name: str) -> None:
    """Raise on a nonzero code from a C entry point (a CUDA error from the
    launch, or -1 for a shape the kernel does not take)."""
    if rc != 0:
        raise RuntimeError(f"{name} failed with code {rc}")
