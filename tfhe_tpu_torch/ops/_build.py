"""Build and load the port's CUDA kernels.

The sources under `tfhe_tpu_torch/csrc/` are compiled by nvcc for Hopper
(`sm_90a`), one nvcc process per source and all started together, linked
into one shared library with a plain C interface and loaded through ctypes.
The build happens at first use, into `tfhe_tpu_torch/_build/<hash>/`, keyed
by a hash of the sources and flags, so a changed source rebuilds and an
unchanged one is loaded as it is. nvcc's output, ptxas's register and
shared-memory report included, is kept beside the library in `build.log`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
_SOURCES = ("blind_rotate.cu", "compact.cu", "cmux_step.cu", "mk_cmux.cu")
_HEADERS = ("cmux_kernels.cuh",)
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit to build")


def _digest() -> str:
    h = hashlib.sha256()
    for name in _SOURCES + _HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels if this source hash has no library yet; return
    the library's path."""
    out_dir = BUILD_DIR / _digest()
    lib = out_dir / "libtfhe_kernels.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = os.getpid()
    tmp = out_dir / f"libtfhe_kernels.{tag}.so"
    objs = [out_dir / f"{Path(name).stem}.{tag}.o" for name in _SOURCES]
    cmds = [[nvcc, *_FLAGS, "-c", "-o", str(obj), str(CSRC / name)]
            for name, obj in zip(_SOURCES, objs)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    log, failed = "", False
    for cmd, proc in zip(cmds, procs):
        out, _ = proc.communicate()
        log += f"$ {' '.join(cmd)}\n{out}exit {proc.returncode}\n"
        failed |= proc.returncode != 0
    if not failed:
        link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(link, capture_output=True, text=True)
        log += (f"$ {' '.join(link)}\n{proc.stdout}{proc.stderr}"
                f"exit {proc.returncode}\n")
        failed = proc.returncode != 0
    log += f"{time.perf_counter() - t0:.1f} s\n"
    (out_dir / "build.log").write_text(log)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError(f"nvcc failed:\n{log}")
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    return lib


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build if needed, then load the library with its C signatures."""
    lib = ctypes.CDLL(str(build()))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.tfhe_blind_rotate.argtypes = [
        vp, vp, vp, vp, vp, i32, vp, vp,  # acc key bara lhs combos n terms start
        i32, i32, i32, i32, i32, i32, i32, i32, i32, i32,  # sizes
        vp,  # stream
    ]
    lib.tfhe_blind_rotate.restype = i32
    lib.tfhe_expand_step.argtypes = [vp, vp, vp, i32, i32, i32, i32, vp]
    lib.tfhe_expand_step.restype = i32
    lib.tfhe_blind_rotate_compact.argtypes = [
        vp, vp, vp, vp, vp, vp,  # acc limbs bara lhs scratch entry_masks
        vp, i32, vp, vp,  # combos n terms start
        i32, i32, i32, i32, i32, i32, i32, i32, i32, i32,  # sizes
        vp,  # stream
    ]
    lib.tfhe_blind_rotate_compact.restype = i32
    lib.tfhe_rotate_decompose.argtypes = [
        vp, vp, vp, i32, i32, i32, i32, i32, i32, i32, i32, vp]
    lib.tfhe_rotate_decompose.restype = i32
    lib.tfhe_cmux_matmul.argtypes = [
        vp, vp, vp, vp, vp, i32, i32, i32, i32, i32, i32, i32, vp]
    lib.tfhe_cmux_matmul.restype = i32
    mk_head = [vp, vp, vp, vp]  # acc operand bara lhs
    mk_tables = [vp, i32, vp, vp]  # combos n terms start
    lib.tfhe_mk_cmux_step.argtypes = (
        mk_head + mk_tables + [i32] * 9 + [vp])
    lib.tfhe_mk_cmux_step.restype = i32
    lib.tfhe_mk_blind_rotate_chunk.argtypes = (
        mk_head + mk_tables + [i32] * 11 + [vp])
    lib.tfhe_mk_blind_rotate_chunk.restype = i32
    lib.tfhe_mk_blind_rotate_compact.argtypes = (
        mk_head + [vp, vp] + mk_tables + [i32] * 11 + [vp])  # + scratch masks
    lib.tfhe_mk_blind_rotate_compact.restype = i32
    lib.tfhe_error_string.argtypes = [i32]
    lib.tfhe_error_string.restype = ctypes.c_char_p
    return lib
