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
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from ..instrument import cached_build

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
_SOURCES = ("blind_rotate.cu", "compact.cu", "cmux_step.cu", "mk_cmux.cu",
            "fused_step.cu")
_HEADERS = ("cmux_kernels.cuh", "dots_sm90.cuh")
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


@cached_build("kernel_library")
def load() -> ctypes.CDLL:
    """Build if needed, then load the library with its C signatures. The
    rotation entries take a step's sizes and the dots' tables as the two
    structs `blind_rotate.StepSizes` and `dots.DotsArgs` (by pointer; ctypes
    refuses any other type there)."""
    from .blind_rotate import StepSizes
    from .dots import DotsArgs

    lib = ctypes.CDLL(str(build()))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    sizes, tables = ctypes.POINTER(StepSizes), ctypes.POINTER(DotsArgs)
    signatures = {
        # acc key bara_t lhs, n_steps
        "tfhe_blind_rotate": [vp, vp, vp, vp, sizes, tables, i32],
        # acc limbs bara_t lhs scratch entry_masks, n_steps
        "tfhe_blind_rotate_compact": [vp] * 6 + [sizes, tables, i32],
        "tfhe_rotate_decompose_rows": [vp, vp, vp, sizes],  # acc bara lhs
        "tfhe_rotate_decompose": [vp, vp, vp, sizes],  # acc bara digits
        "tfhe_cmux_matmul": [vp, vp, vp, sizes, tables],  # acc digits e_step
        # acc e_step bara lhs, nzn
        "tfhe_mk_cmux_step": [vp, vp, vp, vp, sizes, tables, i32],
        # acc e_chunk bara_t lhs, n_steps nzn
        "tfhe_mk_blind_rotate_chunk": [vp] * 4 + [sizes, tables, i32, i32],
        # acc limbs bara_t lhs scratch entry_masks, n_steps nzn
        "tfhe_mk_blind_rotate_compact": [vp] * 6 + [sizes, tables, i32, i32],
        # acc key_step bara out lhs ready, stage_rows
        "tfhe_cmux_step_karatsuba": [vp] * 6 + [sizes, tables, i32],
        # limbs_step entry_masks out, total_rows p_rows k1 n kmajor
        "tfhe_expand_step": [vp, vp, vp] + [i32] * 5,
    }
    for name, args in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = [*args, vp]  # the stream last
        fn.restype = i32
    lib.tfhe_error_string.argtypes = [i32]
    lib.tfhe_error_string.restype = ctypes.c_char_p
    return lib
