"""Builds the CUDA sources of `csrc/` into one shared library at first use.

`nvcc` compiles every `*.cu` under `csrc/` for sm_90a, one compiler process
for each source and all of them at once, and links the objects into a shared
library with a plain C interface, which is loaded with `ctypes`. It lands in
`aleo_tpu_torch/_build/`, keyed by a hash of the sources, so an unchanged
tree builds once. A failed build raises with the compiler's output; nothing
falls back to another implementation. One lock holds the check, the build
and the load, so threads that reach the first launch together (the dev
server's handlers) build once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lib = None
_LOCK = threading.Lock()
BUILD_LOG = ""      # nvcc's output (-Xptxas -v: registers and spills per kernel)


def _sources():
    names = sorted(os.listdir(CSRC_DIR))
    return (
        [os.path.join(CSRC_DIR, n) for n in names if n.endswith(".cu")],
        [os.path.join(CSRC_DIR, n) for n in names if n.endswith((".cu", ".cuh"))],
    )


def _find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def ptxas_info(log: str | None = None) -> dict:
    """What `-Xptxas -v` says of each kernel in a build log (BUILD_LOG by
    default) -> {kernel function name: {registers, spill_stores,
    spill_loads, stack, smem}}. Empty when this process did not build."""
    info, cur = {}, None
    for line in (BUILD_LOG if log is None else log).splitlines():
        m = re.search(r"Compiling entry function '_Z\d+(\w+?)P", line)
        if m:
            cur = info.setdefault(m.group(1), {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and cur is not None:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            smem = re.search(r"(\d+) bytes smem", line)
            cur.update(registers=int(m.group(1)), smem=int(smem.group(1)) if smem else 0)
    return info


def library() -> ctypes.CDLL:
    """The loaded kernel library (built now if this source state never was)."""
    global _lib
    if _lib is None:            # checked again under the lock
        with _LOCK:
            if _lib is None:
                _lib = _build_and_load()
    return _lib


def _build_and_load() -> ctypes.CDLL:
    global BUILD_LOG
    cu, all_src = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in all_src:
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    so_path = os.path.join(BUILD_DIR, f"libaleo_kernels_{h.hexdigest()[:16]}.so")
    if not os.path.exists(so_path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so_path}.{os.getpid()}.tmp"
        nvcc = _find_nvcc()
        objs = [f"{tmp}.{os.path.basename(src)}.o" for src in cu]
        cmds = [
            [nvcc, *NVCC_FLAGS, "-I", CSRC_DIR, "-c", "-o", obj, src]
            for src, obj in zip(cu, objs)
        ]
        procs = [
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True)
            for cmd in cmds
        ]
        cmds.append([nvcc, "-shared", "-o", tmp, *objs])
        outs = [proc.communicate()[0] for proc in procs]
        failed = [proc.returncode != 0 for proc in procs]
        if not any(failed):
            link = subprocess.run(cmds[-1], capture_output=True, text=True)
            outs.append(link.stdout + link.stderr)
            failed.append(link.returncode != 0)
        BUILD_LOG = "".join(outs)
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
        if any(failed):
            bad = [" ".join(cmd) for cmd, f in zip(cmds, failed) if f]
            raise RuntimeError("nvcc failed (" + "; ".join(bad) + "):\n" + BUILD_LOG)
        os.replace(tmp, so_path)
    lib = ctypes.CDLL(so_path)
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    lib.fq_mul_launch.argtypes = [P, P, P, I, P]
    lib.fq_prepare_launch.argtypes = [P] * 11 + [I, P]
    lib.fq_apply_launch.argtypes = [P] * 12 + [I, P]
    lib.fq_fermat_launch.argtypes = [P, P, I, P]
    lib.fq_inv_up_launch.argtypes = [P, P, I, P]
    lib.fq_inv_down_launch.argtypes = [P, P, P, I, P]
    lib.fmat_reduce_launch.argtypes = [P, P, I, P, P]
    lib.fmat_carry2d_launch.argtypes = [P, P, I, I, P]
    lib.fmat_carry3d_launch.argtypes = [P, P, I, I, I, P]
    lib.g1_double_launch.argtypes = [P] * 6 + [I, P]
    lib.g1_add_launch.argtypes = [P] * 9 + [I, P]
    lib.g1_add_sel_launch.argtypes = [P] * 10 + [I, P]
    lib.g1_add_sel_proj_launch.argtypes = [P] * 11 + [I, P]
    lib.g1_normalize_launch.argtypes = [P] * 6 + [I, P]
    lib.fq_mul_canon_launch.argtypes = [P] * 3 + [I, P]
    lib.fq_mul_chain12_launch.argtypes = [P] * 3 + [I, P]
    lib.fr_mul_launch.argtypes = [P] * 3 + [I, P]
    for fn in (lib.fq_mul_launch, lib.fq_prepare_launch, lib.fq_apply_launch,
               lib.fq_fermat_launch, lib.fq_inv_up_launch, lib.fq_inv_down_launch,
               lib.fmat_reduce_launch,
               lib.fmat_carry2d_launch, lib.fmat_carry3d_launch,
               lib.g1_double_launch, lib.g1_add_launch, lib.g1_add_sel_launch,
               lib.g1_add_sel_proj_launch, lib.g1_normalize_launch,
               lib.fq_mul_canon_launch, lib.fq_mul_chain12_launch, lib.fr_mul_launch):
        fn.restype = ctypes.c_int
    return lib
