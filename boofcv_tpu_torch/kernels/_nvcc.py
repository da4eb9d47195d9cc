"""Build the hand-written CUDA kernels with ``nvcc`` at first use.

Each ``csrc/<name>.cu`` exposes a plain ``extern "C"`` launcher; it is
compiled for Hopper (``sm_90a``) into a shared library under ``_build/``
(git-ignored, keyed by a hash of the source and flags) and loaded with
``ctypes``.  ptxas's report (``-Xptxas -v``: registers, spills) is kept
beside the library as ``<library>.ptxas.txt``.  No PyTorch headers are compiled, so a build takes seconds.

A failed build raises: there is no fallback to the plain PyTorch version
on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")

ARCH_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a",)
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-shared", "-Xcompiler",
                           "-fPIC", "-Xptxas", "-v")
# per-source additions; each source's header says why
EXTRA_FLAGS = {"klt_track": ("-fmad=false",)}

# name -> (ctypes.CDLL, build record); filled at first use
_LIBS: dict = {}


def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    nvcc = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(nvcc):
        return nvcc
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be built")


def load_library(name: str):
    """Return the loaded ``ctypes.CDLL`` for ``csrc/<name>.cu``, building
    it first if no library for this source and these flags exists."""
    if name in _LIBS:
        return _LIBS[name][0]
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    flags = NVCC_FLAGS + EXTRA_FLAGS.get(name, ())
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags).encode())
    out = os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")
    record = {"name": name, "source": src, "library": out,
              "arch_flags": list(ARCH_FLAGS), "flags": list(flags),
              "built": False, "build_s": 0.0, "ptxas": ""}
    if not os.path.exists(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_find_nvcc(), *flags, "-o", tmp, src]
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed building {src} (exit {proc.returncode}):\n"
                    f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
            # registers, shared memory and spills of each kernel
            with open(tmp + ".ptxas.txt", "w") as f:
                f.write(proc.stderr.strip())
            os.replace(tmp + ".ptxas.txt", out + ".ptxas.txt")
            os.replace(tmp, out)   # atomic: concurrent builds agree
        finally:
            for path in (tmp, tmp + ".ptxas.txt"):
                if os.path.exists(path):
                    os.remove(path)
        record["built"] = True
        record["build_s"] = time.perf_counter() - t0
    if os.path.exists(out + ".ptxas.txt"):
        with open(out + ".ptxas.txt") as f:
            record["ptxas"] = f.read()
    lib = ctypes.CDLL(out)
    _LIBS[name] = (lib, record)
    return lib


def build_record(name: str) -> dict:
    """What :func:`load_library` did for ``name``: library path, arch
    flags, all nvcc flags, whether it compiled in this process, how long
    it took and what ptxas reported when it was built."""
    return dict(_LIBS[name][1])
