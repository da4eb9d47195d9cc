"""Build the hand-written CUDA kernels with ``nvcc`` at first use, and
launch them.

Each ``csrc/<name>.cu`` exposes a plain ``extern "C"`` launcher; it is
compiled for Hopper (``sm_90a``) into a shared library under ``_build/``
(git-ignored, keyed by a hash of the source and flags) and loaded with
``ctypes``.  ptxas's report (``-Xptxas -v``: registers, spills) is kept
beside the library as ``<library>.ptxas.txt``.  No PyTorch headers are compiled, so a build takes seconds.

:class:`Kernel` is the one layer under every wrapper module: the build
with the flags the module gives, the C ABI, each thread's launch structs,
the launch on the device's current stream, the check of what the launcher
returns and the count of launches.  A wrapper module keeps its structs,
its argument checks and its public function.

A failed build or launch raises: there is no fallback to the plain
PyTorch version on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")

ARCH_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a",)
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-shared", "-Xcompiler",
                           "-fPIC", "-Xptxas", "-v")

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


def load_library(name: str, flags: tuple = ()):
    """Return the loaded ``ctypes.CDLL`` for ``csrc/<name>.cu``, building
    it first, with ``flags`` after :data:`NVCC_FLAGS`, if no library for
    this source and these flags exists."""
    if name in _LIBS:
        return _LIBS[name][0]
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    flags = NVCC_FLAGS + tuple(flags)
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


def _raw_stream(index: int) -> int:
    """The current CUDA stream of device ``index`` as an integer."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(index)
    return torch.cuda.current_stream(index).cuda_stream


def call_on_device(index: int, launch, *args) -> int:
    """``launch(*args, stream)``, a C launcher, with CUDA device ``index``
    current and its current stream; returns what the launcher returns."""
    if torch.cuda.current_device() == index:
        return launch(*args, _raw_stream(index))
    with torch.cuda.device(index):
        return launch(*args, _raw_stream(index))


class Kernel:
    """One hand kernel: ``csrc/<name>.cu`` built with ``flags`` after
    :data:`NVCC_FLAGS`.  Its C ABI: ``int <name>_launch(const S1*, ...,
    void* stream)``, one pointer for each of ``structs`` in order,
    returning 0 or a ``cudaError_t``; and ``const char*
    <name>_error_string(int)``."""

    def __init__(self, name: str, structs: tuple, flags: tuple = ()):
        self.name, self.flags, self._types = name, tuple(flags), structs
        self._launches = 0
        self._lib = self._launcher = None
        self._lock = threading.Lock()     # one build when threads race
        self._tls = threading.local()

    def library(self):
        """The loaded ``ctypes.CDLL``, built and its C ABI declared at
        first use."""
        with self._lock:
            if self._lib is None:
                lib = load_library(self.name, self.flags)
                fn = getattr(lib, f"{self.name}_launch")
                fn.argtypes = [ctypes.POINTER(t) for t in self._types] + [
                    ctypes.c_void_p]
                fn.restype = ctypes.c_int
                err = getattr(lib, f"{self.name}_error_string")
                err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
                self._launcher, self._lib = fn, lib
        return self._lib

    def structs(self) -> tuple:
        """(this thread's instances of the structs, their ``byref``s):
        each thread packs its own, and its next launch reuses them."""
        s = getattr(self._tls, "structs", None)
        if s is None:
            objs = tuple(t() for t in self._types)
            s = self._tls.structs = objs, tuple(map(ctypes.byref, objs))
        return s

    def launch(self, index: int) -> None:
        """One launch on this thread's structs, CUDA device ``index``
        current, on its current stream; counted if it succeeded."""
        if self._launcher is None:
            self.library()
        err = call_on_device(index, self._launcher, *self.structs()[1])
        if err:
            self.fail(err)
        self._launches += 1

    def fail(self, err: int, what: str = "") -> None:
        """Raise the ``RuntimeError`` for a launcher's return ``err``,
        with the kernel's own message for it."""
        msg = getattr(self.library(), f"{self.name}_error_string")(err)
        raise RuntimeError(f"{what or self.name + ' launch'} failed: "
                           f"{msg.decode()} ({err})")

    def launch_count(self) -> int:
        """Number of kernel launches since import or the last reset."""
        return self._launches

    def reset_launch_count(self) -> None:
        """Set the count of launches to 0."""
        self._launches = 0
