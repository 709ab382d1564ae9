"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface.  It is compiled with
``nvcc`` for ``sm_90a`` into ``build/kernels/lib<name>.so`` at the root of
the checkout, at first use, and loaded with ``ctypes``.  Nothing here runs at
import, and there is no fallback: a build that fails raises.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


class KernelLibraries:
    """The loaded kernel libraries of one process, built on first use."""

    def __init__(self):
        self._libs = {}
        self.build_logs = {}

    def _nvcc(self):
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        if not os.path.exists(nvcc):
            raise RuntimeError("nvcc not found: the CUDA kernels are built on the machine "
                               "with the card, with the CUDA toolkit installed")
        return nvcc

    def _paths(self, name):
        return os.path.join(CSRC, f"{name}.cu"), os.path.join(BUILD_DIR, f"lib{name}.so")

    def _stale(self, name):
        src, lib = self._paths(name)
        return not os.path.exists(lib) or os.path.getmtime(lib) < os.path.getmtime(src)

    def build(self, names, force: bool = False):
        """Compile the stale sources of ``names`` (all of them with
        ``force``), one nvcc each, all at once."""
        names = [n for n in names if force or self._stale(n)]
        if not names:
            return
        os.makedirs(BUILD_DIR, exist_ok=True)
        nvcc = self._nvcc()
        procs = {}
        for name in names:
            src, lib = self._paths(name)
            tmp = f"{lib}.{os.getpid()}.tmp"
            procs[name] = (subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", tmp, src],
                                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                            text=True), tmp, lib)
        failed = []
        for name, (proc, tmp, lib) in procs.items():
            log, _ = proc.communicate()
            self.build_logs[name] = log
            if proc.returncode != 0:
                failed.append(f"{name}:\n{log}")
            else:
                os.replace(tmp, lib)
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))

    def get(self, name):
        """The ctypes library of ``csrc/<name>.cu``, built if needed."""
        lib = self._libs.get(name)
        if lib is None:
            self.build([name])
            lib = ctypes.CDLL(self._paths(name)[1])
            self._libs[name] = lib
        return lib


KERNELS = KernelLibraries()
