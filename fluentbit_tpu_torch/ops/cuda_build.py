"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface, under
``fluentbit_tpu_torch/_build/`` (listed in ``.gitignore``). The library
name carries a digest of the source and flags, so an edited source never
loads a stale build. Nothing here runs at import: the first ``load`` of a
kernel builds it.
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
from typing import Dict, Sequence

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

#: every kernel source of ``csrc/``: K1-K3 (``grep_dfa``), K4
#: (``grep_assoc``), K6/K7/K9/K10 (``sketch``), K11 (``utf8``)
SOURCES = ("grep_dfa", "grep_assoc", "sketch", "utf8")

#: keep the ``a``: plain sm_90 refuses wgmma/setmaxnreg in later kernels
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then the
    toolkit's default prefix."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels build from csrc/ at first use")


def library_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


class KernelLibraries:
    """Loaded ``csrc/<name>.cu`` libraries, each built on first use.
    ``build_log`` maps a name to the wall seconds (from the start of the
    builds started with it) and the ptxas ``-v`` report of the ``nvcc``
    run that built it in this process."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._loaded: Dict[str, ctypes.CDLL] = {}
        self.build_log: Dict[str, dict] = {}

    def load(self, name: str) -> ctypes.CDLL:
        """The loaded library of ``csrc/<name>.cu``, built first if it
        has no current build. Raises RuntimeError with the compiler's
        output if the build fails."""
        with self._lock:
            lib = self._loaded.get(name)
            if lib is None:
                self._build([name])
                lib = self._loaded[name] = ctypes.CDLL(str(library_path(name)))
            return lib

    def build(self, names: Sequence[str]) -> None:
        """Build every named source that has no current build: one
        ``nvcc`` per source, all started together."""
        with self._lock:
            self._build(names)

    def _build(self, names: Sequence[str]) -> None:
        todo = [(n, library_path(n)) for n in names]
        todo = [(n, out) for n, out in todo if not out.exists()]
        if not todo:
            return
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        compiler = nvcc()
        t0 = time.perf_counter()
        running = []
        for name, out in todo:
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            proc = subprocess.Popen(
                [compiler, *NVCC_FLAGS, "-o", str(tmp),
                 str(CSRC_DIR / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            running.append((name, out, tmp, proc))
        failed = []
        for name, out, tmp, proc in running:
            report = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(f"CUDA kernel build of {name} failed: nvcc "
                              f"exit {proc.returncode}\n{report}")
                continue
            os.replace(tmp, out)
            self.build_log[name] = {"seconds": time.perf_counter() - t0,
                                    "ptxas": report.strip()}
        if failed:
            raise RuntimeError("\n".join(failed))


#: the process's kernel libraries (one build and one load per source)
libraries = KernelLibraries()
