"""Build the port's native libraries at first use and load them.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for Hopper (``sm_90a``),
and the host codec ``csrc/codec_host.cpp`` with ``g++``, into a shared
library with a plain C interface, loaded with ctypes. The event codec
``csrc/codec_py.cpp`` is a CPython extension: ``g++`` builds it against
``Python.h`` (``sysconfig``'s include directory) and it is imported as
the module ``fbtpu_torch_codec``. Every build lands under
``fluentbit_tpu_torch/_build/`` (listed in ``.gitignore``). The name
carries a digest of the source, the headers it may include and the
flags (for the extension also the include directory and the
interpreter's ``EXT_SUFFIX``), so an edited source, or a build for
another Python, never loads. Nothing here runs at import: the first
``load`` of a library builds it, and a failed build raises
``ops.device.DeviceError`` (lane ``flux`` for the sketch kernels,
``grep`` for the rest).
"""

from __future__ import annotations

import ctypes
import hashlib
import importlib.machinery
import importlib.util
import os
import shutil
import subprocess
import sysconfig
import threading
import time
from pathlib import Path
from typing import Dict, Sequence, Tuple

from .device import DeviceError

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

#: every source of ``csrc/``: the kernels K1-K3 (``grep_dfa``), K4
#: (``grep_assoc``), K6/K7/K9/K10 (``sketch``), K11 (``utf8``), the raw
#: chunk path's host codec (``codec_host``, C++ for the CPU) and the
#: event codec (``codec_py``, a CPython extension)
SOURCES = ("grep_dfa", "grep_assoc", "sketch", "utf8", "codec_host",
           "codec_py")

#: the sources ``g++`` builds as plain C libraries (``csrc/<name>.cpp``)
HOST_SOURCES = ("codec_host",)

#: the sources ``g++`` builds as CPython extensions, by the module name
#: each is imported as
EXT_SOURCES = {"codec_py": "fbtpu_torch_codec"}

#: every source ``g++`` builds (``csrc/<name>.cpp``); the rest are CUDA
GXX_SOURCES = HOST_SOURCES + tuple(EXT_SOURCES)

#: the headers of ``csrc/`` the CUDA sources include (the grep kernels'
#: bulk table copy): part of every CUDA library's digest
HEADERS = ("bulk_copy.cuh",)

#: the lane of a source's build errors (``grep`` where not listed)
LANES = {"sketch": "flux"}

#: keep the ``a``: plain sm_90 refuses wgmma/setmaxnreg in later kernels
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
GXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-pthread")
GXX_EXT_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")


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
    raise DeviceError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels build from csrc/ at first use")


def gxx() -> str:
    """Path of ``g++`` on ``PATH`` (``nvcc`` needs it too)."""
    found = shutil.which("g++")
    if found is None:
        raise DeviceError("g++ not found on PATH; the host codecs build "
                           "from csrc/codec_host.cpp and csrc/codec_py.cpp "
                           "at first use")
    return found


def python_include() -> str:
    """The interpreter's C header directory (``sysconfig``), where the
    extension's ``Python.h`` is looked for."""
    return sysconfig.get_paths().get("include") or ""


def source_path(name: str) -> Path:
    return CSRC_DIR / (f"{name}.cpp" if name in GXX_SOURCES
                       else f"{name}.cu")


def _flags(name: str) -> Tuple[str, ...]:
    if name in EXT_SOURCES:
        return GXX_EXT_FLAGS + ("-I", python_include())
    return GXX_FLAGS if name in HOST_SOURCES else NVCC_FLAGS


def library_path(name: str) -> Path:
    text = source_path(name).read_bytes()
    if name not in GXX_SOURCES:
        text += b"".join((CSRC_DIR / h).read_bytes() for h in HEADERS)
    if name in EXT_SOURCES:
        suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
        text += suffix.encode()
    else:
        suffix = ".so"
    digest = hashlib.sha256(text + " ".join(_flags(name)).encode()
                            ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}{suffix}"


def _import_extension(name: str, path: Path):
    """Import the built extension ``path`` as its module name."""
    module = EXT_SOURCES[name]
    loader = importlib.machinery.ExtensionFileLoader(module, str(path))
    spec = importlib.util.spec_from_file_location(module, str(path),
                                                  loader=loader)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class KernelLibraries:
    """Loaded ``csrc/`` libraries, each built on first use.
    ``build_log`` maps a name to the wall seconds (from the start of the
    builds started with it) and the compiler's report (ptxas ``-v`` for
    a kernel) of the run that built it in this process."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._loaded: Dict[str, object] = {}
        self.build_log: Dict[str, dict] = {}

    def load(self, name: str):
        """The loaded library of ``csrc/<name>`` (a ``ctypes.CDLL``; for
        an extension of ``EXT_SOURCES`` the imported module), built first
        if it has no current build. Raises DeviceError with the
        compiler's output if the build fails."""
        with self._lock:
            lib = self._loaded.get(name)
            if lib is None:
                self._build([name])
                path = library_path(name)
                lib = (_import_extension(name, path) if name in EXT_SOURCES
                       else ctypes.CDLL(str(path)))
                self._loaded[name] = lib
            return lib

    def build(self, names: Sequence[str]) -> None:
        """Build every named source that has no current build: one
        compiler process per source, all started together."""
        with self._lock:
            self._build(names)

    def _build(self, names: Sequence[str]) -> None:
        todo = [(n, library_path(n)) for n in names]
        todo = [(n, out) for n, out in todo if not out.exists()]
        if not todo:
            return
        for name, _ in todo:
            if name in EXT_SOURCES:
                header = Path(python_include()) / "Python.h"
                if not header.is_file():
                    raise DeviceError(
                        f"{header} not found: the event codec "
                        f"{source_path(name)} builds against the "
                        "interpreter's C headers (install its -dev "
                        "package)")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        running = []
        for name, out in todo:
            compiler = gxx() if name in GXX_SOURCES else nvcc()
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            proc = subprocess.Popen(
                [compiler, *_flags(name), "-o", str(tmp),
                 str(source_path(name))],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            running.append((name, out, tmp, proc))
        failed = []
        for name, out, tmp, proc in running:
            report = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append((name, f"build of {name} failed: "
                               f"{os.path.basename(proc.args[0])} exit "
                               f"{proc.returncode} on {source_path(name)}"
                               f"\n{report}"))
                continue
            os.replace(tmp, out)
            self.build_log[name] = {"seconds": time.perf_counter() - t0,
                                    "ptxas": report.strip()}
        if failed:
            raise DeviceError("\n".join(msg for _n, msg in failed),
                              lane=LANES.get(failed[0][0], "grep"))


#: the process's native libraries (one build and one load per source)
libraries = KernelLibraries()
