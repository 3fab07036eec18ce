"""The port's hand-written CUDA kernels: build, load and launch counts.

Each ``csrc/*.cu`` file is one :class:`Library` with one or more plain C
launchers, each a :class:`Kernel` entry.  A library is compiled from the
checkout's sources at first use with
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``
into ``karpenter_tpu_torch/_build/`` (one library per source content
hash, so an edited source rebuilds) and loaded with ``ctypes``.  Nothing
is compiled or loaded at import: the CPU tests import every module.

Every kernel entry carries a plain ``launches`` counter that its wrapper
adds one to where it launches the kernel, and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Sequence

_PKG = Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, /usr/local/cuda, or PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                           "on a machine with the CUDA toolkit")
    return found


class Library:
    """One CUDA source, compiled to one shared library."""

    def __init__(self, name: str, source: str) -> None:
        self.name = name
        self.source = _CSRC / source
        self.build_s: Optional[float] = None
        self.handle = None

    @property
    def repo_path(self) -> str:
        """The source's path relative to the repository root."""
        return str(self.source.relative_to(_PKG.parent))

    def library_path(self) -> Path:
        digest = hashlib.sha256(self.source.read_bytes()).hexdigest()[:12]
        return _BUILD / f"lib{self.name}_{digest}.so"

    def compile_command(self) -> List[str]:
        return [nvcc_path(), *NVCC_FLAGS, "-o", str(self.library_path()),
                str(self.source)]


class Kernel:
    """One C launcher of a :class:`Library`, with its launch counter."""

    def __init__(self, name: str, library: Library, symbol: str,
                 argtypes: Sequence) -> None:
        self.name = name
        self.library = library
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._fn = None

    @property
    def repo_path(self) -> str:
        return self.library.repo_path

    def launcher(self):
        """The loaded C launcher, building the library first if needed."""
        if self._fn is None:
            build([self])
            fn = getattr(self.library.handle, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn


def build(kernels: Sequence[Kernel]) -> Dict[str, float]:
    """Compile every library of ``kernels`` not built yet — one ``nvcc`` per
    source, all started together — and load them.  Returns seconds per
    library built."""
    import time

    _BUILD.mkdir(parents=True, exist_ok=True)
    todo = [lib for lib in libraries(kernels) if lib.handle is None]
    procs = []
    t0 = time.perf_counter()
    for lib in todo:
        path = lib.library_path()
        if path.exists():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = lib.compile_command()
        cmd[cmd.index("-o") + 1] = str(tmp)
        procs.append((lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for lib, tmp, proc in procs:
        out, _ = proc.communicate()
        lib.build_s = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"{lib.name}: nvcc exited {proc.returncode}\n"
                          f"{out.decode(errors='replace')}")
            continue
        os.replace(tmp, lib.library_path())
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    for lib in todo:
        lib.handle = ctypes.CDLL(str(lib.library_path()))
    return {lib.name: (lib.build_s or 0.0) for lib in todo}


#: csrc/packed_score.cu: one kernel template, two entries
PACKED_SCORE_LIB = Library("packed_score", "packed_score.cu")

#: replaces karpenter_tpu/solver/hierarchy.py::_pallas_score — f int8
#: [G, C] and a bf16 price row [C]
PACKED_SCORE = Kernel(
    "packed_score", PACKED_SCORE_LIB, "packed_score_launch",
    [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])

#: the price loop's score step: _pallas_score fused with the host price
#: math before it (f, base prices and owners resident, exp(lam) per call)
PRICE_STEP_SCORE = Kernel(
    "price_step_score", PACKED_SCORE_LIB, "price_step_score_launch",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p])

#: every kernel entry of the port
ALL: List[Kernel] = [PACKED_SCORE, PRICE_STEP_SCORE]


def libraries(kernels: Sequence[Kernel] = ()) -> List[Library]:
    """The distinct libraries behind ``kernels`` (default: all), in order."""
    return list({id(k.library): k.library
                 for k in (kernels or ALL)}.values())


def reset_counts() -> None:
    for k in ALL:
        k.launches = 0
