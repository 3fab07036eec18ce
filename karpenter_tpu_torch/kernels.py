"""The port's hand-written CUDA kernels: build, load and launch counts.

Each kernel is one ``csrc/*.cu`` file with a plain C launcher.  It is
compiled from the checkout's sources at first use with
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``
into ``karpenter_tpu_torch/_build/`` (one library per source content
hash, so an edited source rebuilds) and loaded with ``ctypes``.  Nothing
is compiled or loaded at import: the CPU tests import every module.

Every kernel carries a plain ``launches`` counter that its wrapper adds one
to where it launches the kernel, and nowhere else.
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


class Kernel:
    """One CUDA source with its C launcher symbol and launch counter."""

    def __init__(self, name: str, source: str, symbol: str,
                 argtypes: Sequence) -> None:
        self.name = name
        self.source = _CSRC / source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self.build_s: Optional[float] = None
        self._lib = None

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

    def _load(self, path: Path) -> None:
        lib = ctypes.CDLL(str(path))
        fn = getattr(lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        self._lib = lib
        self._fn = fn

    def launcher(self):
        """The loaded C launcher, building the library first if needed."""
        if self._lib is None:
            build([self])
        return self._fn


def build(kernels: Sequence[Kernel]) -> Dict[str, float]:
    """Compile every kernel not built yet — one ``nvcc`` per source, all
    started together — and load them.  Returns seconds per kernel built."""
    import time

    _BUILD.mkdir(parents=True, exist_ok=True)
    todo = [k for k in kernels if k._lib is None]
    procs = []
    t0 = time.perf_counter()
    for k in todo:
        path = k.library_path()
        if path.exists():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = k.compile_command()
        cmd[cmd.index("-o") + 1] = str(tmp)
        procs.append((k, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for k, tmp, proc in procs:
        out, _ = proc.communicate()
        k.build_s = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"{k.name}: nvcc exited {proc.returncode}\n"
                          f"{out.decode(errors='replace')}")
            continue
        os.replace(tmp, k.library_path())
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    for k in todo:
        k._load(k.library_path())
    return {k.name: (k.build_s or 0.0) for k in todo}


#: replaces karpenter_tpu/solver/hierarchy.py::_pallas_score
PACKED_SCORE = Kernel(
    "packed_score", "packed_score.cu", "packed_score_launch",
    [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])

#: every kernel of the port
ALL: List[Kernel] = [PACKED_SCORE]


def reset_counts() -> None:
    for k in ALL:
        k.launches = 0
