"""karpenter_tpu_torch — the provisioning solver of karpenter_tpu, ported to
PyTorch and hand-written CUDA kernels for an NVIDIA H100.

The JAX package ``karpenter_tpu`` stays the reference; this package imports
nothing of it (and no JAX): it keeps its own copies of the host models and
of the solver modules its path runs.  Entry points run on the CUDA card
unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

# Lock-discipline sanitizer (``analysis/sanitize.py``): KT_SANITIZE=1 wraps
# the thread-sensitive serving classes in lock-assertion proxies that raise
# on cross-thread re-entrancy and on acquisitions against the global lock
# order.  Production leaves it off.
import os as _os

if _os.environ.get("KT_SANITIZE") == "1":
    from .analysis import sanitize as _sanitize

    _sanitize.install()
