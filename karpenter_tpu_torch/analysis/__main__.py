"""``python -m karpenter_tpu_torch.analysis`` — run ktlint over the port.

Exits non-zero when any unsuppressed finding remains
(tests/test_torch_lint.py gates on this).
"""

from .ktlint import main

if __name__ == "__main__":
    raise SystemExit(main())
