"""Machine-checked solver invariants of the port: the ktlint static
analyzer — the function-local rules plus the whole-program call-graph
passes (``analysis/callgraph.py``) — the protocol model checker
(``analysis/model.py``), the trace conformance checker
(``analysis/conformance.py``), and the runtime lock-discipline +
lock-order sanitizer (``KT_SANITIZE=1``).

Run the analyzer: ``python -m karpenter_tpu_torch.analysis``;
``--format json`` for machine-readable findings, ``--lock-order`` for the
KT012-derived global lock-acquisition order, ``--model`` for the protocol
models.  Rule catalog and annotation grammar: docs/ANALYSIS.md.

``sanitize`` is deliberately NOT imported here — the analyzer, the model
checker and the conformance checker are pure stdlib and must stay
importable without torch, numpy or grpc; the sanitizer wraps the serving
classes and is loaded on demand by ``karpenter_tpu_torch.__init__`` when
``KT_SANITIZE=1``.
"""

from .callgraph import (  # noqa: F401
    Project,
    SummaryCache,
    build_project,
)
from .ktlint import (  # noqa: F401
    Finding,
    analyze_files,
    analyze_package,
    analyze_source,
    load_source,
    main,
)
