#!/usr/bin/env python
"""Render the GPU-node deployment of the PyTorch/CUDA port.

The port's counterpart of ``deploy/render.py``, with its own copy of the
``${KT_NAME:-default}`` token logic (pure stdlib, no helm/kustomize).  It
emits the shared ``rbac.yaml`` and ``configmap.yaml`` as they are, then the
GPU pair: ``gpu/solver.yaml`` (the ``karpenter-tpu-torch serve`` sidecar on
NVIDIA nodes, one ``nvidia.com/gpu`` each, its fleet Deployment and the
session-spool claim) and ``gpu/operator.yaml`` (the operator, which needs
no GPU and dials the solver Service):

    python deploy/render_torch.py                      # all manifests, stdout
    KT_IMAGE=repo/karpenter-tpu-torch:v1 KT_NAMESPACE=prod \\
        python deploy/render_torch.py | kubectl apply -f -
    python deploy/render_torch.py --out build/         # one file per manifest

Values (beside ``deploy/render.py``'s):
    KT_IMAGE              container image             (karpenter-tpu-torch:latest
                                                       in the GPU pair)
    KT_GPU_PRODUCT        nvidia.com/gpu.product label of the solver's
                          nodes                       (NVIDIA-H100-80GB-HBM3)
    KT_SOLVER_REPLICAS    solver sidecar replicas     (1 per GPU)
    KT_JIT_CACHE_DIR      the kernel library's directory in the solver
                          container                   (/var/cache/karpenter-tpu-jit)

Unknown ``${KT_...}`` tokens without a default are an error (a typo'd
token must not ship as a literal).
"""

from __future__ import annotations

import argparse
import os
import re
import sys
from pathlib import Path

TOKEN = re.compile(r"\$\{(KT_[A-Z0-9_]+)(?::-([^}]*))?\}")

#: render order mirrors apply order (rbac before the deployments)
MANIFESTS = ("rbac.yaml", "configmap.yaml", "gpu/solver.yaml",
             "gpu/operator.yaml")


def render_text(text: str, env=None) -> str:
    env = os.environ if env is None else env

    def sub(m: re.Match) -> str:
        name, default = m.group(1), m.group(2)
        val = env.get(name, default)
        if val is None:
            raise KeyError(f"token ${{{name}}} has no default and {name} "
                           f"is not set")
        return val

    return TOKEN.sub(sub, text)


def render_all(base: Path = None, env=None) -> dict:
    base = base or Path(__file__).parent
    return {name: render_text((base / name).read_text(), env)
            for name in MANIFESTS}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="deploy/render_torch.py")
    ap.add_argument("--out", default="", help="write per-manifest files here "
                                             "instead of stdout")
    args = ap.parse_args(argv)
    rendered = render_all()
    if args.out:
        out = Path(args.out)
        for name, text in rendered.items():
            (out / name).parent.mkdir(parents=True, exist_ok=True)
            (out / name).write_text(text)
            print(f"wrote {out / name}", file=sys.stderr)
    else:
        try:
            print("\n---\n".join(rendered[n].strip() for n in MANIFESTS))
        except BrokenPipeError:  # | head — not an error
            sys.stderr.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
