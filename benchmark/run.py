"""Run one cell of the benchmark of ``karpenter_tpu_torch`` on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout.  The cell's configuration, traffic and
metrics are the ones ``BENCHMARK.json`` names.  The last line of standard
output is one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``; with ``--trace 1`` also ``breakdown``; the
numbers compared for ``correct`` under ``compared``, last), and the
compared numbers with their limits are the last lines of standard error.
Exits 2 without a result where there is no CUDA card, or fewer than the
cell asks for; 3 where a module of JAX or of the JAX package was loaded.

Every cache of the program and of the CUDA toolchain goes to a fixed
directory inside the checkout, ``.bench_cache/``, so that only a cell's
first run in a checkout builds anything.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".bench_cache"


def _environment(trace: bool) -> None:
    for var, sub in (("KT_JIT_CACHE", "kt_jit"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "nv")):
        path = CACHE / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)
    # one thread in each CPU math pool: the launching thread does not
    # share the cores with pools that spin between calls
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    if trace:
        # tear CUPTI down after the profiled stretch, so that it leaves
        # nothing behind in the solves that follow
        os.environ["TEARDOWN_CUPTI"] = "1"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment(bool(args.trace))
    sys.path.insert(0, str(ROOT))

    from benchmark import harness

    c = harness.cell(harness.manifest(ROOT), args.workload, ROOT)

    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < c["chips"]:
        print(f"benchmark: the cell needs {c['chips']} CUDA device(s); "
              f"this machine has {have}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    out = harness.run_cell(c, args.seed, args.seconds, bool(args.trace),
                           device, T_START)
    found = harness.banned_modules()
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, v in out["compared"].items():
        print(f"{name} {v['value']} limit {v['limit']}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
