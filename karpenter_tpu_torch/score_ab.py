"""Time the price-row entry of the packed-score kernel of one checkout.

    python karpenter_tpu_torch/score_ab.py [--root DIR] [--out NAME]

Run from the repository root, on the CUDA card.  ``--root`` names the
checkout whose ``karpenter_tpu_torch`` is timed (default: this one), so two
versions of the kernel can be compared in one run on one card: unpack the
other commit with ``git archive`` into a git-ignored directory and run
this script on each tree in turns (old, new, new, old).  The timing itself
is ``chip_smoke.py``'s, from this checkout: ``packed_scan_scores``, its
plain version and the one-call yardstick, graph-replayed between CUDA
events, at the slice's shape (40 x 425), at 4,096 x 1,024 and at
65,536 x 1,024 (two 64 MiB buffers used in turn, so L2 does not hold the
next call's f).  Prints one JSON line with the card's ``nvidia-smi`` name
and power limit, and writes it to ``chiprun_out/<NAME>.json``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

_REPO = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(_REPO))
    ap.add_argument("--out", default="score_ab")
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    # the timed package from --root; chip_smoke's timing from this checkout
    sys.path.insert(0, str(root))
    import importlib.util

    import numpy as np
    import torch

    spec = importlib.util.spec_from_file_location(
        "chip_smoke_timing", _REPO / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import karpenter_tpu_torch
    from karpenter_tpu_torch.models.tensorize import pack_feasibility

    if not torch.cuda.is_available():
        print("score_ab: no CUDA device", file=sys.stderr)
        return 2
    pkg = Path(karpenter_tpu_torch.__file__).resolve().parent
    if pkg.parent != root:
        print(f"score_ab: imported {pkg}, not the package under {root}",
              file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    zeros = np.zeros(1)
    out = dict(root=str(root), nvidia_smi=smi)
    for name, (G, C, p, n_buf) in {
            "packed_40x425": (40, 425, 0.3, 1),
            "packed_4096x1024": (4096, 1024, 0.6, 1),
            "packed_65536x1024": (65536, 1024, 0.5, 2)}.items():
        fs = []
        for b in range(n_buf):
            feas, base, prov, _ = cs._score_case(G, C, 13 + b, p=p,
                                                 ties=False)
            fs.append(torch.from_numpy(pack_feasibility(feas)).cuda())
            del feas
        row = cs.host_row(base, prov, zeros).cuda()
        out[name] = cs._time_packed(fs, row)
        del fs
    line = json.dumps(out)
    dest = Path("chiprun_out")
    dest.mkdir(exist_ok=True)
    (dest / f"{args.out}.json").write_text(line)
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
