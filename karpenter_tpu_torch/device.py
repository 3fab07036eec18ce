"""Device resolution for the port's entry points.

The port runs on a CUDA device.  ``device=None`` means the card and RAISES
when CUDA is absent — there is no silent CPU path.  Only an explicit
``device="cpu"`` (the tests, the CPU side of a parity check) runs the plain
PyTorch path on the host.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` -> ``cuda`` (raising without CUDA); anything else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "karpenter_tpu_torch runs on a CUDA device and none is "
                "available; pass device='cpu' explicitly to run the plain "
                "PyTorch path on the host")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev


class ProgramRuns:
    """Run counter of one plain-PyTorch device program (the relax descent,
    the consolidation screen), per device type: the program adds one where
    it runs, so a caller can zero the counts, drive an entry point and see
    which device the program ran on."""

    def __init__(self, name: str) -> None:
        self.name = name
        self.runs: dict = {}

    def add(self, device: torch.device) -> None:
        self.runs[device.type] = self.runs.get(device.type, 0) + 1

    def get(self, device_type: str) -> int:
        return self.runs.get(device_type, 0)

    def reset(self) -> None:
        self.runs = {}
