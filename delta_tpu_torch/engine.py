"""TorchEngine: the CUDA-backed engine of the port.

Counterpart of `delta_tpu/engine/tpu.py::TpuEngine` plus the read half of
`delta_tpu/engine/host.py`. It holds the device every load runs on and
the filesystem the log is read from. On the card, every snapshot load
takes the device page decode for every Parquet checkpoint part, the
device JSON parse and the device replay; the routing economics of the JAX
package (`parallel/gate.py::decode_route` and `replay_route`) are not
ported yet.
"""

from __future__ import annotations

import torch

from delta_tpu_torch.replay.device_parse import DEFAULT_WINDOW_BYTES
from delta_tpu_torch.storage.local import LocalLogStore


class TorchEngine:
    """Runs on `cuda` unless the caller passes `device="cpu"` (which the
    CPU tests do: every kernel then runs its plain PyTorch version). With
    no card and no explicit device it raises; it never slides to the CPU.

    `parse_window_bytes` caps one device parse window (commits are never
    split across windows)."""

    def __init__(self, device=None,
                 parse_window_bytes: int = DEFAULT_WINDOW_BYTES):
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "TorchEngine: no CUDA device is available; pass "
                    "device='cpu' to run the plain PyTorch versions")
            device = "cuda"
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"TorchEngine: {self.device} requested but "
                               f"no CUDA device is available")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"TorchEngine: unsupported device {self.device}")
        self.parse_window_bytes = int(parse_window_bytes)
        self.fs = LocalLogStore()

    def synchronize(self) -> None:
        """Wait for the device's queued work (no-op on the CPU)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __repr__(self):
        return f"TorchEngine(device={str(self.device)!r})"
