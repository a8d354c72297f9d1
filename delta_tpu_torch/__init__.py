"""delta_tpu_torch: the PyTorch/CUDA port of delta-tpu, for an NVIDIA H100.

The JAX package `delta_tpu` stays the reference; this package imports
nothing of it. This slice loads a commit-only `_delta_log`:

    from delta_tpu_torch import Table, TorchEngine
    state = Table.for_path(path, engine=TorchEngine()).latest_snapshot().state

LIST -> parallel read -> device JSON parse (kernel K1, byte classes) ->
device replay (stable sort + kernel K2, the winner pass) -> live-file and
tombstone masks on the card.
"""

from delta_tpu_torch.engine import TorchEngine
from delta_tpu_torch.table import Table

__all__ = ["Table", "TorchEngine"]
