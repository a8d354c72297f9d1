"""Hand-over between numpy arrays and the port's tensors.

The two packages share the `_delta_log` on disk; for the module-level
tests they also share inputs. These helpers turn the JAX package's replay
lanes (numpy) into this package's tensors, and this package's parse lanes
back into numpy, so that both sides see identical values.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from delta_tpu_torch.ops.json_parse import FLAG_NAMES, SPAN_NAMES, VAL_NAMES


def replay_inputs_from_numpy(key_lanes: Sequence[np.ndarray],
                             version: np.ndarray, order: np.ndarray,
                             is_add: np.ndarray, device):
    """(key lanes int64, version int64, order int32, is_add bool) tensors
    on `device`, from the JAX package's numpy replay lanes (uint32 or
    int32 codes)."""
    lanes = [torch.from_numpy(np.asarray(k).astype(np.int64)).to(device)
             for k in key_lanes]
    return (lanes,
            torch.from_numpy(np.asarray(version).astype(np.int64)).to(device),
            torch.from_numpy(np.asarray(order).astype(np.int32)).to(device),
            torch.from_numpy(np.asarray(is_add).astype(bool)).to(device))


def lanes_to_numpy(vals: torch.Tensor, spans: torch.Tensor,
                   flags: torch.Tensor, n_lines: int) -> Dict[str, np.ndarray]:
    """`ops.json_parse.parse_lanes` output -> {lane name: numpy [n_lines]},
    keyed like the JAX package's `parse_window_fields` result."""
    out = {}
    for names, block in ((VAL_NAMES, vals), (SPAN_NAMES, spans),
                         (FLAG_NAMES, flags)):
        block = block[:, :n_lines].cpu().numpy()
        for i, name in enumerate(names):
            out[name] = block[i]
    return out
