"""Deletion vectors: roaring-bitmap soft deletes.

Counterpart of `delta_tpu/dv/`: `roaring.py` holds the bitmap set, its
serialization (RoaringFormatSpec 32-bit plus the 64-bit portable form)
and the decode of a batch of stored blobs to row masks in one K8 launch;
`descriptor.py` the Delta wire formats (the magic-prefixed blob, the
versioned DV file, inline base85 descriptors, 'u' paths).
"""

from delta_tpu_torch.dv.descriptor import (
    absolute_dv_path,
    inline_descriptor,
    load_deletion_vector,
    load_deletion_vector_mask,
    load_deletion_vector_masks,
    write_deletion_vector_file,
)
from delta_tpu_torch.dv.roaring import RoaringBitmapArray

__all__ = [
    "RoaringBitmapArray",
    "absolute_dv_path",
    "inline_descriptor",
    "load_deletion_vector",
    "load_deletion_vector_mask",
    "load_deletion_vector_masks",
    "write_deletion_vector_file",
]
