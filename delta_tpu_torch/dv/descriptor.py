"""Deletion-vector storage: paths, inline blobs, the file layout.

Counterpart of `delta_tpu/dv/descriptor.py`, after the Delta protocol's
deletion vector descriptor:

- storageType 'u': pathOrInlineDv = `<random prefix><base85 uuid (20
  chars)>`; the DV lives in `<table>/<prefix>/deletion_vector_<uuid>.bin`
  at `offset` (this package writes no prefix; other writers do);
- storageType 'p': an absolute path;
- storageType 'i': pathOrInlineDv = base85 of the magic-prefixed blob.

DV file layout (big-endian): [version u8 = 1], then per DV [dataSize i32]
[blob: magic + portable bitmap][crc32 of the blob]. Base85 is the RFC 1924
alphabet (Python's `base64.b85*`), as the reference writes it.

A blob read from a file is checked against its CRC, and against the
descriptor's `sizeInBytes` and `cardinality`; a mismatch raises
`DeletionVectorError` with the reference's error class. The mask route
(`load_deletion_vector_masks`) reads each DV file of a batch once and
decodes every blob of the batch in one K8 launch on the engine's device
(`dv/roaring.py::decode_delta_masks`); the values route
(`load_deletion_vector`) decodes on the host. `write_deletion_vector_file`
packs every bitmap container of its DVs in one K8 launch.
"""

from __future__ import annotations

import base64
import struct
import uuid as _uuid
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from delta_tpu_torch.dv.roaring import (
    RoaringBitmapArray,
    checksum,
    decode_delta_masks,
    serialize_deltas,
)
from delta_tpu_torch.errors import DeletionVectorError
from delta_tpu_torch.models.actions import DeletionVectorDescriptor

DV_FILE_VERSION = 1


def encode_uuid_base85(u: _uuid.UUID) -> str:
    return base64.b85encode(u.bytes).decode("ascii")


def decode_uuid_base85(s: str) -> _uuid.UUID:
    return _uuid.UUID(bytes=base64.b85decode(s.encode("ascii")))


def absolute_dv_path(table_path: str, descriptor_row: Dict) -> str:
    """The DV file of a descriptor ('u' or 'p'; a dict or its to_dict)."""
    storage = descriptor_row["storageType"]
    p = descriptor_row["pathOrInlineDv"]
    if storage == "p":
        return p
    if storage == "u":
        prefix, enc = p[:-20], p[-20:]
        name = f"deletion_vector_{decode_uuid_base85(enc)}.bin"
        return f"{table_path}/{prefix}/{name}" if prefix \
            else f"{table_path}/{name}"
    raise DeletionVectorError(
        f"cannot resolve a path for storageType {storage!r}",
        error_class="DELTA_CANNOT_RECONSTRUCT_PATH_FROM_URI")


def _load_blob(engine, table_path: str, descriptor_row: Dict,
               files: Optional[Dict[str, bytes]] = None
               ) -> tuple[bytes, str]:
    """Descriptor -> (the blob, checked against its CRC and declared size;
    where it was read). `files` caches DV files by path across a batch."""
    if descriptor_row["storageType"] == "i":
        blob = base64.b85decode(
            descriptor_row["pathOrInlineDv"].encode("ascii"))
        where = "<inline>"
    else:
        where = absolute_dv_path(table_path, descriptor_row)
        files = {} if files is None else files
        data = files.get(where)
        if data is None:
            data = files[where] = engine.fs.read_file(where)
        offset = descriptor_row.get("offset") or 0
        (size,) = struct.unpack_from(">i", data, offset)
        blob = data[offset + 4:offset + 4 + size]
        (crc,) = struct.unpack_from(">I", data, offset + 4 + size)
        if checksum(blob) != crc:
            raise DeletionVectorError(
                f"deletion vector checksum mismatch in {where}",
                error_class="DELTA_DELETION_VECTOR_CHECKSUM_MISMATCH")
    declared = descriptor_row.get("sizeInBytes")
    if declared is not None and declared != len(blob):
        raise DeletionVectorError(
            f"deletion vector at {where}: sizeInBytes {declared} != actual "
            f"{len(blob)}", error_class="DELTA_DELETION_VECTOR_SIZE_MISMATCH")
    return blob, where


def _check_cardinality(descriptor_row: Dict, card: int, where: str) -> None:
    declared = descriptor_row.get("cardinality")
    if declared is not None and declared != card:
        raise DeletionVectorError(
            f"deletion vector at {where}: cardinality {declared} != decoded "
            f"{card}", error_class="DELTA_DELETION_VECTOR_CARDINALITY_MISMATCH")


def load_deletion_vector(engine, table_path: str,
                         descriptor_row: Dict) -> np.ndarray:
    """Descriptor -> sorted uint64 array of deleted row indexes, decoded on
    the host."""
    blob, where = _load_blob(engine, table_path, descriptor_row)
    values = RoaringBitmapArray.deserialize_delta(blob).values
    _check_cardinality(descriptor_row, len(values), where)
    return values


def load_deletion_vector_masks(engine, table_path: str,
                               rows: Sequence[Tuple[Dict, int]]
                               ) -> List[np.ndarray]:
    """[(descriptor, the file's rows)] -> each file's bool deleted-row
    mask: each DV file read once, every blob checked, all decoded in one
    K8 launch on the engine's device."""
    files: Dict[str, bytes] = {}
    loaded = [_load_blob(engine, table_path, d, files) for d, _ in rows]
    decoded = decode_delta_masks([b for b, _ in loaded],
                                 [n for _, n in rows], engine.device)
    for (d, _), (_, where), (_, card) in zip(rows, loaded, decoded):
        _check_cardinality(d, card, where)
    return [mask for mask, _ in decoded]


def load_deletion_vector_mask(engine, table_path: str, descriptor_row: Dict,
                              num_rows: int) -> np.ndarray:
    """Descriptor -> bool deleted-row mask [num_rows]: a batch of one."""
    return load_deletion_vector_masks(engine, table_path,
                                      [(descriptor_row, num_rows)])[0]


def write_deletion_vector_file(engine, table_path: str,
                               bitmaps: List[RoaringBitmapArray]
                               ) -> List[DeletionVectorDescriptor]:
    """Write one `deletion_vector_<uuid>.bin` at the table root holding
    `bitmaps` (serialized on the engine's device, one pack launch for
    all); returns their 'u' descriptors, which share the file."""
    u = _uuid.uuid4()
    path = f"{table_path}/deletion_vector_{u}.bin"
    body = bytearray([DV_FILE_VERSION])
    descriptors = []
    for bm, blob in zip(bitmaps, serialize_deltas(bitmaps, engine.device)):
        offset = len(body)
        body += struct.pack(">i", len(blob))
        body += blob
        body += struct.pack(">I", checksum(blob))
        descriptors.append(DeletionVectorDescriptor(
            storageType="u",
            pathOrInlineDv=encode_uuid_base85(u),
            offset=offset, sizeInBytes=len(blob),
            cardinality=bm.cardinality))
    engine.fs.write(path, bytes(body), overwrite=True)
    return descriptors


def inline_descriptor(bitmap: RoaringBitmapArray,
                      device) -> DeletionVectorDescriptor:
    """An 'i' descriptor holding `bitmap` itself."""
    blob = bitmap.serialize_delta(device)
    return DeletionVectorDescriptor(
        storageType="i",
        pathOrInlineDv=base64.b85encode(blob).decode("ascii"),
        sizeInBytes=len(blob), cardinality=bitmap.cardinality)
