"""ZCube tags and the clustered-table check.

Counterpart of `delta_tpu/clustering.py:23-59, 111-116`. OPTIMIZE ZORDER
BY stamps every file it writes with one set of ZCube tags per command
(`ZCUBE_ID`, the columns, the curve), so scan planning can see which
files were curve-clustered. A clustered table (liquid clustering: a
`delta.clusteringMetadata` domain in the snapshot) clusters by its own
columns; this package refuses it for now.
"""

from __future__ import annotations

import json
import uuid
from typing import List, Optional

CLUSTERING_DOMAIN = "delta.clusteringMetadata"
ZCUBE_ID_TAG = "ZCUBE_ID"
ZCUBE_ZORDER_BY_TAG = "ZCUBE_ZORDER_BY"
ZCUBE_ZORDER_CURVE_TAG = "ZCUBE_ZORDER_CURVE"


def clustering_columns(state) -> Optional[List[str]]:
    """The table's clustering columns, or None if it is not clustered."""
    dm = state.domain_metadata.get(CLUSTERING_DOMAIN)
    if dm is None or dm.removed or not dm.configuration:
        return None
    try:
        cols = json.loads(dm.configuration).get("clusteringColumns", [])
    except ValueError:
        return None
    return [".".join(c) if isinstance(c, list) else str(c) for c in cols]


def new_zcube_tags(columns: List[str], curve: str) -> dict:
    return {
        ZCUBE_ID_TAG: uuid.uuid4().hex,
        ZCUBE_ZORDER_BY_TAG: json.dumps(columns),
        ZCUBE_ZORDER_CURVE_TAG: curve,
    }
