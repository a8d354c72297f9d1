"""Shared by the port's scan, read and conflict parity tests: tables the JAX
package writes (every type the port reads), and seeded random predicates
built alike in both packages' expression trees."""

import datetime
import json
import os
import shutil

import numpy as np
import pyarrow as pa

import delta_tpu.api as dta
from delta_tpu.engine.host import HostEngine

TYPES = ("long", "integer", "double", "float", "boolean", "string", "date",
         "timestamp")
UTC = datetime.timezone.utc
EPOCH = datetime.datetime(1970, 1, 1)


def typed_batch(rng, n: int, base: int, with_nulls: bool = True) -> pa.Table:
    """n rows of every type, values around `base` (each append covers its
    own range, so min/max stats separate the files)."""
    k = base + rng.integers(0, 100, n)
    mask = (rng.random(n) < 0.15) if with_nulls else np.zeros(n, bool)
    days = (k // 10).astype("timedelta64[D]") + np.datetime64("2020-01-01")
    us = k.astype(np.int64) * 3_600_000_000 + 1_600_000_000_000_000
    return pa.table({
        "long": pa.array(k, pa.int64()),
        "integer": pa.array(k.astype(np.int32) - 500, pa.int32(),
                            mask=mask),
        "double": pa.array(k / 7.0, pa.float64(), mask=np.roll(mask, 1)),
        "float": pa.array((k / 3.0).astype(np.float32), pa.float32()),
        "boolean": pa.array(k % 3 == 0, mask=np.roll(mask, 2)),
        "string": pa.array([f"s{int(x):05d}" for x in k], pa.string(),
                           mask=np.roll(mask, 3)),
        "date": pa.array(days.astype("datetime64[D]"), pa.date32(),
                         mask=np.roll(mask, 4)),
        "timestamp": pa.array(us, pa.timestamp("us", "UTC"),
                              mask=np.roll(mask, 5)),
    })


def write_typed_table(path: str, seed: int, appends: int = 6,
                      rows: int = 40, partition_by=None,
                      properties=None) -> list:
    """A table of `appends` reference appends; returns the batches."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(appends):
        b = typed_batch(rng, rows + 7 * i, 200 * i)
        if partition_by:
            b = b.append_column("p", pa.array([f"p{i % 3}"] * b.num_rows))
        dta.write_table(path, b, engine=HostEngine(),
                        partition_by=partition_by, properties=properties)
        out.append(b)
    return out


def add_file_without_stats(path: str) -> None:
    """Commit a copy of the table's first data file with no stats."""
    log = os.path.join(path, "_delta_log")
    versions = sorted(int(n[:20]) for n in os.listdir(log)
                      if n.endswith(".json"))
    with open(os.path.join(log, f"{versions[0]:020d}.json")) as f:
        add = next(json.loads(ln)["add"] for ln in f if '"add"' in ln)
    new = "part-nostats-" + add["path"].split("/")[-1]
    shutil.copy(os.path.join(path, add["path"]), os.path.join(path, new))
    body = {"path": new, "partitionValues": add["partitionValues"],
            "size": add["size"], "modificationTime": add["modificationTime"],
            "dataChange": True}
    with open(os.path.join(log, f"{versions[-1] + 1:020d}.json"), "w") as f:
        f.write(json.dumps({"add": body}) + "\n")


def build(spec, E):
    """The expression `spec` (nested tuples) in the tree module E."""
    tag = spec[0]
    if tag == "cmp":
        _, op, name, v, flip = spec
        c, lit = E.col(name), E.lit(v)
        return E.Comparison(op, lit, c) if flip else E.Comparison(op, c, lit)
    if tag == "in":
        return E.col(spec[1]).is_in(*spec[2])
    if tag == "null":
        return E.col(spec[1]).is_null()
    if tag == "notnull":
        return E.col(spec[1]).is_not_null()
    if tag == "starts":
        return E.col(spec[1]).starts_with(spec[2])
    if tag == "not":
        return ~build(spec[1], E)
    if tag == "or":
        return build(spec[1], E) | build(spec[2], E)
    if tag == "and":
        return build(spec[1], E) & build(spec[2], E)
    raise ValueError(tag)


def random_literal(rng, name: str, zoned: bool = True):
    """A literal for column `name` near the data's range; now and then of
    another type (the ladder and the evaluator must refuse alike)."""
    k = int(rng.integers(-50, 1300))
    roll = rng.random()
    if name in ("long", "integer"):
        v = k - (500 if name == "integer" else 0)
        return v + 0.5 if roll < 0.15 else (str(v) if roll < 0.2 else v)
    if name in ("double", "float"):
        v = k / (7.0 if name == "double" else 3.0)
        return int(v) if roll < 0.2 else v
    if name == "boolean":
        return bool(k % 2)
    if name == "string":
        return f"s{k:05d}" if roll < 0.9 else k
    if name == "date":
        d = datetime.date(2020, 1, 1) + datetime.timedelta(days=k // 10)
        return d.isoformat() if roll < 0.3 else d
    if name == "timestamp":
        t = EPOCH + datetime.timedelta(
            microseconds=k * 3_600_000_000 + 1_600_000_000_000_000)
        return t.replace(tzinfo=UTC) if zoned else t
    if name == "p":
        return f"p{k % 4}"
    return k


OPS = ("=", "!=", "<", "<=", ">", ">=")


def random_spec(rng, columns, depth: int = 0, zoned: bool = True):
    """A seeded random predicate over `columns`."""
    r = rng.random()
    name = columns[int(rng.integers(0, len(columns)))]
    if depth < 2 and r < 0.25:
        tag = ("and", "or")[int(rng.integers(0, 2))]
        return (tag, random_spec(rng, columns, depth + 1, zoned),
                random_spec(rng, columns, depth + 1, zoned))
    if depth < 2 and r < 0.32:
        return ("not", random_spec(rng, columns, depth + 1, zoned))
    if r < 0.42:
        vals = {random_literal(rng, name, zoned)
                for _ in range(int(rng.integers(1, 6)))}
        kinds = {type(v) for v in vals}
        if len(kinds) > 1:
            vals = {v for v in vals if type(v) is type(next(iter(vals)))}
        return ("in", name, tuple(sorted(vals, key=repr)))
    if r < 0.47:
        return ("null", name)
    if r < 0.52:
        return ("notnull", name)
    return ("cmp", OPS[int(rng.integers(0, 6))], name,
            random_literal(rng, name, zoned), bool(rng.random() < 0.3))
