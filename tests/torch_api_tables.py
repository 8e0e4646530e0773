"""Helpers of the table API parity tests (tests/test_torch_api.py,
test_torch_create.py, test_torch_clone.py, test_torch_convert.py).

A case is a function ``case(p, root)``: ``p`` is one package's entry points
under one set of names (:class:`P`), ``root`` a directory of that package's
own. :func:`both` runs the case once a package, each in its own directory,
and holds the two observations equal: what the case returns, an exception
as its class and message, and :func:`state` of a table (its version, its
rows as both packages read them, its files' partition values, stats and
deletion-vector cardinalities, its metadata and protocol, and every
commit's operation, parameters and metrics without times and byte counts).
Every string is compared with the case's directory written as ``<root>``,
so paths under it compare equal; file names (random in each package) are
never compared.
"""
import json
import os

import delta_tpu
import delta_tpu_torch
from delta_tpu.ops.state_cache import DeviceStateCache as JaxCache
from delta_tpu.protocol import filenames
from delta_tpu_torch.ops.state_cache import DeviceStateCache as TorchCache
from tests.torch_port_tables import Pkg, reset_caches, sorted_rows

PKGS = ("jax", "torch")


class P(Pkg):
    """One package's table API: the JAX package's as it is, the port's
    with ``device="cpu"`` on every entry point that takes a device."""

    def __init__(self, name):
        super().__init__(name)
        if self.jax:
            from delta_tpu.api import tables as api
            from delta_tpu.catalog import catalog
            from delta_tpu.commands import alter, clone, convert, create
            from delta_tpu.exec import scan
            from delta_tpu.hooks import symlink_manifest
            from delta_tpu.schema import types
            from delta_tpu.utils import errors
        else:
            from delta_tpu_torch.api import tables as api
            from delta_tpu_torch.catalog import catalog
            from delta_tpu_torch.commands import alter, clone, convert, create
            from delta_tpu_torch.exec import scan
            from delta_tpu_torch.hooks import symlink_manifest
            from delta_tpu_torch.schema import types
            from delta_tpu_torch.utils import errors
        self.api, self.catalog, self.alter, self.types, self.errors = (
            api, catalog, alter, types, errors)
        self.clone_mod, self.convert_mod, self.create_mod = clone, convert, create
        self.scan_mod, self.manifest = scan, symlink_manifest
        self.DeltaTable = api.DeltaTable
        self.dev = {} if self.jax else {"device": "cpu"}

    # -- constructors with the device where the package takes one --------

    def create(self, path, *a, **kw):
        return self.DeltaTable.create(path, *a, **kw, **self.dev)

    def replace(self, path, *a, **kw):
        return self.DeltaTable.replace(path, *a, **kw, **self.dev)

    def for_path(self, path):
        return self.DeltaTable.for_path(path, **self.dev)

    def for_name(self, name, catalog=None):
        return self.DeltaTable.for_name(name, catalog, **self.dev)

    def is_delta_table(self, path):
        return self.DeltaTable.is_delta_table(path, **self.dev)

    def convert_to_delta(self, path, partition_schema=None):
        return self.DeltaTable.convert_to_delta(path, partition_schema, **self.dev)

    def catalog_create(self, cat, name, path, *a, **kw):
        return cat.create_table(name, path, *a, **kw, **self.dev)

    def load_table(self, cat, name):
        return cat.load_table(name, **self.dev)

    # -- values ----------------------------------------------------------

    def schema(self, *fields):
        """A StructType of ``(name, type name[, nullable])`` fields, the
        type name one of ``schema.types``' classes (``"LongType"``) or a
        StructType already built."""
        st = self.types.StructType()
        for f in fields:
            name, typ = f[0], f[1]
            dt = getattr(self.types, typ)() if isinstance(typ, str) else typ
            st = st.add(name, dt, *f[2:])
        return st

    def read(self, t, **kw):
        """Sorted Python rows of ``t`` (``kw``: filters, columns, version)."""
        got = t.to_arrow(**kw) if self.jax else t.to_table(**kw)
        return sorted_rows(got.to_pylist())


def norm(obj, root):
    """``obj`` with ``root`` written as ``<root>`` in every string."""
    root = str(root)
    if isinstance(obj, str):
        return obj.replace(root, "<root>")
    if isinstance(obj, dict):
        return {norm(k, root): norm(v, root) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(norm(v, root) for v in obj)
    return obj


def observe(fn):
    """The call's value, or ``("raises", class name, message)``."""
    try:
        return fn()
    except Exception as e:  # the class and message are the observation
        return ("raises", type(e).__name__, str(e))


def _commits(path, version):
    out = []
    for v in range(version + 1):
        p = os.path.join(path, "_delta_log", filenames.delta_file(v))
        if not os.path.exists(p):
            out.append(None)  # cleaned up
            continue
        kinds, seen = [], {}
        with open(p) as f:
            for line in f:
                if not line.strip():
                    continue
                a = json.loads(line)
                k = next(iter(a))
                kinds.append(k)
                body = a[k]
                if k == "commitInfo":
                    seen["op"] = (body.get("operation"), body.get("operationParameters"),
                                  {m: x for m, x in (body.get("operationMetrics") or {}).items()
                                   if not m.endswith(("TimeMs", "Bytes", "Size"))
                                   and m != "sourceTableSize"})
                elif k == "metaData":
                    seen["metaData"] = (body.get("schemaString"), body.get("partitionColumns"),
                                        body.get("configuration"), body.get("name"),
                                        body.get("description"))
                elif k == "protocol":
                    seen["protocol"] = body
        out.append((sorted(kinds), seen))
    return out


def state(path):
    """A table's state as both packages see it (None where there is no
    table): both packages' reads of it must agree."""
    jlog = delta_tpu.DeltaLog.for_table(path)
    snap = jlog.update()
    if snap.version < 0:
        return None
    rows = sorted_rows(delta_tpu.DeltaTable.for_path(path).to_arrow().to_pylist())
    delta_tpu_torch.DeltaLog.clear_cache()
    port = delta_tpu_torch.DeltaTable.for_path(path, device="cpu")
    assert sorted_rows(port.to_table().to_pylist()) == rows
    assert port.version == snap.version
    files = sorted(
        (json.dumps(f.partition_values, sort_keys=True),
         json.dumps(json.loads(f.stats) if f.stats else None, sort_keys=True),
         f.deletion_vector["cardinality"] if f.deletion_vector else None,
         os.path.isabs(f.path))
        for f in snap.all_files)
    meta = snap.metadata
    proto = snap.protocol
    return {"version": snap.version, "rows": rows, "files": files,
            "schema": meta.schema_string, "partition_columns": list(meta.partition_columns),
            "configuration": dict(meta.configuration or {}),
            "protocol": (proto.min_reader_version, proto.min_writer_version,
                         tuple(proto.reader_features or ()), tuple(proto.writer_features or ())),
            "tombstones": len(snap.tombstones), "commits": _commits(path, snap.version)}


def fresh():
    """Both packages' process caches emptied."""
    reset_caches()
    JaxCache.reset()
    TorchCache.reset()
    delta_tpu.DeltaLog.clear_cache()


def both(tmp_path, case):
    """Run ``case(p, root)`` in each package's own directory and hold the
    two observations equal; returns the JAX package's."""
    got = {}
    for name in PKGS:
        root = os.path.join(str(tmp_path), name)
        os.makedirs(root)
        fresh()
        got[name] = norm(observe(lambda: case(P(name), root)), root)
        fresh()
    assert got["torch"] == got["jax"]
    return got["jax"]
