"""Tables and helpers shared by the port's parity tests (tests/test_torch_*.py).

Every table is written through ``delta_tpu``'s own API as JSON commits, and
both packages read the same ``_delta_log/``. Inputs come from numpy seeds.

The MERGE parity tests (tests/test_torch_merge*.py) use :class:`Pkg`: one
vocabulary that builds the same tables, sources and clauses in either
package. A column is a Python list (ints, floats, strings, None for NULL)
or a ``(type, list)`` pair naming its type (``date`` takes
``datetime.date``s, ``timestamp`` and ``timestamp_utc`` naive
``datetime``s, ``decimal(p,s)`` ``Decimal``s, a nested spec of
``delta_tpu_torch.expr.nested`` such as ``("struct", (("x", "int64"), ("y",
"string")))`` its Python values: dicts, lists, lists of pairs for a map);
each package builds its own table from it (``pyarrow`` for ``delta_tpu``,
numpy masked arrays or ``HostColumn``s for ``delta_tpu_torch``).
"""
import datetime as dt
import json

import numpy as np
import pyarrow as pa

import delta_tpu
import delta_tpu_torch
from delta_tpu.commands.merge import MergeClause as JaxClause
from delta_tpu.commands.merge import MergeIntoCommand as JaxMerge
from delta_tpu.commands.write import WriteIntoDelta as JaxWrite
from delta_tpu.exec.scan import scan_to_table as jax_scan
from delta_tpu.log.deltalog import DeltaLog as JaxDeltaLog
from delta_tpu.ops.key_cache import KeyCache as JaxKeyCache
from delta_tpu.protocol import filenames
from delta_tpu.protocol.actions import AddFile, Metadata, Protocol, RemoveFile
from delta_tpu.schema.types import DoubleType, IntegerType, LongType, StringType, StructType
from delta_tpu.utils.config import conf as jax_conf
from delta_tpu_torch.commands.merge import MergeClause as TorchClause
from delta_tpu_torch.commands.merge import MergeIntoCommand as TorchMerge
from delta_tpu_torch.commands.write import WriteIntoDelta as TorchWrite
from delta_tpu_torch.exec.scan import scan_to_table as torch_scan
from delta_tpu_torch.ops.key_cache import KeyCache as TorchKeyCache
from delta_tpu_torch.utils.config import conf as torch_conf

DAYS = [f"2021-01-{d:02d}" for d in range(1, 29)]


def commit(path: str, version: int, actions) -> None:
    log = JaxDeltaLog.for_table(path)
    log.store.write(f"{log.log_path}/{filenames.delta_file(version)}",
                    [a.json() for a in actions])


def _stats(rng, i, n, base, partitioned):
    c0 = int(base["c0"][i])
    c1 = float(base["c1"][i])
    mins = {"c0": c0, "c1": c1}
    maxs = {"c0": c0 + int(rng.randint(0, 400)), "c1": c1 + float(rng.rand() * 3)}
    if i % 97 == 5:  # a file with no stats for c1: NaN lanes, always kept
        del mins["c1"], maxs["c1"]
    return json.dumps({"numRecords": int(rng.randint(1, 1000)), "minValues": mins,
                       "maxValues": maxs, "nullCount": {"c0": 0, "c1": 0}})


def write_table(path: str, n_files: int = 3000, partitioned: bool = False,
                seed: int = 7, commits: int = 3) -> dict:
    """v0 = protocol + metadata, then ``commits`` commits of adds: a
    well-clustered table (sorted per-file ranges), ``c0`` long and ``c1``
    double stats, and with ``partitioned`` a string ``day`` and an integer
    ``bucket`` partition column (some files null in ``bucket``). Returns the
    generator state the tail helper continues from."""
    rng = np.random.RandomState(seed)
    schema = StructType().add("c0", LongType()).add("c1", DoubleType())
    part_cols = []
    if partitioned:
        schema = schema.add("day", StringType()).add("bucket", IntegerType())
        part_cols = ["day", "bucket"]
    commit(path, 0, [Protocol(1, 2),
                     Metadata(schema_string=schema.to_json(), partition_columns=part_cols)])
    base = {"c0": np.sort(rng.randint(0, 1 << 22, n_files)),
            "c1": np.sort(rng.rand(n_files) * 1e4)}
    per = (n_files + commits - 1) // commits
    for v in range(commits):
        acts = []
        for i in range(v * per, min((v + 1) * per, n_files)):
            pv = {}
            if partitioned:
                bucket = None if i % 53 == 0 else str(i % 7)
                pv = {"day": DAYS[i * len(DAYS) // n_files], "bucket": bucket}
            acts.append(AddFile(path=f"part-{i:06d}.parquet", size=1000 + i,
                                partition_values=pv, modification_time=i,
                                data_change=True,
                                stats=_stats(rng, i, n_files, base, partitioned)))
        commit(path, v + 1, acts)
    return {"rng": rng, "n": n_files, "version": commits, "partitioned": partitioned,
            "base": base}


def write_tail(path: str, state: dict, n_commits: int = 3, adds: int = 40,
               removes: int = 20) -> None:
    """Commits of adds (fresh paths, and one re-add of a live path with new
    stats) and removes of live paths."""
    rng = state["rng"]
    for _ in range(n_commits):
        v = state["version"] + 1
        acts = []
        live = rng.choice(state["n"], removes + 1, replace=False)
        for i in live[:removes]:
            acts.append(RemoveFile(path=f"part-{i:06d}.parquet", deletion_timestamp=v,
                                   data_change=True))
        for j in range(adds + 1):
            i = state["n"] + j if j < adds else int(live[-1])  # last: a re-add
            c0 = int(rng.randint(0, 1 << 22))
            c1 = float(rng.rand() * 1e4)
            pv = {}
            if state["partitioned"]:
                # new values: one sorts after every day, one before it (the
                # second clears the dictionary's sorted flag)
                if j % 3:
                    day = "2021-02-01"
                else:
                    day = "2020-12-31" if j == 0 else DAYS[j % len(DAYS)]
                pv = {"day": day, "bucket": str(j % 9)}
            st = json.dumps({"numRecords": 5, "minValues": {"c0": c0, "c1": c1},
                             "maxValues": {"c0": c0 + 300, "c1": c1 + 2.0},
                             "nullCount": {"c0": 0, "c1": 0}})
            acts.append(AddFile(path=f"part-{i:06d}.parquet", size=7 + j,
                                partition_values=pv, modification_time=v,
                                data_change=True, stats=st))
        commit(path, v, acts)
        state["n"] += adds
        state["version"] = v


def point_queries(state: dict, count: int, seed: int = 3):
    """Point-range predicates shaped as the hot-plan benchmark builds them."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(count):
        i = rng.randint(len(state["base"]["c0"]))
        lo0 = int(state["base"]["c0"][i])
        lo1 = float(state["base"]["c1"][i])
        out.append(f"c0 >= {lo0} AND c0 <= {lo0 + 500} "
                   f"AND c1 >= {lo1:.6f} AND c1 <= {lo1 + 5:.6f}")
    return out


def write_ops_table(path):
    """tests/test_ops.py's files f1-f4 (long/double/string stats, a string
    partition), plus a file without stats, a null-partition file and a file
    whose int stats lie beyond 2^53."""
    from tests.test_ops import FILES, SCHEMA

    big = dict(json.loads(FILES[0].stats))
    big["minValues"] = dict(big["minValues"], id=2**53)
    big["maxValues"] = dict(big["maxValues"], id=2**53 + 1)
    extra = [
        AddFile(path="f5", partition_values={"part": "eu"}, size=10),
        AddFile(path="fnull", partition_values={"part": None}, size=1),
        AddFile(path="fbig", partition_values={"part": "us"}, size=1, stats=json.dumps(big)),
    ]
    commit(path, 0, [Protocol(1, 2), Metadata(schema_string=SCHEMA.to_json(),
                                              partition_columns=["part"])])
    commit(path, 1, list(FILES) + extra)


# -- the MERGE parity tests' vocabulary -------------------------------------------


_NP = {"int64": np.int64, "int32": np.int32, "float64": np.float64, "bool": bool}


def _infer(values):
    vals = [v for v in values if v is not None]
    if vals and all(isinstance(v, str) for v in vals):
        return "string"
    if vals and all(isinstance(v, bool) for v in vals):
        return "bool"
    if any(isinstance(v, float) for v in vals):
        return "float64"
    return "int64"


class Pkg:
    """One package's entry points under one set of names."""

    def __init__(self, name):
        self.name = name
        self.jax = name == "jax"
        self.conf = jax_conf if self.jax else torch_conf
        self.Clause = JaxClause if self.jax else TorchClause

    def column(self, spec):
        typ, values = spec if isinstance(spec, tuple) else (_infer(spec), spec)
        if isinstance(values, np.ndarray):
            values = values.tolist()
        mask = np.array([v is None for v in values], bool)
        if typ in ("date", "timestamp", "timestamp_utc"):
            return self._temporal(typ, values, mask)
        if isinstance(typ, tuple) or typ.startswith("decimal("):
            return self._typed(typ, values)
        if self.jax:
            t = {"int64": pa.int64(), "int32": pa.int32(), "float64": pa.float64(),
                 "string": pa.string(), "bool": pa.bool_()}[typ]
            return pa.array(values, t)
        if typ == "string":
            return np.ma.masked_array(np.array([v or "" for v in values], object), mask)
        fill = [0 if v is None else v for v in values]
        return np.ma.masked_array(np.array(fill, _NP[typ]), mask)

    def _temporal(self, typ, values, mask):
        if self.jax:
            return pa.array(values, {"date": pa.date32(), "timestamp": pa.timestamp("us"),
                                     "timestamp_utc": pa.timestamp("us", tz="UTC")}[typ])
        from delta_tpu_torch.expr.vectorized import HostColumn

        if typ == "date":
            epoch = dt.date(1970, 1, 1)
            lane = [0 if v is None else (v - epoch).days for v in values]
            return HostColumn("date", np.array(lane, np.int64), ~mask)
        epoch = dt.datetime(1970, 1, 1)
        lane = [0 if v is None else (v - epoch) // dt.timedelta(microseconds=1) for v in values]
        return HostColumn("ts", np.array(lane, np.int64), ~mask,
                          "timestamp[us, tz=UTC]" if typ == "timestamp_utc" else None)

    def _typed(self, typ, values):
        """A decimal or nested column."""
        from delta_tpu_torch.expr.nested import decimal_type, ncol_from_py
        from delta_tpu_torch.expr.vectorized import HostColumn

        spec = typ
        if isinstance(typ, str):
            p, sc = (int(x) for x in typ[len("decimal("):-1].split(","))
            spec = decimal_type(p, sc)
        if self.jax:
            return pa.array(values, arrow_type(spec))
        ncol = ncol_from_py(spec, values)
        if isinstance(spec, str):
            return HostColumn("decimal", ncol.values, ncol.valid, spec)
        return HostColumn("nested", ncol, ncol.valid, spec)

    def table(self, cols):
        if not isinstance(cols, dict):
            return cols  # already this package's table
        built = {k: self.column(v) for k, v in cols.items()}
        return pa.table(built) if self.jax else built

    def log(self, path):
        if self.jax:
            return delta_tpu.DeltaLog.for_table(path)
        return delta_tpu_torch.DeltaLog.for_table(path, device="cpu")

    def write(self, path, cols, mode="append", **kw):
        log = self.log(path)
        (JaxWrite if self.jax else TorchWrite)(log, mode, self.table(cols), **kw).run()
        return log

    def clause(self, kind, condition=None, assignments=None):
        return self.Clause(kind, condition=condition, assignments=assignments)

    def command(self, log, source, cond, matched=(), not_matched=(), **kw):
        cls = JaxMerge if self.jax else TorchMerge
        return cls(log, self.table(source), cond,
                   [self.clause(*c) for c in matched],
                   [self.clause(*c) for c in not_matched], **kw)

    def merge(self, log, source, cond, matched=(), not_matched=(), **kw):
        cmd = self.command(log, source, cond, matched, not_matched, **kw)
        cmd.run()
        return cmd

    def scan(self, log):
        return (jax_scan if self.jax else torch_scan)(log.update())

    def rows(self, log):
        return sorted_rows(self.scan(log).to_pylist())

    def key_cache(self):
        return JaxKeyCache if self.jax else TorchKeyCache


def arrow_type(spec):
    """The ``pyarrow`` type of a ``delta_tpu_torch.expr.nested`` spec."""
    from delta_tpu_torch.expr.nested import decimal_ps

    if isinstance(spec, tuple):
        if spec[0] == "struct":
            return pa.struct([(name, arrow_type(s)) for name, s in spec[1]])
        if spec[0] == "list":
            return pa.list_(arrow_type(spec[1]))
        return pa.map_(arrow_type(spec[1]), arrow_type(spec[2]))
    ps = decimal_ps(spec)
    if ps is not None:
        return pa.decimal128(*ps)
    return {"int64": pa.int64(), "int32": pa.int32(), "float64": pa.float64(),
            "string": pa.string(), "bool": pa.bool_(), "date32": pa.date32(),
            "timestamp[us]": pa.timestamp("us")}[spec]


def sorted_rows(rows):
    return sorted(rows, key=lambda r: [(v is None, repr(v)) for v in r.values()])


def metrics(cmd):
    return {k: v for k, v in cmd.metrics.items() if not k.endswith("TimeMs")}


def observe(fn):
    """The call's value, or its exception's class name."""
    try:
        return fn()
    except Exception as e:  # the class is the observation
        return type(e).__name__


def both_confs(**kv):
    """Set the same session keys in both packages."""
    class _Both:
        def __enter__(self):
            self.ctx = [jax_conf.set_temporarily(**kv), torch_conf.set_temporarily(**kv)]
            for c in self.ctx:
                c.__enter__()
            return self

        def __exit__(self, *exc):
            for c in reversed(self.ctx):
                c.__exit__(*exc)
            return False

    return _Both()


def reset_caches():
    JaxKeyCache.reset()
    TorchKeyCache.reset()
    delta_tpu_torch.DeltaLog.clear_cache()


# -- the link router's parity vocabulary --------------------------------------------

#: the cost constants both packages price with; the port's defaults are its
#: card's, so a parity test installs the JAX package's values in the port
LINK_CONSTANTS = ("KERNEL_S_PER_ROW", "HOST_JOIN_S_PER_ROW", "HOST_PRUNE_S_PER_CELL",
                  "DEVICE_PRUNE_S_PER_CELL", "HOST_KEY_DECODE_S_PER_ROW",
                  "RESIDENT_PROBE_S_PER_ROW", "RESIDENT_PROBE_FIXED_S",
                  "RESIDENT_PAIR_S_PER_ROW", "DEVICE_SORT_S_PER_ROW",
                  "HOST_RESIDUAL_S_PER_CELL", "DEVICE_RESIDUAL_S_PER_CELL",
                  "SHARD_DISPATCH_S", "SHARD_GATHER_S_PER_SHARD")


def install_reference_constants(monkeypatch):
    """The JAX package's cost constants in the port, for this test."""
    from delta_tpu.parallel import link as jax_link
    from delta_tpu_torch.parallel import link as torch_link

    for name in LINK_CONSTANTS:
        monkeypatch.setattr(torch_link, name, getattr(jax_link, name))


def reset_links():
    """Both packages' cached link profiles, calibration and audits dropped."""
    from delta_tpu.obs import calibration as jax_cal
    from delta_tpu.obs import router_audit as jax_audit
    from delta_tpu.parallel import link as jax_link
    from delta_tpu_torch.obs import calibration as torch_cal
    from delta_tpu_torch.obs import router_audit as torch_audit
    from delta_tpu_torch.parallel import link as torch_link

    for m in (jax_link, torch_link):
        m.reset()
    for m in (jax_cal, torch_cal):
        m.reset()
    for m in (jax_audit, torch_audit):
        m.clear_audits()


def both_links(up, down, **kv):
    """The same injected link profile (MB/s) in both packages' confs, with
    the JAX package held to one card's pricing (no sharded plan)."""
    return both_confs(**{"delta.tpu.link.uploadMBps": up, "delta.tpu.link.downloadMBps": down,
                         "delta.tpu.distributed.plan.enabled": False}, **kv)


def both_links_on_mesh(up, down, shards=8, **kv):
    """The same injected link profile (MB/s) in both packages' confs with
    sharded planning left on: the port on a ``shards``-entry CPU mesh, the
    JAX package on its 8-device test mesh."""
    import contextlib

    from delta_tpu_torch.parallel import mesh

    stack = contextlib.ExitStack()
    stack.enter_context(both_confs(**{"delta.tpu.link.uploadMBps": up,
                                      "delta.tpu.link.downloadMBps": down}, **kv))
    stack.enter_context(mesh.using_devices(["cpu"] * shards))
    return stack
