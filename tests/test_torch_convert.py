"""The port's CONVERT TO DELTA and symlink manifests against ``delta_tpu``'s
on the CPU: the convert and GENERATE cases of
``tests/test_utility_commands.py``, each run by both packages in
directories of their own over the same ``pyarrow``-written Parquet files
(``tests/torch_api_tables.both``). Rows, versions, files (partition values,
stats), metadata, commits, manifests (their lines, with the case's
directory as ``<root>``) and every error's class and message must be
exactly equal.

Also here: ``exec/rowgroups.stats_from_footer`` against the JAX package's
over files of every type the port reads, the ``convert.stats.fromFooter``
and ``fromDecode`` counters, and a multi-process convert's refusal.
"""
import datetime as dt
import decimal
import json
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from tests.torch_api_tables import P, both, fresh, observe, state


def _pq(root, rel, data, **kw):
    path = os.path.join(root, "t", rel)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    pq.write_table(pa.table(data), path, **kw)


def _schema(p, *fields):
    return p.types.StructType([p.types.StructField(n, getattr(p.types, t)())
                               for n, t in fields])


def _convert(p, root, partition_schema=None, collect_stats=False):
    log = p.log(os.path.join(root, "t"))
    return p.convert_mod.ConvertToDeltaCommand(log, partition_schema=partition_schema,
                                               collect_stats=collect_stats).run()


def _manifests(root):
    base = os.path.join(root, "t", "_symlink_format_manifest")
    out = {}
    for d, _, files in os.walk(base):
        for f in files:
            with open(os.path.join(d, f)) as fh:
                lines = fh.read().splitlines()
            out[os.path.relpath(os.path.join(d, f), base)] = [
                line.rsplit("/", 1)[0] for line in lines]  # the file names are random
    return out


def _convert_unpartitioned(p, root):
    _pq(root, "a.parquet", {"id": [1, 2]})
    _pq(root, "b.parquet", {"id": [3]})
    v = _convert(p, root)
    return v, state(os.path.join(root, "t")), _convert(p, root)


def _convert_partitioned(p, root):
    _pq(root, "c=x/a.parquet", {"id": [1]})
    _pq(root, "c=y/b.parquet", {"id": [2]})
    _convert(p, root, _schema(p, ("c", "StringType")))
    t = p.for_path(os.path.join(root, "t"))
    return state(os.path.join(root, "t")), p.read(t, filters=["c = 'y'"])


def _convert_partitioned_requires_partition_schema(p, root):
    _pq(root, "c=x/a.parquet", {"id": [1]})
    return _convert(p, root)


def _convert_merges_schemas(p, root):
    _pq(root, "a.parquet", {"id": [1]})
    _pq(root, "b.parquet", {"id": [2], "v": ["x"]})
    _pq(root, "c.parquet", {"id": [3.5], "w": pa.array([True])})
    _convert(p, root)
    return state(os.path.join(root, "t"))


def _generate_full_manifest(p, root):
    path = os.path.join(root, "t")
    p.write(path, {"id": [1, 2], "c": ["a", "b"]}, partition_columns=["c"])
    n = p.manifest.generate_full_manifest(p.log(path))
    p.for_path(path).generate()
    return n, _manifests(root), observe(lambda: p.for_path(path).generate("other_mode"))


def _incremental_manifest_hook(p, root):
    path = os.path.join(root, "t")
    p.write(path, {"id": [1, 2], "c": ["a", "b"]}, partition_columns=["c"],
            configuration={"delta.compatibility.symlinkFormatManifest.enabled": "true"})
    first = _manifests(root)
    t = p.for_path(path)
    t.delete("c = 'a'")
    after_delete = _manifests(root)
    p.write(path, {"id": [3], "c": ["b"]})
    return first, after_delete, _manifests(root), state(path)


def _convert_with_stats_enables_skipping(p, root):
    _pq(root, "a.parquet", {"id": [1, 2]})
    _pq(root, "b.parquet", {"id": [100, 200]})
    _convert(p, root, collect_stats=True)
    snap = p.log(os.path.join(root, "t")).update()
    scan = p.scan_mod.scan_files(snap, ["id > 50"])
    return len(scan.files), state(os.path.join(root, "t"))


def _convert_null_partition_token(p, root):
    _pq(root, "c=__HIVE_DEFAULT_PARTITION__/a.parquet", {"id": [1]})
    _pq(root, "c=x/b.parquet", {"id": [2]})
    _convert(p, root, _schema(p, ("c", "StringType")))
    return state(os.path.join(root, "t"))


def _convert_escaped_partition_values(p, root):
    _pq(root, "c=a%3Db/a.parquet", {"id": [1]})
    _convert(p, root, _schema(p, ("c", "StringType")))
    return state(os.path.join(root, "t"))


def _convert_ignores_hidden_files_and_dirs(p, root):
    _pq(root, "_staging/x.parquet", {"id": [9]})
    _pq(root, "a.parquet", {"id": [1]})
    with open(os.path.join(root, "t", ".hidden.parquet"), "wb") as f:
        f.write(b"junk")
    _convert(p, root)
    return state(os.path.join(root, "t"))


def _convert_empty_dir_errors(p, root):
    os.makedirs(os.path.join(root, "t"))
    return _convert(p, root)


def _convert_mixed_depth_partitions_rejected(p, root):
    _pq(root, "c=x/a.parquet", {"id": [1]})
    _pq(root, "b.parquet", {"id": [2]})
    return _convert(p, root, _schema(p, ("c", "StringType")))


def _post_convert_dml_works(p, root):
    _pq(root, "a.parquet", {"id": [1, 2, 3]})
    _convert(p, root)
    t = p.for_path(os.path.join(root, "t"))
    t.delete("id = 2")
    t.update({"id": "id * 10"}, "id = 3")
    return p.read(t), len(t.history()), state(os.path.join(root, "t"))


def _convert_to_delta_api(p, root):
    _pq(root, "c=1/a.parquet", {"id": [1, 2]})
    _pq(root, "c=2/b.parquet", {"id": [3]})
    t = p.convert_to_delta(os.path.join(root, "t"), _schema(p, ("c", "IntegerType")))
    return p.read(t, filters=["c = 2"]), state(os.path.join(root, "t"))


CASES = [
    _convert_unpartitioned, _convert_partitioned, _convert_partitioned_requires_partition_schema,
    _convert_merges_schemas, _generate_full_manifest, _incremental_manifest_hook,
    _convert_with_stats_enables_skipping, _convert_null_partition_token,
    _convert_escaped_partition_values, _convert_ignores_hidden_files_and_dirs,
    _convert_empty_dir_errors, _convert_mixed_depth_partitions_rejected,
    _post_convert_dml_works, _convert_to_delta_api,
]

RAISES = {
    "_convert_partitioned_requires_partition_schema": "DeltaAnalysisError",
    "_convert_empty_dir_errors": "DeltaFileNotFoundError",
    "_convert_mixed_depth_partitions_rejected": "DeltaAnalysisError",
}


@pytest.mark.parametrize("case", CASES, ids=[c.__name__.lstrip("_") for c in CASES])
def test_convert_and_manifest_match_jax(tmp_path, case):
    got = both(tmp_path, case)
    want = RAISES.get(case.__name__)
    if want is None:
        assert not (isinstance(got, tuple) and got[:1] == ("raises",)), got
    else:
        assert got[:2] == ("raises", want), got


# -- footer stats ---------------------------------------------------------------------


def _typed_table(rng, n):
    base = dt.date(2020, 1, 1)
    return pa.table({
        "i8": pa.array(rng.integers(-100, 100, n), pa.int8()),
        "i32": pa.array(rng.integers(-1 << 30, 1 << 30, n), pa.int32()),
        "i64": pa.array(rng.integers(-1 << 60, 1 << 60, n), pa.int64()),
        "f64": pa.array(rng.normal(size=n)),
        "f32": pa.array(rng.normal(size=n).astype(np.float32)),
        "s": pa.array([None if i % 7 == 0 else f"k{rng.integers(1000)}" for i in range(n)]),
        "b": pa.array(rng.integers(0, 2, n).astype(bool)),
        "d": pa.array([base + dt.timedelta(days=int(x)) for x in rng.integers(0, 900, n)],
                      pa.date32()),
        "ts": pa.array([dt.datetime(2021, 1, 1) + dt.timedelta(microseconds=int(x))
                        for x in rng.integers(0, 10**12, n)], pa.timestamp("us")),
        "tz": pa.array([dt.datetime(2021, 1, 1) + dt.timedelta(milliseconds=int(x))
                        for x in rng.integers(0, 10**9, n)], pa.timestamp("us", tz="UTC")),
        "dec": pa.array([decimal.Decimal(int(x)) / 100 for x in rng.integers(-10**6, 10**6, n)],
                        pa.decimal128(9, 2)),
        "bin": pa.array([bytes([int(x)]) * 3 for x in rng.integers(0, 255, n)], pa.binary()),
        "nul": pa.array([None] * n, pa.int64()),
    })


@pytest.mark.parametrize("variant", ["plain", "row_groups", "nan", "no_stats", "one_row"])
def test_stats_from_footer_matches_jax(tmp_path, variant):
    from delta_tpu.exec import rowgroups as jax_rg
    from delta_tpu_torch.exec import rowgroups as torch_rg

    rng = np.random.default_rng(11)
    n = 1 if variant == "one_row" else 5000
    table = _typed_table(rng, n)
    kw = {}
    if variant == "row_groups":
        kw["row_group_size"] = 1000
    if variant == "no_stats":
        kw["write_statistics"] = ["i64", "s"]
    if variant == "nan":
        f = table.column("f64").to_numpy(zero_copy_only=False).copy()
        f[3] = np.nan
        table = table.set_column(table.schema.get_field_index("f64"), "f64", pa.array(f))
    path = str(tmp_path / "f.parquet")
    pq.write_table(table, path, **kw)
    want = jax_rg.stats_from_footer(jax_rg.read_footer(path))
    got = torch_rg.stats_from_footer(torch_rg.read_footer(path))
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    if variant in ("plain", "row_groups"):
        assert got is not None and "dec" not in got["minValues"] and "bin" in got["nullCount"]


def test_convert_counts_footer_and_decode_stats(tmp_path):
    from delta_tpu.utils import telemetry as jax_tel
    from delta_tpu_torch.utils import telemetry as torch_tel

    def case(p, root):
        _pq(root, "a.parquet", {"id": [1, 2], "v": ["x", "y"]})
        _pq(root, "b.parquet", {"id": [5, 6], "v": ["z", None]}, write_statistics=False)
        tel = p.jax and jax_tel or torch_tel
        tel.clear_counters()
        _convert(p, root, collect_stats=True)
        return tel.counters("convert.stats"), state(os.path.join(root, "t"))

    counts, _ = both(tmp_path, case)
    assert counts == {"convert.stats.fromFooter": 1, "convert.stats.fromDecode": 1}


def test_multi_process_convert_is_refused(tmp_path, monkeypatch):
    from delta_tpu_torch.parallel import distributed

    fresh()
    p = P("torch")
    _pq(str(tmp_path), "a.parquet", {"id": [1]})
    monkeypatch.setattr(distributed, "process_info", lambda: (0, 2))
    log = p.log(str(tmp_path / "t"))
    with pytest.raises(NotImplementedError, match="queue A item 8"):
        p.convert_mod.ConvertToDeltaCommand(log, distribute=True).run()
    assert p.convert_mod.ConvertToDeltaCommand(log).run() == 0  # one process converts
    fresh()
