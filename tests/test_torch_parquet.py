"""The port's Parquet codec (``delta_tpu_torch.exec``: thrift, snappy,
encodings, parquet, rowgroups) and deletion-vector reader
(``delta_tpu_torch.protocol.deletion_vectors``) held against ``pyarrow`` and
``delta_tpu`` on the CPU.

* the reader, on files ``delta_tpu.exec.parquet.write_parquet_file`` writes
  on every branch of its policy (dictionary strings, dictionary overflow to
  PLAIN pages, BYTE_STREAM_SPLIT floats, snappy or none, gzip, nulls,
  all-null and empty files, several row groups and pages, every type in
  scope) and on ``pyarrow``'s own defaults (v1 and v2 data pages): every
  value equal to what ``pyarrow`` reads;
* the writer: ``pyarrow`` reads the port's files back equal, types
  included;
* nested columns (the checkpoint codec, ``read_nested`` /
  ``write_nested``): struct, map and 3-level list columns nested in each
  other, against ``pyarrow`` on v1 and v2 pages, dictionary and PLAIN,
  uncompressed, snappy and zstd, several row groups and pages, nulls at
  every level and empty maps and lists; a checkpoint the JAX package wrote;
  and the port's nested files read back by ``pyarrow``;
* ``collect_stats``/``stats_json``: equal to ``delta_tpu``'s;
* deletion vectors, inline and sidecar: equal to ``delta_tpu``'s;
* what the codec does not cover raises ``NotImplementedError`` naming the
  column;
* the ZSTD (RFC 8878) and LZ4_RAW page decoders, against ``pyarrow``'s
  compressors (levels 1, 3, 9, 19 and -5; 0 bytes to 1 MiB of random,
  repetitive and text-like data), ``zstandard``'s frames (checksums,
  several frames, skippable frames, a dictionary), XXH64 against
  ``xxhash``, corrupt input raising ``ValueError``, a corpus that reaches
  every block, literals and sequence mode, and tables ``delta_tpu`` wrote
  under ``delta.tpu.write.compression=zstd`` and ``lz4``.

Tolerance: exact (NaN equal to NaN).
"""
import datetime as dt
import json
import math
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from delta_tpu.exec import parquet as jpq
from delta_tpu.protocol import deletion_vectors as jdv
from delta_tpu.utils.config import conf
from delta_tpu_torch.exec import encodings, parquet as tpq, rowgroups, snappy, thrift
from delta_tpu_torch.expr.nested import ncol_from_py
from delta_tpu_torch.expr.vectorized import HostColumn, HostTable
from delta_tpu_torch.protocol import deletion_vectors as tdv

#: pyarrow type -> the port's stored type (``HostColumn.type or default``)
_STORED = {pa.bool_(): "bool", pa.int8(): "int8", pa.int16(): "int16", pa.int32(): "int32",
           pa.int64(): "int64", pa.float32(): "float32", pa.float64(): "float64",
           pa.string(): "string", pa.binary(): "binary", pa.date32(): "date32",
           pa.timestamp("us"): "timestamp[us]", pa.timestamp("ms"): "timestamp[us]",
           pa.timestamp("us", tz="UTC"): "timestamp[us, tz=UTC]"}
_DEFAULT = {"bool": "bool", "int": "int64", "double": "float64", "str": "string",
            "object": "binary", "date": "date32", "ts": "timestamp[us]"}
_EPOCH_TS = dt.datetime(1970, 1, 1)


def _py(col: HostColumn):
    """A port column as the Python values ``pyarrow``'s ``to_pylist`` gives."""
    out = []
    utc = col.type == "timestamp[us, tz=UTC]"
    for v, ok in zip(col.values.tolist(), col.valid.tolist()):
        if not ok:
            out.append(None)
        elif col.kind == "date":
            out.append(dt.date(1970, 1, 1) + dt.timedelta(days=v))
        elif col.kind == "ts":
            t = _EPOCH_TS + dt.timedelta(microseconds=v)
            out.append(t.replace(tzinfo=dt.timezone.utc) if utc else t)
        else:
            out.append(v)
    return out


def _eq(a, b):
    if len(a) != len(b):
        return False
    for x, y in zip(a, b):
        if isinstance(x, float) and isinstance(y, float) and math.isnan(x) and math.isnan(y):
            continue
        if x != y or type(x) is not type(y):
            return False
    return True


def _assert_reads_like_pyarrow(path, columns=None):
    got = tpq.read_parquet_file(path, columns, device="cpu")
    ref = pq.read_table(path, columns=columns)
    assert got.column_names == ref.column_names
    assert got.num_rows == ref.num_rows
    for name in ref.column_names:
        c = got.columns[name]
        t = ref.schema.field(name).type
        assert (c.type or _DEFAULT[c.kind]) == _STORED[t], name
        assert _eq(_py(c), ref.column(name).to_pylist()), name
    return got


def _table(n, seed=0, nulls=True):
    rng = np.random.RandomState(seed)
    mask = (lambda p: rng.rand(n) < p) if nulls else (lambda p: np.zeros(n, bool))
    return pa.table({
        "i64": pa.array(rng.randint(-2**62, 2**62, n), pa.int64()),
        "low": pa.array(rng.randint(0, 5, n), pa.int64(), mask=mask(0.1)),
        "i32": pa.array(rng.randint(-2**31, 2**31 - 1, n).astype(np.int32), mask=mask(0.2)),
        "i16": pa.array(rng.randint(-2**15, 2**15 - 1, n).astype(np.int16)),
        "i8": pa.array(rng.randint(-128, 127, n).astype(np.int8), mask=mask(0.5)),
        "f32": pa.array(rng.randn(n).astype(np.float32), mask=mask(0.1)),
        "f64": pa.array(np.where(rng.rand(n) < 0.01, np.nan, rng.randn(n) * 1e6)),
        "s": pa.array([f"v{x}" for x in rng.randint(0, 50, n)], pa.string(), mask=mask(0.1)),
        "u": pa.array(["é€" * (x % 3) + str(x) for x in rng.randint(0, 10**9, n)], pa.string()),
        "b": pa.array(rng.rand(n) < 0.3, mask=mask(0.05)),
        "d": pa.array(rng.randint(-1000, 30000, n).astype(np.int32)).cast(pa.date32()),
        "ts": pa.array(rng.randint(-2**45, 2**50, n)).cast(pa.timestamp("us")),
        "tz": pa.array(rng.randint(0, 2**50, n), mask=mask(0.1)).cast(
            pa.timestamp("us", tz="UTC")),
        "bin": pa.array([bytes([x % 256, 0]) * (x % 4) for x in range(n)], pa.binary()),
        "nul": pa.array([None] * n, pa.int64()),
    })


# -- the reader on the JAX package's files -----------------------------------------


@pytest.mark.parametrize("compression", [None, "none", "snappy", "gzip"])
def test_reader_on_jax_writer_policies(tmp_path, compression):
    """``None`` is the writer's "auto" policy: dictionary strings, snappy on
    strings, floats and low-entropy ints, BYTE_STREAM_SPLIT floats."""
    p = str(tmp_path / "f.parquet")
    jpq.write_parquet_file(_table(3000), p, compression=compression)
    md = pq.ParquetFile(p).metadata
    if compression is None:
        encs = {md.schema.column(i).name: md.row_group(0).column(i).encodings
                for i in range(md.num_columns)}
        assert "BYTE_STREAM_SPLIT" in encs["f64"] and "RLE_DICTIONARY" in encs["s"]
    _assert_reads_like_pyarrow(p)
    _assert_reads_like_pyarrow(p, ["tz", "i8", "s"])


def test_reader_row_groups_pages_and_dictionary_overflow(tmp_path):
    """Several row groups, several pages per column chunk, and a string
    dictionary past its page limit that falls back to PLAIN pages."""
    n = 300_000
    t = pa.table({"k": np.arange(n, dtype=np.int64),
                  "hs": pa.array([f"key-{i:012d}" for i in range(n)])})
    p = str(tmp_path / "f.parquet")
    with conf.set_temporarily(**{"delta.tpu.write.rowGroupRows": 120_000}):
        jpq.write_parquet_file(t, p)
    md = pq.ParquetFile(p).metadata
    assert md.num_row_groups == 3
    encs = md.row_group(0).column(1).encodings
    assert "RLE_DICTIONARY" in encs and "PLAIN" in encs  # the fallback
    _assert_reads_like_pyarrow(p)
    assert rowgroups.read_footer(p).num_rows == n


def test_reader_on_all_null_and_empty_files(tmp_path):
    p = str(tmp_path / "e.parquet")
    jpq.write_parquet_file(_table(0), p)
    got = _assert_reads_like_pyarrow(p)
    assert got.num_rows == 0
    p2 = str(tmp_path / "n.parquet")
    jpq.write_parquet_file(pa.table({"a": pa.array([None] * 10, pa.int64()),
                                     "s": pa.array([None] * 10, pa.string())}), p2)
    _assert_reads_like_pyarrow(p2)


@pytest.mark.parametrize("kw", [
    {}, {"data_page_version": "2.0"}, {"compression": "gzip", "data_page_version": "2.0"},
    {"use_dictionary": False, "compression": "none"},
    {"use_byte_stream_split": ["f32", "f64", "i64", "i32"], "use_dictionary": False},
    {"data_page_size": 1000, "row_group_size": 700},
])
def test_reader_on_pyarrow_defaults(tmp_path, kw):
    p = str(tmp_path / "p.parquet")
    t = _table(2000, seed=3).append_column(
        "ms", pa.array(np.arange(2000) * 1000, pa.int64()).cast(pa.timestamp("ms")))
    pq.write_table(t, p, **kw)
    _assert_reads_like_pyarrow(p)


def test_reader_on_required_columns(tmp_path):
    schema = pa.schema([pa.field("a", pa.int64(), nullable=False),
                        pa.field("s", pa.string(), nullable=False)])
    p = str(tmp_path / "r.parquet")
    pq.write_table(pa.table({"a": np.arange(100), "s": [str(i) for i in range(100)]},
                            schema=schema), p)
    _assert_reads_like_pyarrow(p)


@pytest.mark.parametrize("make,what", [
    (lambda p: pq.write_table(pa.table({"a": [1, 2]}), p, compression="zstd"), "ZSTD"),
    (lambda p: pq.write_table(pa.table({"a": [1, 2]}), p, compression="lz4"), "LZ4"),
    (lambda p: pq.write_table(pa.table({"a": [1, 2]}), p, compression="brotli"), "BROTLI"),
    (lambda p: pq.write_table(pa.table({"a": np.arange(500)}), p, use_dictionary=False,
                              column_encoding={"a": "DELTA_BINARY_PACKED"}),
     "DELTA_BINARY_PACKED"),
    (lambda p: pq.write_table(pa.table({"a": [[1], [2, 3]]}), p), "nested"),
    (lambda p: pq.write_table(pa.table({"a": pa.array([{"x": 1}])}), p), "nested"),
    (lambda p: pq.write_table(pa.table({"a": pa.array([b"ab"], pa.binary(2))}), p),
     "FIXED_LEN_BYTE_ARRAY"),
    (lambda p: pq.write_table(pa.table({"a": pa.array([1], pa.timestamp("ns"))}), p,
                              use_deprecated_int96_timestamps=True), "INT96"),
    (lambda p: pq.write_table(pa.table({"a": pa.array([1], pa.uint32())}), p), "unsigned"),
    (lambda p: pq.write_table(pa.table({"a": pa.array([1], pa.timestamp("ns"))}), p),
     "nanosecond"),
])
def test_unsupported_raises_not_implemented(tmp_path, make, what):
    p = str(tmp_path / "x.parquet")
    make(p)
    if what in ("ZSTD", "LZ4"):
        # covered since the port's own ZSTD and LZ4_RAW decoders: the file
        # reads as pyarrow reads it
        _assert_reads_like_pyarrow(p)
        return
    if what == "nested":
        # covered since nested data columns: the rows pyarrow reads
        assert tpq.read_parquet_file(p, device="cpu").to_pylist() == pq.read_table(p).to_pylist()
        return
    with pytest.raises(NotImplementedError, match=f"'a'.*{what}|{what}.*'a'"):
        tpq.read_parquet_file(p, device="cpu")


def test_unsupported_column_outside_the_projection_is_not_read(tmp_path):
    p = str(tmp_path / "x.parquet")
    pq.write_table(pa.table({"a": [[1], [2]], "k": [1, 2]}), p)
    assert tpq.read_parquet_file(p, ["k"], device="cpu").column("k").values.tolist() == [1, 2]


# -- the writer --------------------------------------------------------------------


def _host(t: pa.Table) -> HostTable:
    """A pyarrow table as the port's HostTable, through a pyarrow-written
    file and the port's reader (whose equality the reader tests hold)."""
    import io

    buf = io.BytesIO()
    pq.write_table(t, buf)
    p = os.path.join(os.environ.get("TMPDIR", "/tmp"), f"host-{os.getpid()}-{id(t)}.parquet")
    with open(p, "wb") as f:
        f.write(buf.getvalue())
    try:
        return tpq.read_parquet_file(p, device="cpu")
    finally:
        os.unlink(p)


def test_writer_round_trips_through_pyarrow(tmp_path):
    src = _table(5000, seed=1)
    host = _host(src)
    p = str(tmp_path / "w.parquet")
    size, mtime = tpq.write_parquet_file(host, p, device="cpu")
    assert size == os.path.getsize(p) and mtime > 0
    back = pq.read_table(p)
    assert back.schema.names == src.schema.names
    for name in src.column_names:
        assert back.schema.field(name).type == src.schema.field(name).type, name
        assert _eq(back.column(name).to_pylist(), src.column(name).to_pylist()), name
    md = pq.ParquetFile(p).metadata
    st0 = md.row_group(0).column(0).statistics
    assert st0.has_min_max and st0.min == min(src.column("i64").to_pylist())
    assert md.row_group(0).column(2).statistics.null_count == src.column("i32").null_count
    _assert_reads_like_pyarrow(p)


def test_writer_row_groups_and_empty_table(tmp_path):
    n = tpq.ROW_GROUP_ROWS * 2 + 17
    host = HostTable({"k": HostColumn("int", np.arange(n, dtype=np.int64), np.ones(n, bool))}, n)
    p = str(tmp_path / "big.parquet")
    tpq.write_parquet_file(host, p, device="cpu")
    md = pq.ParquetFile(p).metadata
    assert md.num_row_groups == 3 and md.row_group(2).num_rows == 17
    assert pq.read_table(p).column("k").to_numpy().tolist() == list(range(n))
    e = HostTable({"k": HostColumn("int", np.zeros(0, np.int64), np.zeros(0, bool))}, 0)
    p2 = str(tmp_path / "empty.parquet")
    tpq.write_parquet_file(e, p2, device="cpu")
    assert pq.read_table(p2).num_rows == 0


@settings(max_examples=40, deadline=None, suppress_health_check=[HealthCheck.too_slow,
                                                                  HealthCheck.function_scoped_fixture])
@given(ints=st.lists(st.one_of(st.none(), st.integers(-2**63, 2**63 - 1)), max_size=300),
       strs=st.lists(st.one_of(st.none(), st.text(max_size=12)), max_size=300),
       floats=st.lists(st.one_of(st.none(), st.floats(width=64)), max_size=300))
def test_hypothesis_round_trips(tmp_path, ints, strs, floats):
    n = min(len(ints), len(strs), len(floats))
    t = pa.table({"i": pa.array(ints[:n], pa.int64()), "s": pa.array(strs[:n], pa.string()),
                  "f": pa.array(floats[:n], pa.float64())})
    p = str(tmp_path / "h.parquet")
    pq.write_table(t, p, data_page_size=256)
    got = _assert_reads_like_pyarrow(p)
    p2 = str(tmp_path / "h2.parquet")
    tpq.write_parquet_file(got, p2, device="cpu")
    back = pq.read_table(p2)
    for name in t.column_names:
        assert _eq(back.column(name).to_pylist(), t.column(name).to_pylist())
    assert tpq.collect_stats(got) == jpq.collect_stats(t)


@settings(max_examples=60, deadline=None)
@given(st.binary(max_size=5000))
def test_hypothesis_snappy_matches_pyarrow(raw):
    assert snappy.decompress(pa.compress(raw, codec="snappy", asbytes=True)) == raw


@settings(max_examples=60, deadline=None)
@given(st.lists(st.integers(0, 2**20 - 1), max_size=600), st.integers(1, 20))
def test_hypothesis_hybrid_levels(values, width):
    bits = np.array([v & 1 for v in values], bool)
    enc = encodings.encode_hybrid_bits(bits)
    assert encodings.decode_hybrid(enc, 0, len(enc), 1, len(bits)).astype(bool).tolist() \
        == bits.tolist()


def test_snappy_repeated_pattern_and_corrupt_input():
    raw = b"abc" * 5000 + bytes(range(256)) * 40
    assert snappy.decompress(pa.compress(raw, codec="snappy", asbytes=True)) == raw
    with pytest.raises(snappy.SnappyError):
        snappy.decompress(b"\x10\x09\x08")


def test_thrift_round_trips_pyarrow_footers(tmp_path):
    p = str(tmp_path / "f.parquet")
    pq.write_table(_table(100), p, data_page_version="2.0")
    meta = tpq.read_metadata(p)
    again, end = thrift.read(thrift.FileMetaData, meta.write())
    assert again == meta and end == len(meta.write())
    assert meta.num_rows == 100 and [s.name for s in meta.schema[1:]] == _table(1).column_names
    with pytest.raises(thrift.ThriftError):
        thrift.read(thrift.FileMetaData, meta.write()[:20])


# -- stats -------------------------------------------------------------------------


@pytest.mark.parametrize("num_indexed", [32, 2, 0, -1])
def test_collect_stats_matches_jax(num_indexed):
    t = _table(2000, seed=9)
    host = _host(t)
    assert tpq.collect_stats(host, num_indexed) == jpq.collect_stats(t, num_indexed)
    assert tpq.stats_json(host, num_indexed) == jpq.stats_json(t, num_indexed)


@pytest.mark.parametrize("values,typ", [
    ([float("nan"), 1.5, -0.5], pa.float64()), ([float("nan")] * 3, pa.float64()),
    ([float("inf"), 1.0], pa.float64()), ([None, None], pa.int64()),
    ([dt.datetime(2020, 1, 1, 0, 0, 0, 1500), dt.datetime(2019, 5, 5)], pa.timestamp("us")),
    ([dt.date(1969, 12, 31), dt.date(2100, 1, 1)], pa.date32()),
    (["b", "a", "é"], pa.string()), ([True, False], pa.bool_()), ([], pa.int32()),
])
def test_collect_stats_edges_match_jax(values, typ):
    t = pa.table({"c": pa.array(values, typ)})
    assert tpq.collect_stats(_host(t)) == jpq.collect_stats(t)
    assert tpq.json_stat_value(dt.datetime(2020, 1, 1, 0, 0, 0, 1), True) == \
        jpq.json_stat_value(dt.datetime(2020, 1, 1, 0, 0, 0, 1), True)


# -- deletion vectors --------------------------------------------------------------


@pytest.mark.parametrize("rows", [[], [0], [5, 3, 3, 9], list(range(0, 100000, 7)),
                                  list(np.random.RandomState(1).choice(10**6, 20000,
                                                                       replace=False))])
def test_deletion_vectors_match_jax(tmp_path, rows):
    rows = np.asarray(rows, np.int64)
    payload = jdv.encode_bitmap(rows)
    assert tdv.encode_bitmap(rows) == payload
    assert np.array_equal(tdv.decode_bitmap(payload), jdv.decode_bitmap(payload))
    d = str(tmp_path)
    for writer, reader in ((jdv, tdv), (tdv, jdv)):
        desc = writer.write_deletion_vector(rows, d)
        other = reader.DeletionVectorDescriptor.from_dict(desc.to_dict())
        got = reader.read_deletion_vector(other, d)
        want = jdv.read_deletion_vector(jdv.DeletionVectorDescriptor.from_dict(desc.to_dict()), d)
        assert np.array_equal(got, want) and got.dtype == want.dtype
        assert desc.storage_type == ("i" if len(payload) <= 4096 else "u")
    with pytest.raises(ValueError, match="bad magic"):
        tdv.decode_bitmap(b"nope")


def test_stats_of_a_port_written_file_describe_it(tmp_path):
    host = _host(_table(500, seed=4))
    p = str(tmp_path / "s.parquet")
    tpq.write_parquet_file(host, p, device="cpu")
    stats = json.loads(tpq.stats_json(tpq.read_parquet_file(p, device="cpu")))
    assert stats == jpq.collect_stats(pq.read_table(p))


# -- the ZSTD and LZ4_RAW decoders -----------------------------------------------------

from delta_tpu_torch.exec import lz4, zstd  # noqa: E402

ZSTD_LEVELS = (1, 3, 9, 19, -5)
_WORDS = [b"delta", b"lake", b"parquet", b"zstd", b"the", b"of", b"table", b"merge", b"\n",
          b" ", b"2021-01-01", b"id="]


def _data(kind, n, seed=1):
    rng = np.random.RandomState(seed)
    if kind == "random":
        return rng.bytes(n)
    if kind == "repetitive":
        return (b"abcabcabd" * (n // 9 + 1))[:n]
    return b"".join(_WORDS[i] for i in rng.randint(0, len(_WORDS), n))[:n]


def _pa_zstd(raw, level):
    return pa.Codec("zstd", compression_level=level).compress(raw, asbytes=True)


@pytest.mark.parametrize("kind", ["random", "repetitive", "text"])
@pytest.mark.parametrize("size", [0, 1, 1024, 1 << 20])
def test_zstd_decodes_pyarrow_at_every_level(kind, size):
    raw = _data(kind, size)
    for level in ZSTD_LEVELS:
        assert zstd.decompress(_pa_zstd(raw, level), len(raw)) == raw, level


@pytest.mark.parametrize("kind", ["random", "repetitive", "text"])
@pytest.mark.parametrize("size", [0, 1, 1024, 1 << 20])
def test_lz4_raw_decodes_pyarrow(kind, size):
    raw = _data(kind, size)
    assert lz4.decompress(pa.compress(raw, codec="lz4_raw", asbytes=True), len(raw)) == raw


def _rle_literals_input():
    """Literals that are one byte repeated (a 128 KiB random block, then
    copies of it each after one 'a'): level 19 codes them as RLE."""
    rng = np.random.RandomState(3)
    r = rng.bytes(131072)
    return r + b"".join(b"a" + r[k:k + 48] for k in rng.randint(0, 131072 - 64, 3000))


def test_zstd_corpus_reaches_every_mode():
    import zstandard

    trace = set()
    col = np.arange(300_000, dtype="<i8").tobytes()
    for raw, levels in ((col, (1, 19)), (b"\0" * 300_000, (3,)), (_rle_literals_input(), (19,)),
                        (_data("text", 1 << 18), (1, 19)), (_data("repetitive", 5000), (3,))):
        for level in levels:
            assert zstd.decompress(_pa_zstd(raw, level), len(raw), trace=trace) == raw
    raw = _data("text", 20_000)
    frame = zstandard.ZstdCompressor(level=3, write_checksum=True).compress(raw)
    skip = (0x184D2A5A).to_bytes(4, "little") + (5).to_bytes(4, "little") + b"12345"
    assert zstd.decompress(skip + frame + frame, trace=trace) == raw + raw
    want = {"block.raw", "block.rle", "block.compressed", "frame.checksum", "frame.multiple",
            "frame.skippable", "literals.raw", "literals.rle", "literals.huffman1",
            "literals.huffman4", "literals.huffman-tree", "literals.treeless",
            "offset.repeat1", "offset.repeat2", "offset.repeat3", "offset.repeat4"}
    want |= {f"seq.{k}.{m}" for k in ("ll", "of", "ml")
             for m in ("predefined", "rle", "fse", "repeat")}
    assert want <= trace, sorted(want - trace)


@pytest.mark.parametrize("level", [1, 19])
def test_zstd_frames_from_zstandard(level):
    import zstandard

    raw = _data("text", 200_000, seed=level) + _data("random", 3000)
    for kw in ({"write_checksum": True}, {"write_content_size": False},
               {"write_checksum": True, "write_content_size": False}):
        c = zstandard.ZstdCompressor(level=level, **kw).compress(raw)
        assert zstd.decompress(c) == raw, kw
    # a streamed frame: several blocks, no content size
    cctx = zstandard.ZstdCompressor(level=level, write_checksum=True)
    obj = cctx.compressobj()
    streamed = obj.compress(raw) + obj.flush()
    assert zstd.decompress(streamed) == raw
    # several frames back to back
    parts = [_data("text", 5000, seed=i) for i in range(4)]
    multi = b"".join(zstandard.ZstdCompressor(level=level).compress(p) for p in parts)
    assert zstd.decompress(multi) == b"".join(parts)


def test_zstd_dictionary_frame_is_refused():
    import zstandard

    samples = [_data("text", 2000, seed=i) for i in range(50)]
    d = zstandard.train_dictionary(4096, samples)
    c = zstandard.ZstdCompressor(level=3, dict_data=d).compress(samples[0])
    with pytest.raises(zstd.ZstdError, match="dictionar"):
        zstd.decompress(c)


def test_xxh64_matches_xxhash():
    import xxhash

    rng = np.random.RandomState(5)
    assert zstd.xxh64(b"") == 0xEF46DB3751D8E999
    for n in list(range(0, 80)) + [1000, 4096 + 3, 1 << 16]:
        b = rng.bytes(n)
        assert zstd.xxh64(b) == xxhash.xxh64(b).intdigest(), n
        assert zstd.xxh64(b, seed=7) == xxhash.xxh64(b, seed=7).intdigest(), n


def test_zstd_corrupt_input_raises_value_error():
    import zstandard

    raw = _data("text", 50_000)
    good = zstandard.ZstdCompressor(level=3, write_checksum=True).compress(raw)
    bad_sum = good[:-1] + bytes([good[-1] ^ 0xFF])
    with pytest.raises(ValueError, match="checksum"):
        zstd.decompress(bad_sum)
    with pytest.raises(ValueError):
        zstd.decompress(b"\x00\x01\x02\x03" + good[4:])  # bad magic
    with pytest.raises(ValueError):
        zstd.decompress(good[: len(good) // 2])  # truncated
    with pytest.raises(ValueError):
        zstd.decompress(good, size=len(raw) + 1)
    rng = np.random.RandomState(9)
    failures = 0
    for _ in range(40):  # flipped bytes inside the blocks: an error, never a wrong answer
        b = bytearray(good)
        i = rng.randint(12, len(b) - 4)
        b[i] ^= 1 << rng.randint(8)
        try:
            out = zstd.decompress(bytes(b))
        except ValueError:
            failures += 1
        else:
            assert out == raw
    assert failures > 30


def test_lz4_corrupt_input_raises_value_error():
    raw = _data("text", 50_000)
    good = pa.compress(raw, codec="lz4_raw", asbytes=True)
    with pytest.raises(ValueError):
        lz4.decompress(good[: len(good) // 2], len(raw))
    with pytest.raises(ValueError):
        lz4.decompress(good, len(raw) - 1)
    with pytest.raises(ValueError):
        lz4.decompress(b"\x1f\x41\x00\x00", 100)  # offset 0


@pytest.mark.parametrize("codec,name", [("zstd", "ZSTD"), ("lz4", "LZ4_RAW")])
def test_corrupt_page_raises_value_error_naming_the_column(tmp_path, codec, name):
    p = str(tmp_path / "x.parquet")
    pq.write_table(pa.table({"a": np.arange(20_000)}), p,
                   compression=codec, use_dictionary=False)
    md = pq.ParquetFile(p).metadata.row_group(0).column(0)
    buf = bytearray(open(p, "rb").read())
    start = md.data_page_offset
    for i in range(start + 40, start + md.total_compressed_size - 8, 7):
        buf[i] ^= 0x5A
    open(p, "wb").write(bytes(buf))
    with pytest.raises(ValueError, match=f"'a'.*{name}"):
        tpq.read_parquet_file(p, device="cpu")


@pytest.mark.parametrize("codec", ["zstd", "lz4"])
def test_queue_c_tables_written_compressed_read_like_jax(tmp_path, codec):
    """1000-row tables ``delta_tpu`` wrote under ``delta.tpu.write.
    compression``: the port reads the queue's query (10 rows) and the whole
    table as the reference does."""
    from delta_tpu import DeltaLog as JaxDeltaLog
    from delta_tpu.api.tables import DeltaTable as JaxTable
    from delta_tpu.commands.write import WriteIntoDelta as JaxWrite
    from delta_tpu_torch.api.tables import DeltaTable

    path = str(tmp_path / codec)
    rng = np.random.RandomState(4)
    t = pa.table({"id": np.arange(1000, dtype=np.int64), "x": rng.rand(1000),
                  "s": pa.array([f"v{i % 37}" for i in range(1000)]),
                  "n": pa.array([None if i % 5 == 0 else i for i in range(1000)], pa.int32())})
    with conf.set_temporarily(**{"delta.tpu.write.compression": codec}):
        JaxWrite(JaxDeltaLog.for_table(path), "append", t).run()
    files = [f for f in os.listdir(path) if f.endswith(".parquet")]
    want_codec = {"zstd": "ZSTD", "lz4": "LZ4"}[codec]  # pyarrow's name for LZ4_RAW
    assert {pq.ParquetFile(os.path.join(path, f)).metadata.row_group(0).column(0).compression
            for f in files} == {want_codec}
    for filters in (["id < 10"], []):
        ref = JaxTable.for_path(path).to_arrow(filters=filters).sort_by("id")
        got = DeltaTable.for_path(path, device="cpu").to_table(filters=filters)
        order = np.argsort(got.column("id").values)
        assert got.num_rows == ref.num_rows == (10 if filters else 1000)
        for c in ("id", "x", "s"):
            assert got.column(c).values[order].tolist() == ref.column(c).to_pylist()
        n = got.column("n")
        assert [None if not ok else int(v) for v, ok in zip(n.values[order], n.valid[order])] \
            == ref.column("n").to_pylist()


# -- nested columns: the checkpoint reader and writer -----------------------------

_NESTED_TYPE = pa.struct([
    ("a", pa.int64()),
    ("m", pa.map_(pa.string(), pa.string())),
    ("l", pa.list_(pa.string())),
    ("z", pa.struct([("q", pa.timestamp("us")), ("w", pa.bool_()),
                     ("d", pa.date32()), ("f", pa.float32())])),
    ("ls", pa.list_(pa.struct([("k", pa.int32()), ("v", pa.string())]))),
])


def _nested_values(n, seed):
    """Rows with nulls at every level: a null struct, null fields, null and
    empty maps and lists, null map values and list elements."""
    rng = np.random.RandomState(seed)

    def maybe(p, v):
        return None if rng.rand() < p else v

    out = []
    for i in range(n):
        if rng.rand() < 0.1:
            out.append(None)
            continue
        m = maybe(0.2, {f"k{j}": maybe(0.3, f"v{i}-{j}") for j in range(rng.randint(0, 4))})
        lst = maybe(0.2, [maybe(0.3, f"e{i}-{j}") for j in range(rng.randint(0, 4))])
        z = maybe(0.2, {"q": maybe(0.3, dt.datetime(1960, 1, 1) + dt.timedelta(
                            microseconds=int(rng.randint(0, 1 << 60) // 1000))),
                        "w": maybe(0.3, bool(rng.rand() < 0.5)),
                        "d": maybe(0.3, dt.date(1969, 12, 1) + dt.timedelta(
                            days=int(rng.randint(0, 40000)))),
                        "f": maybe(0.3, float(np.float32(rng.randn())))})
        ls = maybe(0.2, [maybe(0.2, {"k": maybe(0.3, int(rng.randint(-99, 99))),
                                     "v": maybe(0.3, f"s{j}")})
                         for j in range(rng.randint(0, 3))])
        out.append({"a": maybe(0.2, int(rng.randint(-1 << 62, 1 << 62))), "m": m,
                    "l": lst, "z": z, "ls": ls})
    return out


def _py_of_arrow(v, t):
    """A ``pyarrow`` value as the port's ``NCol.to_py`` gives it (maps as
    dicts, dates and timestamps as epoch days and µs)."""
    if v is None:
        return None
    if pa.types.is_struct(t):
        return {t.field(i).name: _py_of_arrow(v.get(t.field(i).name), t.field(i).type)
                for i in range(t.num_fields)}
    if pa.types.is_map(t):
        return {k: _py_of_arrow(x, t.item_type) for k, x in v}
    if pa.types.is_list(t):
        return [_py_of_arrow(x, t.value_type) for x in v]
    if pa.types.is_timestamp(t):
        return (v.replace(tzinfo=None) - dt.datetime(1970, 1, 1)) // dt.timedelta(microseconds=1)
    if pa.types.is_date(t):
        return (v - dt.date(1970, 1, 1)).days
    return v


@pytest.mark.parametrize("version", ["1.0", "2.0"])
@pytest.mark.parametrize("dictionary", [True, False])
@pytest.mark.parametrize("codec", ["none", "snappy", "zstd"])
def test_nested_reader_matches_pyarrow(version, dictionary, codec, tmp_path):
    """Struct, map and 3-level list columns, nested in each other, by
    definition and repetition levels: v1 and v2 data pages, dictionary and
    PLAIN, uncompressed, snappy and zstd, several row groups and pages,
    nulls at every level, empty maps and lists."""
    vals = _nested_values(700, seed=len(version) + 2 * dictionary + len(codec))
    t = pa.table({"s": pa.array(vals, _NESTED_TYPE),
                  "i": pa.array([None if k % 7 == 3 else k for k in range(700)], pa.int32())})
    path = str(tmp_path / "n.parquet")
    pq.write_table(t, path, data_page_version=version, use_dictionary=dictionary,
                   compression=codec, row_group_size=300, data_page_size=2048)
    n, cols = tpq.read_nested(open(path, "rb").read(), device="cpu")
    assert n == 700
    want = pq.read_table(path)
    for name in ("s", "i"):
        assert cols[name].to_py() == [_py_of_arrow(v, want.schema.field(name).type)
                                      for v in want.column(name).to_pylist()], name
    rows = np.array([5, 0, 699, 5])
    assert cols["s"].to_py(rows) == [cols["s"].to_py()[r] for r in rows]


def test_nested_writer_read_by_pyarrow_and_the_port(tmp_path):
    spec = ("struct", [("a", "int64"), ("m", ("map", "string", "string")),
                       ("l", ("list", "string")),
                       ("z", ("struct", [("q", "timestamp[us]"), ("w", "bool"),
                                         ("d", "date32"), ("f", "float32")])),
                       ("ls", ("list", ("struct", [("k", "int32"), ("v", "string")])))])
    arrow_vals = _nested_values(500, seed=11)
    py = [_py_of_arrow(v, _NESTED_TYPE) for v in
          pa.array(arrow_vals, _NESTED_TYPE).to_pylist()]
    data = tpq.write_nested([("s", spec, ncol_from_py(spec, py)),
                             ("i", "int32", ncol_from_py("int32", list(range(500))))],
                            500, row_group_rows=128, device="cpu")
    path = str(tmp_path / "w.parquet")
    open(path, "wb").write(data)
    got = pq.read_table(path)
    assert got.num_rows == 500 and len(pq.ParquetFile(path).metadata.to_dict()["row_groups"]) == 4
    assert [_py_of_arrow(v, _NESTED_TYPE) for v in got.column("s").to_pylist()] == py
    assert got.column("i").to_pylist() == list(range(500))
    m = got.schema.field("s").type.field("m").type
    assert pa.types.is_map(m) and not m.key_field.nullable
    n, cols = tpq.read_nested(data, device="cpu")
    assert n == 500 and cols["s"].to_py() == py


def test_nested_reader_on_a_jax_checkpoint(tmp_path):
    """A checkpoint the JAX package wrote (snappy, dictionary pages, the
    V2 columns) decodes to the rows ``pyarrow`` reads."""
    from delta_tpu.log import checkpoints as jck
    from delta_tpu.protocol.actions import AddFile, Metadata, Protocol, RemoveFile
    from delta_tpu.schema.types import DateType, LongType, StructType
    from delta_tpu.storage.logstore import LocalLogStore

    schema = StructType().add("x", LongType()).add("d", DateType()).add("p", LongType())
    acts = [Protocol(1, 2), Metadata(schema_string=schema.to_json(), partition_columns=["p"]),
            RemoveFile("gone", deletion_timestamp=5, data_change=False)]
    for i in range(40):
        acts.append(AddFile(f"f{i}", {"p": None if i % 9 == 0 else str(i % 3)}, i, i, False,
                            stats=json.dumps({"numRecords": i, "minValues": {"x": i, "d":
                                              "2020-01-0%d" % (1 + i % 9)},
                                              "maxValues": {"x": i + 1}, "nullCount": {"x": 0}})
                            if i % 5 else None))
    log = str(tmp_path / "_delta_log")
    jck.write_checkpoint(LocalLogStore(), log, 3, acts)
    path = f"{log}/00000000000000000003.checkpoint.parquet"
    n, cols = tpq.read_nested(open(path, "rb").read(), device="cpu")
    want = pq.read_table(path)
    assert n == want.num_rows
    for name in want.column_names:
        assert cols[name].to_py() == [_py_of_arrow(v, want.schema.field(name).type)
                                      for v in want.column(name).to_pylist()], name


def test_nested_writer_refuses_what_it_lacks():
    """A decimal leaf, once refused, now round-trips through the nested
    writer (``pyarrow`` and the port read it back); a type the writer
    still lacks is named."""
    import decimal

    spec = ("struct", [("d", "decimal128(38, 4)"), ("l", ("list", "decimal128(7, 2)"))])
    py = [{"d": decimal.Decimal("-" + "9" * 34 + ".9999"), "l": [decimal.Decimal("1.50"), None]},
          None, {"d": None, "l": []}]
    data = tpq.write_nested([("x", spec, ncol_from_py(spec, py))], 3, device="cpu")
    assert pq.read_table(pa.BufferReader(data)).column("x").to_pylist() == py
    assert tpq.read_nested(data, device="cpu")[1]["x"].to_py(typed=True) == py
    with pytest.raises(NotImplementedError, match="decimal"):
        tpq.write_nested([("x", "decimal", ncol_from_py("int64", [1]))], 1, device="cpu")
