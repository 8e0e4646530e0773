"""The port's Parquet write policy and page codec against ``delta_tpu``'s
(``exec/parquet.write_parquet_file`` and its checkpoints, through Arrow's
C++), on the CPU, where the codec runs its plain versions.

* policy: each package writes the same table under
  ``delta.tpu.write.compression`` ``auto``, ``none``, ``snappy``, ``gzip``
  and under ``delta.tpu.write.byteStreamSplit=false``; every column chunk's
  codec and set of encodings, as ``pyarrow`` reads the footers, is the
  JAX package's; each package's reader reads the other's file to the
  same rows; the port's file is at most 1.15x the JAX package's. Tables:
  twelve leaves (random and sequential int64, an int32 of 7 values,
  float64, float32, a 37-value string, a near-unique string, bool, date,
  ``decimal(7,2)``, a struct of int64 and string), bench config 2's
  ``store_sales`` (``bench.py:168-181``) and ``tests/test_torch_datatypes``'s
  flat and nested tables;
* the probe (``_compresses_well``): the port's decision equals the JAX
  package's for each type, an all-NULL column, an empty one, one under
  1,024 bytes, a timestamp and ``decimal(38,10)``;
* checkpoints: each package's checkpoint of one log has SNAPPY and the
  JAX package's encodings on every leaf, and each package reads the
  other's to the same snapshot;
* the plain compressor: a hypothesis corpus round-trips through the plain
  decoder and ``pyarrow``'s; the batched calls equal the per-page ones;
* no fallback: a raising codec fails a write and a read, and no commit
  lands; ZSTD, LZ4 and BROTLI writes raise ``NotImplementedError``.

The port's compressor and Arrow's (Google's Snappy) differ in ratio, so a
column whose sample compresses to within a few percent of the probe's 0.9
cut may be judged differently (``ROADMAP.md`` queue C): every column here
lies clear of that band, which :func:`test_probe_data_is_clear_of_the_band`
checks with both compressors.

Tolerance: exact (codecs, encodings, rows); sizes within 1.15x.
"""
import datetime as dt
import decimal
import os
import shutil

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
from hypothesis import given, settings, strategies as st

from delta_tpu import DeltaLog as JaxDeltaLog
from delta_tpu.commands.write import WriteIntoDelta as JaxWrite
from delta_tpu.exec import parquet as jpq
from delta_tpu.utils.config import conf as jax_conf
from delta_tpu_torch import DeltaLog as TorchDeltaLog
from delta_tpu_torch.api.tables import DeltaTable as TorchTable
from delta_tpu_torch.commands.write import WriteIntoDelta as TorchWrite
from delta_tpu_torch.exec import parquet as tpq
from delta_tpu_torch.exec import snappy
from delta_tpu_torch.expr.vectorized import stored_type
from delta_tpu_torch.utils.config import conf as torch_conf
from tests.test_torch_datatypes import ALL_TYPES, _nested_rows, _nested_table
from tests.torch_port_tables import Pkg

D = decimal.Decimal
CPU = "cpu"


@pytest.fixture(autouse=True)
def _fresh_logs():
    JaxDeltaLog.clear_cache()
    TorchDeltaLog.clear_cache()
    yield
    JaxDeltaLog.clear_cache()
    TorchDeltaLog.clear_cache()


def twelve_leaves(n=20_000, seed=0):
    rng = np.random.RandomState(seed)
    some_null = lambda vals, every: [None if i % every == 3 else v  # noqa: E731
                                     for i, v in enumerate(vals)]
    return pa.table({
        "rand_i64": pa.array(rng.randint(-2**62, 2**62, n, dtype=np.int64)),
        "seq_i64": pa.array(np.arange(n, dtype=np.int64)),
        "low_i32": pa.array(some_null(rng.randint(0, 7, n).tolist(), 11), pa.int32()),
        "f64": pa.array(rng.normal(size=n)),
        "f32": pa.array(rng.normal(size=n).astype(np.float32)),
        "s37": pa.array(some_null([f"val{x}" for x in rng.randint(0, 37, n)], 13)),
        "suniq": pa.array([f"u{x:012d}" for x in rng.permutation(n)]),
        "b": pa.array(rng.randint(0, 2, n).astype(bool)),
        "date": pa.array((18000 + rng.randint(0, 30, n)).astype(np.int32)).cast(pa.date32()),
        "dec": pa.array([D(int(x)).scaleb(-2) for x in rng.randint(0, 10**6, n)],
                        pa.decimal128(7, 2)),
        "st": pa.StructArray.from_arrays(
            [pa.array(rng.randint(0, 100, n)), pa.array([f"k{x}" for x in rng.randint(0, 5, n)])],
            ["a", "b"]),
    })


def store_sales(n=20_000, seed=7):
    """``bench.py:168-181``'s ``_store_sales`` draws."""
    rng = np.random.RandomState(seed)
    return pa.table({
        "ss_item_sk": rng.permutation(n * 2)[:n].astype(np.int64),
        "ss_customer_sk": rng.randint(0, 1_000_000, n).astype(np.int64),
        "ss_sold_date_sk": rng.randint(2450000, 2452000, n).astype(np.int64),
        "ss_store_sk": rng.randint(0, 500, n).astype(np.int64),
        "ss_quantity": rng.randint(1, 100, n).astype(np.int64),
        "ss_sales_price": rng.rand(n) * 100,
        "ss_ext_discount_amt": rng.rand(n) * 10,
        "ss_net_paid": rng.rand(n) * 90,
    })


def nested_table():
    return Pkg("jax").table(_nested_table(_nested_rows(600, 1)))


TABLES = {"twelve": twelve_leaves, "store_sales": store_sales, "all_types": lambda: ALL_TYPES,
          "nested": nested_table}
SETTINGS = {"auto": {}, "none": {"delta.tpu.write.compression": "none"},
            "snappy": {"delta.tpu.write.compression": "snappy"},
            "gzip": {"delta.tpu.write.compression": "gzip"},
            "no-bss": {"delta.tpu.write.byteStreamSplit": False}}


def host(t: pa.Table, tmp_path):
    """The same table as the port's HostTable (a plain pyarrow file read by
    the port's reader: NULL slots as Arrow fills them)."""
    p = str(tmp_path / "host.parquet")
    pq.write_table(t, p, compression="none", use_dictionary=False)
    return tpq.read_parquet_file(p, device=CPU)


def chunks(path):
    md = pq.ParquetFile(path).metadata
    return [(md.row_group(g).column(i).path_in_schema, md.row_group(g).column(i).compression,
             tuple(sorted(md.row_group(g).column(i).encodings)))
            for g in range(md.num_row_groups) for i in range(md.num_columns)]


def write_both(t, tmp_path, setting):
    paths = {k: str(tmp_path / f"{k}.parquet") for k in ("jax", "torch")}
    h = host(t, tmp_path)
    with jax_conf.set_temporarily(**setting), torch_conf.set_temporarily(**setting):
        jpq.write_parquet_file(t, paths["jax"])
        tpq.write_parquet_file(h, paths["torch"], device=CPU)
    return paths


@pytest.mark.parametrize("setting", list(SETTINGS))
@pytest.mark.parametrize("table", list(TABLES))
def test_policy_matches_jax(tmp_path, table, setting):
    t = TABLES[table]()
    paths = write_both(t, tmp_path, SETTINGS[setting])
    assert chunks(paths["torch"]) == chunks(paths["jax"])
    want = t.to_pylist()
    assert pq.read_table(paths["torch"]).to_pylist() == want
    for p in paths.values():
        assert tpq.read_parquet_file(p, device=CPU).to_pylist() == want
    size = {k: os.path.getsize(p) for k, p in paths.items()}
    assert size["torch"] <= 1.15 * size["jax"], size


def test_twelve_leaves_pinned_choices(tmp_path):
    """The JAX writer's choices for the twelve leaves under ``auto``, pinned
    by probing ``pyarrow``: the port reproduces them (the struct's leaves
    stay uncompressed, Arrow's 16-byte decimal words compress)."""
    paths = write_both(twelve_leaves(), tmp_path, {})
    got = {path: (codec, encs) for path, codec, encs in chunks(paths["torch"])}
    plain, bss, dct = ("PLAIN", "RLE"), ("BYTE_STREAM_SPLIT", "RLE"), \
        ("PLAIN", "RLE", "RLE_DICTIONARY")
    assert got == {
        "rand_i64": ("UNCOMPRESSED", plain), "seq_i64": ("SNAPPY", plain),
        "low_i32": ("SNAPPY", plain), "f64": ("SNAPPY", bss), "f32": ("SNAPPY", bss),
        "s37": ("SNAPPY", dct), "suniq": ("SNAPPY", dct), "b": ("UNCOMPRESSED", plain),
        "date": ("SNAPPY", plain), "dec": ("SNAPPY", plain),
        "st.a": ("UNCOMPRESSED", plain), "st.b": ("UNCOMPRESSED", plain)}


def test_pages_near_a_mebibyte_and_the_dictionary_fallback(tmp_path):
    """300,000 rows: data pages are cut near 1 MiB, and a near-unique string
    column's dictionary stops at its 1 MiB page, the rest PLAIN (both
    readers read it); the size stays within 1.15x of the JAX file."""
    n = 300_000
    rng = np.random.RandomState(3)
    t = pa.table({"id": np.arange(n, dtype=np.int64),
                  "u": pa.array([f"user-{x:020d}" for x in rng.permutation(n)])})
    with jax_conf.set_temporarily(**{"delta.tpu.write.rowGroupRows": n}), \
            torch_conf.set_temporarily(**{"delta.tpu.write.rowGroupRows": n}):
        paths = write_both(t, tmp_path, {})
    assert chunks(paths["torch"]) == chunks(paths["jax"])
    meta = tpq.read_metadata(paths["torch"])
    md = meta.row_groups[0].columns[1].meta_data
    assert md.dictionary_page_offset is not None
    pages, data = [], open(paths["torch"], "rb").read()
    pos = md.dictionary_page_offset
    from delta_tpu_torch.exec import thrift

    while pos < md.dictionary_page_offset + md.total_compressed_size:
        ph, pos = thrift.read(thrift.PageHeader, data, pos)
        enc_ = (ph.data_page_header.encoding if ph.data_page_header else None)
        pages.append((ph.type, enc_, ph.uncompressed_page_size))
        pos += ph.compressed_page_size
    assert pages[0][0] == 2 and pages[0][2] >= 1 << 20  # the dictionary page, at its limit
    encs = [e for _, e, _ in pages[1:]]
    assert 8 in encs and encs[-1] == 0  # RLE_DICTIONARY pages, then PLAIN
    assert all(size < (1 << 20) + 65536 for kind, _, size in pages[1:])
    assert len(pages) > 4
    want = t.to_pylist()
    assert pq.read_table(paths["torch"]).to_pylist() == want
    assert tpq.read_parquet_file(paths["torch"], device=CPU).to_pylist() == want
    assert os.path.getsize(paths["torch"]) <= 1.15 * os.path.getsize(paths["jax"])


# -- the probe ----------------------------------------------------------------------


def probe_table():
    rng = np.random.RandomState(11)
    n = 20_000
    return pa.table({
        "i8": pa.array(rng.randint(-100, 100, n).astype(np.int8)),
        "i16": pa.array(rng.randint(-30000, 30000, n).astype(np.int16)),
        "i32_low": pa.array(rng.randint(0, 7, n).astype(np.int32)),
        "i64_rand": pa.array(rng.randint(-2**62, 2**62, n, dtype=np.int64)),
        "i64_seq": pa.array(np.arange(n, dtype=np.int64)),
        "f64": pa.array(rng.rand(n)),
        "f32": pa.array(rng.rand(n).astype(np.float32)),
        "s37": pa.array([f"val{x}" for x in rng.randint(0, 37, n)]),
        "bin_rand": pa.array([rng.bytes(16) for _ in range(n)], pa.binary()),
        "b": pa.array(rng.randint(0, 2, n).astype(bool)),
        "date": pa.array((18000 + rng.randint(0, 30, n)).astype(np.int32)).cast(pa.date32()),
        "ts_rand": pa.array(rng.randint(0, 2**50, n)).cast(pa.timestamp("us")),
        "ts_seq": pa.array(np.arange(n) * 1_000_000).cast(pa.timestamp("us", tz="UTC")),
        "dec7": pa.array([D(int(x)).scaleb(-2) for x in rng.randint(0, 10**6, n)],
                         pa.decimal128(7, 2)),
        "dec38": pa.array([D(int(x)).scaleb(-10) for x in rng.randint(-10**17, 10**17, n,
                                                                       dtype=np.int64)],
                          pa.decimal128(38, 10)),
        "all_null": pa.array([None] * n, pa.int64()),
        "small": pa.array(list(range(100)) + [None] * (n - 100), pa.int64()),
        "st": pa.StructArray.from_arrays(
            [pa.array(rng.randint(0, 100, n)), pa.array([f"k{x}" for x in rng.randint(0, 5, n)])],
            ["a", "b"]),
    })


def _port_decisions(h):
    return {name: tpq._compresses_well([tpq._probe_sample(col, stored_type(col))], CPU)[0]
            for name, col in h.columns.items()}


def test_probe_decisions_match_jax(tmp_path):
    t = probe_table()
    want = {name: jpq._compresses_well(t.column(name)) for name in t.column_names}
    assert _port_decisions(host(t, tmp_path)) == want
    # the pinned traps: Arrow's 16-byte decimal words compress, random bits
    # and random integers do not, an all-NULL column's zeros do
    assert want["dec7"] and want["dec38"] and not want["b"] and not want["i64_rand"]
    assert want["all_null"] and want["small"] and want["st"]


def test_probe_on_an_empty_column_and_a_short_one(tmp_path):
    for t in (pa.table({"e": pa.array([], pa.int64())}),
              pa.table({"short": np.random.RandomState(1).randint(-2**62, 2**62, 100,
                                                                   dtype=np.int64)})):
        want = {name: jpq._compresses_well(t.column(name)) for name in t.column_names}
        assert all(want.values())
        h = tpq.read_parquet_file(_plain_file(t, tmp_path), device=CPU)
        assert _port_decisions(h) == want


def _plain_file(t, tmp_path):
    p = str(tmp_path / "plain.parquet")
    pq.write_table(t, p, compression="none", use_dictionary=False)
    return p


def test_probe_data_is_clear_of_the_band(tmp_path):
    """Each probed sample's ratio under Google's Snappy (``pyarrow``) and
    under the port's plain compressor lies on the same side of 0.9, at
    least 0.03 from it."""
    t = probe_table()
    h = host(t, tmp_path)
    for name, col in h.columns.items():
        sample = tpq._probe_sample(col, stored_type(col))
        if sample is None or len(sample) < 1024:
            continue
        google = len(pa.compress(sample, codec="snappy", asbytes=True)) / len(sample)
        port = len(snappy.compress(sample)) / len(sample)
        assert (google < 0.9) == (port < 0.9), (name, google, port)
        assert min(abs(google - 0.9), abs(port - 0.9)) > 0.03, (name, google, port)


# -- checkpoints ---------------------------------------------------------------------


def _checkpoint_chunks(log_dir):
    [name] = [f for f in os.listdir(log_dir) if ".checkpoint." in f]
    return {tuple(p.split(".")): (codec, encs)
            for p, codec, encs in chunks(os.path.join(log_dir, name))}


def test_checkpoints_match_jax_and_read_across(tmp_path):
    src = str(tmp_path / "src")
    rng = np.random.RandomState(2)
    for i in range(3):
        n = 50
        JaxWrite(JaxDeltaLog.for_table(src), "append", pa.table({
            "id": np.arange(i * n, (i + 1) * n, dtype=np.int64), "x": rng.rand(n),
            "s": [f"s{k % 7}" for k in range(n)]})).run()
    paths = {k: str(tmp_path / k) for k in ("jax", "torch")}
    for p in paths.values():
        shutil.copytree(src, p)
    JaxDeltaLog.for_table(paths["jax"]).checkpoint()
    TorchDeltaLog.for_table(paths["torch"], device=CPU).checkpoint()
    got = {k: _checkpoint_chunks(os.path.join(p, "_delta_log")) for k, p in paths.items()}
    common = set(got["jax"]) & set(got["torch"])
    assert len(common) > 20
    assert {k: got["torch"][k] for k in common} == {k: got["jax"][k] for k in common}
    for leaf, (codec, encs) in got["torch"].items():
        assert codec == "SNAPPY", leaf
        assert encs in (("PLAIN", "RLE"), ("PLAIN", "RLE", "RLE_DICTIONARY")), leaf
    snaps = []
    for p in paths.values():
        JaxDeltaLog.clear_cache()
        TorchDeltaLog.clear_cache()
        j = JaxDeltaLog.for_table(p).update()
        t = TorchDeltaLog.for_table(p, device=CPU).update()
        assert j.version == t.version == 2 and t.segment.checkpoint_version == 2
        snaps.append(sorted((a.path, a.size) for a in j.all_files))
        snaps.append(sorted((a.path, a.size) for a in t.all_files))
    assert all(s == snaps[0] for s in snaps) and len(snaps[0]) == 3


# -- the plain compressor and the batched calls --------------------------------------

EDGES = [0, 1, 59, 60, 61, 62, 63, 64, 65, 255, 256, 257, 65535, 65536, 65537]


def _corpus():
    edge = st.sampled_from(EDGES).flatmap(lambda n: st.binary(min_size=n, max_size=n))
    period = st.tuples(st.binary(min_size=1, max_size=7), st.integers(1, 70_000)).map(
        lambda pr: (pr[0] * (pr[1] // len(pr[0]) + 1))[:pr[1]])
    mixed = st.lists(st.one_of(st.binary(max_size=300), period), max_size=6).map(b"".join)
    return st.one_of(edge, period, st.binary(max_size=5000), mixed)


@settings(max_examples=120, deadline=None)
@given(_corpus())
def test_plain_compressor_round_trips(raw):
    z = snappy.compress(raw)
    assert snappy.decompress(z) == raw
    assert pa.decompress(z, decompressed_size=len(raw), codec="snappy", asbytes=True) == raw


@pytest.mark.parametrize("n", [65535, 65536, 65537, 3 * 65536 + 5])
def test_plain_compressor_fragment_edges(n):
    rng = np.random.RandomState(n)
    raw = (rng.randint(0, 3, n).astype(np.uint8) * 7).tobytes()
    z = snappy.compress(raw)
    assert snappy.decompress(z) == raw and len(z) < n // 2
    assert pa.decompress(z, decompressed_size=n, codec="snappy", asbytes=True) == raw


def test_batched_calls_equal_the_per_page_calls():
    rng = np.random.RandomState(4)
    pages = [b"", b"x", rng.bytes(70_000), b"ab" * 40_000, bytes(100)]
    z = snappy.compress_pages(pages, CPU)
    assert z == [snappy.compress(p) for p in pages]
    assert snappy.decompress_pages(z, [len(p) for p in pages], CPU) == pages
    with pytest.raises(snappy.SnappyError, match="f.parquet: column 'c'"):
        snappy.decompress_pages(z[2:3], [69_999], CPU, ["f.parquet: column 'c'"])


@pytest.mark.parametrize("need, want", [
    ([], [(0, 0)]),
    ([10, 20, 30], [(0, 3)]),
    ([40, 30, 30, 100, 1], [(0, 1), (1, 3), (3, 4), (4, 5)]),
    ([0, 64, 0, 0, 1], [(0, 4), (4, 5)]),
])
def test_staging_chunks_stay_within_the_cap(monkeypatch, need, want):
    """The card's codec stages a batch in chunks of at most ``STAGING_CAP``
    bytes (here 64), consecutive and covering every page; a page past the
    cap goes alone."""
    from delta_tpu_torch.ops import page_codec

    monkeypatch.setattr(page_codec, "STAGING_CAP", 64)
    got = page_codec._chunks(need)
    assert [(g.start, g.stop) for g in got] == want
    for g in got:
        assert len(g) == 1 or sum(need[g.start:g.stop]) <= 64


# -- no fallback, and the codecs the port does not write ------------------------------


def _raise(*args, **kwargs):
    raise RuntimeError("injected codec failure")


def test_a_failing_codec_fails_the_write_and_the_read(tmp_path, monkeypatch):
    path = str(tmp_path / "t")
    log = TorchDeltaLog.for_table(path, device=CPU)
    TorchWrite(log, "append", host(pa.table({"id": np.arange(100, dtype=np.int64)}),
                                   tmp_path)).run()
    assert log.update().version == 0
    more = host(pa.table({"id": np.arange(100, 200, dtype=np.int64)}), tmp_path)
    with monkeypatch.context() as m:
        m.setattr(snappy, "compress_pages", _raise)
        with pytest.raises(RuntimeError, match="injected"):
            TorchWrite(log, "append", more).run()
        with pytest.raises(RuntimeError, match="injected"):
            TorchTable(log).delete("id < 5")
    assert log.update().version == 0
    with monkeypatch.context() as m:
        m.setattr(snappy, "decompress_pages", _raise)
        with pytest.raises(RuntimeError, match="injected"):
            TorchTable(log).to_table()
    assert TorchTable(log).to_table().num_rows == 100


@pytest.mark.parametrize("codec", ["zstd", "lz4", "brotli", "ZSTD"])
def test_unwritten_codecs_raise(tmp_path, codec):
    h = host(pa.table({"a": [1, 2, 3]}), tmp_path)
    with torch_conf.set_temporarily(**{"delta.tpu.write.compression": codec}):
        with pytest.raises(NotImplementedError, match="queue A item 3"):
            tpq.write_parquet_file(h, str(tmp_path / "x.parquet"), device=CPU)
    with pytest.raises(ValueError, match="not a Parquet codec"):
        tpq.write_parquet_file(h, str(tmp_path / "y.parquet"), compression="lzo2", device=CPU)


def test_timestamps_and_dates_keep_their_values(tmp_path):
    """A date and a timestamp column through the port's compressed writer
    (SNAPPY where the probe says so), read back by ``pyarrow``."""
    t = pa.table({"d": pa.array([dt.date(2020, 1, 1) + dt.timedelta(days=i % 40)
                                 for i in range(5000)]),
                  "ts": pa.array([dt.datetime(2021, 5, 1) + dt.timedelta(seconds=i)
                                  for i in range(5000)], pa.timestamp("us"))})
    paths = write_both(t, tmp_path, {})
    assert chunks(paths["torch"]) == chunks(paths["jax"])
    assert pq.read_table(paths["torch"]).to_pylist() == t.to_pylist()
