"""The port's scan-planning slice end to end (``delta_tpu_torch``): log ->
snapshot -> resident lanes -> block-cull plan -> files, held against
``delta_tpu.ops.pruning.files_for_scan`` on the same ``_delta_log/``.

Tolerance: exact equality of the file lists (paths, in order, and the
AddFile JSON) and of every DataSize; the JAX package plans exactly too.
"""
import os
import subprocess
import sys

import numpy as np
import pyarrow as pa
import pytest
import torch

from delta_tpu.commands.write import WriteIntoDelta
from delta_tpu.expr.parser import parse_expression as jax_parse
from delta_tpu.log.deltalog import DeltaLog as JaxDeltaLog
from delta_tpu.ops import pruning as jax_pruning
from delta_tpu.ops.state_cache import DeviceStateCache as JaxCache
from delta_tpu_torch import DeltaLog as TorchDeltaLog
from delta_tpu_torch.expr.parser import parse_expression as torch_parse
from delta_tpu_torch.ops import pruning as torch_pruning
from delta_tpu_torch.ops.state_cache import DeviceStateCache as TorchCache
from tests.torch_port_tables import point_queries, write_ops_table, write_table, write_tail

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _fresh_caches():
    JaxCache.reset()
    TorchCache.reset()
    TorchDeltaLog.clear_cache()
    yield
    JaxCache.reset()
    TorchCache.reset()
    TorchDeltaLog.clear_cache()


def _size(d):
    return (d.bytes_compressed, d.rows, d.files)


def _assert_scans_equal(path, queries, device="cpu"):
    jsnap = JaxDeltaLog.for_table(path).update()
    tsnap = TorchDeltaLog.for_table(path, device=device).update()
    assert tsnap.version == jsnap.version
    for q in queries:
        js = jax_pruning.files_for_scan(jsnap, [jax_parse(s) for s in q])
        ts = torch_pruning.files_for_scan(tsnap, [torch_parse(s) for s in q])
        assert [f.json() for f in ts.files] == [f.json() for f in js.files], q
        assert ts.version == js.version
        assert _size(ts.total) == _size(js.total), q
        assert _size(ts.partition) == _size(js.partition), q
        assert _size(ts.scanned) == _size(js.scanned), q
        assert [f.sql() for f in ts.partition_filters] == [f.sql() for f in js.partition_filters]
        assert [f.sql() for f in ts.data_filters] == [f.sql() for f in js.data_filters]


UNPARTITIONED_QUERIES = [
    ["c0 >= 1000000 AND c0 <= 1100000"],
    ["c0 = 2000000"],
    ["c1 <= 12.5"],
    ["c1 >= 9990.0"],
    ["c0 >= 1000 AND c0 <= 50000 AND c1 >= 0 AND c1 <= 100.0"],
    ["c0 <= 20000 OR c0 >= 4190000"],
    ["c0 IN (5, 777777, 3000000)"],
    ["c0 BETWEEN 100 AND 90000"],
    ["c0 >= 100", "c1 <= 5000.0"],
    ["c0 = NULL"],
    ["c0 <= 0"],
    [],
]


def test_unpartitioned_scans_match_jax_before_and_after_tail(tmp_path):
    path = str(tmp_path / "t")
    state = write_table(path, n_files=3000)
    queries = UNPARTITIONED_QUERIES + [[q] for q in point_queries(state, 12)]
    _assert_scans_equal(path, queries)
    write_tail(path, state, n_commits=4)
    _assert_scans_equal(path, queries)


PARTITIONED_QUERIES = [
    ["day = '2021-01-05'"],
    ["day >= '2021-01-20'"],
    ["day >= '2021-01-03' AND day <= '2021-01-06'"],
    ["day IN ('2021-01-02', '2021-01-03', '2021-01-09')"],
    ["bucket = 3"],
    ["bucket >= 5"],
    ["bucket IN (1, 2)"],
    ["day = '2021-01-05' AND c0 >= 1000000"],
    ["day = '2021-01-05' OR day = '2021-01-07'"],
    ["bucket = 99"],
    ["day = 'nope'"],
    ["c0 >= 1000 AND c0 <= 900000"],
    ["bucket <= 2", "c1 <= 3000.0"],
]


def test_partitioned_scans_match_jax_before_and_after_tail(tmp_path):
    path = str(tmp_path / "t")
    state = write_table(path, n_files=2400, partitioned=True)
    _assert_scans_equal(path, PARTITIONED_QUERIES)
    write_tail(path, state, n_commits=3)
    # the tail added a day that sorts before the dictionary: the day lane is
    # unsorted now, so day RANGES stop lowering (equality and IN still do)
    after = [q for q in PARTITIONED_QUERIES
             if not any(("day >" in s or "day <" in s) for s in q)]
    _assert_scans_equal(path, after + [["day = '2020-12-31'"], ["day = '2021-02-01'"]])
    # ...and take the normal leg, with the JAX package's answer
    tsnap = TorchDeltaLog.for_table(path, device="cpu").update()
    assert torch_pruning._resident_scan(tsnap, [torch_parse("day >= '2021-01-20'")], []) is None
    _assert_scans_equal(path, [["day >= '2021-01-20'"], ["day <= '2021-01-03'"]])


def test_table_written_by_write_command(tmp_path):
    """A table written by the JAX package's write command (Parquet data
    files, collected stats), a few small appends."""
    path = str(tmp_path / "t")
    log = JaxDeltaLog.for_table(path)
    rng = np.random.RandomState(1)
    for i in range(6):
        WriteIntoDelta(log, "append", pa.table({
            "a": np.arange(i * 40, (i + 1) * 40, dtype=np.int64),
            "b": rng.rand(40),
        })).run()
    _assert_scans_equal(path, [["a = 25"], ["a >= 100 AND a <= 139"], ["a <= 0"],
                               ["b <= 2.0"], ["a IN (1, 200)"], []])


@pytest.mark.parametrize("predicate,served", [
    ("c1 > 5.0", False),          # strict bound: the range lowering is not exact
    ("NOT (c0 <= 4000000)", False),  # flips to a strict c0 > 4000000: not exact
    ("c0 IS NULL", False),        # null counts are not range lanes
    ("c0 + 1 >= 5", True),        # synthesis inverts it exactly: max.c0 >= 4
    ("c0 >= -5", True),           # unary minus folds into the literal
    ("c0 != 5", True),            # rewrites to UNKNOWN: keep every file
])
def test_unlowerable_predicate_raises(tmp_path, predicate, served):
    """Once the first slice raised on each; now a predicate the resident
    planner cannot lower exactly takes the normal leg, and every one
    returns the JAX package's answer."""
    path = str(tmp_path / "t")
    write_table(path, n_files=200)
    tsnap = TorchDeltaLog.for_table(path, device="cpu").update()
    got = torch_pruning._resident_scan(tsnap, [], [torch_parse(predicate)])
    assert (got is not None) == served
    _assert_scans_equal(path, [[predicate]])


def test_time_travel_snapshot_below_residency_raises(tmp_path):
    """A snapshot older than the resident state takes the normal leg (the
    first slice raised here) and answers as the JAX package does."""
    path = str(tmp_path / "t")
    state = write_table(path, n_files=300)
    write_tail(path, state, n_commits=1)
    log = TorchDeltaLog.for_table(path, device="cpu")
    q = "c0 >= 0 AND c0 <= 3000000"
    torch_pruning.files_for_scan(log.update(), [torch_parse(q)])
    old = log.get_snapshot_at(2)
    assert torch_pruning._resident_scan(old, [], [torch_parse(q)]) is None
    ts = torch_pruning.files_for_scan(old, [torch_parse(q)])
    js = jax_pruning.files_for_scan(JaxDeltaLog.for_table(path).get_snapshot_at(2),
                                    [jax_parse(q)])
    assert [f.json() for f in ts.files] == [f.json() for f in js.files]
    assert _size(ts.total) == _size(js.total) and _size(ts.scanned) == _size(js.scanned)


def test_port_imports_no_jax_pyarrow_or_delta_tpu():
    code = (
        "import importlib, pkgutil, sys\n"
        "import delta_tpu_torch\n"
        "for m in pkgutil.walk_packages(delta_tpu_torch.__path__, 'delta_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'jaxlib', 'pyarrow', 'delta_tpu'))\n"
        "print(len([n for n in sys.modules if n.startswith('delta_tpu_torch.')]))\n"
        "print(bad)\n"
        "print(' '.join(sorted(n for n in sys.modules if n.startswith('delta_tpu_torch.'))))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules, bad, names = out.stdout.strip().splitlines()
    assert int(n_modules) >= 30
    assert bad == "[]"
    for m in ("expr.device_eval", "expr.vectorized", "expr.synthesis", "expr.partition",
              "schema.char_varchar", "utils.timeparse", "ops.replay_kernel", "ops.pruning",
              "ops.state_export"):
        assert f"delta_tpu_torch.{m}" in names.split(), m


def test_chip_smoke_imports_no_jax_or_delta_tpu():
    import ast

    tree = ast.parse(open(os.path.join(REPO, "chip_smoke.py")).read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    assert "delta_tpu_torch.ops" in names  # it drives the port
    assert not [m for m in names if m.split(".")[0] in ("jax", "jaxlib", "pyarrow", "delta_tpu")]


def test_default_device_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is usable")
    path = str(tmp_path / "t")
    write_table(path, n_files=10)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchDeltaLog.for_table(path)


# -- the pruning cases of tests/test_ops.py, on a real log ------------------------


@pytest.mark.parametrize("predicate,served", [
    ("part = 'us'", True),
    ("id = 150", True),
    ("price >= 25.0", True),
    ("part = 'eu' AND id <= 250", True),
    ("id IN (5, 305)", True),
    ("id >= 2147483647", True),
    (f"id >= {2**53}", True),  # beyond 2^53: a missing stat, the file is kept
    ("part = 'us' OR id >= 350", True),
    ("part IN ('us', 'xx')", True),
    ("id < 100", False),  # strict: not exact
    ("part = 'us' OR id > 350", False),
    ("name IS NULL", False),
    ("name >= 'zz'", False),  # string-prefix lanes are never exact
    ("name LIKE '%x%'", True),  # no literal prefix: UNKNOWN, keep every file
])
def test_ops_pruning_cases_match_jax(tmp_path, predicate, served):
    path = str(tmp_path / "t")
    write_ops_table(path)
    tsnap = TorchDeltaLog.for_table(path, device="cpu").update()
    filters = [torch_parse(predicate)]
    parts = [c for c in filters if "part" in c.sql() and "id" not in c.sql()]
    data = [c for c in filters if c not in parts]
    assert (torch_pruning._resident_scan(tsnap, parts, data) is not None) == served
    _assert_scans_equal(path, [[predicate]])
