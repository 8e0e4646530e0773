"""The port's streaming (``delta_tpu_torch.streaming``: ``DeltaSource``,
``DeltaCDFSource``, ``DeltaSink``, ``StreamingQuery``) against
``delta_tpu``'s on the CPU: every case of ``tests/test_streaming.py`` and
``tests/test_streaming_scenarios.py`` and the streaming CDF cases of
``tests/test_cdf.py``, each run once a package in its own directory
(``tests/torch_api_tables.both``). The observation is each batch's rows,
the offsets (version, index, starting flag: the table id is random in each
run), batch counts, the sink table's state as both packages read it, and
every error's class and message, exactly equal."""
import os

import pytest

from tests.torch_api_tables import both, observe
from tests.torch_write_tables import CDF, W, state


def write(p, log, data, mode="append", **kw):
    return p.write_mod.WriteIntoDelta(log, mode, p.table(data), **kw).run()


def off(o):
    return None if o is None else (o.reservoir_version, o.index, o.is_starting_version)


def drain(source, start=None, limit=100):
    """Every pending batch's sorted ids (empty batches left out), and the
    last offset."""
    out, cur = [], start
    for _ in range(limit):
        anchor = cur if cur is not None else source.initial_offset()
        end = source.latest_offset(anchor)
        if end is None:
            return out, cur
        t = source.get_batch(cur, end)
        if t.num_rows:
            out.append(sorted(r["id"] for r in t.to_pylist()))
        cur = end
    raise AssertionError("source did not drain")


def src_log(p, root, name="src"):
    path = os.path.join(root, name)
    return path, p.log(path)


# -- tests/test_streaming.py ---------------------------------------------------------


def _source_initial_snapshot_then_tail(p, root):
    _, log = src_log(p, root)
    write(p, log, {"id": [1, 2]})
    write(p, log, {"id": [3]})
    source = p.source.DeltaSource(log)
    first, cur = drain(source)
    write(p, log, {"id": [4, 5]})
    second, cur = drain(source, cur)
    return first, second, drain(source, cur)[0], off(cur)


def _source_max_files_and_bytes(p, root):
    _, log = src_log(p, root)
    for i in range(4):
        write(p, log, {"id": [i]})
    D = p.source.DeltaSource
    return (drain(D(log, max_files_per_trigger=2))[0],
            drain(D(log, max_files_per_trigger=None, max_bytes_per_trigger=1))[0],
            drain(D(log, starting_version=0, max_files_per_trigger=None,
                    max_bytes_per_trigger=1))[0])


def _source_starting_version_skips_snapshot(p, root):
    _, log = src_log(p, root)
    for i in (1, 2, 3):
        write(p, log, {"id": [i]})
    return drain(p.source.DeltaSource(log, starting_version=1))[0]


def _source_delete_and_ignore_deletes(p, root):
    path, log = src_log(p, root)
    write(p, log, {"id": [1, 2]})
    write(p, log, {"id": [3]})
    strict = p.source.DeltaSource(log)
    lax = p.source.DeltaSource(log, ignore_deletes=True)
    _, cur = drain(strict)
    _, cur2 = drain(lax)
    p.for_path(path).delete()
    err = observe(lambda: drain(strict, cur))[:2]  # the message names a random file
    write(p, log, {"id": [9]})
    return err, drain(lax, cur2)[0]


def _source_update_requires_ignore_changes(p, root):
    path, log = src_log(p, root)
    write(p, log, {"id": [1, 2], "v": [1, 1]})
    source = p.source.DeltaSource(log)
    _, cur = drain(source)
    p.for_path(path).update({"v": "2"}, "id = 1")
    err = observe(lambda: drain(source, cur))[:2]  # the message names a random file
    source2 = p.source.DeltaSource(log, ignore_changes=True)
    _, cur2 = drain(source2)
    p.for_path(path).update({"v": "3"}, "id = 1")
    return err, drain(source2, cur2)[0]


def _source_schema_change_fails(p, root):
    _, log = src_log(p, root)
    write(p, log, {"id": [1]})
    source = p.source.DeltaSource(log)
    _, cur = drain(source)
    write(p, log, {"id": [2], "extra": ["x"]}, merge_schema=True)
    return [observe(lambda: drain(source, cur))]


def _offset_json_roundtrip_and_table_id_check(p, root):
    o = p.source.DeltaSourceOffset(7, 3, True, "tbl-1")
    back = p.source.DeltaSourceOffset.from_json(o.json(), "tbl-1")
    return o.json(), back == o, observe(
        lambda: p.source.DeltaSourceOffset.from_json(o.json(), "other-table"))


def _sink_exactly_once_and_complete_mode(p, root):
    path, log = src_log(p, root, "sink")
    sink = p.sink.DeltaSink(log, query_id="q1")
    got = [sink.add_batch(0, p.table({"id": [1]})), sink.add_batch(0, p.table({"id": [1]})),
           sink.add_batch(1, p.table({"id": [2]}))]
    cpath, clog = src_log(p, root, "complete")
    csink = p.sink.DeltaSink(clog, query_id="q1", output_mode="complete")
    csink.add_batch(0, p.table({"id": [1, 2]}))
    csink.add_batch(1, p.table({"id": [9]}))
    return got, state(path), state(cpath), observe(
        lambda: p.sink.DeltaSink(log, query_id="q", output_mode="update"))


def _query_end_to_end_and_restart(p, root):
    path, log = src_log(p, root)
    dst, ckpt = os.path.join(root, "dst"), os.path.join(root, "ckpt")
    write(p, log, {"id": [1, 2]})

    def run():
        q = p.query.StreamingQuery(p.source.DeltaSource(log, max_files_per_trigger=1),
                                   p.sink.DeltaSink(p.log(dst), query_id="qx"), ckpt)
        return q.process_all_available()

    runs = [run()]
    write(p, log, {"id": [3]})
    write(p, log, {"id": [4]})
    runs += [run(), run()]
    return runs, state(dst)


def _query_recovers_unfinished_batch(p, root):
    path, log = src_log(p, root)
    dst, ckpt = os.path.join(root, "dst"), os.path.join(root, "ckpt")
    write(p, log, {"id": [1]})
    source = p.source.DeltaSource(log)
    q = p.query.StreamingQuery(source, p.sink.DeltaSink(p.log(dst), query_id="qy"), ckpt)
    q.process_all_available()
    write(p, log, {"id": [2]})
    q._write_offset(1, source.latest_offset(q._read_offset(0)))
    q2 = p.query.StreamingQuery(p.source.DeltaSource(log),
                                p.sink.DeltaSink(p.log(dst), query_id="qy"), ckpt)
    return q2.process_all_available(), state(dst)


def _source_rearrange_only_commit_does_not_spin(p, root):
    path, log = src_log(p, root)
    for i in range(3):
        write(p, log, {"id": [i]})
    source = p.source.DeltaSource(log, ignore_changes=True)
    _, cur = drain(source)
    p.for_path(path).optimize().execute_compaction()
    end = source.latest_offset(cur)
    return off(end), end and off(source.latest_offset(end)), \
        end and source.get_batch(cur, end).num_rows


def _query_recovery_of_initial_snapshot_batch(p, root):
    path, log = src_log(p, root)
    dst, ckpt = os.path.join(root, "dst"), os.path.join(root, "ckpt")
    write(p, log, {"id": [1, 2]})
    source = p.source.DeltaSource(log)
    q = p.query.StreamingQuery(source, p.sink.DeltaSink(p.log(dst), query_id="qz"), ckpt)
    q._write_offset(0, source.latest_offset(source.initial_offset()))
    write(p, log, {"id": [3]})
    q2 = p.query.StreamingQuery(p.source.DeltaSource(log),
                                p.sink.DeltaSink(p.log(dst), query_id="qz"), ckpt)
    q2.process_all_available()
    return state(dst)


def _source_exclude_regex(p, root):
    _, log = src_log(p, root)
    write(p, log, {"id": [1]})
    return (drain(p.source.DeltaSource(log, exclude_regex=r"never-matches"))[0],
            drain(p.source.DeltaSource(log, exclude_regex=r"part-"))[0])


def _source_starting_version_latest_skips_everything(p, root):
    _, log = src_log(p, root)
    write(p, log, {"id": [1]})
    write(p, log, {"id": [2]})
    source = p.source.DeltaSource(log, starting_version="latest")
    start = source.initial_offset()
    first, cur = drain(source, start)
    write(p, log, {"id": [3]})
    return first, drain(source, cur if cur is not None else start)[0]


def _source_starting_timestamp(p, root):
    _, log = src_log(p, root)
    write(p, log, {"id": [1]})
    write(p, log, {"id": [2]})
    base = 1_700_000_000_000
    for v in (0, 1):
        os.utime(os.path.join(log.log_path, f"{v:020d}.json"),
                 ((base + v * 3_600_000) / 1000,) * 2)
    return drain(p.source.DeltaSource(log, starting_timestamp=base + 60_000))[0]


def _source_data_loss_detection(p, root):
    path, log = src_log(p, root)
    for i in range(3):
        write(p, log, {"id": [i]})
    log.checkpoint()
    for v in (0, 1):
        os.remove(os.path.join(log.log_path, f"{v:020d}.json"))
    log2 = p.for_path(path).delta_log
    strict = observe(lambda: drain(p.source.DeltaSource(log2, starting_version=0,
                                                        fail_on_data_loss=True)))
    lax = drain(p.source.DeltaSource(log2, starting_version=0, fail_on_data_loss=False))[0]
    return strict, lax


def _source_concurrent_appends_between_batches(p, root):
    _, log = src_log(p, root)
    write(p, log, {"id": [1]})
    source = p.source.DeltaSource(log, max_files_per_trigger=1)
    end = source.latest_offset(source.initial_offset())
    write(p, log, {"id": [2]})
    t = source.get_batch(None, end)
    return sorted(r["id"] for r in t.to_pylist()), drain(source, end)[0]


def _offset_ordering_never_regresses(p, root):
    _, log = src_log(p, root)
    for i in range(3):
        write(p, log, {"id": [i]})
    source = p.source.DeltaSource(log, max_files_per_trigger=1)
    cur, seen = source.initial_offset(), []
    while True:
        end = source.latest_offset(cur)
        if end is None:
            return seen
        seen.append(off(end))
        cur = end


def _sink_append_then_read_back_via_source(p, root):
    path, log = src_log(p, root)
    write(p, log, {"id": [1, 2, 3]})
    spath, slog = src_log(p, root, "sink")
    sink = p.sink.DeltaSink(slog, query_id="sink-rb")
    source = p.source.DeltaSource(log)
    end = source.latest_offset(source.initial_offset())
    got = [sink.add_batch(0, source.get_batch(None, end)),
           sink.add_batch(0, source.get_batch(None, end))]
    return got, state(spath)


def _sink_schema_widens_with_merge_schema(p, root):
    path, log = src_log(p, root, "sink")
    sink = p.sink.DeltaSink(log, query_id="sink-ms", merge_schema=True)
    sink.add_batch(0, p.table({"id": [1]}))
    sink.add_batch(1, p.table({"id": [2], "extra": ["e"]}))
    return state(path)


def _query_restart_does_not_duplicate_mid_tail(p, root):
    path, log = src_log(p, root)
    dst, ckpt = os.path.join(root, "dst"), os.path.join(root, "ckpt")
    write(p, log, {"id": [1]})

    def query():
        return p.query.StreamingQuery(p.source.DeltaSource(log),
                                      p.sink.DeltaSink(p.log(dst), query_id="q-dup"), ckpt)

    q = query()
    q.process_all_available()
    write(p, log, {"id": [2]})
    q.process_all_available()
    markers = sorted(os.listdir(os.path.join(ckpt, "commits")), key=int)
    os.remove(os.path.join(ckpt, "commits", markers[-1]))
    return query().process_all_available(), state(dst)


def _source_pushed_down_filter(p, root):
    """A pushed-down filter changes what a batch holds, never where it ends."""
    _, log = src_log(p, root)
    for i in range(4):
        write(p, log, {"id": [i * 10, i * 10 + 5]})
    source = p.source.DeltaSource(log, max_files_per_trigger=2, filters=["id % 10 = 5"])
    cur, out = None, []
    while True:
        end = source.latest_offset(cur if cur is not None else source.initial_offset())
        if end is None:
            return out
        out.append((off(end), sorted(r["id"] for r in source.get_batch(cur, end).to_pylist())))
        cur = end


# -- tests/test_streaming_scenarios.py -------------------------------------------------


def _restart_at_each_boundary(p, root):
    _, log = src_log(p, root)
    for i in range(5):
        write(p, log, {"id": [i * 10, i * 10 + 1]})
    out = []
    for max_files in (1, 2, 3):
        source = p.source.DeltaSource(log, max_files_per_trigger=max_files)
        seen, cur = [], None
        while True:
            anchor = cur if cur is not None else source.initial_offset()
            end = source.latest_offset(anchor)
            if end is None:
                break
            seen.append(sorted(r["id"] for r in source.get_batch(cur, end).to_pylist()))
            cur = p.source.DeltaSourceOffset.from_json(end.json())
            source = p.source.DeltaSource(log, max_files_per_trigger=max_files)
        out.append(seen)
    return out


def _restart_mid_initial_snapshot_with_concurrent_appends(p, root):
    _, log = src_log(p, root)
    for i in range(4):
        write(p, log, {"id": [i]})
    source = p.source.DeltaSource(log, max_files_per_trigger=2)
    cur = source.latest_offset(source.initial_offset())
    got = sorted(r["id"] for r in source.get_batch(None, cur).to_pylist())
    write(p, log, {"id": [100]})
    return got, drain(p.source.DeltaSource(log, max_files_per_trigger=2), cur)[0]


def _restart_across_rearrange_only_commit(p, root):
    path, log = src_log(p, root)
    for i in range(3):
        write(p, log, {"id": [i]})
    first, cur = drain(p.source.DeltaSource(log))
    p.for_path(path).optimize().execute_compaction()
    source2 = p.source.DeltaSource(log)
    second, cur = drain(source2, cur)
    write(p, log, {"id": [7]})
    return first, second, drain(source2, cur)[0]


def _offsets_monotonic_under_mixed_limits(p, root):
    _, log = src_log(p, root)
    for i in range(6):
        write(p, log, {"id": [i]})
    cur, keys = None, []
    for limit in (1, 3, 2, 1000):
        source = p.source.DeltaSource(log, max_files_per_trigger=limit)
        end = source.latest_offset(cur if cur is not None else source.initial_offset())
        if end is None:
            break
        keys.append(off(end))
        cur = end
    return keys


def _query_restart_after_each_batch(p, root):
    path, log = src_log(p, root)
    dst, wal = os.path.join(root, "dst"), os.path.join(root, "wal")
    for i in range(4):
        write(p, log, {"id": [i]})
    runs = []
    for _ in range(8):
        q = p.query.StreamingQuery(p.source.DeltaSource(log, max_files_per_trigger=1),
                                   p.sink.DeltaSink(p.log(dst), query_id="q1"), wal)
        runs.append(q.process_all_available())
        if runs[-1] == 0:
            break
    return runs, state(dst)


def _query_restart_with_new_data_between_runs(p, root):
    path, log = src_log(p, root)
    dst, wal = os.path.join(root, "dst"), os.path.join(root, "wal")
    write(p, log, {"id": [1]})

    def run():
        return p.query.StreamingQuery(p.source.DeltaSource(log),
                                      p.sink.DeltaSink(p.log(dst), query_id="q2"),
                                      wal).process_all_available()

    first = run()
    write(p, log, {"id": [2]})
    write(p, log, {"id": [3]})
    return first, run(), state(dst)


def _starting_version_with_restart_and_delete_handling(p, root):
    path, log = src_log(p, root)
    write(p, log, {"id": [1]})
    write(p, log, {"id": [2]})
    v = log.update().version
    source = p.source.DeltaSource(log, starting_version=v + 1)
    first, cur = drain(source)
    write(p, log, {"id": [3]})
    second, cur = drain(source, cur)
    p.for_path(path).delete("id = 3")
    err = observe(lambda: drain(p.source.DeltaSource(log, starting_version=v + 1), cur))[:2]
    lax = drain(p.source.DeltaSource(log, starting_version=v + 1, ignore_deletes=True), cur)[0]
    return first, second, err, lax


# -- tests/test_cdf.py: the streaming CDF source ----------------------------------------


def _cdf_table(p, root, n):
    path = os.path.join(root, "t")
    t = p.create(path, data=p.table({"id": list(range(n)), "value": [f"v{i}" for i in range(n)]}),
                 configuration=CDF)
    return path, t


def _change_rows(t):
    return sorted((r["id"], r["value"], r["_change_type"], r["_commit_version"],
                   r["_commit_timestamp"] > 0) for r in t.to_pylist())


def _cdf_source_tails_changes(p, root):
    path, t = _cdf_table(p, root, 4)
    src = p.source.DeltaCDFSource(t.delta_log)
    end = src.latest_offset(src.initial_offset())
    first = _change_rows(src.get_batch(None, end))
    t.delete("id = 2")
    t.update({"value": "'u'"}, "id = 3")
    cur, rows = end, []
    while True:
        nxt = src.latest_offset(cur)
        if nxt is None:
            break
        rows += _change_rows(src.get_batch(cur, nxt))
        cur = nxt
    return first, sorted(rows), off(cur)


def _cdf_source_ignores_hygiene(p, root):
    path, t = _cdf_table(p, root, 4)
    t.update({"value": "'u'"}, "id = 1")
    plain = p.source.DeltaSource(t.delta_log, starting_version=0)
    cdf = p.source.DeltaCDFSource(t.delta_log, starting_version=0)
    return (observe(lambda: list(plain._changes_from(1, -1)))[:2],
            [f.version for f in cdf._changes_from(1, -1)])


def _cdf_schema_change_still_fatal(p, root):
    path, t = _cdf_table(p, root, 2)
    src = p.source.DeltaCDFSource(t.delta_log, starting_version=0)
    p.alter.add_columns(t.delta_log, [p.types.StructField("extra", p.types.LongType())])
    return [observe(lambda: list(src._changes_from(1, -1)))]


def _cdf_admission_caps_commits_per_trigger(p, root):
    path, t = _cdf_table(p, root, 4)
    for i in range(4):
        t.delete(f"id = {i}")
    src = p.source.DeltaCDFSource(t.delta_log, starting_version=0, max_files_per_trigger=2)
    end1 = src.latest_offset(src.initial_offset())
    end2 = src.latest_offset(end1)
    return off(end1), off(end2), _change_rows(src.get_batch(None, end1)), \
        _change_rows(src.get_batch(end1, end2))


def _cdf_query_into_a_table(p, root):
    """A CDF stream through ``StreamingQuery`` into a sink table."""
    path, t = _cdf_table(p, root, 3)
    t.update({"value": "'u'"}, "id = 0")
    t.delete("id = 1")
    dst = os.path.join(root, "dst")
    q = p.query.StreamingQuery(p.source.DeltaCDFSource(t.delta_log, max_files_per_trigger=1),
                               lambda batch_id, batch: p.sink.DeltaSink(
                                   p.log(dst), query_id="cdf").add_batch(
                                   batch_id, batch.select([c for c in batch.column_names
                                                           if c != "_commit_timestamp"])),
                               os.path.join(root, "ckpt"))
    return q.process_all_available(), state(dst)


CASES = [
    _source_initial_snapshot_then_tail, _source_max_files_and_bytes,
    _source_starting_version_skips_snapshot, _source_delete_and_ignore_deletes,
    _source_update_requires_ignore_changes, _source_schema_change_fails,
    _offset_json_roundtrip_and_table_id_check, _sink_exactly_once_and_complete_mode,
    _query_end_to_end_and_restart, _query_recovers_unfinished_batch,
    _source_rearrange_only_commit_does_not_spin, _query_recovery_of_initial_snapshot_batch,
    _source_exclude_regex, _source_starting_version_latest_skips_everything,
    _source_starting_timestamp, _source_data_loss_detection,
    _source_concurrent_appends_between_batches, _offset_ordering_never_regresses,
    _sink_append_then_read_back_via_source, _sink_schema_widens_with_merge_schema,
    _query_restart_does_not_duplicate_mid_tail, _source_pushed_down_filter,
    _restart_at_each_boundary,
    _restart_mid_initial_snapshot_with_concurrent_appends, _restart_across_rearrange_only_commit,
    _offsets_monotonic_under_mixed_limits, _query_restart_after_each_batch,
    _query_restart_with_new_data_between_runs, _starting_version_with_restart_and_delete_handling,
    _cdf_source_tails_changes, _cdf_source_ignores_hygiene, _cdf_schema_change_still_fatal,
    _cdf_admission_caps_commits_per_trigger, _cdf_query_into_a_table,
]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__.lstrip("_") for c in CASES])
def test_streaming_matches_jax(tmp_path, case):
    got = both(tmp_path, lambda p, root: case(W(p.name), root))
    assert not (isinstance(got, tuple) and got[:1] == ("raises",)), got
