"""The port's transaction (``delta_tpu_torch.txn``) against ``delta_tpu.txn``
on the CPU: the cases of ``tests/test_txn.py``'s ``TestCommitPipeline``,
``TestConflictMatrix``, ``TestConflictMatrixDepth`` and
``TestConcurrentThreads``, each run through both packages on tables of their
own. Each case gives the same committed versions, the same exception classes
and the same log: every commit file equal line for line, ``commitInfo``
without its timestamp, ``txnId`` and ``engineInfo``, ``metaData`` without
its id. ``test_checkpoint_written_at_interval`` becomes
``test_port_writes_no_checkpoint``, which holds the post-commit files (the
``.crc`` of each version, the interval checkpoint, ``_last_checkpoint``)
equal to the JAX package's."""
import json
import os
import threading
from dataclasses import replace

import pytest

import delta_tpu
import delta_tpu_torch
from delta_tpu.commands import operations as jax_ops
from delta_tpu.protocol import actions as jax_actions
from delta_tpu.schema import types as jax_types
from delta_tpu_torch.commands import operations as torch_ops
from delta_tpu_torch.protocol import actions as torch_actions
from delta_tpu_torch.schema import types as torch_types


class Pkg:
    """One package's classes under one set of names."""

    def __init__(self, name):
        self.name = name
        self.ops = jax_ops if name == "jax" else torch_ops
        self.A = jax_actions if name == "jax" else torch_actions
        self.T = jax_types if name == "jax" else torch_types

    def log(self, path):
        if self.name == "jax":
            return delta_tpu.DeltaLog.for_table(path)
        return delta_tpu_torch.DeltaLog.for_table(path, device="cpu")

    def add(self, path, part=None, data_change=True):
        return self.A.AddFile(path, {} if part is None else {"part": part}, 1, 1, data_change)

    def metadata(self, partitioned=False, configuration=None):
        if partitioned:
            schema = self.T.StructType().add("id", self.T.IntegerType()).add(
                "part", self.T.StringType())
            return self.A.Metadata(schema_string=schema.to_json(), partition_columns=["part"],
                                   configuration=dict(configuration or {}))
        schema = self.T.StructType().add("id", self.T.IntegerType()).add(
            "value", self.T.StringType())
        return self.A.Metadata(schema_string=schema.to_json(),
                               configuration=dict(configuration or {}))

    def create(self, path, partitioned=False, configuration=None):
        log = self.log(path)
        txn = log.start_transaction()
        txn.update_metadata(self.metadata(partitioned, configuration))
        txn.commit([], self.ops.ManualUpdate())
        return log


def outcome(fn):
    """The call's value, or its exception's class name."""
    try:
        return fn()
    except Exception as e:  # the class is the observation
        return type(e).__name__


# -- the cases: each returns its observations ------------------------------------


def first_commit_injects_protocol(P, path):
    snap = P.create(path).update()
    return [snap.version, snap.protocol.min_writer_version, snap.metadata.schema.field_names]


def versions_increment(P, path):
    log = P.create(path)
    out = [log.start_transaction().commit([P.add(f"f{i}")], P.ops.Write("Append"))
           for i in range(3)]
    return out + [len(log.update().all_files)]


def commit_info_written(P, path):
    log = P.create(path)
    return [log.start_transaction().commit([P.add("f0")], P.ops.Write("Append"))]


def cannot_commit_twice(P, path):
    log = P.create(path)
    txn = log.start_transaction()
    txn.commit([P.add("f0")], P.ops.Write("Append"))
    return [outcome(lambda: txn.commit([P.add("f1")], P.ops.Write("Append")))]


def metadata_change_only_once(P, path):
    log = P.create(path)
    txn = log.start_transaction()
    txn.update_metadata(P.metadata())
    return [outcome(lambda: txn.update_metadata(P.metadata()))]


def first_commit_requires_metadata(P, path):
    txn = P.log(path).start_transaction()
    return [outcome(lambda: txn.commit([P.add("f0")], P.ops.Write("Append")))]


def add_partition_values_must_match_schema(P, path):
    log = P.create(path, partitioned=True)
    txn = log.start_transaction()
    bad = outcome(lambda: txn.commit([P.add("f0")], P.ops.Write("Append")))
    return [bad, log.start_transaction().commit([P.add("f0", part="a")], P.ops.Write("Append"))]


def append_only_table_blocks_deletes(P, path):
    log = P.create(path, configuration={"delta.appendOnly": "true"})
    log.start_transaction().commit([P.add("f0")], P.ops.Write("Append"))
    txn2 = log.start_transaction()
    return [outcome(lambda: txn2.commit([P.A.RemoveFile("f0", deletion_timestamp=1)],
                                        P.ops.Delete()))]


def no_checkpoint_at_interval(P, path):
    log = P.create(path, configuration={"delta.checkpointInterval": "4"})
    for i in range(5):
        log.start_transaction().commit([P.add(f"f{i}")], P.ops.Write("Append"))
    return [log.update().version, len(log.update().all_files)]


def txn_version_roundtrip(P, path):
    log = P.create(path)
    txn = log.start_transaction()
    first = txn.txn_version("stream-1")
    txn.commit([P.A.SetTransaction("stream-1", 7, None), P.add("f0")],
               P.ops.StreamingUpdate("Append", "stream-1", 7))
    return [first, log.start_transaction().txn_version("stream-1")]


def allow_disjoint_blind_appends(P, path):
    log = P.create(path)
    a = log.start_transaction()
    log.start_transaction().commit([P.add("b1")], P.ops.Write("Append"))
    return [a.commit([P.add("a1")], P.ops.Write("Append")), len(log.update().all_files)]


def read_whole_table_vs_nonblind_append_blocks(P, path):
    log = P.create(path)
    log.start_transaction().commit([P.add("f0")], P.ops.Write("Append"))
    a = log.start_transaction()
    a.filter_files()
    b = log.start_transaction()
    b.filter_files()
    b.commit([P.add("b1")], P.ops.Write("Append"))
    return [outcome(lambda: a.commit([P.add("a1")], P.ops.Write("Append")))]


def read_whole_table_vs_blind_append_allowed(P, path):
    log = P.create(path)
    a = log.start_transaction()
    a.filter_files()
    log.start_transaction().commit([P.add("b1")], P.ops.Write("Append"))
    return [a.commit([P.add("a1")], P.ops.Write("Append"))]


def disjoint_partitions_do_not_conflict(P, path):
    log = P.create(path, partitioned=True)
    log.start_transaction().commit([P.add("f0", part="x")], P.ops.Write("Append"))
    a = log.start_transaction()
    a.filter_files(["part = 'x'"])
    b = log.start_transaction()
    b.filter_files(["part = 'y'"])
    b.commit([P.add("b1", part="y")], P.ops.Write("Append"))
    return [a.commit([P.add("a1", part="x")], P.ops.Write("Append"))]


def same_partition_conflicts(P, path):
    log = P.create(path, partitioned=True)
    log.start_transaction().commit([P.add("f0", part="x")], P.ops.Write("Append"))
    a = log.start_transaction()
    a.filter_files(["part = 'x'"])
    b = log.start_transaction()
    b.filter_files(["part = 'x'"])
    b.commit([P.add("b1", part="x")], P.ops.Write("Append"))
    return [outcome(lambda: a.commit([P.add("a1", part="x")], P.ops.Write("Append")))]


def concurrent_delete_of_read_file(P, path):
    log = P.create(path)
    log.start_transaction().commit([P.add("f0")], P.ops.Write("Append"))
    a = log.start_transaction()
    a.filter_files()
    read = sorted(a.read_files)
    b = log.start_transaction()
    b.filter_files()
    b.commit([P.A.RemoveFile("f0", deletion_timestamp=1)], P.ops.Delete())
    return [read, outcome(lambda: a.commit([P.add("a1")], P.ops.Write("Append")))]


def concurrent_delete_delete(P, path):
    log = P.create(path)
    log.start_transaction().commit([P.add("f0")], P.ops.Write("Append"))
    a = log.start_transaction()
    b = log.start_transaction()
    b.commit([P.A.RemoveFile("f0", deletion_timestamp=1)], P.ops.Delete())
    return [outcome(lambda: a.commit([P.A.RemoveFile("f0", deletion_timestamp=2)],
                                     P.ops.Delete()))]


def metadata_change_conflicts(P, path):
    log = P.create(path)
    a = log.start_transaction()
    b = log.start_transaction()
    b.update_metadata(P.metadata(configuration={"delta.checkpointInterval": "20"}))
    b.commit([], P.ops.SetTableProperties({"delta.checkpointInterval": "20"}))
    return [outcome(lambda: a.commit([P.add("a1")], P.ops.Write("Append")))]


def protocol_change_conflicts(P, path):
    log = P.create(path)
    a = log.start_transaction()
    b = log.start_transaction()
    b.new_protocol = P.A.Protocol(1, 3)
    b.commit([], P.ops.UpgradeProtocol(P.A.Protocol(1, 3)))
    return [outcome(lambda: a.commit([P.add("a1")], P.ops.Write("Append")))]


def concurrent_set_transaction_conflicts(P, path):
    log = P.create(path)
    a = log.start_transaction()
    a.txn_version("app-1")
    b = log.start_transaction()
    b.commit([P.A.SetTransaction("app-1", 1, None)],
             P.ops.StreamingUpdate("Append", "app-1", 1))
    return [outcome(lambda: a.commit([P.A.SetTransaction("app-1", 2, None), P.add("a1")],
                                     P.ops.StreamingUpdate("Append", "app-1", 2)))]


def snapshot_isolation_rearrange_only_vs_append(P, path):
    log = P.create(path)
    log.start_transaction().commit([P.add("f0")], P.ops.Write("Append"))
    a = log.start_transaction()
    a.filter_files()
    b = log.start_transaction()
    b.filter_files()
    b.commit([P.add("b1")], P.ops.Write("Append"))
    return [a.commit([P.A.RemoveFile("f0", deletion_timestamp=1, data_change=False),
                      P.add("f0-compacted", data_change=False)], P.ops.Optimize())]


def delete_vs_rearrange_of_same_file_conflicts(P, path):
    log = P.create(path)
    log.start_transaction().commit([P.add("f0")], P.ops.Write("Append"))
    a = log.start_transaction()
    a.filter_files()
    b = log.start_transaction()
    b.filter_files()
    b.commit([P.A.RemoveFile("f0", deletion_timestamp=1)], P.ops.Delete())
    return [outcome(lambda: a.commit(
        [P.A.RemoveFile("f0", deletion_timestamp=2, data_change=False),
         P.add("f0-compacted", data_change=False)], P.ops.Optimize()))]


def multiple_winning_commits_replayed(P, path):
    log = P.create(path)
    a = log.start_transaction()
    for i in range(3):
        log.start_transaction().commit([P.add(f"b{i}")], P.ops.Write("Append"))
    return [a.commit([P.add("a1")], P.ops.Write("Append")), a.stats.attempts >= 2]


def many_threads_all_commit(P, path):
    log = P.create(path)
    results = []
    lock = threading.Lock()

    def worker(i):
        v = log.start_transaction().commit([P.add(f"t{i}")], P.ops.Write("Append"))
        with lock:
            results.append(v)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return [sorted(results), len(log.update().all_files)]


def serializable_table_blocks_blind_append_vs_read(P, path):
    log = P.create(path, configuration={"delta.isolationLevel": "Serializable"})
    a = log.start_transaction()
    a.filter_files()
    log.start_transaction().commit([P.add("b1")], P.ops.Write("Append"))
    return [outcome(lambda: a.commit([P.add("a1")], P.ops.Write("Append")))]


def invalid_isolation_level_property_rejected(P, path):
    log = P.create(path)
    a = log.start_transaction()
    return [outcome(lambda: a.update_metadata(
        P.metadata(configuration={"delta.isolationLevel": "ReadCommitted"})))]


def unread_set_transaction_no_conflict(P, path):
    log = P.create(path)
    a = log.start_transaction()
    a.txn_version("app-A")
    log.start_transaction().commit([P.A.SetTransaction("app-B", 7)],
                                   P.ops.StreamingUpdate("Append", "app-B", 7))
    return [a.commit([P.add("a1")], P.ops.Write("Append"))]


def winner_removes_unread_file_no_conflict(P, path):
    log = P.create(path, partitioned=True)
    log.start_transaction().commit([P.add("fx", part="x")], P.ops.Write("Append"))
    log.start_transaction().commit([P.add("fy", part="y")], P.ops.Write("Append"))
    a = log.start_transaction()
    a.filter_files(["part = 'y'"])
    b = log.start_transaction()
    b.commit([P.A.AddFile("fx", {"part": "x"}, 1, 1, True).remove(deletion_timestamp=5)],
             P.ops.Delete(["part = 'x'"]))
    return [a.commit([P.add("a1", part="y")], P.ops.Write("Append"))]


def commit_info_only_winner_no_conflict(P, path):
    log = P.create(path)
    a = log.start_transaction()
    a.filter_files()
    log.start_transaction().commit([], P.ops.ManualUpdate())
    return [a.commit([P.add("a1")], P.ops.Write("Append"))]


def dv_readds_of_same_file_conflict(P, path):
    log = P.create(path)
    f = P.add("shared")
    log.start_transaction().commit([f], P.ops.Write("Append"))
    dv1 = {"storageType": "i", "pathOrInlineDv": "p1", "sizeInBytes": 1, "cardinality": 1}
    dv2 = {"storageType": "i", "pathOrInlineDv": "p2", "sizeInBytes": 1, "cardinality": 2}
    a = log.start_transaction()
    a.filter_files()
    b = log.start_transaction()
    b.filter_files()
    b.commit([f.remove(deletion_timestamp=3), replace(f, deletion_vector=dv2)],
             P.ops.Delete([]))
    return [outcome(lambda: a.commit([f.remove(deletion_timestamp=4),
                                      replace(f, deletion_vector=dv1)], P.ops.Delete([])))]


def protocol_upgrade_winner_blocks_everyone(P, path):
    log = P.create(path)
    a = log.start_transaction()
    log.start_transaction().commit([P.A.Protocol(1, 3)],
                                   P.ops.UpgradeProtocol(P.A.Protocol(1, 3)))
    return [outcome(lambda: a.commit([P.add("a1")], P.ops.Write("Append")))]


def append_only_table_rejects_dv_readd(P, path):
    log = P.create(path, configuration={"delta.appendOnly": "true"})
    f = P.add("f1")
    log.start_transaction().commit([f], P.ops.Write("Append"))
    dv = {"storageType": "i", "pathOrInlineDv": "p", "sizeInBytes": 1, "cardinality": 1}
    a = log.start_transaction()
    return [outcome(lambda: a.commit([replace(f, deletion_vector=dv)], P.ops.Delete([])))]


CASES = [first_commit_injects_protocol, versions_increment, commit_info_written,
         cannot_commit_twice, metadata_change_only_once, first_commit_requires_metadata,
         add_partition_values_must_match_schema, append_only_table_blocks_deletes,
         txn_version_roundtrip, allow_disjoint_blind_appends,
         read_whole_table_vs_nonblind_append_blocks, read_whole_table_vs_blind_append_allowed,
         disjoint_partitions_do_not_conflict, same_partition_conflicts,
         concurrent_delete_of_read_file, concurrent_delete_delete, metadata_change_conflicts,
         protocol_change_conflicts, concurrent_set_transaction_conflicts,
         snapshot_isolation_rearrange_only_vs_append,
         delete_vs_rearrange_of_same_file_conflicts, multiple_winning_commits_replayed,
         serializable_table_blocks_blind_append_vs_read,
         invalid_isolation_level_property_rejected, unread_set_transaction_no_conflict,
         winner_removes_unread_file_no_conflict, commit_info_only_winner_no_conflict,
         dv_readds_of_same_file_conflict, protocol_upgrade_winner_blocks_everyone,
         append_only_table_rejects_dv_readd]

_VOLATILE = {"commitInfo": ("timestamp", "txnId", "engineInfo"), "metaData": ("id",)}


def log_lines(path):
    """Every commit file's actions, volatile fields dropped."""
    log_dir = os.path.join(path, "_delta_log")
    out = []
    if not os.path.isdir(log_dir):
        return out
    for name in sorted(n for n in os.listdir(log_dir) if n.endswith(".json")):
        rows = []
        for line in open(os.path.join(log_dir, name)):
            obj = json.loads(line)
            for key, drop in _VOLATILE.items():
                for k in drop:
                    obj.get(key, {}).pop(k, None)
            rows.append(obj)
        out.append((name, rows))
    return out


@pytest.fixture(autouse=True)
def _fresh_logs():
    delta_tpu_torch.DeltaLog.clear_cache()
    yield
    delta_tpu_torch.DeltaLog.clear_cache()


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__)
def test_transaction_matches_jax(case, tmp_path):
    got = case(Pkg("torch"), str(tmp_path / "torch"))
    want = case(Pkg("jax"), str(tmp_path / "jax"))
    assert got == want
    assert log_lines(str(tmp_path / "torch")) == log_lines(str(tmp_path / "jax"))


def test_many_threads_all_commit(tmp_path):
    """8 threads of blind appends: all land, versions unique (the commit
    order between threads is free, so the logs are compared as sets)."""
    got = many_threads_all_commit(Pkg("torch"), str(tmp_path / "torch"))
    assert got == many_threads_all_commit(Pkg("jax"), str(tmp_path / "jax"))
    assert got == [list(range(1, 9)), 8]


def post_commit_files(path):
    """The log's files after the commits: the listing, every ``.crc`` and
    ``_last_checkpoint`` as text, and each checkpoint's actions as read by
    both packages (metadata id dropped)."""
    from delta_tpu.log import checkpoints as jax_ck
    from delta_tpu_torch.log import checkpoints as torch_ck

    log_dir = os.path.join(path, "_delta_log")
    names = sorted(n for n in os.listdir(log_dir) if not n.startswith("."))
    text = {n: open(os.path.join(log_dir, n)).read() for n in names
            if n.endswith(".crc") or n == "_last_checkpoint"}
    ckpts = {}
    for n in names:
        if ".checkpoint." in n:
            full = os.path.join(log_dir, n)
            for pkg, mod, store in (("jax", jax_ck, delta_tpu.DeltaLog.for_table(path).store),
                                    ("torch", torch_ck,
                                     delta_tpu_torch.DeltaLog.for_table(path, device="cpu").store)):
                acts = []
                kw = {"device": "cpu"} if pkg == "torch" else {}
                for a in mod.read_checkpoint_actions(store, [full], **kw):
                    d = a.to_dict()
                    d.pop("id", None) if type(a).__name__ == "Metadata" else None
                    acts.append((type(a).__name__, d))
                ckpts[(n, pkg)] = acts
    return names, text, ckpts


def test_port_writes_no_checkpoint(tmp_path):
    """Named when the port wrote no checkpoint. The port's commits now write
    what the JAX package's do: a ``.crc`` after each commit and a checkpoint
    every ``delta.checkpointInterval`` versions, with ``_last_checkpoint``;
    the same files, the same ``.crc`` and pointer contents, and each
    checkpoint's actions equal read by either package."""
    torch_path, jax_path = str(tmp_path / "torch"), str(tmp_path / "jax")
    assert no_checkpoint_at_interval(Pkg("torch"), torch_path) == [5, 5]
    assert no_checkpoint_at_interval(Pkg("jax"), jax_path) == [5, 5]
    names, text, ckpts = post_commit_files(torch_path)
    j_names, j_text, j_ckpts = post_commit_files(jax_path)
    assert names == j_names
    assert "00000000000000000004.checkpoint.parquet" in names and "_last_checkpoint" in names
    assert sum(n.endswith(".crc") for n in names) == 6
    assert text == j_text
    assert {k[0]: v for k, v in ckpts.items() if k[1] == "torch"} == \
        {k[0]: v for k, v in ckpts.items() if k[1] == "jax"}
    assert ckpts == j_ckpts
    assert log_lines(torch_path) == log_lines(jax_path)


def test_checkpoint_async_is_refused(tmp_path):
    """``delta.tpu.checkpoint.async``: the async checkpointer is not ported,
    so a commit under it raises before anything lands."""
    from delta_tpu_torch.utils.config import conf

    log = Pkg("torch").create(str(tmp_path / "t"))
    with conf.set_temporarily(**{"delta.tpu.checkpoint.async": True}):
        with pytest.raises(NotImplementedError, match="async"):
            log.start_transaction().commit([Pkg("torch").add("f0")],
                                           torch_ops.Write("Append"))
    assert log.update().version == 0


def test_failed_checkpoint_leaves_the_commit(tmp_path, monkeypatch):
    """A checkpoint that fails after its commit landed leaves the version
    standing (a warning), as in the JAX package."""
    P = Pkg("torch")
    log = P.create(str(tmp_path / "t"), configuration={"delta.checkpointInterval": "2"})

    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(delta_tpu_torch.log.checkpoints, "write_checkpoint", boom)
    assert log.start_transaction().commit([P.add("f0")], P.ops.Write("Append")) == 1
    assert log.start_transaction().commit([P.add("f1")], P.ops.Write("Append")) == 2
    assert log.update().version == 2 and len(log.update().all_files) == 2
    assert not [n for n in os.listdir(os.path.join(str(tmp_path / "t"), "_delta_log"))
                if "checkpoint" in n]
