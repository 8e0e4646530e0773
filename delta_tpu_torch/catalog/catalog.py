"""Name-based table catalog (the port's own copy of
``delta_tpu.catalog.catalog``).

The reference resolves table *names* through Spark's DSv2 catalog plugin
(`catalog/DeltaCatalog.scala:57`, `DeltaTableV2.scala:50`), backed by a
metastore. This engine has no metastore; the equivalent is a small
name→path registry with optional JSON-file persistence, giving the API
surface (`DeltaTable.for_name`, CREATE/DROP by name) without path-typing
every call site.

Identifiers are case-insensitive, optionally qualified (``db.table``; the
default database is ``default``). ``delta.`/abs/path``` identifiers resolve
directly to paths, mirroring the reference's path-table escape hatch
(`DeltaTableIdentifier.scala`).
"""
from __future__ import annotations

import json
import os
import threading
from typing import Dict, Optional, Sequence

from delta_tpu_torch.utils import errors
from delta_tpu_torch.utils.config import conf
from delta_tpu_torch.utils.errors import DeltaAnalysisError

__all__ = ["Catalog", "default_catalog", "resolve_identifier"]


def _normalize(name: str) -> str:
    parts = [p.strip().strip("`") for p in name.split(".")]
    if len(parts) == 1:
        parts = ["default"] + parts
    if len(parts) != 2 or not all(parts):
        raise errors.invalid_table_identifier(name)
    return ".".join(p.lower() for p in parts)


class Catalog:
    """name → path registry; optionally persisted as a JSON file so
    multiple processes share one namespace."""

    def __init__(self, store_path: Optional[str] = None):
        self._store_path = store_path
        self._tables: Dict[str, str] = {}
        # in-flight CREATE claims: name → {path, pid, host, ts_ms}. Kept out
        # of ``_tables`` so lookups never resolve a half-created table.
        self._claims: Dict[str, Dict] = {}
        self._lock = threading.RLock()
        if store_path and os.path.exists(store_path):
            self._load()

    # -- persistence ------------------------------------------------------
    #
    # Cross-process safety: every load-mutate-save cycle holds an OS file
    # lock (flock on <store>.lock) in addition to the in-process RLock, so
    # two processes registering tables concurrently cannot lose a write
    # (the in-process lock alone only orders threads).

    def _file_lock(self):
        import contextlib

        if not self._store_path:
            return contextlib.nullcontext()

        import fcntl

        @contextlib.contextmanager
        def locked():
            os.makedirs(os.path.dirname(self._store_path) or ".", exist_ok=True)
            with open(self._store_path + ".lock", "w") as lockf:
                fcntl.flock(lockf, fcntl.LOCK_EX)
                try:
                    yield
                finally:
                    fcntl.flock(lockf, fcntl.LOCK_UN)

        return locked()

    def _load(self) -> None:
        try:
            with open(self._store_path) as f:
                data = json.load(f)
            self._tables = dict(data.get("tables", {}))
            self._claims = dict(data.get("claims", {}))
        except (OSError, json.JSONDecodeError):
            self._tables = {}
            self._claims = {}

    def _save(self) -> None:
        if not self._store_path:
            return
        os.makedirs(os.path.dirname(self._store_path) or ".", exist_ok=True)
        tmp = self._store_path + ".tmp"
        try:
            with open(tmp, "w") as f:
                json.dump({"tables": self._tables, "claims": self._claims},
                          f, indent=1, sort_keys=True)
            os.replace(tmp, self._store_path)
        finally:
            try:
                os.unlink(tmp)  # no-op after a successful replace
            except OSError:
                pass

    def _claim_is_live(self, claim: Dict) -> bool:
        """Is an in-flight CREATE claim still owned by a live creator?

        Same-host claims are checked by pid liveness; foreign-host claims (a
        shared store on network storage) fall back to an age bound
        (``delta.tpu.catalog.claimTimeoutMs``) — a creator that takes longer
        forfeits the name."""
        import socket
        import time

        timeout_ms = int(conf.get("delta.tpu.catalog.claimTimeoutMs", 600_000))
        within_age = (time.time() * 1000 - claim.get("ts_ms", 0)) < timeout_ms
        if claim.get("host") == socket.gethostname():
            pid = claim.get("pid")
            if pid == os.getpid():
                return True
            try:
                os.kill(int(pid), 0)
                alive = True
            except ProcessLookupError:
                alive = False  # definitely gone
            except PermissionError:
                alive = True  # exists, owned by another user
            except (OSError, TypeError, ValueError):
                alive = True  # unknown: never hijack on doubt
            # age bound also applies same-host: a recycled pid would
            # otherwise block the name forever
            return alive and within_age
        return within_age

    def _new_claim(self, path: str) -> Dict:
        import socket
        import time

        return {"path": path, "pid": os.getpid(),
                "host": socket.gethostname(), "ts_ms": int(time.time() * 1000)}

    # -- registry ---------------------------------------------------------

    def register(self, name: str, path: str) -> None:
        """Point ``name`` at an existing table location (external table)."""
        key = _normalize(name)
        with self._lock, self._file_lock():
            if self._store_path:
                self._load()
            if key in self._tables:
                raise errors.table_already_exists_in_catalog(name)
            claim = self._claims.get(key)
            if claim is not None and self._claim_is_live(claim):
                raise errors.table_being_created_concurrently(name)
            self._claims.pop(key, None)
            self._tables[key] = os.path.abspath(path)
            self._save()

    def create_table(self, name: str, path: str, schema=None,
                     partition_columns: Sequence[str] = (),
                     configuration=None, data=None, mode: str = "create", device="cuda"):
        """CREATE TABLE by name: registers the identifier and runs the
        create command at ``path`` (`DeltaCatalog.createTable :183`)."""
        from delta_tpu_torch.api.tables import DeltaTable

        key = _normalize(name)
        abs_path = os.path.abspath(path)
        # Claim the name inside the first critical section, then run the
        # (possibly long) CTAS/create outside the lock so unrelated catalog
        # operations aren't serialized behind data writes. A concurrent
        # creator of the same name fails BEFORE materializing any data (no
        # orphan table directory). Claims live in a separate map carrying
        # owner liveness (pid/host/ts), so a crashed creator's claim is
        # reclaimable while a live in-progress one blocks the race — and
        # lookups never resolve a name whose table hasn't committed yet.
        with self._lock, self._file_lock():
            if self._store_path:
                self._load()
            if mode == "create":
                if key in self._tables:
                    raise errors.table_already_exists_in_catalog(name)
                claim = self._claims.get(key)
                if claim is not None and self._claim_is_live(claim):
                    raise errors.table_being_created_concurrently(name)
            my_claim = self._new_claim(abs_path)
            self._claims[key] = my_claim
            self._save()

        def _release(register_table: bool):
            with self._lock, self._file_lock():
                if self._store_path:
                    self._load()
                cur = self._claims.get(key)
                if (cur and cur.get("pid") == my_claim["pid"]
                        and cur.get("ts_ms") == my_claim["ts_ms"]):
                    self._claims.pop(key, None)
                if register_table:
                    self._tables[key] = abs_path
                self._save()

        try:
            table = DeltaTable.create(
                path, schema, partition_columns, configuration, data, mode=mode,
                device=device,
            )
        except BaseException:
            _release(register_table=False)
            raise
        _release(register_table=True)
        return table

    def drop_table(self, name: str) -> None:
        """Remove the name mapping (the data/log stay on disk, like dropping
        an external table)."""
        key = _normalize(name)
        with self._lock, self._file_lock():
            if self._store_path:
                self._load()
            if key not in self._tables:
                raise errors.table_not_found_in_catalog(name)
            del self._tables[key]
            self._save()

    def table_path(self, name: str) -> str:
        key = _normalize(name)
        with self._lock:
            if self._store_path:
                self._load()
            path = self._tables.get(key)
        if path is None:
            raise errors.table_not_found_in_catalog(name)
        return path

    def table_exists(self, name: str) -> bool:
        try:
            self.table_path(name)
            return True
        except DeltaAnalysisError:
            return False

    def load_table(self, name: str, device="cuda"):
        from delta_tpu_torch.api.tables import DeltaTable

        return DeltaTable.for_path(self.table_path(name), device=device)

    def list_tables(self, database: str = "default"):
        with self._lock:
            if self._store_path:
                self._load()
            prefix = database.lower() + "."
            return sorted(
                k[len(prefix):] for k in self._tables if k.startswith(prefix)
            )


_default: Optional[Catalog] = None
_default_lock = threading.Lock()


def default_catalog() -> Catalog:
    """Process-default catalog; persists to ``delta.tpu.catalog.path`` when
    that conf is set, else stays in-memory."""
    global _default
    with _default_lock:
        if _default is None:
            _default = Catalog(conf.get("delta.tpu.catalog.path"))
        return _default


def reset_default_catalog() -> None:
    global _default
    with _default_lock:
        _default = None


def resolve_identifier(identifier: str, catalog: Optional[Catalog] = None) -> str:
    """``delta.`/path``` → the path; anything else → catalog lookup."""
    ident = identifier.strip()
    if ident.lower().startswith("delta.`") and ident.endswith("`"):
        return ident[len("delta.`"):-1]
    return (catalog or default_catalog()).table_path(ident)
