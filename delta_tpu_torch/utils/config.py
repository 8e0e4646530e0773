"""Session conf and table properties (the port's own copy of part of
``delta_tpu.utils.config``).

* :data:`conf` holds the session keys the port reads, with the JAX
  package's defaults: the MERGE routing (``delta.tpu.merge.devicePath.*``,
  ``delta.tpu.merge.keyCache.enabled`` and its alias
  ``delta.tpu.merge.residentKeys.enabled``, ``residentKeys.minRows``,
  ``nonEquiPairBudget``), the writer's ``delta.tpu.write.targetFileRows``,
  the deletion-vector switch, the schema-evolution switch (which the port
  refuses when on), ``delta.tpu.history.metricsEnabled``, and the read
  path's keys: ``delta.tpu.read.deviceResidual.mode``,
  ``delta.tpu.read.rowGroupSkipping``, ``delta.tpu.read.footerCacheEntries``,
  ``delta.tpu.columnCache.maxBytes`` /
  ``maxEntries`` and the writer's ``delta.tpu.write.rowGroupRows``; the
  router's: ``delta.tpu.stateCache.devicePlan.*``, the state mesh's
  ``delta.tpu.distributed.plan.*`` and ``delta.tpu.merge.devicePath.preferMesh``,
  ``delta.tpu.link.uploadMBps`` / ``downloadMBps``,
  ``delta.tpu.router.auditKeep``, ``delta.tpu.router.calibration.*`` and
  ``delta.tpu.telemetry.enabled``. A key that is not in the table reads as
  the caller's default, as in the JAX package.
* :class:`DeltaConfigs` is the JAX package's table-property registry,
  whole, so that a table property is validated (and an unknown ``delta.``
  key refused) exactly as there.

The state cache's and the key cache's budgets stay constants in their
modules (``ops/state_cache``, ``ops/key_cache``).
"""
from __future__ import annotations

import re
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, Generic, Optional, TypeVar

from delta_tpu_torch.utils.errors import DeltaIllegalArgumentError

T = TypeVar("T")

__all__ = ["SqlConf", "conf", "DeltaConfig", "DeltaConfigs", "parse_interval_ms"]


class SqlConf:
    """Process-wide conf with defaults; thread-safe; ``with
    conf.set_temporarily(...)`` for tests."""

    _DEFAULTS: Dict[str, Any] = {
        # ≈ DELTA_MAX_RETRY_COMMIT_ATTEMPTS (DeltaSQLConf.scala:182)
        "delta.tpu.maxCommitAttempts": 10_000_000,
        # the MERGE join on the card: "auto" prices the device route against
        # the host join through the link cost model (parallel/link), the
        # resident-slab and the cold-slab cases each with its own price, and
        # takes the cheaper; "force" takes a device route whenever the merge
        # is eligible; "off" pins the host join
        "delta.tpu.merge.devicePath.enabled": True,
        "delta.tpu.merge.devicePath.mode": "auto",
        # the cross-MERGE resident key cache (ops/key_cache); either key set
        # to false disables caching and the post-commit warmup
        "delta.tpu.merge.keyCache.enabled": True,
        "delta.tpu.merge.residentKeys.enabled": True,
        # rows below which the post-commit warmup builds no key lane
        "delta.tpu.merge.residentKeys.minRows": 1 << 20,
        # non-equi MERGE: candidate pairs per tile of the target x source grid
        "delta.tpu.merge.nonEquiPairBudget": 8_000_000,
        # ≈ DELTA_SCHEMA_AUTO_MIGRATE; the port refuses it when on
        "delta.tpu.schema.autoMerge.enabled": False,
        # ≈ DELTA_HISTORY_METRICS_ENABLED
        "delta.tpu.history.metricsEnabled": True,
        # target max rows per written data file
        "delta.tpu.write.targetFileRows": 4_000_000,
        # DML writes deletion vectors where the table enables them
        "delta.tpu.deletionVectors.enabled": True,
        # VACUUM refuses a retention below the tombstone retention
        "delta.tpu.retentionDurationCheck.enabled": True,
        # rows per Parquet row group the writer emits
        "delta.tpu.write.rowGroupRows": 131_072,
        # the Parquet writer's codec: "auto" (SNAPPY where it pays, the JAX
        # package's policy), "snappy", "gzip", "none"/"uncompressed"
        "delta.tpu.write.compression": "auto",
        # BYTE_STREAM_SPLIT for float columns (off for parquet-mr < 1.12)
        "delta.tpu.write.byteStreamSplit": True,
        # the device residual filter (ops/column_cache): "auto" prices the
        # device mask against the host filter per scan (parallel/link),
        # "force" engages it whenever the residual lowers, "off" keeps the
        # host path
        "delta.tpu.read.deviceResidual.mode": "auto",
        # the scan column cache's budgets (ColumnCache._evict)
        "delta.tpu.columnCache.maxBytes": 1 << 30,
        "delta.tpu.columnCache.maxEntries": 4096,
        # footer row-group skipping and late materialization (exec/rowgroups)
        "delta.tpu.read.rowGroupSkipping": True,
        # parsed Parquet footers kept across scans (exec/rowgroups.FooterCache)
        "delta.tpu.read.footerCacheEntries": 1024,
        # scan planning from the resident lanes (ops/state_cache): "auto"
        # prices the block cull on the card against the host plan, "force"
        # and "off" pin one; enabled=False pins the host plan
        "delta.tpu.stateCache.devicePlan.enabled": True,
        "delta.tpu.stateCache.devicePlan.mode": "auto",
        # the sharded plan over the state mesh (ops/state_cache): "auto"
        # shards when link.sharded_plan_device_s prices it below one card,
        # "force" whenever the mesh and the lanes allow it, "off" never
        "delta.tpu.distributed.plan.enabled": True,
        "delta.tpu.distributed.plan.mode": "auto",
        # MERGE's cold estimate prices the upload join over the mesh
        # (link.estimate_device_s(..., shards=)) in place of the cold slab
        "delta.tpu.merge.devicePath.preferMesh": False,
        # link profile overrides (MB/s); unset, parallel/link probes the
        # device's link once per process
        "delta.tpu.link.uploadMBps": None,
        "delta.tpu.link.downloadMBps": None,
        # the router audit ring (obs/router_audit): the last N decisions
        "delta.tpu.router.auditKeep": 256,
        # the EWMA re-fit of the link constants from audited samples
        # (obs/calibration), off by default; the state file is statePath, or
        # <log dir>/.router_calibration.json when unset
        "delta.tpu.router.calibration.enabled": False,
        "delta.tpu.router.calibration.statePath": None,
        "delta.tpu.router.calibration.alpha": 0.2,
        "delta.tpu.router.calibration.minSamples": 3,
        "delta.tpu.router.calibration.flushIntervalMs": 2000,
        # events, gauges, histograms, audits and calibration
        # (utils/telemetry); false is a blackout (counters stay live)
        "delta.tpu.telemetry.enabled": True,
        # checkpoints (log/checkpoints): actions a part, the V2 stats
        # columns' engine default, the .crc after each commit; the async and
        # incremental checkpointer is not ported (true raises)
        "delta.tpu.checkpointPartSize": 1_000_000,
        "delta.tpu.checkpoint.writeStatsAsStruct": True,
        "delta.tpu.checkpoint.async": False,
        "delta.tpu.writeChecksum.enabled": True,
        "delta.tpu.cleanup.tmpOrphanTtlMs": 3_600_000,
        # the name catalog (catalog/catalog): its JSON file (unset: in
        # memory), and the age past which an in-flight CREATE's claim lapses
        "delta.tpu.catalog.path": None,
        "delta.tpu.catalog.claimTimeoutMs": 600_000,
    }

    def __init__(self):
        self._values: Dict[str, Any] = {}
        self._lock = threading.RLock()

    def get(self, key: str, default: Any = None) -> Any:
        with self._lock:
            if key in self._values:
                return self._values[key]
        if key in self._DEFAULTS:
            return self._DEFAULTS[key]
        return default

    def get_bool(self, key: str, default: bool = False) -> bool:
        """Boolean conf with string coercion: "false"/"0"/"off" (any case)
        are False."""
        v = self.get(key, default)
        if isinstance(v, str):
            return v.strip().lower() not in ("false", "0", "off", "no", "")
        return bool(v)

    def set_temporarily(self, **kv: Any):
        """Context manager: ``with conf.set_temporarily(**{'k': v}): ...``"""
        outer = self

        class _Ctx:
            def __enter__(self):
                self._saved = {}
                for k, v in kv.items():
                    key = k.replace("__", ".")
                    with outer._lock:
                        self._saved[key] = outer._values.get(key, _MISSING)
                        outer._values[key] = v
                return outer

            def __exit__(self, *exc):
                for key, old in self._saved.items():
                    with outer._lock:
                        if old is _MISSING:
                            outer._values.pop(key, None)
                        else:
                            outer._values[key] = old
                return False

        return _Ctx()


_MISSING = object()
conf = SqlConf()


_UNIT_MS = {"millisecond": 1, "second": 1000, "minute": 60_000, "hour": 3_600_000,
            "day": 86_400_000, "week": 7 * 86_400_000}
_INTERVAL_RE = re.compile(r"(-?\d+)\s+(millisecond|second|minute|hour|day|week)s?",
                          re.IGNORECASE)


def parse_interval_ms(s: str) -> int:
    """``"interval 30 days"``-style durations in millis; months and years
    are refused."""
    text = s.strip()
    if text.lower().startswith("interval"):
        text = text[len("interval"):]
    ms = 0
    matched = False
    for m in _INTERVAL_RE.finditer(text):
        matched = True
        ms += int(m.group(1)) * _UNIT_MS[m.group(2).lower()]
    if not matched:
        raise DeltaIllegalArgumentError(f"Invalid interval: {s!r}")
    if ms < 0:
        raise DeltaIllegalArgumentError(f"Interval must be non-negative: {s!r}")
    return ms


@dataclass(frozen=True)
class DeltaConfig(Generic[T]):
    key: str  # full key incl. "delta." prefix
    default: str
    from_string: Callable[[str], T]
    validate: Optional[Callable[[T], bool]] = None

    def from_metadata(self, metadata) -> T:
        raw = (metadata.configuration or {}).get(self.key)
        if raw is None:
            raw = conf.get(f"delta.tpu.properties.defaults.{self.key[len('delta.'):]}")
        if raw is None:
            raw = self.default
        try:
            value = self.from_string(str(raw))
        except DeltaIllegalArgumentError:
            raise
        except (ValueError, TypeError) as e:
            raise DeltaIllegalArgumentError(
                f"Invalid value {raw!r} for table property {self.key}: {e}")
        if self.validate and not self.validate(value):
            raise DeltaIllegalArgumentError(f"Invalid value {raw!r} for table property {self.key}")
        return value


def _bool(s: str) -> bool:
    if s.lower() in ("true", "1"):
        return True
    if s.lower() in ("false", "0"):
        return False
    raise ValueError(f"not a boolean: {s!r}")


class _Probe:
    def __init__(self, configuration: Dict[str, str]):
        self.configuration = configuration


class DeltaConfigs:
    """Registry of table properties (``DeltaConfig.scala:227-433``)."""

    LOG_RETENTION = DeltaConfig("delta.logRetentionDuration", "interval 30 days",
                                parse_interval_ms)
    TOMBSTONE_RETENTION = DeltaConfig("delta.deletedFileRetentionDuration",
                                      "interval 1 week", parse_interval_ms)
    CHECKPOINT_INTERVAL = DeltaConfig("delta.checkpointInterval", "10", int, lambda v: v > 0)
    ENABLE_EXPIRED_LOG_CLEANUP = DeltaConfig("delta.enableExpiredLogCleanup", "true", _bool)
    IS_APPEND_ONLY = DeltaConfig("delta.appendOnly", "false", _bool)
    ISOLATION_LEVEL = DeltaConfig("delta.isolationLevel", "WriteSerializable", str,
                                  lambda v: v in ("Serializable", "WriteSerializable"))
    ENABLE_DELETION_VECTORS = DeltaConfig("delta.tpu.enableDeletionVectors", "false", _bool)
    CHECKPOINT_WRITE_STATS_AS_JSON = DeltaConfig("delta.checkpoint.writeStatsAsJson", "true",
                                                 _bool)
    CHECKPOINT_WRITE_STATS_AS_STRUCT = DeltaConfig("delta.checkpoint.writeStatsAsStruct",
                                                   "false", _bool)
    DATA_SKIPPING_NUM_INDEXED_COLS = DeltaConfig("delta.dataSkippingNumIndexedCols", "32", int,
                                                 lambda v: v >= -1)
    SYMLINK_FORMAT_MANIFEST_ENABLED = DeltaConfig(
        "delta.compatibility.symlinkFormatManifest.enabled", "false", _bool)
    RANDOMIZE_FILE_PREFIXES = DeltaConfig("delta.randomizeFilePrefixes", "false", _bool)
    RANDOM_PREFIX_LENGTH = DeltaConfig("delta.randomPrefixLength", "2", int, lambda v: v > 0)
    CHANGE_DATA_FEED = DeltaConfig("delta.enableChangeDataFeed", "false", _bool)
    MIN_READER_VERSION = DeltaConfig("delta.minReaderVersion", "1", int, lambda v: v > 0)
    MIN_WRITER_VERSION = DeltaConfig("delta.minWriterVersion", "2", int, lambda v: v > 0)

    _ALL: Dict[str, DeltaConfig] = {}

    @classmethod
    def all_configs(cls) -> Dict[str, DeltaConfig]:
        if not cls._ALL:
            for name in dir(cls):
                v = getattr(cls, name)
                if isinstance(v, DeltaConfig):
                    cls._ALL[v.key.lower()] = v
        return cls._ALL

    @classmethod
    def validate_configuration(cls, configuration: Dict[str, str]) -> Dict[str, str]:
        """Type-check ``delta.*`` keys; unknown ``delta.`` keys are refused
        (``delta.constraints.*`` passes through)."""
        registry = cls.all_configs()
        out = {}
        for k, v in configuration.items():
            lk = k.lower()
            if lk.startswith("delta."):
                cfg = registry.get(lk)
                if cfg is None:
                    if lk.startswith("delta.constraints."):
                        out[k] = v
                        continue
                    raise DeltaIllegalArgumentError(f"Unknown configuration was specified: {k}")
                cfg.from_metadata(_Probe({cfg.key: v}))
                out[cfg.key] = v
            else:
                out[k] = v
        return out

    @classmethod
    def merge_global_configs(cls, configuration: Dict[str, str]) -> Dict[str, str]:
        """Session-level defaults ``delta.tpu.properties.defaults.*`` for the
        keys the user did not set."""
        out = dict(configuration)
        for cfg in cls.all_configs().values():
            if cfg.key in out:
                continue
            default = conf.get(f"delta.tpu.properties.defaults.{cfg.key[len('delta.'):]}")
            if default is not None:
                out[cfg.key] = str(default)
        return out
