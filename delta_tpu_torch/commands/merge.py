"""MERGE INTO — columnar three-phase upsert (the port's own copy of
``delta_tpu.commands.merge``).

As in the reference (``commands/MergeIntoCommand.scala:201-771``): (1) join
the source with the candidate target files to find the matched pairs and
detect multi-matches; (2) apply the clauses column by column — matched
pairs, unmatched target rows of rewritten files, unmatched source rows each
as a block with one vectorized mask and projection per clause; (3) commit
the removes, the deletion-vector re-adds and the new data files.

The join has four routes, named by ``cmd._join_path``:

* ``resident`` — the table's key lane is already on the card
  (``ops/key_cache.KeyCache``): it advances over the log tail (K11) and the
  probe ships only the source keys (K9, K10);
* ``device-cold`` — no lane yet: each candidate file's key projection
  decodes and lands on a pre-sized device slab (``SlabBuilder``: K11), the
  slab is sorted (K8) and probed (K9, K10), and it is registered so the
  next MERGE against the table takes the resident route;
* ``device-upload`` — the key lane cannot be laid out in physical rows
  (copy-on-write over files that carry deletion vectors): the decoded keys
  upload whole and the upload join K12 (``ops/join_kernel``) probes them;
* ``host`` — ``devicePath.mode=off``, a key that is not an integer, more
  than two keys, residual conjuncts: the numpy sort-merge
  ``join_kernel.host_equi_join``, or the blocked cartesian pairing for a
  condition with no equi conjunct.

The device routes take 1-2 integer equi keys and no residual conjunct.
``devicePath.mode=force`` takes a device route whenever the merge is
eligible; ``off`` pins the host join; ``auto`` (the default) prices each
device route against the host join with the link cost model
(``parallel/link``), as the JAX package does: the cold estimate before the
key decode, from the candidates' ``numRecords`` (``_rows_from_stats``:
slab upload + sort + probe against the host join); the resident estimate
when a slab is cached (the probe alone, plus the slab's re-upload when its
device copy was dropped, against the host join and key decode); and the
upload join's budget (``join_kernel.inner_join_async(budget_s=)``). A
declined device route counts ``merge.device.declined`` and records
``reason`` (``cold-estimate`` / ``resident-estimate`` / ``upload-declined``).
``cmd._router`` carries the prices compared (``deviceEstS``,
``hostEstS``); one ``delta.merge.router`` event and one ``merge.join``
router audit (``obs/router_audit``: the prediction against the measured
``key_decode_ms + join_ms``, with the calibrator's samples) follow each
merge. Persisted calibration (``obs/calibration``) is applied before
routing. Every route gives the same rows.

Where the JAX package turns an error of the device route into the host
join or a quietly cold next MERGE, the port raises: a kernel or CUDA error
anywhere in the join propagates out of :meth:`MergeIntoCommand.run`. The
one fallback kept is a data disagreement, recorded in
``cmd._router["reason"]``: the slab's pairs do not line up with a file's
decode (``pairs_for_file`` returns None) or the cold build finds a file
whose rows disagree with its recorded count.

Write semantics, as in the JAX package: with
``delta.tpu.schema.autoMerge.enabled`` and a star clause the target schema
evolves to ``merge_schemas(target, source)`` before the join (new source
columns append, types widen, generated columns and their inputs keep
their types); a generated column is computed for inserted rows and
recomputed where an update assigns one of its inputs; with the change data
feed on, the clauses' rows go to one CDC file (``update_preimage`` and
``update_postimage`` from the matched pairs, whichever route produced them,
``delete`` once a target row, ``insert``), and the candidate scan is not
narrowed to the join keys. Left out, result-identical: the distributed
touched-files probe (it runs on the multi-host executor), row-group
skipping, and the workload journal.

On a state mesh of several entries (``parallel/mesh.default_devices``:
every visible card, or the list ``mesh.using_devices`` installs), the
upload join runs K13 over the mesh in place of K12, as the JAX package
passes ``state_mesh()`` whenever it has several devices; with
``delta.tpu.merge.devicePath.preferMesh`` the cold estimate prices that
route (``link.estimate_device_s(..., shards=)``) in place of the cold
slab's.
"""
from __future__ import annotations

import queue as queue_mod
import threading
from dataclasses import dataclass, replace
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from delta_tpu_torch.commands import dml_common as dv_common
from delta_tpu_torch.commands import operations as ops
from delta_tpu_torch.commands.dml_common import POSITION_COL, Timer, candidate_files
from delta_tpu_torch.commands.write import coerce_to_table
from delta_tpu_torch.exec import cdf as cdf_exec
from delta_tpu_torch.exec import write as write_exec
from delta_tpu_torch.exec.scan import read_files_as_table
from delta_tpu_torch.expr import ir
from delta_tpu_torch.expr.parser import parse_expression, parse_predicate
from delta_tpu_torch.expr.vectorized import (
    HostColumn, HostTable, boolean_mask, cast_column, concat_tables, evaluate, null_column,
    stored_type,
)
from delta_tpu_torch.ops import join_kernel
from delta_tpu_torch.ops import key_cache as kc_mod
from delta_tpu_torch.protocol.actions import Action, AddFile
from delta_tpu_torch.schema import generated as generated_mod
from delta_tpu_torch.schema import schema_utils
from delta_tpu_torch.utils import errors as errors_mod
from delta_tpu_torch.utils import telemetry
from delta_tpu_torch.utils.config import conf
from delta_tpu_torch.utils.errors import DeltaAnalysisError, DeltaUnsupportedOperationError

__all__ = ["MergeIntoCommand", "MergeClause"]


def _float_to_int64(col: HostColumn) -> HostColumn:
    """An integral float64 in [-2^63, 2^63) is an int64 exactly; any other
    value can equal no int64 key, so it becomes NULL (NULL keys never join)."""
    f = col.values.astype(np.float64)
    with np.errstate(invalid="ignore"):
        integral = col.valid & (np.floor(f) == f) & (f >= -(2.0 ** 63)) & (f < 2.0 ** 63)
    vals = np.where(integral, f, 0).astype(np.int64)
    return HostColumn("int", vals, integral, None)


def _coerce_join_keys(t_vals: HostColumn, s_vals: HostColumn) -> Tuple[HostColumn, HostColumn]:
    """Lossless join-key coercion: never a narrowing or precision-losing
    cast (wrapped or rounded keys fabricate matches). int vs int and
    float vs float compare as they are (the values are int64 and float64
    already); int vs float keeps int64 and maps the float side through an
    integrality check; a string against anything compares as strings; a
    decimal key joins a decimal key of its own type only, on the host (a
    decimal key never takes a device lane)."""
    a, b = stored_type(t_vals), stored_type(s_vals)
    if a == b:
        return t_vals, s_vals
    ka, kb = t_vals.kind, s_vals.kind
    if ka == kb and ka in ("int", "double"):
        return t_vals, s_vals
    if ka == "int" and kb == "double":
        return t_vals, _float_to_int64(s_vals)
    if ka == "double" and kb == "int":
        return _float_to_int64(t_vals), s_vals
    if ka == "str" or kb == "str":
        return cast_column(t_vals, "str", None), cast_column(s_vals, "str", None)
    if "decimal" in (ka, kb):
        # Arrow's hash join refuses keys of two types
        raise ValueError(f"Incompatible data types for corresponding join field keys: {a} "
                         f"and {b}")
    return t_vals, s_vals


_SRC = "__s__"  # prefix for source columns in the combined pair table
_TID = "__t_row__"
_SID = "__s_row__"
_FID = "__t_file__"


def _rows_from_stats(candidates) -> Optional[int]:
    """Total numRecords over the candidate files; None when a file lacks
    stats (the cold estimate is then skipped)."""
    total = 0
    for add in candidates:
        n = add.num_logical_records
        if n is None:
            return None
        total += int(n)
    return total


def _int_column(values: np.ndarray) -> HostColumn:
    return HostColumn("int", np.asarray(values, np.int64), np.ones(len(values), bool))


def _append_all(table: HostTable, other: HostTable) -> HostTable:
    for name, col in other.columns.items():
        table = table.append_column(name, col)
    return table


@dataclass
class MergeClause:
    """One WHEN clause (``catalyst/plans/logical/deltaMerge.scala:161-221``)."""

    kind: str  # "update" | "delete" | "insert"
    condition: Optional[ir.Expression] = None
    # None = updateAll/insertAll (star); else target column -> expression
    assignments: Optional[Dict[str, ir.Expression]] = None

    @property
    def is_star(self) -> bool:
        return self.assignments is None and self.kind in ("update", "insert")


def _parse_opt(e: Optional[Union[str, ir.Expression]], pred=True):
    if e is None or isinstance(e, ir.Expression):
        return e
    return parse_predicate(e) if pred else parse_expression(e)


class MergeIntoCommand:
    def __init__(self, delta_log, source: Any, condition: Union[str, ir.Expression],
                 matched_clauses: Sequence[MergeClause] = (),
                 not_matched_clauses: Sequence[MergeClause] = (),
                 source_alias: Optional[str] = None, target_alias: Optional[str] = None):
        self.delta_log = delta_log
        self.source = coerce_to_table(source)
        self.condition = _parse_opt(condition)

        def _norm(c: MergeClause) -> MergeClause:
            return MergeClause(
                kind=c.kind, condition=_parse_opt(c.condition),
                assignments=None if c.assignments is None else {
                    col: (parse_expression(e) if isinstance(e, str) else e)
                    for col, e in c.assignments.items()})

        self.matched_clauses = [_norm(c) for c in matched_clauses]
        self.not_matched_clauses = [_norm(c) for c in not_matched_clauses]
        self.source_alias = source_alias
        self.target_alias = target_alias
        self.metrics: Dict[str, int] = {}
        # wall-clock per phase (key_decode/decode/join/apply/write ms)
        self.phase_ms: Dict[str, float] = {}
        # set by _join when a device route ran: the JoinResult with exact
        # per-target first matches and per-source matched flags
        self._device_join = None
        self._validate_clauses()

    def _validate_clauses(self) -> None:
        for c in self.matched_clauses:
            if c.kind not in ("update", "delete"):
                raise errors_mod.invalid_merge_clause(c.kind, matched=True)
        for c in self.not_matched_clauses:
            if c.kind != "insert":
                raise errors_mod.invalid_merge_clause(c.kind, matched=False)
        for c in self.matched_clauses:
            if c.kind == "delete" and c.assignments:
                raise DeltaAnalysisError("DELETE clauses cannot carry SET assignments")
        # only the last clause of each group may lack a condition
        for group in (self.matched_clauses, self.not_matched_clauses):
            for c in group[:-1]:
                if c.condition is None:
                    raise DeltaAnalysisError(
                        "When there are more than one MATCHED/NOT MATCHED clauses, "
                        "only the last can omit its condition")
        # duplicate assignment targets within one clause (case-insensitive)
        for group in (self.matched_clauses, self.not_matched_clauses):
            for c in group:
                if not c.assignments:
                    continue
                seen = set()
                for col in c.assignments:
                    low = col.split(".")[-1].lower()
                    if low in seen:
                        raise errors_mod.merge_conflicting_set_columns(col)
                    seen.add(low)

    def _analyze_clauses(self, target_cols, source_cols) -> None:
        """Every clause condition and assignment must resolve, insert
        conditions see only the source, assignment targets are target
        columns."""
        t_low = {c.lower() for c in target_cols}
        for clause in self.matched_clauses:
            if clause.condition is not None:
                self._resolve(clause.condition, target_cols, source_cols)
            for col, e in (clause.assignments or {}).items():
                if col.split(".")[-1].lower() not in t_low:
                    raise errors_mod.merge_unresolvable_column(col, target_cols, [])
                self._resolve(e, target_cols, source_cols)
        for clause in self.not_matched_clauses:
            if clause.condition is not None:
                self._resolve(clause.condition, [], source_cols)
            for col, e in (clause.assignments or {}).items():
                if col.split(".")[-1].lower() not in t_low:
                    raise errors_mod.merge_unresolvable_column(col, target_cols, [])
                self._resolve(e, [], source_cols)

    def _migrate_schema(self, txn):
        """MERGE schema evolution (``deltaMerge.scala:224-424``,
        ``PreprocessTableMerge.scala:65-71``): with
        ``delta.tpu.schema.autoMerge.enabled`` and a star clause the target
        schema widens to ``merge_schemas(target, source)``. Returns the
        transaction's (possibly evolved) metadata."""
        metadata = txn.metadata
        has_star = any(c.is_star for c in self.matched_clauses + self.not_matched_clauses)
        if not (conf.get_bool("delta.tpu.schema.autoMerge.enabled", False) and has_star):
            return metadata
        merged = schema_utils.merge_schemas(
            metadata.schema, schema_utils.schema_from_table(self.source),
            allow_implicit_conversions=True,
            fixed_type_columns=generated_mod.fixed_type_columns(metadata.schema))
        if merged.to_json() != metadata.schema.to_json():
            txn.update_metadata(replace(metadata, schema_string=merged.to_json()))
            metadata = txn.metadata
        return metadata

    # -- name resolution --------------------------------------------------

    def _resolve(self, e: ir.Expression, target_cols: Sequence[str],
                 source_cols: Sequence[str]) -> ir.Expression:
        """Rewrite alias-qualified/unqualified refs onto the combined pair
        table: target columns keep their names, source columns get _SRC."""
        t_low = {c.lower(): c for c in target_cols}
        s_low = {c.lower(): c for c in source_cols}
        t_alias = (self.target_alias or "").lower()
        s_alias = (self.source_alias or "").lower()

        def rewrite(node: ir.Expression) -> Optional[ir.Expression]:
            if not isinstance(node, ir.Column):
                return None
            name = node.name
            low = name.lower()
            if "." in low and low not in t_low and low not in s_low:
                qual, _, col = low.partition(".")
                if qual == s_alias and col in s_low:
                    return ir.Column(_SRC + s_low[col])
                if qual == t_alias and col in t_low:
                    return ir.Column(t_low[col])
                # an unknown qualifier must NOT fall back to bare resolution
                raise errors_mod.merge_unresolvable_qualifier(
                    name, qual, self.target_alias, self.source_alias)
            if low in t_low:
                return ir.Column(t_low[low])
            if low in s_low:
                return ir.Column(_SRC + s_low[low])
            raise errors_mod.merge_unresolvable_column(name, target_cols, source_cols)

        return e.transform(rewrite)

    def _split_equi_keys(self, cond: ir.Expression
                         ) -> Tuple[List[Tuple[ir.Expression, ir.Expression]], List[ir.Expression]]:
        """Split the resolved join condition into target=source equi pairs
        and residual conjuncts."""
        pairs: List[Tuple[ir.Expression, ir.Expression]] = []
        residual: List[ir.Expression] = []
        for c in ir.split_conjuncts(cond):
            if isinstance(c, ir.Eq):
                sides = [c.left, c.right]
                t_side = s_side = None
                for side in sides:
                    r = set(ir.references(side))
                    if r and all(x.startswith(_SRC) for x in r):
                        s_side = side
                    elif r and not any(x.startswith(_SRC) for x in r):
                        t_side = side
                if t_side is not None and s_side is not None:
                    pairs.append((t_side, s_side))
                    continue
            residual.append(c)
        return pairs, residual

    # -- main -------------------------------------------------------------

    def run(self) -> int:
        return self.delta_log.with_new_transaction(self._body)

    def _body(self, txn) -> int:
        from delta_tpu_torch.obs import calibration

        # persisted calibration first, so a fresh process routes with what
        # the last one learned (a no-op unless calibration is enabled)
        calibration.apply_state(self.delta_log.log_path)
        # per-execution state: a re-run must not consume a previous run's
        # device-join flags
        self._device_join = None
        self._resident_candidate = None
        # the router audit's workload: (target rows, source rows) the join
        # saw, the slab's rows where a device probe ran, and whether a
        # device route existed for this condition at all
        self._audit_units = None
        self._audit_eligible = False
        self._audit_slab_rows = None
        # 'resident' | 'device-cold' | 'device-upload' | 'host'
        self._join_path = "host"
        self._router: Dict[str, Any] = {}
        self._cdf_blocks: List[Tuple[str, HostTable]] = []
        self._use_cdf = cdf_exec.cdf_enabled(txn.metadata)
        self.phase_ms.clear()
        timer = Timer()
        metadata = self._migrate_schema(txn)
        target_cols = [f.name for f in metadata.schema.fields]
        source_cols = list(self.source.column_names)
        # static star coverage (`deltaMerge.scala:322-328`)
        for clause in self.matched_clauses:
            if clause.is_star:
                self._check_star_coverage(target_cols, source_cols, "UPDATE", metadata)
                break
        for clause in self.not_matched_clauses:
            if clause.is_star:
                self._check_star_coverage(target_cols, source_cols, "INSERT", metadata)
                break
        # read-side char padding of the condition and the matched clauses'
        # conditions (only refs that resolve to the target pad)
        from delta_tpu_torch.schema.char_varchar import pad_char_literals

        tq = frozenset({self.target_alias.lower()} if self.target_alias else ())
        self.condition = pad_char_literals(self.condition, metadata, tq)
        self.matched_clauses = [
            MergeClause(c.kind, pad_char_literals(c.condition, metadata, tq)
                        if c.condition is not None else None, c.assignments)
            for c in self.matched_clauses]
        self._analyze_clauses(target_cols, source_cols)
        cond = self._resolve(self.condition, target_cols, source_cols)
        equi, residual = self._split_equi_keys(cond)

        # source with prefixed names + row ids
        src = self.source.rename_columns([_SRC + c for c in source_cols])
        src = src.append_column(_SID, _int_column(np.arange(src.num_rows)))

        # phase 1: candidates by target-only conjuncts, then the join
        target_only = [c for c in ir.split_conjuncts(cond)
                       if not any(r.startswith(_SRC) for r in ir.references(c))]
        prune = ir.and_all(target_only) if target_only else None
        candidates = candidate_files(txn, prune)
        insert_only = not self.matched_clauses
        matched_pairs, tgt_tables = self._join(txn, candidates, src, equi, residual, metadata)
        self._emit_router()
        scan_ms = timer.lap_ms()

        if not insert_only:
            # insert-only merges never modify target rows, so duplicate
            # matches are harmless (reference fast path, `:397-450`)
            self._check_multi_match(matched_pairs)

        removes: List[Action] = []
        dv_adds: List[Action] = []
        out_blocks: List[HostTable] = []
        n_copied = n_updated = n_deleted = 0
        use_dv = not insert_only and dv_common.dv_enabled(metadata)

        if not insert_only:
            upd, n_updated, n_deleted, n_pair_copied, claimed_tbl, fired_fids = (
                self._apply_matched(matched_pairs, target_cols, metadata, dv_mode=use_dv))
            n_copied += n_pair_copied
            if upd is not None:
                out_blocks.append(upd)
            if use_dv:
                # claimed rows are marked deleted through per-file deletion
                # vectors; every other row stays live in place
                if claimed_tbl is not None and claimed_tbl.num_rows:
                    fids = claimed_tbl.column(_FID).values
                    poss = claimed_tbl.column(POSITION_COL).values
                    for fid in np.unique(fids):
                        rm, re_add = dv_common.dv_mark_deleted(
                            self.delta_log.data_path, candidates[int(fid)], poss[fids == fid])
                        removes.append(rm)
                        if re_add is not None:
                            dv_adds.append(re_add)
            else:
                for fid in sorted(fired_fids):
                    removes.append(candidates[fid].remove())
                # unmatched target rows inside touched files -> copy. _TID is
                # the global row index over the candidate concat
                total_rows = sum(t.num_rows for t in tgt_tables.values())
                claimed = np.zeros(total_rows, bool)
                claimed[matched_pairs.column(_TID).values] = True
                row_start = 0
                starts = {}
                for fid in sorted(tgt_tables):
                    starts[fid] = row_start
                    row_start += tgt_tables[fid].num_rows
                for fid in sorted(fired_fids):
                    t = tgt_tables[fid]
                    keep = ~claimed[starts[fid]: starts[fid] + t.num_rows]
                    copied = t.filter(keep).select(target_cols) if not keep.all() \
                        else t.select(target_cols)
                    n_copied += copied.num_rows
                    if copied.num_rows:
                        out_blocks.append(copied)

        # not-matched source rows -> insert clauses
        inserts, n_inserted = self._apply_not_matched(matched_pairs, src, target_cols,
                                                      source_cols, metadata)
        if inserts is not None and inserts.num_rows:
            out_blocks.append(inserts)
            if self._use_cdf:
                self._cdf_blocks.append(("insert", inserts))

        self.phase_ms["apply_ms"] = timer.peek_ms()
        adds: List[Action] = list(dv_adds)
        if out_blocks:
            out = concat_tables([b.select(target_cols) for b in out_blocks])
            if out.num_rows:
                adds += list(write_exec.write_files(self.delta_log.data_path, out, metadata,
                                                    data_change=True,
                                                    device=self.delta_log.device))
        # the change data after the data files: a write the constraints refuse
        # leaves no CDC file behind
        cdc_actions: List[Action] = list(cdf_exec.write_change_data(
            self.delta_log.data_path, self._cdf_blocks, metadata, device=self.delta_log.device))
        rewrite_ms = timer.lap_ms()
        self.phase_ms["write_ms"] = rewrite_ms - self.phase_ms["apply_ms"]

        self.metrics.update(
            numSourceRows=self.source.num_rows,
            numTargetRowsCopied=n_copied,
            numTargetRowsUpdated=n_updated,
            numTargetRowsDeleted=n_deleted,
            numTargetRowsInserted=n_inserted,
            numTargetFilesRemoved=len(removes),
            numTargetFilesAdded=len(adds),
            scanTimeMs=scan_ms,
            rewriteTimeMs=rewrite_ms,
        )
        txn.report_metrics(**self.metrics)

        def _clause_info(c: MergeClause) -> Dict[str, Any]:
            info: Dict[str, Any] = {"actionType": c.kind}
            if c.condition is not None:
                info["predicate"] = c.condition.sql()
            return info

        op = ops.Merge(
            predicate=self.condition.sql(),
            updates=[_clause_info(c) for c in self.matched_clauses if c.kind == "update"],
            deletes=[_clause_info(c) for c in self.matched_clauses if c.kind == "delete"],
            inserts=[_clause_info(c) for c in self.not_matched_clauses],
        )
        version = txn.commit(removes + adds + cdc_actions, op)
        self._maybe_build_resident_keys()
        return version

    # -- join -------------------------------------------------------------

    def _join(self, txn, candidates: List[AddFile], src: HostTable, equi, residual,
              metadata) -> Tuple[HostTable, Dict[int, HostTable]]:
        """Inner-join source x candidate target. Returns (the pair table:
        target columns bare, source columns prefixed, row and file ids; the
        per-file target tables with row ids)."""
        target_cols = [f.name for f in metadata.schema.fields]
        insert_only = not self.matched_clauses
        key_need = {r.lower() for t_e, _ in equi for r in ir.references(t_e)}
        # insert-only merges never rewrite target rows: read only the
        # columns the join condition touches
        if insert_only:
            need = key_need | {r.lower() for c in residual for r in ir.references(c)
                               if not r.startswith(_SRC)}
            read_cols = [c for c in target_cols if c.lower() in need] or None
        else:
            read_cols = self._referenced_target_columns(
                metadata, target_cols, [c for c in src.column_names if c.startswith(_SRC)],
                key_need, residual)

        mode = str(conf.get("delta.tpu.merge.devicePath.mode", "auto"))
        base_eligible = bool(
            conf.get_bool("delta.tpu.merge.devicePath.enabled", True)
            and mode != "off" and 1 <= len(equi) <= 2 and not residual
            and candidates and src.num_rows > 0)
        device_eligible = base_eligible
        self._audit_eligible = base_eligible
        if device_eligible and mode == "auto":
            # the cold price from the files' numRecords, before any decode:
            # slab upload + sort + probe against the host join. A cached
            # slab is priced on its own below
            n_est = _rows_from_stats(candidates)
            if n_est is not None:
                from delta_tpu_torch.parallel import link

                mesh = self._state_mesh()
                rows = n_est + src.num_rows
                if mesh is None or not conf.get_bool("delta.tpu.merge.devicePath.preferMesh",
                                                     False):
                    device_s = link.cold_merge_device_s(n_est, src.num_rows,
                                                        link.profile(self.delta_log.device))
                else:
                    device_s = link.estimate_device_s(
                        up_bytes=rows * 4, down_bytes=rows // 8, kernel_rows=rows,
                        shards=len(mesh), device=mesh[0]).device_s
                host_est_s = rows * link.constant("HOST_JOIN_S_PER_ROW")
                self._router.setdefault("deviceEstS", round(device_s, 3))
                self._router.setdefault("hostEstS", round(host_est_s, 3))
                if device_s > host_est_s:
                    device_eligible = False
                    telemetry.bump_counter("merge.device.declined")
                    self._router.update(reason="cold-estimate")
        # DV-mode matched clauses mark physical rows deleted: every scan that
        # can end up as the phase-2 tables must carry positions
        pos_col = POSITION_COL if (not insert_only and dv_common.dv_enabled(metadata)) else None
        decode_t = Timer()
        pending = None
        resident = None
        via = None
        key_pieces: Optional[List[HostTable]] = None
        key_pieces_have_pos = False
        if base_eligible:
            # the resident slab has its own price (no upload), so it is
            # tried even where the cold estimate declined
            resident = self._launch_resident_probe(txn, candidates, src, equi, target_cols,
                                                   key_need, pos_col, insert_only)
            if resident is not None:
                via = "resident"
        if resident is None and device_eligible:
            resident, key_pieces = self._launch_slab_pipeline(
                txn, candidates, src, equi, target_cols, key_need, pos_col, insert_only, metadata)
            if resident is not None:
                via = "device-cold"
            key_pieces_have_pos = key_pieces is not None
            if resident is None and key_pieces is None:
                # the slab pipeline declined before decoding (the key lane
                # cannot be laid out in physical rows): decode the key
                # projection and upload it whole
                key_cols = [c for c in target_cols if c.lower() in key_need]
                key_pieces = read_files_as_table(self.delta_log.data_path, candidates, metadata,
                                                 columns=key_cols or None, per_file=True,
                                                 position_column=pos_col,
                                                 device=self.delta_log.device)
            if resident is None:
                key_tab = concat_tables(key_pieces) if key_pieces else None
                if key_tab is not None and key_tab.num_rows:
                    pending = self._launch_device_join(key_tab, src, equi)
                    if pending is not None:
                        via = "device-upload"
                    else:
                        self._router.setdefault("reason", "upload-declined")
        self.phase_ms["key_decode_ms"] = decode_t.lap_ms_f()

        # full-column decode (overlaps the in-flight device probe); reuse the
        # key projection when it covers every needed column
        if key_pieces is not None and read_cols is not None and set(
                c.lower() for c in read_cols) <= key_need and (
                not key_pieces_have_pos or pos_col is not None or insert_only):
            raw_pieces = key_pieces
        else:
            raw_pieces = read_files_as_table(self.delta_log.data_path, candidates, metadata,
                                             columns=read_cols, per_file=True,
                                             position_column=pos_col,
                                             device=self.delta_log.device)
        tgt_tables: Dict[int, HostTable] = {}
        pieces: List[HostTable] = []
        row_base = 0
        for fid, t in enumerate(raw_pieces):
            t = t.append_column(_TID, _int_column(np.arange(row_base, row_base + t.num_rows)))
            t = t.append_column(_FID, _int_column(np.full(t.num_rows, fid)))
            row_base += t.num_rows
            tgt_tables[fid] = t
            pieces.append(t)
        self.phase_ms["decode_ms"] = decode_t.lap_ms_f()
        if not pieces:
            target = HostTable({_TID: _int_column(np.empty(0)), _FID: _int_column(np.empty(0))}, 0)
        else:
            target = concat_tables(pieces)
        self._audit_units = (target.num_rows, src.num_rows)

        def empty_pairs() -> HostTable:
            return _append_all(target.slice(0, 0), src.slice(0, 0))

        if target.num_rows == 0 or src.num_rows == 0:
            return empty_pairs(), tgt_tables

        join_t = Timer()
        if resident is not None and pending is None:
            pending = self._finalize_resident(resident, candidates, tgt_tables, target, pos_col,
                                              insert_only)
        if pending is not None:
            res = pending.result()
            if res is None:
                self._router.setdefault("reason", "device-finalize-fallback")
            else:
                self._device_join = res
                self._join_path = via
                # insert-only never consumes the pair rows (the not-matched
                # block comes from s_matched)
                if insert_only:
                    joined = empty_pairs()
                else:
                    matched = np.flatnonzero(res.t_matched)
                    joined = _append_all(target.take(matched), src.take(res.t_first_s[matched]))
                self.phase_ms["join_ms"] = join_t.lap_ms_f()
                return joined, tgt_tables

        if equi:
            keys = []
            for t_e, s_e in equi:
                t_vals, s_vals = _coerce_join_keys(evaluate(t_e, target), evaluate(s_e, src))
                keys.append((t_vals.values, t_vals.valid, s_vals.values, s_vals.valid))
            t_take, s_take = join_kernel.host_equi_join(keys)
            joined = _append_all(target.take(t_take), src.take(s_take))
        else:
            # general condition: BLOCKED cartesian pairing — tile the target x
            # source grid and filter each tile by the condition at once, so
            # peak memory is one tile of pairs (`nonEquiPairBudget`)
            budget = int(conf.get("delta.tpu.merge.nonEquiPairBudget", 8_000_000))
            m = src.num_rows
            tile = max(budget // max(m, 1), 1)
            cond = ir.and_all(residual) if residual else None
            parts = []
            s_base = np.tile(np.arange(m, dtype=np.int64), tile)
            for t0 in range(0, target.num_rows, tile):
                rows = min(tile, target.num_rows - t0)
                t_idx = np.repeat(np.arange(t0, t0 + rows, dtype=np.int64), m)
                piece = _append_all(target.take(t_idx), src.take(s_base[: rows * m]))
                if cond is not None:
                    piece = piece.filter(boolean_mask(cond, piece))
                if piece.num_rows:
                    parts.append(piece)
            joined = concat_tables(parts) if parts else empty_pairs()
            self.phase_ms["join_ms"] = join_t.lap_ms_f()
            return joined, tgt_tables
        if residual:
            joined = joined.filter(boolean_mask(ir.and_all(residual), joined))
        self.phase_ms["join_ms"] = join_t.lap_ms_f()
        return joined, tgt_tables

    def _referenced_target_columns(self, metadata, target_cols, src_prefixed, key_need,
                                   residual) -> Optional[List[str]]:
        """The target columns phase 2 can touch, or None when every column
        is needed. Valid only when nothing re-materializes whole target
        rows: deletion vectors on, the change data feed off (no preimages),
        no generated columns (a recompute reads any base column) and every
        update clause a star. For a star upsert this collapses the scan to
        the join keys."""
        if not dv_common.dv_enabled(metadata) or self._use_cdf:
            return None
        if generated_mod.generated_column_names(metadata.schema):
            return None
        source_bare = [c[len(_SRC):] for c in src_prefixed]
        src_lower = {c.lower() for c in source_bare}
        need = set(key_need)
        for c in residual:
            need |= {r.lower() for r in ir.references(c) if not r.startswith(_SRC)}
        try:
            for clause in self.matched_clauses + self.not_matched_clauses:
                if clause.condition is not None:
                    resolved = self._resolve(clause.condition, target_cols, source_bare)
                    need |= {r.lower() for r in ir.references(resolved)
                             if not r.startswith(_SRC)}
                if clause.kind == "update":
                    if not clause.is_star:
                        return None
                    # star update: target-only columns copy from the target
                    need |= {c.lower() for c in target_cols if c.lower() not in src_lower}
        except DeltaAnalysisError:
            return None  # the normal path raises the real resolution error
        cols = [c for c in target_cols if c.lower() in need]
        if len(cols) == len(target_cols):
            return None
        return cols or None

    # -- the device routes ----------------------------------------------------

    @staticmethod
    def _key_signature(t_exprs) -> str:
        return repr([repr(e) for e in t_exprs])

    def _launch_resident_probe(self, txn, candidates, src, equi, target_cols, key_need,
                               pos_col, insert_only):
        """Probe the table's resident key lane, if one is current (after
        advancing it over the log tail): ships only the source keys. Returns
        (entry, PendingProbe) or None; when no lane exists, records the
        signature for the post-commit warmup."""
        if not kc_mod.key_cache_enabled():
            return None
        # mapping bits back onto the DV-filtered decode needs physical
        # positions; without them only DV-free candidates are alignable
        if (pos_col is None and not insert_only
                and any(f.deletion_vector is not None for f in candidates)):
            return None
        t_exprs = [t for t, _ in equi]
        s_exprs = [s for _, s in equi]
        sig = self._key_signature(t_exprs)
        key_cols = [c for c in target_cols if c.lower() in key_need]
        entry = kc_mod.KeyCache.instance().get(txn.snapshot, sig, key_cols, t_exprs,
                                               build_if_missing=False)
        if entry is None:
            self._resident_candidate = (sig, key_cols, t_exprs)
            return None
        packed = kc_mod._pack_lanes(src, s_exprs, evaluate)
        if packed is None:
            return None
        s_keys, s_ok = packed
        self._router["cacheHit"] = True
        if str(conf.get("delta.tpu.merge.devicePath.mode", "auto")) == "auto":
            from delta_tpu_torch.parallel import link

            m, n = len(s_keys), entry.num_rows
            p = link.profile(self.delta_log.device)
            device_s = link.resident_probe_device_s(n, m, p)
            if not entry.is_resident:
                # the device copy was dropped: the probe re-ships the slab
                device_s += p.upload_s(entry.capacity * 9)
            host_s = ((n + m) * link.constant("HOST_JOIN_S_PER_ROW")
                      + n * link.constant("HOST_KEY_DECODE_S_PER_ROW"))
            self._router["deviceEstS"] = round(device_s, 3)
            self._router["hostEstS"] = round(host_s, 3)
            if device_s > host_s:
                telemetry.bump_counter("merge.device.declined")
                self._router.update(reason="resident-estimate")
                return None
        probe = entry.probe_async(s_keys, s_ok, expected_version=txn.snapshot.version,
                                  insert_only=insert_only)
        if probe is None:
            return None
        self._audit_slab_rows = entry.num_rows
        return entry, probe

    def _launch_slab_pipeline(self, txn, candidates, src, equi, target_cols, key_need,
                              pos_col, insert_only, metadata):
        """The cold device pipeline: decode the key projection file by file,
        each decoded lane landing on a pre-sized device slab from an
        uploader thread while the next files decode, then probe the slab and
        register it so the next MERGE against the table probes it resident.

        Returns ``(resident or None, key pieces or None)``; the per-file
        key pieces (position column attached) come back even when the slab
        cannot serve, so the caller reuses the decode."""
        # DV alignment guard (as on the resident route)
        if (pos_col is None and not insert_only
                and any(f.deletion_vector is not None for f in candidates)):
            return None, None
        t_exprs = [t for t, _ in equi]
        s_exprs = [s for _, s in equi]
        packed = kc_mod._pack_lanes(src, s_exprs, evaluate)
        if packed is None:
            return None, None
        s_keys, s_ok = packed
        snapshot = txn.snapshot
        sig = self._key_signature(t_exprs)
        key_cols = [c for c in target_cols if c.lower() in key_need]
        cache = kc_mod.KeyCache.instance()
        builder = kc_mod.SlabBuilder(
            snapshot.delta_log.log_path, snapshot.metadata.id, snapshot.version, sig, key_cols,
            t_exprs, self.delta_log.data_path, candidates, device=self.delta_log.device,
            epoch=cache.epoch(snapshot.delta_log.log_path))
        if builder.failed is not None:
            self._router.setdefault("reason", builder.failed)
            return None, None

        q: "queue_mod.Queue" = queue_mod.Queue()
        upload_error: List[BaseException] = []

        def uploader():
            while True:
                item = q.get()
                if item is None:
                    return
                if upload_error:
                    continue  # drain: the merging thread raises the first error
                add, tab = item
                try:
                    builder.add_file(add, tab, tab.column(POSITION_COL).values)
                except BaseException as e:  # re-raised in the merging thread
                    upload_error.append(e)

        th = threading.Thread(target=uploader, daemon=True, name="delta-merge-slab-upload")
        th.start()
        try:
            # full physical rows per file, positions attached so DV-filtered
            # decodes land in slab layout
            key_pieces = read_files_as_table(
                self.delta_log.data_path, candidates, metadata, columns=key_cols or None,
                per_file=True, position_column=POSITION_COL,
                file_ready=lambda i, add, tab: q.put((add, tab)), device=self.delta_log.device)
        finally:
            q.put(None)
            th.join()
        if upload_error:
            raise upload_error[0]
        entry = builder.finish(len(candidates))
        if entry is None:
            self._router.setdefault("reason", builder.failed or "slab-build-incomplete")
            return None, key_pieces
        # a residual-free condition prunes no file, so the slab covers the
        # whole table and later merges can probe it
        if cache.register(entry):
            self._resident_candidate = None  # no warmup needed
        probe = entry.probe_async(s_keys, s_ok, expected_version=snapshot.version,
                                  insert_only=insert_only)
        if probe is None:
            self._router.setdefault("reason", "no-sentinel-room")
            return None, key_pieces
        self._audit_slab_rows = entry.num_rows
        return (entry, probe), key_pieces

    def _finalize_resident(self, resident, candidates, tgt_tables, target, pos_col,
                           insert_only):
        """Map the device pairs (physical slab row -> first-match source row)
        onto the DV-filtered decode: O(matched) host work. Returns a
        PendingJoin whose result is a JoinResult, or None when the slab
        disagrees with a file's decode (the caller takes the host join and
        the reason is recorded). Every other error propagates."""
        _entry, probe = resident

        def finalize():
            res_p = probe.result()
            t_first_s = np.full(target.num_rows, -1, np.int64)
            if insert_only:
                # only s_matched / any_multi are consumed downstream
                return join_kernel.JoinResult(t_first_s, res_p.s_matched, res_p.any_multi)
            row_base = 0
            for fid in sorted(tgt_tables):
                t = tgt_tables[fid]
                positions = t.column(pos_col).values if pos_col is not None else None
                got = res_p.pairs_for_file(candidates[fid].path, positions, t.num_rows)
                if got is None:
                    self._router["reason"] = f"slab-decode-mismatch:{candidates[fid].path}"
                    return None
                local_idx, s_rows = got
                t_first_s[row_base + local_idx] = s_rows
                row_base += t.num_rows
            return join_kernel.JoinResult(t_first_s, res_p.s_matched, res_p.any_multi)

        return join_kernel.PendingJoin(finalize)

    def _emit_router(self) -> None:
        """One ``delta.merge.router`` event per MERGE, the ``merge.device.*``
        counters, and the router audit of the decision."""
        decision = self._join_path
        if self._device_join is not None:
            telemetry.bump_counter("merge.device.engaged")
            if decision == "resident":
                telemetry.bump_counter("merge.device.cacheHit")
        data = dict(self._router, decision=decision)
        if "cacheHit" in data:
            # a cache hit may have been abandoned (a priced decline, no
            # sentinel room): report whether the engaged join used the cache
            data["cacheHit"] = decision == "resident"
        telemetry.record_event("delta.merge.router", data, path=self.delta_log.data_path)
        self._emit_audit(decision)

    def _emit_audit(self, decision: str):
        """Record the routed join in the audit ledger: the predicted costs
        (through ``link.constant``, so calibration feeds back) against the
        measured ``key_decode_ms + join_ms``, with the samples the EWMA
        calibrator re-fits from. A join with no measured phase (no
        candidates, an empty source) is not audited. Returns the audit or
        None."""
        if "join_ms" not in self.phase_ms or self._audit_units is None:
            return None
        if not conf.get_bool("delta.tpu.telemetry.enabled", True):
            return None  # blackout: no audit, and no link probe to price one
        from delta_tpu_torch.obs import router_audit
        from delta_tpu_torch.parallel import link

        n, m = self._audit_units
        # the device probe's workload is the slab, not the decode
        n_dev = self._audit_slab_rows if self._audit_slab_rows is not None else n
        key_decode_s = self.phase_ms.get("key_decode_ms", 0.0) / 1000.0
        join_s = self.phase_ms["join_ms"] / 1000.0
        actual_s = key_decode_s + join_s
        predicted = {"host": ((n + m) * link.constant("HOST_JOIN_S_PER_ROW")
                              + n * link.constant("HOST_KEY_DECODE_S_PER_ROW"))}
        # the device prediction is keyed by the route taken (or "device"
        # when the host won), and only where a device route existed
        device_key = "device" if decision == "host" else decision
        if self._audit_eligible:
            recorded = self._router.get("deviceEstS")
            if recorded is not None:
                predicted[device_key] = float(recorded)
            else:
                p = link.profile(self.delta_log.device)
                predicted[device_key] = (link.resident_probe_device_s(n_dev, m, p)
                                         if decision == "resident"
                                         else link.cold_merge_device_s(n_dev, m, p))
        samples = []
        if decision == "host":
            if join_s > 0 and (n + m) > 0:
                samples.append(("HOST_JOIN_S_PER_ROW", n + m, join_s))
            if key_decode_s > 0 and n > 0:
                samples.append(("HOST_KEY_DECODE_S_PER_ROW", n, key_decode_s))
        elif decision == "resident" and (n_dev + m) > 0:
            eff = join_s + key_decode_s - link.RESIDENT_PROBE_FIXED_S
            if eff > 0:
                samples.append(("RESIDENT_PROBE_S_PER_ROW", n_dev + m, eff))
        return router_audit.record_audit(
            "merge.join", self.delta_log.data_path, decision, predicted, actual_s,
            units={"targetRows": n, "sourceRows": m, "slabRows": n_dev},
            samples=samples, log_path=self.delta_log.log_path,
            phases={k: round(v, 1) for k, v in self.phase_ms.items()})

    def _maybe_build_resident_keys(self) -> None:
        """Post-commit: start the warmup of the key lane recorded by
        :meth:`_launch_resident_probe`, so the NEXT merge into this table
        probes it resident. Never blocks the committing merge; an error is
        stored on the ``KeyCache`` (``last_build_error``)."""
        cand = getattr(self, "_resident_candidate", None)
        if cand is None:
            return
        self._resident_candidate = None
        if not kc_mod.key_cache_enabled():
            return
        if str(conf.get("delta.tpu.merge.devicePath.mode", "auto")) == "off":
            return
        sig, key_cols, t_exprs = cand
        kc_mod.KeyCache.instance().warm(
            self.delta_log, sig, key_cols, t_exprs,
            int(conf.get("delta.tpu.merge.residentKeys.minRows", 1 << 20)))

    def _launch_device_join(self, key_tab: HostTable, src: HostTable, equi):
        """Evaluate and coerce the join keys and launch the upload join
        (``ops/join_kernel``, K12). Composite integer keys pack into one
        int64 lane (hi<<32 | lo) when both components fit int32. None when
        the keys are not integers (the caller takes the host join)."""
        lanes = []
        for t_e, s_e in equi:
            t_vals, s_vals = _coerce_join_keys(evaluate(t_e, key_tab), evaluate(s_e, src))
            if t_vals.kind != "int" or s_vals.kind != "int":
                return None
            lanes.append(((np.where(t_vals.valid, t_vals.values, 0).astype(np.int64),
                           np.asarray(t_vals.valid, bool)),
                          (np.where(s_vals.valid, s_vals.values, 0).astype(np.int64),
                           np.asarray(s_vals.valid, bool))))
        if len(lanes) == 1:
            (t_keys, t_ok), (s_keys, s_ok) = lanes[0]
        else:
            i32 = np.iinfo(np.int32)
            for (tk, t_ok_i), (sk, s_ok_i) in lanes:
                if (np.min(tk, where=t_ok_i, initial=0) < i32.min
                        or np.max(tk, where=t_ok_i, initial=0) > i32.max
                        or np.min(sk, where=s_ok_i, initial=0) < i32.min
                        or np.max(sk, where=s_ok_i, initial=0) > i32.max):
                    return None  # a component exceeds 32 bits: host join
            (t0, t_ok0), (s0, s_ok0) = lanes[0]
            (t1, t_ok1), (s1, s_ok1) = lanes[1]
            t_keys = (t0 << 32) | (t1 & 0xFFFFFFFF)
            s_keys = (s0 << 32) | (s1 & 0xFFFFFFFF)
            t_ok = t_ok0 & t_ok1
            s_ok = s_ok0 & s_ok1
        budget_s = None
        if str(conf.get("delta.tpu.merge.devicePath.mode", "auto")) == "auto":
            from delta_tpu_torch.parallel import link

            budget_s = (len(t_keys) + len(s_keys)) * link.constant("HOST_JOIN_S_PER_ROW")
        return join_kernel.inner_join_async(t_keys, t_ok, s_keys, s_ok, mesh=self._state_mesh(),
                                            budget_s=budget_s, device=self.delta_log.device)

    def _state_mesh(self):
        """The default state mesh when it has several entries (the upload
        join then runs K13 over it), else None."""
        from delta_tpu_torch.parallel.mesh import state_mesh

        mesh = state_mesh(device=self.delta_log.device)
        return mesh if len(mesh) > 1 else None

    def _check_star_coverage(self, target_cols: Sequence[str], src_cols: Sequence[str],
                             typ: str, metadata) -> None:
        """Star clauses resolve every target column against the source,
        generated columns aside (they are computed), unless schema evolution
        is on (the star then expands over the source's columns)."""
        if conf.get_bool("delta.tpu.schema.autoMerge.enabled", False):
            return
        src_low = {s.lower() for s in src_cols}
        gen = generated_mod.generated_column_names(metadata.schema)
        missing = [c for c in target_cols if c.lower() not in src_low and c.lower() not in gen]
        if missing:
            raise errors_mod.merge_clause_unresolvable(missing[0], typ, src_cols)

    def _check_multi_match(self, pairs: HostTable) -> None:
        """Error when a target row matches several source rows, unless the
        merge is a single unconditional DELETE (`:351-365`)."""
        single_delete = (len(self.matched_clauses) == 1
                         and self.matched_clauses[0].kind == "delete"
                         and self.matched_clauses[0].condition is None)
        msg = ("Cannot perform Merge as multiple source rows matched and attempted to modify "
               "the same target row in the Delta table in possibly conflicting ways.")
        if self._device_join is not None:
            if not single_delete and self._device_join.any_multi:
                raise DeltaUnsupportedOperationError(msg)
            return
        if pairs.num_rows == 0 or single_delete:
            return
        tids = pairs.column(_TID).values
        if len(np.unique(tids)) < len(tids):
            raise DeltaUnsupportedOperationError(msg)

    # -- clause application ------------------------------------------------

    def _apply_matched(self, pairs: HostTable, target_cols: List[str], metadata,
                       dv_mode: bool = False):
        """Matched block: rows claimed by update clauses are projected, by
        delete clauses dropped, unclaimed pairs copy the target row.
        ``dv_mode``: unclaimed pairs stay in their files, and the 5th value
        is a (file id, physical position) table of the claimed rows."""
        if pairs.num_rows == 0 or not self.matched_clauses:
            return None, 0, 0, 0, None, set()
        n = pairs.num_rows
        unclaimed = np.ones(n, bool)
        out_parts: List[HostTable] = []
        n_updated = n_deleted = 0
        for clause in self.matched_clauses:
            if clause.condition is None:
                fire = unclaimed.copy()
            else:
                cond = self._resolve_in_pairs(clause.condition, pairs)
                fire = unclaimed & boolean_mask(cond, pairs)
            count = int(fire.sum())
            if count:
                block = pairs.filter(fire)
                if clause.kind == "update":
                    projected = self._project_update(block, clause, target_cols, metadata)
                    out_parts.append(projected)
                    if self._use_cdf:
                        self._cdf_blocks += [("update_preimage", block.select(target_cols)),
                                             ("update_postimage", projected)]
                    n_updated += count
                else:
                    # distinct target ROWS: a single unconditional DELETE may
                    # legally multi-match (and the feed has one row a target row)
                    tids, first = np.unique(block.column(_TID).values, return_index=True)
                    if self._use_cdf:
                        self._cdf_blocks.append(
                            ("delete", block.take(np.sort(first)).select(target_cols)))
                    n_deleted += len(tids)
            unclaimed &= ~fire
        claimed_pairs = pairs.filter(~unclaimed)
        # files with at least one FIRED row: only these are rewritten
        fired_fids: set = (set(np.unique(claimed_pairs.column(_FID).values).tolist())
                           if claimed_pairs.num_rows else set())
        claimed_tbl = None
        if dv_mode:
            claimed_tbl = claimed_pairs.select([_FID, POSITION_COL])
            n_rest = 0
        else:
            # unclaimed matched pairs copy the target row, but only out of
            # files being rewritten
            rest = pairs.filter(unclaimed)
            if rest.num_rows:
                rest = rest.filter(np.isin(rest.column(_FID).values,
                                           np.array(sorted(fired_fids), np.int64)))
            if rest.num_rows:
                out_parts.append(rest.select(target_cols))
            n_rest = rest.num_rows
        out = concat_tables(out_parts) if out_parts else None
        return out, n_updated, n_deleted, n_rest, claimed_tbl, fired_fids

    def _resolve_in_pairs(self, e: ir.Expression, pairs: HostTable) -> ir.Expression:
        src_cols = [c[len(_SRC):] for c in pairs.column_names if c.startswith(_SRC)]
        tgt_cols = [c for c in pairs.column_names
                    if not c.startswith("__") and not c.startswith(_SRC)]
        return self._resolve(e, tgt_cols, src_cols)

    def _project_update(self, block: HostTable, clause: MergeClause, target_cols: List[str],
                        metadata) -> HostTable:
        src_cols = [c[len(_SRC):] for c in block.column_names if c.startswith(_SRC)]
        if clause.is_star:
            # updateAll: SET t.c = s.c (star coverage checked in _body)
            assignments = {
                c: ir.Column(_SRC + next(s for s in src_cols if s.lower() == c.lower()))
                for c in target_cols if any(s.lower() == c.lower() for s in src_cols)}
        else:
            assignments = {col.split(".")[-1]: self._resolve_in_pairs(e, block)
                           for col, e in clause.assignments.items()}
        declared = {f.name: schema_utils.stored_type_for(f.data_type)
                    for f in metadata.schema.fields}
        cols = {}
        for c in target_cols:
            e = next((v for k, v in assignments.items() if k.lower() == c.lower()), None)
            if e is None:
                cols[c] = block.column(c)
            else:
                # cast to the SCHEMA's declared type: with the projection
                # pushed down the assigned target column is not decoded
                cols[c] = cast_column(evaluate(e, block), *declared[c])
        # a generated column whose base columns were assigned is recomputed
        return generated_mod.recompute_stale(HostTable(cols, block.num_rows), metadata.schema,
                                             list(assignments))

    def _apply_not_matched(self, pairs: HostTable, src: HostTable, target_cols: List[str],
                           source_cols: List[str], metadata):
        if not self.not_matched_clauses:
            return None, 0
        if self._device_join is not None:
            # the device route computed per-source matched flags (exact: it
            # requires no residual)
            unmatched = src.filter(~self._device_join.s_matched)
        elif pairs.num_rows:
            seen = np.zeros(src.num_rows, bool)
            seen[pairs.column(_SID).values] = True
            unmatched = src.filter(~seen)
        else:
            unmatched = src
        if unmatched.num_rows == 0:
            return None, 0
        unclaimed = np.ones(unmatched.num_rows, bool)
        parts: List[HostTable] = []
        n_inserted = 0
        for clause in self.not_matched_clauses:
            if clause.condition is None:
                fire = unclaimed.copy()
            else:
                cond = self._resolve(clause.condition, [], source_cols)
                fire = unclaimed & boolean_mask(cond, unmatched)
            count = int(fire.sum())
            if count:
                block = unmatched.filter(fire)
                if clause.is_star:
                    assignments = {
                        c: ir.Column(_SRC + next(s for s in source_cols
                                                 if s.lower() == c.lower()))
                        for c in target_cols if any(s.lower() == c.lower()
                                                    for s in source_cols)}
                else:
                    assignments = {col.split(".")[-1]: self._resolve(e, [], source_cols)
                                   for col, e in clause.assignments.items()}
                gen_cols = generated_mod.generated_column_names(metadata.schema)
                cols = {}
                for f in metadata.schema.fields:
                    e = next((v for k, v in assignments.items()
                              if k.lower() == f.name.lower()), None)
                    kind, stype = schema_utils.stored_type_for(f.data_type)
                    if e is None and f.name.lower() in gen_cols:
                        continue  # computed from the built row, not NULL
                    cols[f.name] = (null_column(block.num_rows, kind, stype) if e is None
                                    else cast_column(evaluate(e, block), kind, stype))
                part = generated_mod.compute_on_write(HostTable(cols, block.num_rows),
                                                      metadata.schema)
                parts.append(part.select(target_cols))
                n_inserted += count
            unclaimed &= ~fire
        out = concat_tables(parts) if parts else None
        return out, n_inserted
