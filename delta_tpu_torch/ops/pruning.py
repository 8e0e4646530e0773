"""File pruning for a scan: partition filters, then min/max data skipping.

The port's own copy of ``delta_tpu.ops.pruning``. A data predicate is
rewritten into a *can-match* predicate over per-file stats columns
(``min.c`` / ``max.c`` / ``nullCount.c`` / ``numRecords``) by the base
rules of :func:`skipping_predicate` and, where they cannot exclude
anything, by predicate synthesis (``expr/synthesis``). Then:

* the resident leg (:func:`_resident_scan`): when the rewrite lowers
  EXACTLY to range boxes, the scan plans on the table's resident lanes
  (``ops/state_cache``: one block-cull launch, then the exact host fine
  pass) and only the surviving files materialize as AddFiles;
* otherwise the normal leg: every file materializes, partition predicates
  evaluate per file, and :func:`prune_files` evaluates the rewrite — on the
  card from :data:`DEVICE_PRUNING_MIN_FILES` files up (``_prune_device``,
  the K15 interpreter over ``files_to_arrays`` lanes), else on the host
  (``_prune_host``, numpy over ``stats_table``). A rewrite the device
  program cannot express goes to the host too.

Conservativeness invariant: a file is dropped only when the rewritten
predicate is *definitely False*; NULL (missing stats) keeps the file. Kleene
logic gives this: False AND unknown = False, False OR unknown = unknown.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache
from typing import List, Optional, Sequence

import numpy as np
import torch

from delta_tpu_torch.expr import ir
from delta_tpu_torch.expr import partition as partition_expr
from delta_tpu_torch.expr import synthesis
from delta_tpu_torch.ops import state_export
from delta_tpu_torch.protocol.actions import AddFile, Metadata
from delta_tpu_torch.schema.types import DoubleType, FloatType
from delta_tpu_torch.utils.config import conf

__all__ = ["DataSize", "DeltaScan", "skipping_predicate", "ConjunctRewrite",
           "conjunct_rewrites", "schema_types", "prune_files", "files_for_scan",
           "DEVICE_PRUNING_MIN_FILES"]

#: From this many candidate files the skipping predicate evaluates on the
#: card; below it the host evaluator finishes first (the default of
#: ``delta.tpu.device.pruning.minFiles``, as in the JAX package).
DEVICE_PRUNING_MIN_FILES = 4096

schema_types = synthesis.schema_types


@dataclass
class DataSize:
    bytes_compressed: Optional[int] = None
    rows: Optional[int] = None
    files: Optional[int] = None


@dataclass
class DeltaScan:
    """Result of file pruning (shape of `stats/DeltaScan.scala:29-61`)."""

    version: int
    files: List[AddFile]
    total: DataSize
    partition: DataSize
    scanned: DataSize
    partition_filters: List[ir.Expression] = field(default_factory=list)
    data_filters: List[ir.Expression] = field(default_factory=list)


def _min(c: str) -> ir.Expression:
    return ir.Column(f"min.{c}")


def _max(c: str) -> ir.Expression:
    return ir.Column(f"max.{c}")


def _nulls(c: str) -> ir.Expression:
    return ir.Column(f"nullCount.{c}")


_UNKNOWN = ir.Literal(None)

#: NOT pushdown flips (`Not(Lt)` == `Ge`, ...). Over floating columns the
#: inequality flips are not equivalent (a NaN row fails every comparison,
#: and min/max stats ignore NaN), so they fire only when every referenced
#: column is non-floating; `Not(Ne)` == `Eq` is safe either way.
_NOT_FLIP = {ir.Lt: ir.Ge, ir.Le: ir.Gt, ir.Gt: ir.Le, ir.Ge: ir.Lt, ir.Ne: ir.Eq}
_FLIP = {ir.Lt: ir.Gt, ir.Le: ir.Ge, ir.Gt: ir.Lt, ir.Ge: ir.Le, ir.Eq: ir.Eq}


def _not_flip_safe(c: ir.Expression, types) -> bool:
    if type(c) is ir.Ne:
        return True
    if types is None:
        return False
    return not any(isinstance(types.get(col.lower()), (FloatType, DoubleType))
                   for col in ir.references(c))


def skipping_predicate(
    e: ir.Expression, partition_cols: frozenset = frozenset(),
    types=None, synthesize: Optional[bool] = None,
) -> ir.Expression:
    """Rewrite a data predicate into a can-match predicate over stats
    columns; ``Literal(None)`` (= keep) for shapes nothing covers.
    Partition-column predicates pass through unchanged (they evaluate
    exactly per file); a partition column mixed with data columns rewrites
    to UNKNOWN. ``types`` (lowercased column name -> DataType) arms the NOT
    flips and the synthesis fallback; ``synthesize=False`` keeps to the
    base rules even with types."""

    def _is_part(col: ir.Expression) -> bool:
        return isinstance(col, ir.Column) and col.name.lower() in partition_cols

    def rec(x: ir.Expression) -> ir.Expression:
        return skipping_predicate(x, partition_cols, types, synthesize)

    t = type(e)
    if t is ir.And or t is ir.Or:
        return t(rec(e.left), rec(e.right))
    if t is ir.Not:
        c = e.child
        if isinstance(c, ir.IsNull):
            return rec(ir.IsNotNull(c.child))
        if isinstance(c, ir.IsNotNull):
            return rec(ir.IsNull(c.child))
        if all(col.lower() in partition_cols for col in ir.references(c)):
            return e  # exact per-file partition verdict, negation included
        if isinstance(c, ir.Not):
            return rec(c.child)
        tc = type(c)
        if tc in _NOT_FLIP and _not_flip_safe(c, types):
            return rec(_NOT_FLIP[tc](c.left, c.right))
        if tc is ir.And:  # De Morgan: each side rewrites conservatively
            return rec(ir.Or(ir.Not(c.left), ir.Not(c.right)))
        if tc is ir.Or:
            return rec(ir.And(ir.Not(c.left), ir.Not(c.right)))
        return _synth_fallback(e, partition_cols, types, synthesize)
    if any(_is_part(c) for c in getattr(e, "children", ())):
        if all(col.lower() in partition_cols for col in ir.references(e)):
            return e
        return _UNKNOWN
    if t in _FLIP:
        left, right = e.left, e.right
        if isinstance(left, ir.Literal) and isinstance(right, ir.Column):
            e = _FLIP[t](right, left)
            t = type(e)
            left, right = e.left, e.right
        if not (isinstance(left, ir.Column) and isinstance(right, ir.Literal)):
            return _synth_fallback(e, partition_cols, types, synthesize)
        c, lit = left.name, right
        if lit.value is None:
            return ir.Literal(False)  # col <op> NULL matches nothing
        if t is ir.Eq:
            return ir.And(ir.Le(_min(c), lit), ir.Ge(_max(c), lit))
        if t is ir.Lt:
            return ir.Lt(_min(c), lit)
        if t is ir.Le:
            return ir.Le(_min(c), lit)
        if t is ir.Gt:
            return ir.Gt(_max(c), lit)
        return ir.Ge(_max(c), lit)
    if t is ir.In and isinstance(e.value, ir.Column):
        opts = [o for o in e.options if isinstance(o, ir.Literal) and o.value is not None]
        if len(opts) != len(e.options):
            return _UNKNOWN
        out: Optional[ir.Expression] = None
        for o in opts:
            one = rec(ir.Eq(e.value, o))
            out = one if out is None else ir.Or(out, one)
        return out if out is not None else ir.Literal(False)
    if t is ir.IsNull and isinstance(e.child, ir.Column):
        return ir.Gt(_nulls(e.child.name), ir.Literal(0))
    if t is ir.IsNotNull and isinstance(e.child, ir.Column):
        return ir.Lt(_nulls(e.child.name), ir.Column("numRecords"))
    if t is ir.StartsWith and isinstance(e.left, ir.Column) and isinstance(e.right, ir.Literal):
        p = e.right.value
        if isinstance(p, str) and p:
            c = e.left.name
            lower = ir.Ge(_max(c), ir.Literal(p))  # some value >= the prefix
            hi = _prefix_upper_bound(p)
            if hi is None:
                return lower
            # every string with prefix p is strictly < hi
            return ir.And(ir.Lt(_min(c), ir.Literal(hi)), lower)
    return _synth_fallback(e, partition_cols, types, synthesize)


def _synth_fallback(e: ir.Expression, partition_cols: frozenset, types,
                    synthesize: Optional[bool]) -> ir.Expression:
    """Hand a leaf the base rules cannot lower to predicate synthesis, when
    armed (types known and ``synthesize`` not False)."""
    if types is None or synthesize is False:
        return _UNKNOWN
    return synthesis.synthesize(
        e, partition_cols, types, base=lambda x: skipping_predicate(x, partition_cols))


def _prefix_upper_bound(p: str) -> Optional[str]:
    """Smallest string greater than every string with prefix ``p`` (in
    code-point order): bump the last bumpable char. None = unbounded."""
    chars = list(p)
    while chars:
        cp = ord(chars[-1])
        if cp < 0x10FFFF:
            nxt = cp + 1
            if 0xD800 <= nxt <= 0xDFFF:  # skip the surrogate block
                nxt = 0xE000
            chars[-1] = chr(nxt)
            return "".join(chars)
        chars.pop()
    return None


@dataclass
class ConjunctRewrite:
    """One conjunct's skipping rewrite: ``attempted`` when the base rules
    could not exclude on this shape (so synthesis was consulted),
    ``synthesized`` when synthesis produced a rewrite that can, ``family``
    its rewrite family (arithmetic / string / cast / ...)."""

    conjunct: ir.Expression
    rewritten: ir.Expression
    attempted: bool = False
    synthesized: bool = False
    family: Optional[str] = None


def conjunct_rewrites(filters: Sequence[ir.Expression], partition_cols: frozenset,
                      types) -> List[ConjunctRewrite]:
    """Per-conjunct skipping rewrites; their AND equals
    ``skipping_predicate(and_all(filters), ..., types)``."""
    out: List[ConjunctRewrite] = []
    for f in filters:
        for c in ir.split_conjuncts(f):
            base_rw = skipping_predicate(c, partition_cols, types, synthesize=False)
            if synthesis.can_exclude(base_rw) or types is None:
                out.append(ConjunctRewrite(c, base_rw))
                continue
            rw = skipping_predicate(c, partition_cols, types)
            ok = synthesis.can_exclude(rw)
            out.append(ConjunctRewrite(
                c, rw, attempted=True, synthesized=ok,
                family=synthesis.classify_family(c) if ok else None))
    return out


def _prune_host(files: Sequence[AddFile], metadata: Metadata, pred: ir.Expression) -> np.ndarray:
    """The keep mask by the host evaluator over ``stats_table``. Building
    the table raises where the stats mix types no column holds (as the JAX
    package's ``from_pylist`` does); an error while evaluating keeps every
    file."""
    from delta_tpu_torch.expr.vectorized import evaluate, to_keep_mask

    table = state_export.stats_table(files, metadata)
    try:
        return to_keep_mask(evaluate(pred, table))
    except Exception:  # noqa: BLE001 — a stats/type surprise (foreign stats
        # that contradict the declared schema under a synthesized rewrite,
        # a row the exact evaluator refuses) degrades to keep-everything,
        # never fails the scan, as in the JAX package
        return np.ones(len(files), bool)


@lru_cache(maxsize=256)
def _compiled_skipping(pred: ir.Expression):
    """The compiled skipping predicate, cached per expression so repeat
    scans reuse its lowered programs."""
    from delta_tpu_torch.expr.device_eval import compile_expr

    return compile_expr(pred)


def _prune_device(arrays: state_export.FileStateArrays, pred: ir.Expression,
                  device="cuda") -> Optional[np.ndarray]:
    """The keep mask by the K15 interpreter over the lanes on ``device``;
    None when the rewrite has no device program (the caller takes the host
    evaluator, as the JAX package does where its trace fails). Errors of
    the build or launch propagate."""
    from delta_tpu_torch.expr.device_eval import NotDeviceCompilable, expr_eval

    try:
        program = _compiled_skipping(pred).program_for(arrays.lane_dtypes())
    except NotDeviceCompilable:
        return None
    col = expr_eval(program, arrays.device_env(device, names=program.columns))
    keep = (col.values.to(torch.bool) | ~col.valid).cpu().numpy()
    if keep.ndim == 0:
        keep = np.full(arrays.num_files, bool(keep))
    return keep


def prune_files(files: Sequence[AddFile], metadata: Metadata,
                data_filters: Sequence[ir.Expression], device="cuda") -> List[AddFile]:
    """Apply min/max skipping; returns the files that may contain matches.
    From :data:`DEVICE_PRUNING_MIN_FILES` candidates the rewrite evaluates
    on ``device``, below it (or when it has no device program) on the
    host."""
    if not files or not data_filters:
        return list(files)
    pcols = frozenset(c.lower() for c in metadata.partition_columns)
    rewrites = conjunct_rewrites(list(data_filters), pcols, schema_types(metadata))
    pred = ir.and_all([r.rewritten for r in rewrites])
    keep: Optional[np.ndarray] = None
    if len(files) >= int(conf.get("delta.tpu.device.pruning.minFiles", DEVICE_PRUNING_MIN_FILES)):
        keep = _prune_device(state_export.files_to_arrays(files, metadata), pred, device)
    if keep is None:
        keep = _prune_host(files, metadata, pred)
    return [f for f, k in zip(files, keep) if k]


def _resident_scan(snapshot, partition_filters: Sequence[ir.Expression],
                   data_filters: Sequence[ir.Expression]) -> Optional[DeltaScan]:
    """Serve a scan from the resident state cache (``ops/state_cache``):
    only the surviving files materialize as AddFiles. Taken only when the
    range lowering is EXACT, so the result matches the evaluator file for
    file; None sends the scan to the normal leg."""
    if getattr(snapshot, "delta_log", None) is None:
        return None  # a bare snapshot shim has no resident state
    from delta_tpu_torch.ops.state_cache import DeviceStateCache, extract_range_union

    entry = DeviceStateCache.instance().get(snapshot)
    if entry is None:
        return None
    pcols = frozenset(c.lower() for c in snapshot.metadata.partition_columns)
    rewrites = conjunct_rewrites(list(partition_filters) + list(data_filters), pcols,
                                 schema_types(snapshot.metadata))
    pred = ir.and_all([r.rewritten for r in rewrites])
    terms = extract_range_union(pred, entry.columns, entry.part_info,
                                str_lanes=entry.str_lanes)
    if not terms or not all(t.exact for t in terms):
        return None
    n_main = len(terms)
    if partition_filters and data_filters:
        # partition-only leg on the same lanes, for the partition DataSize
        ppred = skipping_predicate(ir.and_all(list(partition_filters)), pcols)
        pterms = extract_range_union(ppred, entry.columns, entry.part_info,
                                     str_lanes=entry.str_lanes)
        if not pterms or not all(t.exact for t in pterms):
            return None
        terms = terms + pterms
    plans = entry.plan_ranges(terms, k=max(entry.num_rows, 1),
                              expected_version=snapshot.version)
    if plans is None:
        return None

    def _union(chunk):
        if len(chunk) == 1:
            return chunk[0].rows
        return np.unique(np.concatenate([p.rows for p in chunk]))

    rows = _union(plans[:n_main])
    kept = snapshot.files_for_paths([entry.paths[i] for i in rows])
    alive = entry.h_alive[: entry.num_rows]
    sizes = entry.h_size[: entry.num_rows]
    total = DataSize(bytes_compressed=int(sizes[alive].sum()), files=int(alive.sum()))
    if partition_filters:
        prows = _union(plans[n_main:]) if data_filters else rows
        partition = DataSize(bytes_compressed=int(sizes[prows].sum()), files=len(prows))
    else:
        partition = total  # unpartitioned: nothing pruned by partition
    return DeltaScan(
        version=snapshot.version,
        files=kept,
        total=total,
        partition=partition,
        scanned=DataSize(
            bytes_compressed=sum(f.size or 0 for f in kept),
            files=len(kept),
            rows=sum(f.num_logical_records or 0 for f in kept) or None,
        ),
        partition_filters=list(partition_filters),
        data_filters=list(data_filters),
    )


def files_for_scan(snapshot, filters: Sequence[ir.Expression] = (),
                   keep_num_indexed_cols: Optional[int] = None) -> DeltaScan:
    """Partition-prune then stats-prune the snapshot's files for a query
    (`PartitionFiltering.scala:27-42` plus the skipping path). A predicate
    that lowers exactly serves from the resident state; any other goes
    through every AddFile, with the skipping rewrite evaluated on the
    table's device from :data:`DEVICE_PRUNING_MIN_FILES` files up.
    ``keep_num_indexed_cols`` is accepted as the JAX package accepts it,
    and unused there too."""
    from delta_tpu_torch.schema.char_varchar import pad_char_literals

    metadata = snapshot.metadata
    # read-side char padding: literals compared to char(n) columns pad to
    # width, so they match the stored padded form
    filters = [pad_char_literals(f, metadata) for f in filters]
    part_schema = metadata.partition_schema
    part_cols = metadata.partition_columns
    partition_filters: List[ir.Expression] = []
    data_filters: List[ir.Expression] = []
    for f in filters:
        for conj in ir.split_conjuncts(f):
            if partition_expr.is_partition_predicate(conj, part_cols):
                partition_filters.append(conj)
            else:
                data_filters.append(conj)
    if data_filters or partition_filters:
        fast = _resident_scan(snapshot, partition_filters, data_filters)
        if fast is not None:
            return fast

    all_files = snapshot.all_files
    total = DataSize(bytes_compressed=sum(f.size or 0 for f in all_files), files=len(all_files))
    if partition_filters:
        pred = ir.and_all(partition_filters)
        # a NULL partition verdict is constant for the whole file: no row in
        # it can satisfy the WHERE clause, so it is pruned
        after_part = [f for f in all_files if partition_expr.matches(pred, f, part_schema)]
    else:
        after_part = list(all_files)
    partition = DataSize(bytes_compressed=sum(f.size or 0 for f in after_part),
                         files=len(after_part))
    delta_log = getattr(snapshot, "delta_log", None)
    device = delta_log.device if delta_log is not None else "cuda"
    kept = prune_files(after_part, metadata, data_filters, device=device)
    return DeltaScan(
        version=snapshot.version,
        files=kept,
        total=total,
        partition=partition,
        scanned=DataSize(
            bytes_compressed=sum(f.size or 0 for f in kept),
            files=len(kept),
            rows=sum(f.num_logical_records or 0 for f in kept) or None,
        ),
        partition_filters=partition_filters,
        data_filters=data_filters,
    )
