"""Evaluate expressions over device-resident columns: the port's counterpart
of ``delta_tpu.expr.jaxeval`` (``compile_expr``, ``DeviceColumn``,
``NotDeviceCompilable``, ``columns_from_numpy``).

Columns are SoA pairs ``(values, valid)``: a numeric or bool lane tensor and
a validity mask (NULL = invalid lane). The JAX package traces the tree into
``jnp`` ops that XLA fuses; here :func:`compile_expr` does the type
inference on the host and lowers the tree to a flat typed program — a few
dozen instructions over virtual registers, literals in a table — that ONE
hand-written CUDA kernel (K15, :func:`expr_eval`) interprets on the
residual mask K14's tile body (``csrc/residual_mask.cu``): a CTA a tile of
rows, the register file in shared memory, each register a (value, valid)
pair, each instruction decoded once a tile. No code is generated or
compiled per expression. :func:`expr_eval_plain`
interprets the same program with torch ops; it is taken only for tensors
on the CPU, and the card holds the kernel against it bit for bit.

Semantics are the JAX package's under x64, value for value:

* literals are int32 when they fit, else int64; float64; bool; NULL is an
  invalid float32 zero. Mixed operands promote on the lattice
  bool < int32 < int64 < float32 < float64 (int64 + float32 is float32);
* integer arithmetic wraps at the result width; bool + is OR, bool * is
  AND, bool - and unary minus of a bool do not lower (JAX refuses them);
* float -> int casts saturate and NaN gives 0 (XLA's rule);
* ``x / y`` divides in float64 and is NULL where y is 0; ``sqrt`` and
  ``log`` are NULL outside their domain, ``log`` clamps at 1e-300;
* ``hour``/``minute``/``second`` are Python-style floor division and mod
  by constants that take the operand's type (int32 wraps them);
* ``IN`` is NULL where not found and some option is NULL in ANY row (the
  option's validity reduces over all rows), so the kernel makes a launch
  per nesting level to reduce it before the launch that writes the
  output; a program lowered with
  ``row_in=True`` (the residual filter's, :func:`compile_residual`) takes
  each option's validity in its own row instead, which is the host
  evaluator's semantics (see ``ops/column_cache``);
* AND/OR are Kleene.

What the JAX package cannot trace (strings, LIKE, other functions, other
casts, an unbound column) raises :class:`NotDeviceCompilable` here, at
lowering, and the caller evaluates on the host instead.

:func:`compile_residual` is the counterpart of ``jaxeval.compile_residual``:
it rewrites a scan's residual predicate for lanes decoded from data files
(strings as dictionary codes, dates as epoch days, timestamps as epoch
microseconds) and adds the calendar nodes ``__ts_days`` and
``__{year,month,day}_days``, which lower to the opcodes TSDAYS and CIVIL.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from delta_tpu_torch.expr import ir
from delta_tpu_torch.ops import native
from delta_tpu_torch.utils.errors import DeltaAnalysisError

__all__ = ["DeviceColumn", "NotDeviceCompilable", "columns_from_numpy", "Program",
           "lower", "compile_expr", "expr_eval", "expr_eval_plain", "STR_CODE_ABSENT",
           "ResidualPlan", "compile_residual", "lane_dtypes"]


class NotDeviceCompilable(DeltaAnalysisError):
    """The expression cannot be lowered to the device program (the caller
    evaluates it on the host)."""


class DeviceColumn(NamedTuple):
    """One SoA column: lane values + validity mask (True = non-NULL)."""

    values: torch.Tensor
    valid: torch.Tensor

    @staticmethod
    def of(values, valid=None, *, device) -> "DeviceColumn":
        """A column on ``device`` (required: nothing picks the CPU for the
        caller)."""
        v = torch.as_tensor(np.asarray(values) if not torch.is_tensor(values) else values)
        v = v.to(device)
        ok = torch.ones(v.shape, dtype=torch.bool, device=v.device) if valid is None else \
            torch.as_tensor(np.asarray(valid, bool) if not torch.is_tensor(valid) else valid
                            ).to(device=v.device, dtype=torch.bool)
        return DeviceColumn(v, ok)


Env = Dict[str, DeviceColumn]


def columns_from_numpy(data: Dict[str, np.ndarray],
                       masks: Optional[Dict[str, np.ndarray]] = None, *, device) -> Env:
    """A device env from host numpy columns on ``device`` (required)."""
    masks = masks or {}
    return {k: DeviceColumn.of(v, masks.get(k), device=device) for k, v in data.items()}


# -- the program ----------------------------------------------------------------

# dtypes of registers, literals and columns (the kernel's `Dt`)
BOOL, I32, I64, F32, F64 = range(5)
_TORCH = {BOOL: torch.bool, I32: torch.int32, I64: torch.int64, F32: torch.float32,
          F64: torch.float64}
_FROM_TORCH = {v: k for k, v in _TORCH.items()}

# opcodes (the kernel's `Op`; tests/test_torch_device_eval.py holds the two
# tables equal)
OPS = ("LIT", "COL", "CAST", "ADD", "SUB", "MUL", "DIV", "NEG", "EQ", "NE", "LT", "LE",
       "GT", "GE", "AND", "OR", "NOT", "ISNULL", "ISNOTNULL", "NSEQ", "INSTEP", "FLAGALL",
       "INFIN", "COALESCE", "CASESTEP", "ABS", "FLOOR", "CEIL", "EXP", "SQRT", "LOG", "POW",
       "TIMEFIELD", "TSDAYS", "CIVIL", "INROW")
OP = {name: i for i, name in enumerate(OPS)}
#: the opcodes only a residual program (``compile_residual``, ``row_in``)
#: holds: the calendar nodes and the per-row IN
RESIDUAL_OPS = ("TSDAYS", "CIVIL", "INROW")

#: physical registers and instructions the kernel holds (its register file
#: in shared memory, its tables); a program needing more does not lower
MAX_REGS = 64
MAX_INSTRS = 1024

_CMP_OPS = {ir.Eq: "EQ", ir.Ne: "NE", ir.Lt: "LT", ir.Le: "LE", ir.Gt: "GT", ir.Ge: "GE"}
_ARITH_OPS = {ir.Add: "ADD", ir.Sub: "SUB", ir.Mul: "MUL"}


def _promote(a: int, b: int) -> int:
    """JAX's x64 promotion on {bool, i32, i64, f32, f64}: the larger in
    that order (an int with a float takes the float's width)."""
    return max(a, b)


@dataclass
class Program:
    """A lowered expression. ``instrs`` is (n, 8) int32: op, dtype, dst, a,
    b, c, imm, imm2. ``lits`` holds each literal's bits as int64 (float32
    in the low 32 bits), ``lit_valid`` its validity. ``columns`` names the
    env columns the COL instructions index, ``col_dtypes`` their dtypes.
    ``scalar`` when no column is read (the result is 0-d). ``passes`` is 1
    plus the deepest IN nesting that reduces an option's validity;
    ``n_flags`` the flags those reductions fill. ``scalar_slots`` maps each
    per-launch scalar (a name lowered with ``scalars=``) to the literal
    slot the caller fills before each launch."""

    instrs: np.ndarray
    lits: np.ndarray
    lit_valid: np.ndarray
    columns: List[str]
    col_dtypes: List[int]
    root: int
    root_dtype: int
    n_regs: int
    n_flags: int
    passes: int
    scalar: bool
    scalar_slots: Dict[str, int] = None

    def opcodes(self) -> List[str]:
        return [OPS[i] for i in self.instrs[:, 0].tolist()]


class _Lowering:
    def __init__(self, col_dtypes: Dict[str, torch.dtype], row_in: bool = False,
                 scalars: Optional[Dict[str, int]] = None):
        self.env_dtypes = col_dtypes
        self.row_in = row_in
        self.scalars = scalars or {}
        self.scalar_slots: Dict[str, int] = {}
        self.code: List[List[int]] = []
        self.lits: List[Tuple[int, bool]] = []
        self.lit_index: Dict[Tuple[int, int, bool], int] = {}
        self.columns: List[str] = []
        self.col_dt: List[int] = []
        self.n_vregs = 0
        self.n_flags = 0
        self.max_level = 0
        self.scalar = True

    # emission -------------------------------------------------------------
    def emit(self, op: str, dt: int, a=-1, b=-1, c=-1, imm=0, imm2=0, dst=True) -> int:
        r = -1
        if dst:
            r = self.n_vregs
            self.n_vregs += 1
        self.code.append([OP[op], dt, r, a, b, c, imm, imm2])
        return r

    def slot(self, dt: int, bits: int, valid: bool = True) -> int:
        """The literal table's index of a constant."""
        key = (dt, bits, valid)
        if key not in self.lit_index:
            self.lit_index[key] = len(self.lits)
            self.lits.append((bits, valid))
        return self.lit_index[key]

    def lit(self, dt: int, bits: int, valid: bool = True) -> int:
        return self.emit("LIT", dt, imm=self.slot(dt, bits, valid))

    def cast(self, reg: Tuple[int, int], dt: int) -> int:
        r, s = reg
        return r if s == dt else self.emit("CAST", dt, a=r, imm=s)

    # lowering -------------------------------------------------------------
    def lower(self, e: ir.Expression) -> Tuple[int, int]:
        """(virtual register, dtype) of ``e``'s value."""
        t = type(e)
        if t is ir.Literal:
            return self._literal(e.value)
        if t is ir.Column:
            return self._column(e.name)
        if t is ir.Alias:
            return self.lower(e.child)
        if t in _ARITH_OPS:
            l, r = self.lower(e.left), self.lower(e.right)
            dt = _promote(l[1], r[1])
            if dt == BOOL and t is ir.Sub:
                raise NotDeviceCompilable(f"bool subtraction: {e.sql()}")
            return self.emit(_ARITH_OPS[t], dt, self.cast(l, dt), self.cast(r, dt)), dt
        if t in _CMP_OPS:
            l, r = self.lower(e.left), self.lower(e.right)
            dt = _promote(l[1], r[1])
            return self.emit(_CMP_OPS[t], dt, self.cast(l, dt), self.cast(r, dt)), BOOL
        if t is ir.And or t is ir.Or:
            l, r = self.lower(e.left), self.lower(e.right)
            return self.emit("AND" if t is ir.And else "OR", BOOL,
                             self.cast(l, BOOL), self.cast(r, BOOL)), BOOL
        if t is ir.Div:
            l, r = self.lower(e.left), self.lower(e.right)
            return self.emit("DIV", F64, self.cast(l, F64), self.cast(r, F64)), F64
        if t is ir.Not:
            c = self.lower(e.child)
            return self.emit("NOT", BOOL, self.cast(c, BOOL)), BOOL
        if t is ir.Neg:
            c = self.lower(e.child)
            if c[1] == BOOL:
                raise NotDeviceCompilable(f"negation of a bool: {e.sql()}")
            return self.emit("NEG", c[1], c[0]), c[1]
        if t is ir.IsNull or t is ir.IsNotNull:
            c = self.lower(e.child)
            return self.emit("ISNULL" if t is ir.IsNull else "ISNOTNULL", BOOL, c[0]), BOOL
        if t is ir.NullSafeEq:
            l, r = self.lower(e.left), self.lower(e.right)
            dt = _promote(l[1], r[1])
            return self.emit("NSEQ", dt, self.cast(l, dt), self.cast(r, dt)), BOOL
        if t is ir.In:
            return self._in(e)
        if t is ir.Coalesce:
            outs = [self.lower(c) for c in e.children]
            out = outs[-1]
            for c in reversed(outs[:-1]):
                dt = _promote(c[1], out[1])
                out = self.emit("COALESCE", dt, self.cast(c, dt), self.cast(out, dt)), dt
            return out
        if t is ir.CaseWhen:
            conds = [self.lower(e.children[2 * i]) for i in range(e.n_branches)]
            vals = [self.lower(e.children[2 * i + 1]) for i in range(e.n_branches)]
            out = self.lower(e.children[-1])
            for c, v in zip(reversed(conds), reversed(vals)):
                dt = _promote(v[1], out[1])
                out = self.emit("CASESTEP", dt, self.cast(v, dt), self.cast(out, dt),
                                self.cast(c, BOOL)), dt
            return out
        if t is ir.Cast:
            return self._cast_node(e)
        if t is ir.Func:
            return self._func(e)
        raise NotDeviceCompilable(f"{t.__name__} has no device lowering: {e.sql()}")

    def _literal(self, v: Any) -> Tuple[int, int]:
        if v is None:
            return self.lit(F32, 0, valid=False), F32
        if isinstance(v, bool):
            return self.lit(BOOL, int(v)), BOOL
        if isinstance(v, int):
            if not -(2**63) <= v < 2**63:
                raise NotDeviceCompilable(f"integer literal {v} exceeds int64")
            dt = I32 if -(2**31) <= v < 2**31 else I64
            return self.lit(dt, v), dt
        if isinstance(v, float):
            return self.lit(F64, struct.unpack("<q", struct.pack("<d", v))[0]), F64
        raise NotDeviceCompilable(f"literal {v!r} has no device representation")

    def _column(self, name: str) -> Tuple[int, int]:
        if name in self.scalars:  # a per-launch scalar: its own literal slot
            dt = self.scalars[name]
            if name not in self.scalar_slots:
                self.scalar_slots[name] = len(self.lits)
                self.lits.append((0, False))
            return self.emit("LIT", dt, imm=self.scalar_slots[name]), dt
        key = name if name in self.env_dtypes else name.lower()
        if key not in self.env_dtypes:
            raise NotDeviceCompilable(f"column {name!r} not bound in device env")
        if self.env_dtypes[key] not in _FROM_TORCH:
            raise NotDeviceCompilable(f"column {key!r} has dtype {self.env_dtypes[key]}, "
                                      "not one of bool/int32/int64/float32/float64")
        dt = _FROM_TORCH[self.env_dtypes[key]]
        if key not in self.columns:
            self.columns.append(key)
            self.col_dt.append(dt)
        self.scalar = False
        return self.emit("COL", dt, imm=self.columns.index(key)), dt

    def _in(self, e: ir.In) -> Tuple[int, int]:
        v = self.lower(e.value)
        hit = self.lit(BOOL, 0), BOOL
        first = self.n_flags
        for o in e.options:
            ov = self.lower(o)
            dt = _promote(v[1], ov[1])
            # INSTEP's validity: every option so far is valid in this row
            hit = self.emit("INSTEP", dt, self.cast(v, dt), self.cast(ov, dt), hit[0]), BOOL
            if self.row_in:
                continue
            level = _in_depth(o)
            self.max_level = max(self.max_level, level)
            self.emit("FLAGALL", ov[1], a=ov[0], imm=self.n_flags, imm2=level, dst=False)
            self.n_flags += 1
        if self.row_in:
            return self.emit("INROW", BOOL, hit[0], v[0]), BOOL
        return self.emit("INFIN", BOOL, hit[0], v[0], imm=first,
                         imm2=self.n_flags - first), BOOL

    def _cast_node(self, e: ir.Cast) -> Tuple[int, int]:
        c = self.lower(e.child)
        name = e.data_type.name if not hasattr(e.data_type, "precision") else "decimal"
        if name in ("byte", "short", "integer"):
            dt = I32
        elif name == "long":
            dt = I64
        elif name in ("float", "double", "decimal"):
            dt = F64
        elif name == "boolean":
            dt = BOOL
        else:
            raise NotDeviceCompilable(f"cast to {name} not device-representable")
        return self.cast(c, dt), dt

    def _func(self, e: ir.Func) -> Tuple[int, int]:
        name, kids = e.name, e.children
        if name in ("abs", "floor", "ceil", "exp", "sqrt"):
            c = self.lower(kids[0])
            if name == "exp":
                return self.emit("EXP", F64, self.cast(c, F64)), F64
            if name == "sqrt":
                return self.emit("SQRT", F64, self.cast(c, F64)), F64
            if name == "abs":
                return (c if c[1] == BOOL else (self.emit("ABS", c[1], c[0]), c[1]))
            if c[1] in (F32, F64):  # floor/ceil of an int or bool is itself
                return self.emit(name.upper(), c[1], c[0]), c[1]
            return c
        if name == "log" and len(kids) == 1:
            c = self.lower(kids[0])
            return self.emit("LOG", F64, self.cast(c, F64)), F64
        if name in ("pow", "power") and len(kids) == 2:
            a, b = self.lower(kids[0]), self.lower(kids[1])
            return self.emit("POW", F64, self.cast(a, F64), self.cast(b, F64)), F64
        if name in ("date_add", "date_sub") and len(kids) == 2:
            d, n = self.lower(kids[0]), self.lower(kids[1])
            step = self.cast(n, d[1]), d[1]  # n.astype(d.dtype)
            if step[1] == BOOL:  # a Python int times a bool is int64
                step = self.cast(step, I64), I64
            if name == "date_sub":
                step = self.emit("NEG", step[1], step[0]), step[1]
            dt = _promote(d[1], step[1])
            return self.emit("ADD", dt, self.cast(d, dt), self.cast(step, dt)), dt
        if name == "datediff" and len(kids) == 2:
            a, b = self.lower(kids[0]), self.lower(kids[1])
            dt = _promote(a[1], b[1])
            if dt == BOOL:
                raise NotDeviceCompilable(f"bool subtraction: {e.sql()}")
            return self.emit("SUB", dt, self.cast(a, dt), self.cast(b, dt)), dt
        if name in ("hour", "minute", "second") and len(kids) == 1:
            c = self.lower(kids[0])
            if c[1] == BOOL:  # a bool with a Python int is int64
                c = self.cast(c, I64), I64
            div, mod = {"hour": (3_600_000_000, 24), "minute": (60_000_000, 60),
                        "second": (1_000_000, 60)}[name]
            return self.emit("TIMEFIELD", c[1], c[0], imm=self.slot(c[1], _const_bits(div, c[1])),
                             imm2=self.slot(c[1], _const_bits(mod, c[1]))), c[1]
        if name == "__ts_days" and len(kids) == 1:
            # epoch microseconds -> epoch days, a floor division
            c = self.lower(kids[0])
            return self.emit("TSDAYS", I64, self.cast(c, I64)), I64
        if name in _CIVIL and len(kids) == 1:
            # civil-from-days in int64 (the lane is cast first, as JAX does)
            c = self.lower(kids[0])
            return self.emit("CIVIL", I64, self.cast(c, I64), imm=_CIVIL.index(name)), I64
        raise NotDeviceCompilable(f"Func has no device lowering: {e.sql()}")


_CIVIL = ("__year_days", "__month_days", "__day_days")


def _const_bits(v: int, dt: int) -> int:
    """A Python int constant in the operand's dtype, as JAX converts a weak
    int: int32 wraps, floats round."""
    if dt == I32:
        return (v + 2**31) % 2**32 - 2**31
    if dt == I64:
        return v
    if dt == F32:
        return struct.unpack("<i", struct.pack("<f", float(v)))[0] & 0xFFFFFFFF
    return struct.unpack("<q", struct.pack("<d", float(v)))[0]


def _in_depth(e: ir.Expression) -> int:
    """Nesting depth of IN nodes inside ``e``: an option's validity can be
    reduced only after the INs it contains are final."""
    own = 1 if isinstance(e, ir.In) else 0
    return own + max((_in_depth(c) for c in e.children), default=0)


def _allocate(code: List[List[int]], n_vregs: int, root: int) -> Tuple[np.ndarray, int, int]:
    """Map virtual registers onto physical ones, reusing a register after
    its last read (an instruction reads all its operands before it writes)."""
    last = [-1] * n_vregs
    for i, ins in enumerate(code):
        for r in _reads(ins):
            last[r] = i
    last[root] = len(code)
    phys = [-1] * n_vregs
    free: List[int] = []
    n_phys = 0
    out = []
    for i, ins in enumerate(code):
        ins = list(ins)
        for k in (3, 4, 5):
            if _is_reg_operand(ins, k):
                ins[k] = phys[ins[k]]
        for r in set(_reads(code[i])):
            if last[r] == i:
                free.append(phys[r])
        if ins[2] >= 0:
            v = ins[2]
            if free:
                p = free.pop()
            else:
                p, n_phys = n_phys, n_phys + 1
            phys[v] = p
            ins[2] = p
            if last[v] < 0:  # never read: release at once
                free.append(p)
        out.append(ins)
    return np.asarray(out, np.int32).reshape(-1, 8), phys[root], n_phys


_READS = {"LIT": (), "COL": (), "CAST": (3,), "NEG": (3,), "NOT": (3,), "ISNULL": (3,),
          "ISNOTNULL": (3,), "ABS": (3,), "FLOOR": (3,), "CEIL": (3,), "EXP": (3,),
          "SQRT": (3,), "LOG": (3,), "FLAGALL": (3,), "TIMEFIELD": (3,), "TSDAYS": (3,),
          "CIVIL": (3,), "INFIN": (3, 4), "INROW": (3, 4),
          "INSTEP": (3, 4, 5), "CASESTEP": (3, 4, 5)}


def _is_reg_operand(ins: List[int], k: int) -> bool:
    return k in _READS.get(OPS[ins[0]], (3, 4))


def _reads(ins: List[int]) -> List[int]:
    return [ins[k] for k in _READS.get(OPS[ins[0]], (3, 4))]


def lower(e: ir.Expression, col_dtypes: Dict[str, torch.dtype], row_in: bool = False,
          scalars: Optional[Dict[str, int]] = None) -> Program:
    """Lower ``e`` to a :class:`Program` for columns of the given dtypes
    (name -> torch dtype). Raises :class:`NotDeviceCompilable` where the
    JAX package's ``compile_expr`` cannot trace ``e``. ``row_in`` takes an
    IN option's validity per row (no reduction pass); ``scalars`` (name ->
    program dtype) are names bound per launch into literal slots."""
    low = _Lowering(col_dtypes, row_in, scalars)
    root, root_dt = low.lower(e)
    if len(low.code) > MAX_INSTRS:
        raise NotDeviceCompilable(f"{len(low.code)} instructions: more than {MAX_INSTRS}")
    instrs, proot, n_phys = _allocate(low.code, low.n_vregs, root)
    if n_phys > MAX_REGS:
        raise NotDeviceCompilable(f"{n_phys} registers live at once: more than {MAX_REGS}")
    lits = np.array([b for b, _ in low.lits] or [0], np.int64)
    lit_valid = np.array([v for _, v in low.lits] or [False], bool)
    return Program(instrs, lits, lit_valid, low.columns, low.col_dt, proot, root_dt,
                   n_phys, low.n_flags, low.max_level + 1, low.scalar, low.scalar_slots)


class CompiledExpr:
    """``compile_expr``'s result: call it with an env to evaluate. The
    lowering depends on the env's column dtypes and is cached per dtype
    set."""

    def __init__(self, e: ir.Expression):
        self.expr = e
        self._programs: Dict[Tuple, Program] = {}

    def program(self, env: Env) -> Program:
        return self.program_for({k: c.values.dtype for k, c in env.items()})

    def program_for(self, dtypes: Dict[str, torch.dtype]) -> Program:
        """The program for columns of these dtypes (name -> torch dtype)."""
        key = tuple(sorted(dtypes.items(), key=lambda kv: kv[0]))
        p = self._programs.get(key)
        if p is None:
            p = self._programs[key] = lower(self.expr, dtypes)
        return p

    def __call__(self, env: Env) -> DeviceColumn:
        return expr_eval(self.program(env), env)


def compile_expr(e: ir.Expression) -> CompiledExpr:
    """Compile ``e`` for evaluation over a device env (name ->
    :class:`DeviceColumn`). The program is lowered at the first call, for
    that env's dtypes."""
    return CompiledExpr(e)


# -- running a program ------------------------------------------------------------


def _env_columns(program: Program, env: Env) -> List[DeviceColumn]:
    cols = []
    for name, dt in zip(program.columns, program.col_dtypes):
        c = env.get(name)
        if c is None or _FROM_TORCH.get(c.values.dtype) != dt:
            raise ValueError(f"expr_eval: column {name!r} missing from the env or of "
                             "another dtype than the program was lowered for")
        cols.append(c)
    return cols


def _rows(program: Program, cols: List[DeviceColumn]) -> int:
    if not cols:
        return 1
    n = cols[0].values.shape[0]
    for c in cols:
        if c.values.dim() != 1 or c.values.shape[0] != n or c.valid.shape != c.values.shape:
            raise ValueError("expr_eval: env columns must be 1-D, of one length, "
                             "with valid masks of the same shape")
    return n


def _env_device(cols: List[DeviceColumn], env: Env) -> torch.device:
    """The device a program runs on: its columns', or for a program that
    reads none (a scalar), the env's."""
    for c in list(cols) + list(env.values()):
        return c.values.device
    return torch.device("cpu")


def _k15_blocks(program: Program, cols: List[DeviceColumn], n: int):
    """K15's block: the program and the stats lanes as one "file" of ``n``
    rows, packed by the residual mask K14's packing
    (``ops/column_cache``: the launch's parameters, or staged tables when
    the program does not fit them); returns (layout, blocks), one block or
    none when ``n`` is 0."""
    from delta_tpu_torch.ops import column_cache

    # every program the lowering emits fits the staged tables
    layout = column_cache._K14_PARAMS if column_cache._fits_tables(
        program, column_cache._K14_PARAMS) else column_cache._K14_GLOBAL
    ptrs = [p for c in cols for p in (c.values.data_ptr(), c.valid.data_ptr())]
    return layout, column_cache._param_blocks(program, ptrs, [n], [None], [0], layout,
                                              column_cache._K15_TILE_BYTES)


def expr_eval(program: Program, env: Env) -> DeviceColumn:
    """Run ``program`` over ``env``: the K15 kernel for columns on a CUDA
    device (``csrc/residual_mask.cu``'s tile body, as K14 runs it: one
    launch a nesting level of IN reductions, then the one that writes the
    output), the plain version for columns on the CPU. Returns the root's
    ``(values, valid)``, 0-d when the program reads no column."""
    from delta_tpu_torch.ops import column_cache

    cols = _env_columns(program, env)
    dev = _env_device(cols, env)
    if dev.type == "cpu":
        return expr_eval_plain(program, env)
    n = _rows(program, cols)
    for c in cols:
        if c.values.device != dev or c.valid.device != dev:
            raise ValueError("expr_eval: env columns on more than one device")
    # contiguous lanes, whatever their offset: the kernel reads a lane that
    # starts off a 16-byte boundary one element a thread
    cols = [DeviceColumn(c.values.contiguous(), c.valid.contiguous()) for c in cols]
    layout, blocks = _k15_blocks(program, cols, n)
    flags = max(program.n_flags, 1)
    # the output, its validity and the flags in one allocation
    nv = n * _TORCH[program.root_dtype].itemsize
    at_ok = (nv + 15) // 16 * 16
    at_fl = (at_ok + n + 15) // 16 * 16
    buf = torch.empty(at_fl + 4 * flags, dtype=torch.uint8, device=dev)
    out = buf[:nv].view(_TORCH[program.root_dtype])
    out_valid = buf[at_ok:at_ok + n].view(torch.bool)
    for blk in blocks:
        host, tables, _keep = column_cache._block_args(blk, layout, dev)
        native.call("expr_eval", dev, host, len(blk), tables, out.data_ptr(),
                    out_valid.data_ptr(), buf.data_ptr() + at_fl, program.n_flags,
                    program.passes)
        native.launches["expr_eval"] += 1
    if program.scalar:
        return DeviceColumn(out.reshape(()), out_valid.reshape(()))
    return DeviceColumn(out, out_valid)


# -- the plain version ------------------------------------------------------------

_I32_MIN, _I32_MAX = -(2**31), 2**31 - 1
_I64_MIN, _I64_MAX = -(2**63), 2**63 - 1


def _sat_int(x: torch.Tensor, dt: int) -> torch.Tensor:
    """float -> int32/int64 with XLA's rule: truncate, saturate, NaN -> 0."""
    tdt = _TORCH[dt]
    if dt == I32:
        hi, lo = 2147483648.0, -2147483649.0 if x.dtype == torch.float64 else -2147483648.0
        imax, imin = _I32_MAX, _I32_MIN
    else:
        hi, lo = 9223372036854775808.0, -9223372036854775808.0
        imax, imin = _I64_MAX, _I64_MIN
    over = x >= hi
    under = (x <= lo) if (dt == I32 and x.dtype == torch.float64) else (x < lo)
    nan = torch.isnan(x)
    safe = torch.where(over | under | nan, torch.zeros_like(x), x)
    out = safe.to(tdt)
    out = torch.where(over, torch.full_like(out, imax), out)
    out = torch.where(under, torch.full_like(out, imin), out)
    return out


def _cast_plain(x: torch.Tensor, s: int, t: int) -> torch.Tensor:
    if s == t:
        return x
    if t == BOOL:
        return x != 0
    if t in (I32, I64) and s in (F32, F64):
        return _sat_int(x, t)
    if t == I32 and s == I64:
        return x.to(torch.int32)  # wraps
    return x.to(_TORCH[t])


def _wrap_int(op, a: torch.Tensor, b: Optional[torch.Tensor], dt: int) -> torch.Tensor:
    """Integer arithmetic that wraps at the result width: int32 computes in
    int64 and keeps the low 32 bits; int64 wraps as two's complement."""
    if dt == I32:
        a64 = a.to(torch.int64)
        r = op(a64) if b is None else op(a64, b.to(torch.int64))
        r = r & 0xFFFFFFFF
        return torch.where(r >= 2**31, r - 2**32, r).to(torch.int32)
    return op(a) if b is None else op(a, b)


def _round_half_away(x: torch.Tensor) -> torch.Tensor:
    t = torch.trunc(x)
    frac = x - t
    one = torch.ones_like(x)
    step = torch.where(x < 0, -one, one)
    return torch.where(frac.abs() >= 0.5, t + step, t)


def _floordiv_mod_float(a: torch.Tensor, d: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``(a // d) % m`` with Python (JAX) semantics on floats."""
    mod = torch.fmod(a, d)
    div = (a - mod) / d
    ind = (mod != 0) & ((d < 0) != (mod < 0))
    div = torch.where(ind, div - 1, div)
    q = _round_half_away(div)
    r = torch.fmod(q, m)
    ind = (r != 0) & ((m < 0) != (r < 0))
    return torch.where(ind, r + m, r)


def _floordiv_mod_int(a: torch.Tensor, d: torch.Tensor, m: torch.Tensor, dt: int) -> torch.Tensor:
    q = torch.div(a, d, rounding_mode="floor")
    return torch.remainder(q, m).to(_TORCH[dt])


def _civil_plain(days: torch.Tensor):
    """(year, month, day) of int64 epoch days, Hinnant's civil-from-days as
    ``jaxeval.py:309-322`` writes it: after the era shift every operand is
    non-negative, so truncating and floor division agree."""
    z = days + 719468
    era = torch.div(z, 146097, rounding_mode="floor")
    doe = z - era * 146097
    yoe = torch.div(doe - torch.div(doe, 1460, rounding_mode="floor")
                    + torch.div(doe, 36524, rounding_mode="floor")
                    - torch.div(doe, 146096, rounding_mode="floor"), 365, rounding_mode="floor")
    doy = doe - (365 * yoe + torch.div(yoe, 4, rounding_mode="floor")
                 - torch.div(yoe, 100, rounding_mode="floor"))
    mp = torch.div(5 * doy + 2, 153, rounding_mode="floor")
    day = doy - torch.div(153 * mp + 2, 5, rounding_mode="floor") + 1
    month = torch.where(mp < 10, mp + 3, mp - 9)
    year = yoe + era * 400 + (month <= 2).to(torch.int64)
    return year, month, day


def expr_eval_plain(program: Program, env: Env) -> DeviceColumn:
    """Plain PyTorch version of the K15 kernel: the same program, one
    instruction at a time over whole lanes."""
    cols = _env_columns(program, env)
    n = _rows(program, cols)
    dev = _env_device(cols, env)
    regs: List[Optional[Tuple[torch.Tensor, torch.Tensor]]] = [None] * max(program.n_regs, 1)
    flags = [False] * max(program.n_flags, 1)
    lits = program.lits
    true = torch.ones((), dtype=torch.bool, device=dev)

    def lit(i: int, dt: int) -> torch.Tensor:
        bits = int(lits[i])
        if dt == F64:
            v = struct.unpack("<d", struct.pack("<q", bits))[0]
        elif dt == F32:
            v = struct.unpack("<f", struct.pack("<I", bits & 0xFFFFFFFF))[0]
        elif dt == BOOL:
            v = bool(bits)
        else:
            v = bits
        return torch.tensor(v, dtype=_TORCH[dt], device=dev)

    for op_i, dt, dst, a, b, c, imm, imm2 in program.instrs.tolist():
        op = OPS[op_i]
        A = regs[a] if a >= 0 and op not in ("LIT", "COL") else None
        B = regs[b] if b >= 0 and op not in ("LIT", "COL", "CAST") else None
        C = regs[c] if c >= 0 and op in ("INSTEP", "CASESTEP") else None
        if op == "LIT":
            res = (lit(imm, dt), torch.tensor(bool(program.lit_valid[imm]), device=dev))
        elif op == "COL":
            col = cols[imm]
            res = (col.values, col.valid)
        elif op == "CAST":
            res = (_cast_plain(A[0], imm, dt), A[1])
        elif op in ("ADD", "SUB", "MUL"):
            x, y = A[0], B[0]
            if dt == BOOL:
                v = (x | y) if op == "ADD" else (x & y)
            elif dt in (I32, I64):
                fn = {"ADD": torch.add, "SUB": torch.sub, "MUL": torch.mul}[op]
                v = _wrap_int(fn, x, y, dt)
            else:
                v = {"ADD": torch.add, "SUB": torch.sub, "MUL": torch.mul}[op](x, y)
            res = (v, A[1] & B[1])
        elif op == "DIV":
            nz = B[0] != 0
            res = (A[0] / torch.where(nz, B[0], torch.ones_like(B[0])), A[1] & B[1] & nz)
        elif op == "NEG":
            v = _wrap_int(torch.neg, A[0], None, dt) if dt in (I32, I64) else -A[0]
            res = (v, A[1])
        elif op in ("EQ", "NE", "LT", "LE", "GT", "GE"):
            fn = {"EQ": torch.eq, "NE": torch.ne, "LT": torch.lt, "LE": torch.le,
                  "GT": torch.gt, "GE": torch.ge}[op]
            res = (fn(A[0], B[0]), A[1] & B[1])
        elif op in ("AND", "OR"):
            lt, rt = A[0] & A[1], B[0] & B[1]
            if op == "AND":
                v = lt & rt
                res = (v, v | (~A[0] & A[1]) | (~B[0] & B[1]))
            else:
                v = lt | rt
                res = (v, (A[1] & B[1]) | v)
        elif op == "NOT":
            res = (~A[0], A[1])
        elif op == "ISNULL":
            res = (~A[1], true.expand(A[1].shape))
        elif op == "ISNOTNULL":
            res = (A[1], true.expand(A[1].shape))
        elif op == "NSEQ":
            eq = (A[0] == B[0]) & A[1] & B[1]
            v = eq | (~A[1] & ~B[1])
            res = (v, true.expand(v.shape))
        elif op == "INSTEP":
            v = C[0] | ((A[0] == B[0]) & B[1])
            res = (v, (C[1] & B[1]).expand(v.shape))
        elif op == "FLAGALL":
            flags[imm] = bool((~A[1]).any())
            continue
        elif op == "INFIN":
            any_null = any(flags[imm:imm + imm2])
            res = (A[0], B[1] & (A[0] | (not any_null)))
        elif op == "INROW":
            res = (A[0], B[1] & (A[0] | A[1]))
        elif op == "TSDAYS":
            res = (torch.div(A[0], 86_400_000_000, rounding_mode="floor"), A[1])
        elif op == "CIVIL":
            res = (_civil_plain(A[0])[imm], A[1])
        elif op == "COALESCE":
            res = (torch.where(A[1], A[0], B[0]), A[1] | B[1])
        elif op == "CASESTEP":
            fire = C[0] & C[1]
            res = (torch.where(fire, A[0], B[0]), torch.where(fire, A[1], B[1]))
        elif op == "ABS":
            if dt in (I32, I64):
                v = torch.where(A[0] < 0, _wrap_int(torch.neg, A[0], None, dt), A[0])
            else:
                v = A[0].abs()
            res = (v, A[1])
        elif op in ("FLOOR", "CEIL"):
            res = ((torch.floor if op == "FLOOR" else torch.ceil)(A[0]), A[1])
        elif op == "EXP":
            res = (torch.exp(A[0]), A[1])
        elif op == "SQRT":
            x = A[0]
            res = (torch.sqrt(torch.where(x < 0, torch.zeros_like(x), x)), A[1] & (x >= 0))
        elif op == "LOG":
            x = A[0]
            floor = torch.full_like(x, 1e-300)
            res = (torch.log(torch.where(x < 1e-300, floor, x)), A[1] & (x > 0))
        elif op == "POW":
            res = (torch.pow(A[0], B[0]), A[1] & B[1])
        elif op == "TIMEFIELD":
            d, m = lit(imm, dt), lit(imm2, dt)
            if dt in (F32, F64):
                v = _floordiv_mod_float(A[0], d, m)
            else:
                v = _floordiv_mod_int(A[0], d, m, dt)
            res = (v, A[1])
        else:  # pragma: no cover - the lowering emits no other opcode
            raise ValueError(f"expr_eval_plain: unknown opcode {op}")
        regs[dst] = res
    values, valid = regs[program.root]
    shape = () if program.scalar else (n,)
    values = values.expand(shape) if values.dim() == 0 else values
    valid = valid.expand(shape) if valid.dim() == 0 else valid
    return DeviceColumn(values.to(_TORCH[program.root_dtype]).contiguous(), valid.contiguous())


# -- the residual predicate, lowered for the device scan path -------------------

#: dictionary code bound to a string literal ABSENT from a file's dictionary
#: — real codes are >= 0, so equality never fires against it and inequality
#: fires for every non-NULL row, exactly the host verdicts
STR_CODE_ABSENT = -2

_STRLIT_PREFIX = "__strlit"
_CMP_TYPES = (ir.Eq, ir.Ne, ir.Lt, ir.Le, ir.Gt, ir.Ge)
_CMP_FLIP = {ir.Lt: ir.Gt, ir.Le: ir.Ge, ir.Gt: ir.Lt, ir.Ge: ir.Le}


class ResidualPlan(NamedTuple):
    """A residual predicate lowered for the device scan path
    (``ops/column_cache``): the rewritten expression (string literals have
    become placeholder columns over dictionary codes, temporal literals
    epoch ints), the data columns bound as lanes, the partition columns
    bound as per-file scalars, and the string-literal bindings the caller
    resolves per file against that file's dictionary (absent value ->
    :data:`STR_CODE_ABSENT`)."""

    expr: ir.Expression
    refs: frozenset        # data columns needed as lanes (lower-cased)
    part_refs: frozenset   # partition columns bound as per-file scalars
    str_binds: tuple       # ((placeholder, column_lower, literal_value), ...)


def lane_dtypes(types: Dict[str, Any]) -> Dict[str, torch.dtype]:
    """The lane dtype of each column of a declared type, as
    ``ops/column_cache`` decodes it: strings int32 codes, dates int32 epoch
    days, timestamps int64 epoch µs, integers int64, floats float64,
    booleans bool; a type with no lane form is left out."""
    from delta_tpu_torch.schema.types import (
        BooleanType, ByteType, DateType, DoubleType, FloatType, IntegerType, LongType,
        ShortType, StringType, TimestampType,
    )

    out = {}
    for name, t in types.items():
        if isinstance(t, (StringType, DateType)):
            out[name] = torch.int32
        elif isinstance(t, (TimestampType, ByteType, ShortType, IntegerType, LongType)):
            out[name] = torch.int64
        elif isinstance(t, (FloatType, DoubleType)):
            out[name] = torch.float64
        elif isinstance(t, BooleanType):
            out[name] = torch.bool
    return out


def compile_residual(e: ir.Expression, types: Dict[str, Any],
                     partition_names=()) -> ResidualPlan:
    """Rewrite and gate a residual predicate so it lowers over decoded file
    lanes (``jaxeval.py:362``):

    * string equality / ``IN`` against literals lowers to int32
      dictionary-code compares through per-file placeholder columns; string
      ORDER comparisons do not lower (codes are unordered);
    * date/timestamp literals (ISO strings or datetime objects) become the
      lane encodings (epoch days / epoch microseconds), and
      ``year``/``month``/``day``/``to_date``/``hour`` over temporal columns
      lower to the calendar opcodes;
    * decimal columns, a cast to DECIMAL (it rounds half up at its scale,
      which no opcode does), string partition references and mixed
      date-vs-timestamp compares raise :class:`NotDeviceCompilable`, and
      the caller keeps the host path.

    ``types`` maps lower-cased column names to declared DataTypes;
    ``partition_names`` marks the columns bound as per-file scalars."""
    import datetime as _dt

    from delta_tpu_torch.schema.types import DateType, DecimalType, StringType, TimestampType
    from delta_tpu_torch.utils.timeparse import iso_to_date, iso_to_naive_utc

    def _no_decimal_cast(x):
        if isinstance(x, ir.Cast) and isinstance(x.data_type, DecimalType):
            raise NotDeviceCompilable(f"{x.sql()} rounds to a decimal: it stays on host")
        for c in x.children:
            _no_decimal_cast(c)

    _no_decimal_cast(e)

    parts = frozenset(c.lower() for c in partition_names)
    binds: list = []
    refs: set = set()
    part_refs: set = set()

    def _ctype(x):
        while isinstance(x, ir.Alias):
            x = x.child
        if isinstance(x, ir.Column):
            return types.get(x.name.lower())
        if isinstance(x, ir.Func) and x.name == "to_date" and len(x.children) == 1:
            ct = _ctype(x.children[0])
            return DateType() if isinstance(ct, (DateType, TimestampType)) else None
        return None

    def _note(c: ir.Column) -> ir.Column:
        n = c.name.lower()
        if isinstance(types.get(n), DecimalType):
            raise NotDeviceCompilable(f"decimal column {c.name!r} stays on host (exact arithmetic)")
        if n in parts:
            if isinstance(types.get(n), StringType):
                raise NotDeviceCompilable(f"string partition column {c.name!r} has no device codes")
            part_refs.add(n)
        else:
            refs.add(n)
        return ir.Column(n)

    def _temporal_lit(lit: ir.Literal, dt) -> ir.Literal:
        v = lit.value
        if v is None:
            return lit
        if isinstance(v, str):
            try:
                v = iso_to_date(v) if isinstance(dt, DateType) else iso_to_naive_utc(v)
            except ValueError:
                raise NotDeviceCompilable(f"unparseable temporal literal {lit.value!r}") from None
        if isinstance(dt, TimestampType) and isinstance(v, _dt.date) \
                and not isinstance(v, _dt.datetime):
            v = _dt.datetime.combine(v, _dt.time())  # midnight, like Spark
        if isinstance(v, _dt.datetime):
            if not isinstance(dt, TimestampType):
                raise NotDeviceCompilable("timestamp literal vs date lane")
            if v.tzinfo is None:
                v = v.replace(tzinfo=_dt.timezone.utc)  # naive IS UTC here
            return ir.Literal(int(v.timestamp() * 1_000_000))
        if isinstance(v, _dt.date):
            return ir.Literal((v - _dt.date(1970, 1, 1)).days)
        raise NotDeviceCompilable(f"literal {v!r} does not coerce to a temporal lane")

    def _strip(x):
        while isinstance(x, ir.Alias):
            x = x.child
        return x

    def _ifunc(name: str, child: ir.Expression) -> ir.Func:
        # a lowering-only node (__ts_days / __{year,month,day}_days), built
        # by the clone idiom because ir.Func validates public names; the host
        # evaluators never see it
        f = object.__new__(ir.Func)
        f.name = name
        f.children = (child,)
        return f

    def rw(x: ir.Expression) -> ir.Expression:
        t = type(x)
        if t is ir.Alias:
            return rw(x.child)
        if t is ir.Column:
            return _note(x)
        if t is ir.Literal:
            v = x.value
            if isinstance(v, str):
                raise NotDeviceCompilable(f"string literal {v!r} outside a dictionary-code compare")
            if isinstance(v, _dt.datetime):
                if v.tzinfo is None:
                    v = v.replace(tzinfo=_dt.timezone.utc)
                return ir.Literal(int(v.timestamp() * 1_000_000))
            if isinstance(v, _dt.date):
                return ir.Literal((v - _dt.date(1970, 1, 1)).days)
            return x
        if t in _CMP_TYPES or t is ir.NullSafeEq:
            l, r = x.left, x.right
            if isinstance(l, ir.Literal) and not isinstance(r, ir.Literal):
                l, r = r, l
                t = _CMP_FLIP.get(t, t)
            lt_, rt_ = _ctype(l), _ctype(r)
            if isinstance(lt_, (DateType, TimestampType)) \
                    and isinstance(rt_, (DateType, TimestampType)):
                if type(lt_) is not type(rt_):
                    raise NotDeviceCompilable("mixed date/timestamp compare (lane units differ)")
                return t(rw(l), rw(r))
            if isinstance(lt_, (DateType, TimestampType)) and isinstance(r, ir.Literal):
                return t(rw(l), _temporal_lit(r, lt_))
            stringy = (isinstance(lt_, StringType) or isinstance(rt_, StringType)
                       or isinstance(getattr(_strip(l), "value", None), str)
                       or isinstance(getattr(_strip(r), "value", None), str))
            if stringy:
                col, lit = _strip(l), _strip(r)
                if t in (ir.Eq, ir.Ne, ir.NullSafeEq) and isinstance(lt_, StringType) \
                        and isinstance(col, ir.Column) and isinstance(lit, ir.Literal) \
                        and (lit.value is None or isinstance(lit.value, str)):
                    if lit.value is None:
                        return t(_note(col), ir.Literal(None))
                    ph = f"{_STRLIT_PREFIX}{len(binds)}"
                    binds.append((ph, col.name.lower(), lit.value))
                    return t(_note(col), ir.Column(ph))
                raise NotDeviceCompilable(f"string comparison stays on host: {x.sql()}")
            return t(rw(l), rw(r))
        if t is ir.In:
            v = _strip(x.value)
            vt = _ctype(v)
            opts = list(x.options)
            if isinstance(vt, StringType):
                if not isinstance(v, ir.Column):
                    raise NotDeviceCompilable("string IN over a non-column")
                new_opts = []
                for o in opts:
                    o = _strip(o)
                    if not isinstance(o, ir.Literal):
                        raise NotDeviceCompilable("string IN option is not a literal")
                    if o.value is None:
                        new_opts.append(o)  # NULL option: Kleene semantics
                        continue
                    if not isinstance(o.value, str):
                        raise NotDeviceCompilable(f"non-string option {o.value!r} in string IN")
                    ph = f"{_STRLIT_PREFIX}{len(binds)}"
                    binds.append((ph, v.name.lower(), o.value))
                    new_opts.append(ir.Column(ph))
                return ir.In(_note(v), new_opts)
            if isinstance(vt, (DateType, TimestampType)):
                new_opts = [o if (isinstance(_strip(o), ir.Literal) and _strip(o).value is None)
                            else _temporal_lit(_strip(o), vt)
                            if isinstance(_strip(o), ir.Literal) else rw(o)
                            for o in opts]
                return ir.In(rw(x.value), new_opts)
            return ir.In(rw(x.value), [rw(o) for o in opts])
        if t is ir.Func and x.name in ("year", "month", "day") and len(x.children) == 1:
            ct = _ctype(x.children[0])
            child = rw(x.children[0])
            if isinstance(ct, TimestampType):
                child = _ifunc("__ts_days", child)
            elif not isinstance(ct, DateType):
                raise NotDeviceCompilable(f"{x.name}() over a non-temporal lane")
            return _ifunc(f"__{x.name}_days", child)
        if t is ir.Func and x.name == "to_date" and len(x.children) == 1:
            ct = _ctype(x.children[0])
            if isinstance(ct, TimestampType):
                return _ifunc("__ts_days", rw(x.children[0]))
            if isinstance(ct, DateType):
                return rw(x.children[0])
            raise NotDeviceCompilable("to_date over a non-temporal lane")
        if t is ir.Func and x.name == "hour" and len(x.children) == 1:
            if not isinstance(_ctype(x.children[0]), TimestampType):
                raise NotDeviceCompilable("hour() needs a timestamp lane")
            return ir.Func("hour", [rw(x.children[0])])
        # generic rebuild (And/Or/Not/arithmetic/null tests/Coalesce/CaseWhen/
        # Cast/other Funcs): unsupported shapes surface from the lowering
        new_children = tuple(rw(c) for c in x.children)
        if new_children == x.children:
            return x
        clone = object.__new__(t)
        clone.__dict__.update(x.__dict__)
        clone.children = new_children
        return clone

    out = rw(e)
    plan = ResidualPlan(out, frozenset(refs), frozenset(part_refs), tuple(binds))
    # validate the lowering now, for the lanes the declared types give
    dtypes = lane_dtypes(types)
    scalars = {ph: I64 for ph, _c, _v in plan.str_binds}
    scalars.update({c: _FROM_TORCH[dtypes.get(c, torch.float64)] for c in plan.part_refs})
    lower(out, {c: dtypes.get(c, torch.float64) for c in refs}, row_in=True, scalars=scalars)
    return plan
