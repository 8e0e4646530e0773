// The expression interpreter's semantics, shared by K15 (the skipping
// predicate over per-file stats lanes) and K14 (the residual filter over a
// query's column lanes). Both run on one kernel body, csrc/residual_mask.cu:
// a CTA takes a tile of rows with the register file in shared memory and
// runs the program one instruction at a time over the tile's rows; K14
// writes the Kleene-TRUE mask byte, K15 the root's (value, valid) in its
// dtype.
//
// A program is a flat typed register program lowered on the host
// (delta_tpu_torch/expr/device_eval.py); `alu` states each opcode's
// semantics once, for one instruction and one row: the tile loops call it
// with the opcode a template constant. Each register is a (value, valid)
// pair; the value lives in a 64-bit union (bool / int32 / int64
// sign-extended in `i`, float32 in `f`, float64 in `d`). Instructions are 8
// int32 each (op, dtype, dst, a, b, c, imm, imm2).
//
// Semantics mirror the plain version (expr_eval_plain) operation for
// operation, so the two agree bit for bit: integer arithmetic wraps
// (computed unsigned), float -> int casts saturate with NaN -> 0, floor
// division and mod by constants follow Python's signs, and float
// arithmetic goes through the round-to-nearest intrinsics (__dadd_rn, ...),
// which the compiler never contracts into a multiply-add. exp/log/pow/sqrt
// are CUDA's math library, which torch's CUDA ops call too, built with
// nvcc's default flags. The calendar opcodes: TSDAYS is a floor division
// of epoch microseconds by 86,400,000,000; CIVIL is Hinnant's
// civil-from-days in int64, as delta_tpu/expr/jaxeval.py:309-322 writes it.
// FLAGALL (an IN option's "some row is NULL", reduced over all rows) is the
// body's own: one atomic a CTA; INFIN reads the reduced flags, which the
// body hands `alu` in place of a TIMEFIELD literal.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace dtt {

enum Op {
  LIT = 0, COL, CAST, ADD, SUB, MUL, DIV, NEG, EQ, NE, LT, LE, GT, GE, AND, OR,
  NOT, ISNULL, ISNOTNULL, NSEQ, INSTEP, FLAGALL, INFIN, COALESCE, CASESTEP, ABS,
  FLOOR, CEIL, EXP, SQRT, LOG, POW, TIMEFIELD, TSDAYS, CIVIL, INROW
};
enum Dt { BOOL = 0, I32 = 1, I64 = 2, F32 = 3, F64 = 4 };

constexpr int kMaxRegs = 64;

union Reg {
  long long i;
  double d;
  float f;
};

__device__ __forceinline__ long long wrap32(unsigned long long x) {
  return (long long)(int32_t)(uint32_t)x;
}

__device__ __forceinline__ long long d2i32(double x) {
  if (isnan(x)) return 0;
  if (x >= 2147483648.0) return 2147483647LL;
  if (x <= -2147483649.0) return -2147483648LL;
  return (long long)(int32_t)x;
}

__device__ __forceinline__ long long f2i32(float x) {
  if (isnan(x)) return 0;
  if (x >= 2147483648.0f) return 2147483647LL;
  if (x < -2147483648.0f) return -2147483648LL;
  return (long long)(int32_t)x;
}

__device__ __forceinline__ long long d2i64(double x) {
  if (isnan(x)) return 0;
  if (x >= 9223372036854775808.0) return 9223372036854775807LL;
  if (x < -9223372036854775808.0) return (long long)(-9223372036854775807LL - 1);
  return (long long)x;
}

__device__ __forceinline__ long long f2i64(float x) {
  if (isnan(x)) return 0;
  if (x >= 9223372036854775808.0f) return 9223372036854775807LL;
  if (x < -9223372036854775808.0f) return (long long)(-9223372036854775807LL - 1);
  return (long long)x;
}

__device__ Reg cast(Reg x, int s, int t) {
  if (s == t) return x;
  const bool from_f = s == F32 || s == F64;
  const double xd = s == F64 ? x.d : 0.0;
  const float xf = s == F32 ? x.f : 0.0f;
  Reg r;
  r.i = 0;
  switch (t) {
    case BOOL:
      r.i = s == F32 ? (xf != 0.0f) : s == F64 ? (xd != 0.0) : (x.i != 0);
      break;
    case I32:
      r.i = s == F32 ? f2i32(xf) : s == F64 ? d2i32(xd) : wrap32((unsigned long long)x.i);
      break;
    case I64:
      r.i = s == F32 ? f2i64(xf) : s == F64 ? d2i64(xd) : x.i;
      break;
    case F32:
      r.f = s == F64 ? __double2float_rn(xd) : __ll2float_rn(x.i);
      break;
    default:  // F64
      r.d = s == F32 ? (double)xf : __ll2double_rn(x.i);
      break;
  }
  (void)from_f;
  return r;
}

__device__ __forceinline__ bool cmp(int op, Reg a, Reg b, int dt) {
  if (dt == F64) {
    const double x = a.d, y = b.d;
    switch (op) {
      case EQ: return x == y;
      case NE: return x != y;
      case LT: return x < y;
      case LE: return x <= y;
      case GT: return x > y;
      default: return x >= y;
    }
  }
  if (dt == F32) {
    const float x = a.f, y = b.f;
    switch (op) {
      case EQ: return x == y;
      case NE: return x != y;
      case LT: return x < y;
      case LE: return x <= y;
      case GT: return x > y;
      default: return x >= y;
    }
  }
  const long long x = a.i, y = b.i;
  switch (op) {
    case EQ: return x == y;
    case NE: return x != y;
    case LT: return x < y;
    case LE: return x <= y;
    case GT: return x > y;
    default: return x >= y;
  }
}

__device__ __forceinline__ bool eq(Reg a, Reg b, int dt) { return cmp(EQ, a, b, dt); }

__device__ __forceinline__ double round_half_away(double x) {
  const double t = trunc(x);
  const double frac = __dsub_rn(x, t);
  return fabs(frac) >= 0.5 ? __dadd_rn(t, x < 0.0 ? -1.0 : 1.0) : t;
}

__device__ __forceinline__ float round_half_away_f(float x) {
  const float t = truncf(x);
  const float frac = __fsub_rn(x, t);
  return fabsf(frac) >= 0.5f ? __fadd_rn(t, x < 0.0f ? -1.0f : 1.0f) : t;
}

// (a // d) % m with Python signs, in the operand's type
__device__ Reg timefield(Reg a, Reg d, Reg m, int dt) {
  Reg r;
  if (dt == F64) {
    double mod = fmod(a.d, d.d);
    double div = __ddiv_rn(__dsub_rn(a.d, mod), d.d);
    if (mod != 0.0 && ((d.d < 0.0) != (mod < 0.0))) div = __dsub_rn(div, 1.0);
    const double q = round_half_away(div);
    double rr = fmod(q, m.d);
    if (rr != 0.0 && ((m.d < 0.0) != (rr < 0.0))) rr = __dadd_rn(rr, m.d);
    r.d = rr;
  } else if (dt == F32) {
    float mod = fmodf(a.f, d.f);
    float div = __fdiv_rn(__fsub_rn(a.f, mod), d.f);
    if (mod != 0.0f && ((d.f < 0.0f) != (mod < 0.0f))) div = __fsub_rn(div, 1.0f);
    const float q = round_half_away_f(div);
    float rr = fmodf(q, m.f);
    if (rr != 0.0f && ((m.f < 0.0f) != (rr < 0.0f))) rr = __fadd_rn(rr, m.f);
    r.f = rr;
  } else {
    const long long x = a.i, y = d.i, z = m.i;
    long long q = x / y;
    const long long rem = x % y;
    if (rem != 0 && ((rem < 0) != (y < 0))) q -= 1;
    long long rr = q % z;
    if (rr != 0 && ((rr < 0) != (z < 0))) rr += z;
    r.i = dt == I32 ? wrap32((unsigned long long)rr) : rr;
  }
  return r;
}

__device__ Reg arith(int op, Reg a, Reg b, int dt) {
  Reg r;
  r.i = 0;
  if (dt == BOOL) {
    r.i = op == ADD ? (a.i | b.i) : (a.i & b.i);
  } else if (dt == I32 || dt == I64) {
    const unsigned long long x = (unsigned long long)a.i, y = (unsigned long long)b.i;
    const unsigned long long v = op == ADD ? x + y : op == SUB ? x - y : x * y;
    r.i = dt == I32 ? wrap32(v) : (long long)v;
  } else if (dt == F32) {
    r.f = op == ADD ? __fadd_rn(a.f, b.f) : op == SUB ? __fsub_rn(a.f, b.f)
                                                      : __fmul_rn(a.f, b.f);
  } else {
    r.d = op == ADD ? __dadd_rn(a.d, b.d) : op == SUB ? __dsub_rn(a.d, b.d)
                                                      : __dmul_rn(a.d, b.d);
  }
  return r;
}

// floor division of int64 (Python's //)
__device__ __forceinline__ long long floordiv(long long x, long long y) {
  long long q = x / y;
  if ((x % y != 0) && ((x < 0) != (y < 0))) q -= 1;
  return q;
}

// year (k = 0), month (1) or day (2) of int64 epoch days; after the era
// shift every operand is non-negative, so C's division is the floor
__device__ __forceinline__ long long civil(long long days, int k) {
  const long long z = days + 719468;
  const long long era = floordiv(z, 146097);
  const long long doe = z - era * 146097;
  const long long yoe = (doe - doe / 1460 + doe / 36524 - doe / 146096) / 365;
  const long long doy = doe - (365 * yoe + yoe / 4 - yoe / 100);
  const long long mp = (5 * doy + 2) / 153;
  const long long day = doy - (153 * mp + 2) / 5 + 1;
  const long long month = mp < 10 ? mp + 3 : mp - 9;
  const long long year = yoe + era * 400 + (month <= 2 ? 1 : 0);
  return k == 0 ? year : k == 1 ? month : day;
}

// Register operands an opcode reads (a, then b, then c), as
// delta_tpu_torch/expr/device_eval._READS lists them.
__host__ __device__ constexpr int arity(int op) {
  return op == LIT || op == COL ? 0
         : op == INSTEP || op == CASESTEP ? 3
         : op == INFIN || op == INROW ? 2
         : op == CAST || op == NEG || op == NOT || op == ISNULL || op == ISNOTNULL ||
                   op == ABS || op == FLOOR || op == CEIL || op == EXP || op == SQRT ||
                   op == LOG || op == FLAGALL || op == TIMEFIELD || op == TSDAYS || op == CIVIL
               ? 1
               : 2;
}

// A literal's bits as a register of dtype dt (float32 in the low 32 bits).
__device__ __forceinline__ Reg lit_reg(long long bits, int dt) {
  Reg v;
  v.i = bits;
  if (dt == F32) {
    v.i = 0;
    v.f = __uint_as_float((uint32_t)(unsigned long long)bits);
  }
  return v;
}

// One instruction of every opcode but LIT, COL and FLAGALL (which read the
// literal table or the lanes, or reduce over rows): the value and validity
// from the operand registers (a, b, c, as many as arity(op)) and, for
// TIMEFIELD, its two literals (d, m); for INFIN, d.i is 1 where some option
// of the IN is NULL in some row. The tile kernel (csrc/residual_mask.cu)
// calls it with the opcode a template constant, so the switch folds away.
__device__ __forceinline__ void alu(int op, int dt, int imm, Reg a, bool oa, Reg b, bool ob,
                                    Reg c, bool oc, Reg d, Reg m, Reg& v, bool& vok) {
  v.i = 0;
  vok = true;
  switch (op) {
    case CAST:
      v = cast(a, imm, dt);
      vok = oa;
      break;
    case ADD:
    case SUB:
    case MUL:
      v = arith(op, a, b, dt);
      vok = oa && ob;
      break;
    case DIV: {
      const bool nz = b.d != 0.0;
      v.d = __ddiv_rn(a.d, nz ? b.d : 1.0);
      vok = oa && ob && nz;
      break;
    }
    case NEG:
      if (dt == I32) v.i = wrap32(0ull - (unsigned long long)a.i);
      else if (dt == I64) v.i = (long long)(0ull - (unsigned long long)a.i);
      else if (dt == F32) { v.i = 0; v.f = -a.f; }
      else v.d = -a.d;
      vok = oa;
      break;
    case EQ:
    case NE:
    case LT:
    case LE:
    case GT:
    case GE:
      v.i = cmp(op, a, b, dt);
      vok = oa && ob;
      break;
    case AND:
    case OR: {
      const bool la = a.i != 0, lb = b.i != 0;
      const bool lt = la && oa, rt = lb && ob;
      if (op == AND) {
        v.i = lt && rt;
        vok = v.i || (!la && oa) || (!lb && ob);
      } else {
        v.i = lt || rt;
        vok = (oa && ob) || v.i;
      }
      break;
    }
    case NOT:
      v.i = a.i == 0;
      vok = oa;
      break;
    case ISNULL:
      v.i = !oa;
      break;
    case ISNOTNULL:
      v.i = oa;
      break;
    case NSEQ:
      v.i = (eq(a, b, dt) && oa && ob) || (!oa && !ob);
      break;
    case INSTEP:
      // validity: every option so far is valid in this row (INROW reads it)
      v.i = (c.i != 0) || (eq(a, b, dt) && ob);
      vok = oc && ob;
      break;
    case INFIN:  // IN with each option's validity reduced over all rows
      v.i = a.i != 0;
      vok = ob && (v.i || !d.i);
      break;
    case INROW:  // IN with each option's validity taken in its own row
      v.i = a.i != 0;
      vok = ob && (v.i || oa);
      break;
    case TSDAYS:  // epoch microseconds -> epoch days, rounding toward -inf
      v.i = floordiv(a.i, 86400000000LL);
      vok = oa;
      break;
    case CIVIL:
      v.i = civil(a.i, imm);
      vok = oa;
      break;
    case COALESCE:
      v = oa ? a : b;
      vok = oa || ob;
      break;
    case CASESTEP: {
      const bool fire = c.i != 0 && oc;
      v = fire ? a : b;
      vok = fire ? oa : ob;
      break;
    }
    case ABS:
      if (dt == I32) v.i = a.i < 0 ? wrap32(0ull - (unsigned long long)a.i) : a.i;
      else if (dt == I64) v.i = a.i < 0 ? (long long)(0ull - (unsigned long long)a.i) : a.i;
      else if (dt == F32) { v.i = 0; v.f = fabsf(a.f); }
      else v.d = fabs(a.d);
      vok = oa;
      break;
    case FLOOR:
    case CEIL:
      if (dt == F32) { v.i = 0; v.f = op == FLOOR ? floorf(a.f) : ceilf(a.f); }
      else v.d = op == FLOOR ? floor(a.d) : ceil(a.d);
      vok = oa;
      break;
    case EXP:
      v.d = exp(a.d);
      vok = oa;
      break;
    case SQRT:
      v.d = sqrt(a.d < 0.0 ? 0.0 : a.d);
      vok = oa && a.d >= 0.0;
      break;
    case LOG:
      v.d = log(a.d < 1e-300 ? 1e-300 : a.d);
      vok = oa && a.d > 0.0;
      break;
    case POW:
      v.d = pow(a.d, b.d);
      vok = oa && ob;
      break;
    case TIMEFIELD:
      v = timefield(a, d, m, dt);
      vok = oa;
      break;
    default:
      break;
  }
}

}  // namespace dtt
