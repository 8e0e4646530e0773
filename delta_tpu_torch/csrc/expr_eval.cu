// Expression interpreter (K15): a lowered skipping predicate over per-file
// stats lanes.
//
// Replaces delta_tpu/expr/jaxeval.py:149 `compile_expr` as jitted by
// delta_tpu/ops/pruning.py:361 `_compiled_skipping` and run by :371
// `_prune_device` (XLA traces the predicate tree into fused jnp ops, one
// executable per expression). Here the host lowers the tree to a flat typed
// program (delta_tpu_torch/expr/device_eval.py) and this one kernel, built
// once, interprets any program: no code is generated or compiled per query.
//
// Layout: one thread per row (file). Each register is a (value, valid)
// pair; the value lives in a 64-bit union (bool / int32 / int64 sign-
// extended in `i`, float32 in `f`, float64 in `d`). Instructions are 8
// int32 each (op, dtype, dst, a, b, c, imm, imm2) and are staged in shared
// memory per block. Literals and the column pointer tables follow the
// program in one device buffer.
//
// Semantics mirror the plain version (expr_eval_plain) operation for
// operation, so the two agree bit for bit: integer arithmetic wraps
// (computed unsigned), float -> int casts saturate with NaN -> 0, floor
// division and mod by constants follow Python's signs, and float
// arithmetic goes through the round-to-nearest intrinsics (__dadd_rn, ...),
// which the compiler never contracts into a multiply-add. exp/log/pow/sqrt
// are CUDA's math library, which torch's CUDA ops call too, built with
// nvcc's default flags.
//
// IN: an option's validity reduces over ALL rows (jnp.all). FLAGALL
// instructions of nesting level p OR "some row is NULL" into a flag with an
// atomic in pass p; the host launches passes 0..P-1 and only the last
// writes the output.
//
// What bounds it: bytes. Each row reads its lanes (8 B value + 1 B valid per
// column) and writes the result (value + 1 B valid); the interpreter's
// per-instruction work is a few dozen ALU operations per row, far below the
// card's rate at these sizes. Registers live in local memory (an L1-cached
// per-thread array), which the dynamic register indexing of an interpreter
// needs.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

enum Op {
  LIT = 0, COL, CAST, ADD, SUB, MUL, DIV, NEG, EQ, NE, LT, LE, GT, GE, AND, OR,
  NOT, ISNULL, ISNOTNULL, NSEQ, INSTEP, FLAGALL, INFIN, COALESCE, CASESTEP, ABS,
  FLOOR, CEIL, EXP, SQRT, LOG, POW, TIMEFIELD
};
enum Dt { BOOL = 0, I32 = 1, I64 = 2, F32 = 3, F64 = 4 };

constexpr int kThreads = 256;
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

__global__ void expr_eval_kernel(const long long* __restrict__ buf, int n_instr,
                                 int lit_off, int litv_off, int colv_off,
                                 int colk_off, long long n, int pass,
                                 int last_pass, int* __restrict__ flags,
                                 void* __restrict__ out,
                                 uint8_t* __restrict__ out_valid, int root,
                                 int root_dt) {
  extern __shared__ int prog[];
  const int* gprog = (const int*)buf;
  for (int k = threadIdx.x; k < n_instr * 8; k += blockDim.x) prog[k] = gprog[k];
  __syncthreads();
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const long long* lits = buf + lit_off;
  const long long* lit_valid = buf + litv_off;
  const long long* col_vals = buf + colv_off;
  const long long* col_valid = buf + colk_off;

  Reg reg[kMaxRegs];
  bool ok[kMaxRegs];
  for (int pc = 0; pc < n_instr; ++pc) {
    const int* ins = prog + pc * 8;
    const int op = ins[0], dt = ins[1], dst = ins[2], a = ins[3], b = ins[4],
              c = ins[5], imm = ins[6], imm2 = ins[7];
    Reg v;
    v.i = 0;
    bool vok = true;
    switch (op) {
      case LIT:
        v.i = lits[imm];
        if (dt == F32) {
          const uint32_t bits = (uint32_t)(unsigned long long)lits[imm];
          v.i = 0;
          v.f = __uint_as_float(bits);
        }
        vok = lit_valid[imm] != 0;
        break;
      case COL: {
        const void* p = (const void*)col_vals[imm];
        switch (dt) {
          case BOOL: v.i = ((const uint8_t*)p)[row] != 0; break;
          case I32: v.i = ((const int32_t*)p)[row]; break;
          case I64: v.i = ((const long long*)p)[row]; break;
          case F32: v.i = 0; v.f = ((const float*)p)[row]; break;
          default: v.d = ((const double*)p)[row]; break;
        }
        const uint8_t* q = (const uint8_t*)col_valid[imm];
        vok = q == nullptr ? true : q[row] != 0;
        break;
      }
      case CAST:
        v = cast(reg[a], imm, dt);
        vok = ok[a];
        break;
      case ADD:
      case SUB:
      case MUL:
        v = arith(op, reg[a], reg[b], dt);
        vok = ok[a] && ok[b];
        break;
      case DIV: {
        const bool nz = reg[b].d != 0.0;
        v.d = __ddiv_rn(reg[a].d, nz ? reg[b].d : 1.0);
        vok = ok[a] && ok[b] && nz;
        break;
      }
      case NEG:
        if (dt == I32) v.i = wrap32(0ull - (unsigned long long)reg[a].i);
        else if (dt == I64) v.i = (long long)(0ull - (unsigned long long)reg[a].i);
        else if (dt == F32) { v.i = 0; v.f = -reg[a].f; }
        else v.d = -reg[a].d;
        vok = ok[a];
        break;
      case EQ:
      case NE:
      case LT:
      case LE:
      case GT:
      case GE:
        v.i = cmp(op, reg[a], reg[b], dt);
        vok = ok[a] && ok[b];
        break;
      case AND:
      case OR: {
        const bool la = reg[a].i != 0, lb = reg[b].i != 0;
        const bool lt = la && ok[a], rt = lb && ok[b];
        if (op == AND) {
          v.i = lt && rt;
          vok = v.i || (!la && ok[a]) || (!lb && ok[b]);
        } else {
          v.i = lt || rt;
          vok = (ok[a] && ok[b]) || v.i;
        }
        break;
      }
      case NOT:
        v.i = reg[a].i == 0;
        vok = ok[a];
        break;
      case ISNULL:
        v.i = !ok[a];
        break;
      case ISNOTNULL:
        v.i = ok[a];
        break;
      case NSEQ:
        v.i = (eq(reg[a], reg[b], dt) && ok[a] && ok[b]) || (!ok[a] && !ok[b]);
        break;
      case INSTEP:
        v.i = (reg[c].i != 0) || (eq(reg[a], reg[b], dt) && ok[b]);
        break;
      case FLAGALL:
        if (ins[7] == pass && !ok[a]) atomicOr(flags + imm, 1);
        continue;
      case INFIN: {
        bool any_null = false;
        for (int k = 0; k < imm2; ++k) any_null = any_null || flags[imm + k] != 0;
        v.i = reg[a].i != 0;
        vok = ok[b] && (v.i || !any_null);
        break;
      }
      case COALESCE:
        v = ok[a] ? reg[a] : reg[b];
        vok = ok[a] || ok[b];
        break;
      case CASESTEP: {
        const bool fire = reg[c].i != 0 && ok[c];
        v = fire ? reg[a] : reg[b];
        vok = fire ? ok[a] : ok[b];
        break;
      }
      case ABS:
        if (dt == I32) v.i = reg[a].i < 0 ? wrap32(0ull - (unsigned long long)reg[a].i) : reg[a].i;
        else if (dt == I64) v.i = reg[a].i < 0 ? (long long)(0ull - (unsigned long long)reg[a].i) : reg[a].i;
        else if (dt == F32) { v.i = 0; v.f = fabsf(reg[a].f); }
        else v.d = fabs(reg[a].d);
        vok = ok[a];
        break;
      case FLOOR:
      case CEIL:
        if (dt == F32) { v.i = 0; v.f = op == FLOOR ? floorf(reg[a].f) : ceilf(reg[a].f); }
        else v.d = op == FLOOR ? floor(reg[a].d) : ceil(reg[a].d);
        vok = ok[a];
        break;
      case EXP:
        v.d = exp(reg[a].d);
        vok = ok[a];
        break;
      case SQRT: {
        const double x = reg[a].d;
        v.d = sqrt(x < 0.0 ? 0.0 : x);
        vok = ok[a] && x >= 0.0;
        break;
      }
      case LOG: {
        const double x = reg[a].d;
        v.d = log(x < 1e-300 ? 1e-300 : x);
        vok = ok[a] && x > 0.0;
        break;
      }
      case POW:
        v.d = pow(reg[a].d, reg[b].d);
        vok = ok[a] && ok[b];
        break;
      case TIMEFIELD: {
        Reg d, m;
        d.i = lits[imm];
        m.i = lits[imm2];
        if (dt == F32) {
          d.i = 0;
          d.f = __uint_as_float((uint32_t)(unsigned long long)lits[imm]);
          m.i = 0;
          m.f = __uint_as_float((uint32_t)(unsigned long long)lits[imm2]);
        }
        v = timefield(reg[a], d, m, dt);
        vok = ok[a];
        break;
      }
      default:
        break;
    }
    reg[dst] = v;
    ok[dst] = vok;
  }
  if (pass != last_pass) return;
  const Reg r = reg[root];
  switch (root_dt) {
    case BOOL: ((uint8_t*)out)[row] = r.i != 0; break;
    case I32: ((int32_t*)out)[row] = (int32_t)r.i; break;
    case I64: ((long long*)out)[row] = r.i; break;
    case F32: ((float*)out)[row] = r.f; break;
    default: ((double*)out)[row] = r.d; break;
  }
  out_valid[row] = ok[root];
}

}  // namespace

// buf: the program (n_instr x 8 int32), then int64 literals, literal
// validity, column value pointers and column valid pointers (0 = all
// valid), at the given int64 offsets. flags (n_flags,) i32 zeroed by the
// caller; out (n,) of the root dtype; out_valid (n,) u8.
extern "C" int dtt_expr_eval(const long long* buf, int n_instr, int lit_off,
                             int litv_off, int colv_off, int colk_off,
                             int passes, long long n, int* flags, void* out,
                             uint8_t* out_valid, int root, int root_dt,
                             void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0) return (int)cudaGetLastError();
  const size_t smem = sizeof(int) * 8 * (size_t)n_instr;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  for (int p = 0; p < passes; ++p) {
    expr_eval_kernel<<<blocks, kThreads, smem, s>>>(
        buf, n_instr, lit_off, litv_off, colv_off, colk_off, n, p, passes - 1,
        flags, out, out_valid, root, root_dt);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}
