// Residual mask (K14) and expression interpreter (K15): one tile body, two
// outputs. K14: the Kleene-TRUE row masks of a scan's lowered residual
// predicate over the resident column lanes of a query's files, in one
// launch. K15: a lowered skipping predicate over the per-file stats lanes,
// the root's (value, valid) in its dtype (below).
//
// Replaces delta_tpu/ops/column_cache.py:312 `_mask_kernel` (one jitted XLA
// executable per rewritten expression over
// delta_tpu/expr/jaxeval.py:362 `compile_residual`'s output, launched once
// per file). Here the host lowers the residual once to the typed register
// program of the expression interpreter (delta_tpu_torch/expr/device_eval.py,
// `row_in=True`), and this one kernel, built once, runs any such program
// over every file of a query: no code is generated per predicate.
//
// The launch carries everything in its parameters (a __grid_constant__
// MaskParams of 14,016 bytes, which CUDA 12.1+ allows on Hopper): the
// program in int16 fields, the literal table, and a file table (rows, the
// offset of the file's mask in the one output, the prefix of its tiles, its
// lane pointers and its per-file scalar literals: a string literal's code
// differs per file). So no device buffer is written per call and nothing is
// copied before the launch. A program or a file table that does not fit
// (more than 256 instructions or 128 literals, say a long IN list, or many
// per-file scalars) takes the same layout with larger tables, MaskGlobal
// (101,696 bytes: every program the lowering emits fits), which the host
// stages in pinned memory and copies to the card on the launch's stream;
// the kernel then reads it from global memory. A query with more files
// than one block holds takes further launches, packed by the host
// (ops/column_cache.py).
//
// Design: a CTA takes one tile of T rows of one file (T = 256..2048, picked
// by the host so that the register file fits in 48 KB, 55 KB for K15: the
// CTA finds its file by a binary search over the tiles' prefix). The register file lives
// in shared memory, laid out [register][row] (8-byte values, then 1-byte
// validity), sized to the program's registers, not to the interpreter's 64.
// Each instruction is decoded once per tile: the opcode is a template
// constant of the row loop (run_rows<OP>), and every thread applies it to its
// rows (thread t takes rows t, t + 256, ...), so consecutive threads touch
// consecutive words and a warp's accesses do not conflict. Instructions whose
// operands are all literals (LIT and what is computed from literals only:
// the host marks them, MaskParams::usrc) are computed once a tile by one
// thread into a per-instruction slot, and a row loop reads such an operand
// from a register. A COL instruction reads its lane with 16-byte vector
// loads (2, 4 or 16 rows a load) between two barriers (its threads' rows
// differ from the row loops'). The mask byte is `value != 0 && valid` of the
// root register, 0 past the file's rows up to its 16-row aligned end, so
// every byte of the output is written.
//
// K15 replaces delta_tpu/expr/jaxeval.py:149 `compile_expr` as jitted by
// delta_tpu/ops/pruning.py:361 `_compiled_skipping` and run by :371
// `_prune_device`. Its stats lanes are one "file" of n rows in the same
// MaskTables layouts (ops/column_cache's packing, shared by
// expr/device_eval.expr_eval), and the body writes the root's value and
// validity instead of the mask. An IN's option validity reduces over ALL
// rows: FLAGALL ORs "some row of this tile is NULL" into its flag with one
// atomic a CTA (__syncthreads_or), in a launch of its own per nesting level
// of the IN (dtt_expr_eval: the flags zeroed, then a launch per level that
// runs the program up to its last FLAGALL, then the launch that writes the
// output, whose INFIN reads the final flags). A lane whose start is off a
// 16-byte boundary (a view at an offset) is read one element a thread.
//
// Semantics are the interpreter's (`alu` in csrc/expr_eval.cuh): the body
// agrees with the plain versions bit for bit.
//
// What bounds it: bytes. Each row reads its lanes once (value + 1 B valid
// per column) and writes 1 B (K14) or the root's value and 1 B (K15). At
// config 12's shapes the interpreter's own work meets the card first
// (PERF.md): staging the columns with cp.async, persistent double-buffered
// CTAs, two rows a thread step and capped registers were each slower than
// this layout, which holds 64 registers and four CTAs an SM.
#include "expr_eval.cuh"

namespace {

using namespace dtt;

constexpr int kThreads = 256;

// K14's input, mirrored field for field by ops/column_cache._k14_dtype.
template <int NI, int NL, int NF, int NP, int NS, class LitScal>
struct MaskTables {
  static constexpr int kInstr = NI, kLits = NL, kFiles = NF, kPtrs = NP, kScal = NS;
  long long lits[NL];
  long long fscal[NS];       // file f's scalar k at f * n_scal + k
  long long rows[NF];        // each file's rows
  long long out_off[NF];     // its mask's offset in the output (16-aligned)
  const void* ptr[NP];       // file f, column c: values at 2 (f n_cols + c), valid next
  int tile_end[NF];          // the prefix of the files' tiles
  int hdr[16];               // see the H_* indices
  short ins[NI][8];          // op, dtype, dst, a, b, c, imm, imm2
  short usrc[NI][4];         // 1 if uniform; the uniform slot of a, b, c or -1
  LitScal lit_scal[NL];      // the per-file scalar a literal slot takes, or -1
  unsigned char lit_valid[NL];
  unsigned char fscal_valid[NS];
};
// in the launch's parameters
using MaskParams = MaskTables<256, 128, 64, 512, 128, signed char>;
// in global memory: room for MAX_INSTRS (1024) instructions, their literals
// (a LIT's one or a TIMEFIELD's two), a column each and a scalar each
using MaskGlobal = MaskTables<1024, 2048, 64, 2048, 4096, short>;
static_assert(sizeof(MaskParams) == 14016, "MaskParams: keep in step with column_cache.py");
static_assert(sizeof(MaskGlobal) == 101696, "MaskGlobal: keep in step with column_cache.py");

enum { H_INSTR = 0, H_COLS, H_FILES, H_SCAL, H_ROOT, H_ROOT_DT, H_ROOT_SLOT, H_TILE, H_REGS,
       H_TILES };

struct Tile {
  long long* val;     // [n_regs][T]
  uint8_t* ok;        // [n_regs][T]
  const Reg* uval;    // [n_instr]
  const uint8_t* uok;
  int T, n;           // tile rows, rows of the file in this tile
};

// Where a launch writes. K14: the mask bytes. K15: the root's (value,
// valid) in its dtype, rows [0, n) of the one "file" (the stats lanes of n
// files), and FLAGALL's flags; a K15 launch either reduces the FLAGALLs of
// nesting level `pass` (running the first `stop` instructions, no output)
// or, with pass = -1, runs the whole program and writes the output.
struct Out {
  uint8_t* mask;
  void* value;
  uint8_t* valid;
  int* flags;
  int pass, stop;
};

template <class P>
__device__ __forceinline__ Reg literal(const P& p, int f, int idx, int dt, bool* valid) {
  const int k = p.lit_scal[idx];
  if (k < 0) {
    *valid = p.lit_valid[idx] != 0;
    return lit_reg(p.lits[idx], dt);
  }
  const int j = f * p.hdr[H_SCAL] + k;
  *valid = p.fscal_valid[j] != 0;
  return lit_reg(p.fscal[j], dt);
}

// One instruction over the tile's rows; operand k comes from the uniform
// slot us[k] where that is >= 0, else from shared register reg[k].
template <int OP>
__device__ __forceinline__ void run_rows(const Tile& t, int dt, int dst, int imm, int r0, int r1,
                                         int r2, int u0, int u1, int u2, Reg d, Reg m) {
  constexpr int na = arity(OP);
  const int reg[3] = {r0, r1, r2};
  const int us[3] = {u0, u1, u2};
  Reg ux[3];
  bool uo[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    ux[k].i = 0;
    uo[k] = false;
    if (k < na && us[k] >= 0) {
      ux[k] = t.uval[us[k]];
      uo[k] = t.uok[us[k]] != 0;
    }
  }
  for (int r = threadIdx.x; r < t.n; r += kThreads) {
    Reg x[3];
    bool o[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      x[k] = ux[k];
      o[k] = uo[k];
      if (k < na && us[k] < 0) {
        x[k].i = t.val[reg[k] * t.T + r];
        o[k] = t.ok[reg[k] * t.T + r] != 0;
      }
    }
    Reg v;
    bool vok;
    alu(OP, dt, imm, x[0], o[0], x[1], o[1], x[2], o[2], d, m, v, vok);
    t.val[dst * t.T + r] = v.i;
    t.ok[dst * t.T + r] = vok;
  }
}

// A COL instruction: rows [base, base + n) of the file's lane into shared
// register dst, 16 bytes a load (rows past n are not read); with kAnyAlign,
// a lane whose start is off a 16-byte boundary one element a thread.
template <bool kAnyAlign>
__device__ __forceinline__ void load_col(const Tile& t, const void* vp, const uint8_t* kp,
                                         int dt, int dst, long long base) {
  long long* out = t.val + dst * t.T;
  uint8_t* okd = t.ok + dst * t.T;
  const int n = t.n;
  const int size = dt == I64 || dt == F64 ? 8 : dt == BOOL ? 1 : 4;
  if (kAnyAlign && ((uintptr_t)vp % 16 || (uintptr_t)kp % 16)) {
    // a lane that starts off a 16-byte boundary (a view at an offset):
    // one element a thread, consecutive threads on consecutive rows
    for (int r = threadIdx.x; r < n; r += kThreads) {
      const char* e = (const char*)vp + (base + r) * size;
      Reg x;
      x.i = 0;
      if (size == 8) x.i = *(const long long*)e;
      else if (dt == I32) x.i = *(const int*)e;
      else if (dt == F32) x.f = *(const float*)e;
      else x.i = *(const uint8_t*)e != 0;
      out[r] = x.i;
      okd[r] = kp == nullptr ? 1 : kp[base + r];
    }
    return;
  }
  if (dt == I64 || dt == F64) {
    const long long* src = (const long long*)vp + base;
    for (int v = threadIdx.x; 2 * v < n; v += kThreads) {
      if (2 * v + 2 <= n) {
        *(longlong2*)(out + 2 * v) = __ldg((const longlong2*)src + v);
      } else {
        out[2 * v] = src[2 * v];
      }
    }
  } else if (dt == I32 || dt == F32) {
    const int* src = (const int*)vp + base;
    for (int v = threadIdx.x; 4 * v < n; v += kThreads) {
      int e[4];
      if (4 * v + 4 <= n) {
        const int4 x = __ldg((const int4*)src + v);
        e[0] = x.x, e[1] = x.y, e[2] = x.z, e[3] = x.w;
      } else {
        for (int k = 0; k < 4; ++k) e[k] = 4 * v + k < n ? src[4 * v + k] : 0;
      }
      long long w[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        Reg r;
        r.i = 0;
        if (dt == I32) r.i = e[k];
        else r.f = __int_as_float(e[k]);
        w[k] = r.i;
      }
      *(longlong2*)(out + 4 * v) = make_longlong2(w[0], w[1]);
      *(longlong2*)(out + 4 * v + 2) = make_longlong2(w[2], w[3]);
    }
  } else {  // BOOL: one byte a row
    const uint8_t* src = (const uint8_t*)vp + base;
    for (int v = threadIdx.x; 16 * v < n; v += kThreads) {
      union {
        uint4 q;
        uint8_t b[16];
      } e;
      if (16 * v + 16 <= n) {
        e.q = __ldg((const uint4*)src + v);
      } else {
        for (int k = 0; k < 16; ++k) e.b[k] = 16 * v + k < n ? src[16 * v + k] : 0;
      }
#pragma unroll
      for (int k = 0; k < 16; k += 2)
        *(longlong2*)(out + 16 * v + k) = make_longlong2(e.b[k] != 0, e.b[k + 1] != 0);
    }
  }
  if (kp == nullptr) {
    for (int r = threadIdx.x; r < n; r += kThreads) okd[r] = 1;
    return;
  }
  const uint8_t* src = kp + base;
  for (int v = threadIdx.x; 16 * v < n; v += kThreads) {
    if (16 * v + 16 <= n) {
      *(uint4*)(okd + 16 * v) = __ldg((const uint4*)src + v);
    } else {
      for (int k = 0; 16 * v + k < n; ++k) okd[16 * v + k] = src[16 * v + k];
    }
  }
}

#define K14_CASE(OPC)                                                                  \
  case OPC:                                                                            \
    run_rows<OPC>(t, dt, dst, imm, ins[3], ins[4], ins[5], p.usrc[pc][1], p.usrc[pc][2], \
                  p.usrc[pc][3], d, m);                                                \
    break;

template <class P, bool K15>
__device__ __forceinline__ void masks_body(const P& p, const Out& o) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = p.hdr[H_TILE], n_regs = p.hdr[H_REGS], n_instr = p.hdr[H_INSTR];
  // this CTA's file: the first whose tiles end past blockIdx.x
  int lo = 0, hi = p.hdr[H_FILES] - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (p.tile_end[mid] > (int)blockIdx.x) hi = mid; else lo = mid + 1;
  }
  const int f = lo;
  const long long base = (long long)((int)blockIdx.x - (f ? p.tile_end[f - 1] : 0)) * T;
  const long long rows = p.rows[f];
  Tile t;
  t.val = (long long*)smem;
  t.ok = smem + (size_t)n_regs * T * 8;
  Reg* uval = (Reg*)(smem + (size_t)n_regs * T * 9);
  uint8_t* uok = (uint8_t*)(uval + n_instr);
  t.uval = uval;
  t.uok = uok;
  t.T = T;
  t.n = (int)min((long long)T, rows - base);

  // the literals, a thread each
  for (int pc = threadIdx.x; pc < n_instr; pc += kThreads) {
    if (p.usrc[pc][0] && p.ins[pc][0] == LIT) {
      bool vok;
      uval[pc] = literal(p, f, p.ins[pc][6], p.ins[pc][1], &vok);
      uok[pc] = vok;
    }
  }
  __syncthreads();
  // the other uniform instructions (computed from literals only), in order
  if (threadIdx.x == 0) {
    for (int pc = 0; pc < n_instr; ++pc) {
      const int op = p.ins[pc][0];
      if (!p.usrc[pc][0] || op == LIT) continue;
      const short* ins = p.ins[pc];
      const int dt = ins[1], imm = ins[6], imm2 = ins[7];
      Reg x[3], d, m, v;
      bool o[3], dv, vok;
      for (int k = 0; k < 3; ++k) {
        const int s = p.usrc[pc][1 + k];
        x[k].i = 0;
        o[k] = false;
        if (k < arity(op) && s >= 0) {
          x[k] = uval[s];
          o[k] = uok[s] != 0;
        }
      }
      d.i = m.i = 0;
      if (op == TIMEFIELD) {
        d = literal(p, f, imm, dt, &dv);
        m = literal(p, f, imm2, dt, &dv);
      }
      alu(op, dt, imm, x[0], o[0], x[1], o[1], x[2], o[2], d, m, v, vok);
      uval[pc] = v;
      uok[pc] = vok;
    }
  }
  __syncthreads();

  const int stop = K15 && o.pass >= 0 ? o.stop : n_instr;
  for (int pc = 0; pc < stop; ++pc) {
    if (p.usrc[pc][0]) continue;
    const short* ins = p.ins[pc];
    const int op = ins[0], dt = ins[1], dst = ins[2], imm = ins[6], imm2 = ins[7];
    if (K15 && op == FLAGALL) {
      // "some row of the option is NULL", reduced over the tile: one
      // atomic a CTA, in the launch that reduces this nesting level
      if (imm2 != o.pass) continue;
      const int a = ins[3], u = p.usrc[pc][1];
      bool null_row = false;
      if (u >= 0) {
        null_row = t.n > 0 && !uok[u];
      } else {
        for (int r = threadIdx.x; r < t.n; r += kThreads) null_row |= !t.ok[a * T + r];
      }
      if (__syncthreads_or(null_row) && threadIdx.x == 0) atomicOr(o.flags + imm, 1);
      continue;
    }
    if (op == COL) {
      const int j = 2 * (f * p.hdr[H_COLS] + imm);
      __syncthreads();  // the register's earlier readers are done
      // K14's host hands it 16-byte aligned lanes only
      load_col<K15>(t, p.ptr[j], (const uint8_t*)p.ptr[j + 1], dt, dst, base);
      __syncthreads();
      continue;
    }
    Reg d, m;
    d.i = m.i = 0;
    if (op == TIMEFIELD) {
      bool dv;
      d = literal(p, f, imm, dt, &dv);
      m = literal(p, f, imm2, dt, &dv);
    } else if (K15 && op == INFIN) {
      // the flags of the IN's options, final: earlier launches reduced them
      for (int k = 0; k < imm2; ++k) d.i |= o.flags[imm + k] != 0;
    }
    switch (op) {
      K14_CASE(CAST) K14_CASE(ADD) K14_CASE(SUB) K14_CASE(MUL) K14_CASE(DIV) K14_CASE(NEG)
      K14_CASE(EQ) K14_CASE(NE) K14_CASE(LT) K14_CASE(LE) K14_CASE(GT) K14_CASE(GE)
      K14_CASE(AND) K14_CASE(OR) K14_CASE(NOT) K14_CASE(ISNULL) K14_CASE(ISNOTNULL)
      K14_CASE(NSEQ) K14_CASE(INSTEP) K14_CASE(COALESCE) K14_CASE(CASESTEP) K14_CASE(ABS)
      K14_CASE(FLOOR) K14_CASE(CEIL) K14_CASE(EXP) K14_CASE(SQRT) K14_CASE(LOG) K14_CASE(POW)
      K14_CASE(TIMEFIELD) K14_CASE(TSDAYS) K14_CASE(CIVIL) K14_CASE(INROW) K14_CASE(INFIN)
      default:
        break;  // FLAGALL: above (K14's host refuses FLAGALL and INFIN)
    }
  }
  if (K15) {
    if (o.pass >= 0) return;
    // the root's value and validity in its dtype, this tile's rows
    const int root = p.hdr[H_ROOT], root_dt = p.hdr[H_ROOT_DT], slot = p.hdr[H_ROOT_SLOT];
    for (int r = threadIdx.x; r < t.n; r += kThreads) {
      Reg x;
      bool ok;
      if (slot >= 0) {
        x = uval[slot];
        ok = uok[slot] != 0;
      } else {
        x.i = t.val[root * T + r];
        ok = t.ok[root * T + r] != 0;
      }
      const long long row = base + r;
      switch (root_dt) {
        case BOOL: ((uint8_t*)o.value)[row] = x.i != 0; break;
        case I32: ((int32_t*)o.value)[row] = (int32_t)x.i; break;
        case I64: ((long long*)o.value)[row] = x.i; break;
        case F32: ((float*)o.value)[row] = x.f; break;
        default: ((double*)o.value)[row] = x.d; break;
      }
      o.valid[row] = ok;
    }
    return;
  }

  // the mask: this tile's rows, 0 past the file's rows up to its aligned end
  const int root = p.hdr[H_ROOT], root_dt = p.hdr[H_ROOT_DT], slot = p.hdr[H_ROOT_SLOT];
  const long long end16 = (rows + 15) & ~15ll;
  const int out_n = (int)min((long long)T, end16 - base);
  uint8_t* out = o.mask + p.out_off[f] + base;
  for (int r = threadIdx.x; r < out_n; r += kThreads) {
    bool truth = false;
    if (r < t.n) {
      Reg x;
      bool o;
      if (slot >= 0) {
        x = uval[slot];
        o = uok[slot] != 0;
      } else {
        x.i = t.val[root * T + r];
        o = t.ok[root * T + r] != 0;
      }
      truth = o && (root_dt == F32 ? x.f != 0.0f : root_dt == F64 ? x.d != 0.0 : x.i != 0);
    }
    out[r] = truth;
  }
}

__global__ void __launch_bounds__(kThreads)
residual_masks_kernel(const __grid_constant__ MaskParams p, const Out o) {
  masks_body<MaskParams, false>(p, o);
}

__global__ void __launch_bounds__(kThreads)
residual_masks_global_kernel(const MaskGlobal* __restrict__ p, const Out o) {
  masks_body<MaskGlobal, false>(*p, o);
}

__global__ void __launch_bounds__(kThreads)
expr_eval_kernel(const __grid_constant__ MaskParams p, const Out o) {
  masks_body<MaskParams, true>(p, o);
}

__global__ void __launch_bounds__(kThreads)
expr_eval_global_kernel(const MaskGlobal* __restrict__ p, const Out o) {
  masks_body<MaskGlobal, true>(*p, o);
}

// The block's header against its layout's capacities; the dynamic shared
// memory it needs in *smem.
template <class P>
int check_block(const P& p, size_t* smem) {
  const int n_instr = p.hdr[H_INSTR], n_files = p.hdr[H_FILES], n_cols = p.hdr[H_COLS],
            n_scal = p.hdr[H_SCAL], T = p.hdr[H_TILE], n_regs = p.hdr[H_REGS],
            n_tiles = p.hdr[H_TILES];
  if (n_instr < 1 || n_instr > P::kInstr || n_files < 1 || n_files > P::kFiles ||
      n_cols < 0 || 2 * n_cols * n_files > P::kPtrs || n_scal < 0 ||
      n_scal * n_files > P::kScal || T < 256 || T > 4096 || (T & (T - 1)) ||
      n_regs < 1 || n_regs > kMaxRegs || p.hdr[H_ROOT] < 0 || p.hdr[H_ROOT] >= n_regs ||
      p.hdr[H_ROOT_SLOT] >= n_instr || n_tiles != p.tile_end[n_files - 1])
    return (int)cudaErrorInvalidValue;
  *smem = (size_t)n_regs * T * 9 + (size_t)n_instr * 9;
  return 0;
}

// One launch of `kernel` over the block's tiles, the dynamic shared memory
// raised past 48 KB where the program needs it.
template <class K, class A>
int launch(K kernel, const A& arg, int tiles, size_t smem, const Out& o, cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<tiles, kThreads, smem, s>>>(arg, o);
  return (int)cudaGetLastError();
}

// K15's launches over one block: a launch per nesting level of the IN
// reductions (level `pass` reduced by the instructions up to its last
// FLAGALL), then the launch that writes the output.
template <class P, class K, class A>
int expr_launches(const P& p, K kernel, const A& arg, size_t smem, Out o, int passes,
                  cudaStream_t s) {
  const int n_instr = p.hdr[H_INSTR], tiles = p.hdr[H_TILES];
  bool flags = false;
  for (int pc = 0; pc < n_instr; ++pc) flags |= p.ins[pc][0] == FLAGALL;
  for (int pass = 0; flags && pass < passes; ++pass) {
    int stop = 0;
    for (int pc = 0; pc < n_instr; ++pc)
      if (p.ins[pc][0] == FLAGALL && p.ins[pc][7] == pass) stop = pc + 1;
    if (!stop) continue;
    o.pass = pass;
    o.stop = stop;
    const int err = launch(kernel, arg, tiles, smem, o, s);
    if (err) return err;
  }
  o.pass = -1;
  o.stop = n_instr;
  return launch(kernel, arg, tiles, smem, o, s);
}

}  // namespace

// K14 over one block of files: mask (the output, sum of the files' rows
// rounded up to 16 each, at the block's offsets) u8. `host` holds the block,
// a MaskParams or a MaskGlobal by `bytes`, and is checked before the launch.
// A MaskParams travels in the launch's parameters (`tables` null). A
// MaskGlobal is read by the kernel from `tables`, its copy on the card,
// which the caller has enqueued on `stream` before this call.
extern "C" int dtt_residual_masks(const void* host, long long bytes, const void* tables,
                                  uint8_t* mask, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const Out o{mask, nullptr, nullptr, nullptr, -1, 0};
  size_t smem = 0;
  int err;
  if (bytes == (long long)sizeof(MaskParams) && tables == nullptr) {
    const MaskParams& p = *(const MaskParams*)host;
    if ((err = check_block(p, &smem)) != 0) return err;
    if (p.hdr[H_TILES] == 0) return (int)cudaGetLastError();
    return launch(residual_masks_kernel, p, p.hdr[H_TILES], smem, o, s);
  }
  if (bytes == (long long)sizeof(MaskGlobal) && tables != nullptr) {
    const MaskGlobal& p = *(const MaskGlobal*)host;
    if ((err = check_block(p, &smem)) != 0) return err;
    if (p.hdr[H_TILES] == 0) return (int)cudaGetLastError();
    return launch(residual_masks_global_kernel, (const MaskGlobal*)tables, p.hdr[H_TILES], smem,
                  o, s);
  }
  return (int)cudaErrorInvalidValue;
}

// K15 over one block (a MaskParams or a MaskGlobal, as for K14) whose one
// file is the n rows of the stats lanes: value (n,) of the root's dtype and
// valid (n,) u8; flags (n_flags,) i32, zeroed here; passes: the program's
// nesting levels of IN reductions.
extern "C" int dtt_expr_eval(const void* host, long long bytes, const void* tables, void* value,
                             uint8_t* valid, int* flags, int n_flags, int passes,
                             void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const Out o{nullptr, value, valid, flags, -1, 0};
  size_t smem = 0;
  int err;
  if (n_flags > 0 && (err = (int)cudaMemsetAsync(flags, 0, 4ll * n_flags, s)) != 0) return err;
  if (bytes == (long long)sizeof(MaskParams) && tables == nullptr) {
    const MaskParams& p = *(const MaskParams*)host;
    if ((err = check_block(p, &smem)) != 0) return err;
    if (p.hdr[H_FILES] != 1 || p.hdr[H_TILES] == 0) return (int)cudaErrorInvalidValue;
    return expr_launches(p, expr_eval_kernel, p, smem, o, passes, s);
  }
  if (bytes == (long long)sizeof(MaskGlobal) && tables != nullptr) {
    const MaskGlobal& p = *(const MaskGlobal*)host;
    if ((err = check_block(p, &smem)) != 0) return err;
    if (p.hdr[H_FILES] != 1 || p.hdr[H_TILES] == 0) return (int)cudaErrorInvalidValue;
    return expr_launches(p, expr_eval_global_kernel, (const MaskGlobal*)tables, smem, o, passes,
                         s);
  }
  return (int)cudaErrorInvalidValue;
}
