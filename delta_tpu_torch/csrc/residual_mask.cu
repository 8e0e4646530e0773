// Residual mask (K14): the Kleene-TRUE row mask of a scan's lowered residual
// predicate over one data file's resident column lanes.
//
// Replaces delta_tpu/ops/column_cache.py:312 `_mask_kernel` (one jitted XLA
// executable per rewritten expression over
// delta_tpu/expr/jaxeval.py:362 `compile_residual`'s output). Here the host
// lowers the residual once to the typed register program of the expression
// interpreter (delta_tpu_torch/expr/device_eval.py, `row_in=True`), and this
// one kernel, built once, runs any such program: one thread per row below
// `n`, `interpret` (csrc/expr_eval.cuh, shared with K15), then the mask
// `value != 0 && valid` written as one byte in the same launch. There is no
// second pass and no separate validity download.
//
// Lanes: int32 string codes, int32 epoch days, int64 epoch microseconds,
// int64, float64 and bool values, each with a bool validity, padded to a
// power of two (floor 64). Only the first `n` rows are read, so the pad
// never reaches a result. Per-file scalars (a string literal's code in this
// file's dictionary) are literals, filled into the literal table by the
// host before the launch. An IN takes each option's validity in its own
// row (INROW): the reference reduces it over every row of the padded lane,
// which makes every padded file's not-found rows NULL, and even over the
// real rows it would under-keep where an option column holds a NULL.
//
// What bounds it: bytes. Each row reads its lanes once (value + 1 B valid
// per column) and writes 1 B; the interpreter does a few dozen ALU
// operations per row, far below the card's rate. Registers live in local
// memory, as for K15.
#include "expr_eval.cuh"

namespace {

using namespace dtt;

constexpr int kThreads = 256;

__global__ void residual_mask_kernel(const long long* __restrict__ buf, int n_instr,
                                     int lit_off, int litv_off, int colv_off,
                                     int colk_off, long long n,
                                     uint8_t* __restrict__ mask, int root,
                                     int root_dt) {
  extern __shared__ int prog[];
  const int* gprog = (const int*)buf;
  for (int k = threadIdx.x; k < n_instr * 8; k += blockDim.x) prog[k] = gprog[k];
  __syncthreads();
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  Reg reg[kMaxRegs];
  bool ok[kMaxRegs];
  interpret(prog, n_instr, buf, lit_off, litv_off, colv_off, colk_off, row, 0, nullptr,
            reg, ok);
  const Reg r = reg[root];
  bool truth;
  switch (root_dt) {
    case F32: truth = r.f != 0.0f; break;
    case F64: truth = r.d != 0.0; break;
    default: truth = r.i != 0; break;
  }
  mask[row] = truth && ok[root];
}

}  // namespace

// buf: the program (n_instr x 8 int32), then int64 literals, literal
// validity, column value pointers and column valid pointers (0 = all
// valid), at the given int64 offsets; the program holds no FLAGALL. mask
// (n,) u8.
extern "C" int dtt_residual_mask(const long long* buf, int n_instr, int lit_off,
                                 int litv_off, int colv_off, int colk_off, long long n,
                                 uint8_t* mask, int root, int root_dt, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0) return (int)cudaGetLastError();
  const size_t smem = sizeof(int) * 8 * (size_t)n_instr;
  const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
  residual_mask_kernel<<<blocks, kThreads, smem, s>>>(buf, n_instr, lit_off, litv_off,
                                                      colv_off, colk_off, n, mask, root,
                                                      root_dt);
  return (int)cudaGetLastError();
}
