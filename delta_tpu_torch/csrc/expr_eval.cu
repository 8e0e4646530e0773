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
// Layout: one thread per row (file); the program is staged in shared memory
// per block and run by `interpret` (csrc/expr_eval.cuh, shared with K14),
// which documents the registers and the semantics.
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
#include "expr_eval.cuh"

namespace {

using namespace dtt;

constexpr int kThreads = 256;

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
  Reg reg[kMaxRegs];
  bool ok[kMaxRegs];
  interpret(prog, n_instr, buf, lit_off, litv_off, colv_off, colk_off, row, pass, flags,
            reg, ok);
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
