// In-place STREAM triad, a = a * scale + b over f32, for sm_90a (Hopper).
//
// Replaces the TPU kernel of tpu_operator/validator/microbench.py
// `_make_triad_kernel` (called through `_pallas_triad`, whose output is
// aliased onto `a` with input_output_aliases={0: 0}); `b` is left intact.
//
// What bounds it: one FMA per 12 bytes moved (two f32 reads, one f32 write),
// far below the H100's ridge, so it is bound by device-memory bandwidth
// (3.35 TB/s).  At the validator's 32768 x 2048 arrays that is 805 MB per
// pass, 16 times the 50 MB L2: nothing is reused, and what counts is keeping
// enough loads in flight on every SM until the last byte, and how the dirty
// lines of `a` leave the L2.
//
// Design (chosen on the card over a persistent bulk-copy ring; the times of
// both are in PERF.md):
//   * Each thread loads VECTORS float4s of `a` and of `b` before it stores
//     any.  `__restrict__` tells the compiler that the stores into `a` do not
//     alias `b`, so all 2 x VECTORS 16-byte loads are in flight at once; the
//     first port's grid-stride loop could not hoist the next loads above a
//     store and held one of each.
//   * A flat grid, one block per threads x VECTORS float4s, no persistent
//     loop: the hardware hands out blocks as SMs free up, so SMs that draw
//     more bandwidth take more of the array.  Every design measured that
//     split the array between SMs up front (the grid-stride loop, a
//     persistent ring of `cp.async.bulk` copies over contiguous or
//     interleaved ranges) ran 4-8% slower; the bulk-copy ring drew level
//     with this kernel only once its blocks claimed chunks from an atomic
//     counter, which then has to be reset before every launch.
//   * Stores take the streaming, evict-first policy (`st.global.cs`): the
//     dirty lines of `a` have no reuse and should leave the L2 first.  Loads
//     keep the default policy: evict-first loads measured slower, and 2%
//     slower still when the stores were left at the default.
//   * `b` must not share memory with `a`: it is read through the read-only
//     path (`LDG.E.128.CONSTANT`) that `__restrict__` opens.  The wrapper
//     (ops.triad_) refuses overlapping operands.
// The caller (ops._triad_plan) computes the grid; the CPU tests check that
// its blocks tile the array, and the entry point refuses any other grid.
#include <cuda_runtime.h>

namespace {

constexpr int VECTORS = 4;  // float4s of each array per thread
constexpr int MAX_THREADS = 1024;

__global__ void __launch_bounds__(MAX_THREADS)
    triad_inplace_kernel(float4* __restrict__ a, const float4* __restrict__ b, float scale,
                         long long n4) {
  const long long first =
      static_cast<long long>(blockIdx.x) * blockDim.x * VECTORS + threadIdx.x;
  float4 x[VECTORS], y[VECTORS];
#pragma unroll
  for (int v = 0; v < VECTORS; ++v) {
    const long long i = first + static_cast<long long>(v) * blockDim.x;
    if (i < n4) {
      x[v] = a[i];
      y[v] = b[i];
    }
  }
#pragma unroll
  for (int v = 0; v < VECTORS; ++v) {
    const long long i = first + static_cast<long long>(v) * blockDim.x;
    if (i < n4) {
      x[v].x = fmaf(x[v].x, scale, y[v].x);
      x[v].y = fmaf(x[v].y, scale, y[v].y);
      x[v].z = fmaf(x[v].z, scale, y[v].z);
      x[v].w = fmaf(x[v].w, scale, y[v].w);
      __stcs(a + i, x[v]);
    }
  }
}

}  // namespace

// a[i] = a[i] * scale + b[i] for n f32 elements (n a multiple of 4, both
// pointers 16-byte aligned, not overlapping) in `blocks` blocks of
// `threads`: the plan of ops._triad_plan, one block per threads x VECTORS
// float4s.  Refuses a grid that leaves a gap or launches an idle block.
// Returns a cudaError_t.
extern "C" int tot_triad_inplace(void* a, const void* b, float scale, long long n, int blocks,
                                 int threads, void* stream) {
  const long long n4 = n / 4;
  if (threads <= 0 || threads > MAX_THREADS || n4 <= 0) return cudaErrorInvalidValue;
  const long long span = static_cast<long long>(threads) * VECTORS;
  if (blocks != (n4 + span - 1) / span) return cudaErrorInvalidValue;
  triad_inplace_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float4*>(a), static_cast<const float4*>(b), scale, n4);
  return cudaGetLastError();
}
