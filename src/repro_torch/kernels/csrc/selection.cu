// Template: coordinate-wise order statistics of W worker rows, any W >= 1.
//
// kernels/cwise_median.py and kernels/trimmed_mean.py fill the three
// @-placeholders with the worker count, the unrolled compare-exchange
// program of selection_network.selection_program(W, ranks) and the
// statement that forms the result from the selected slots, then build the
// generated source (kernels/_build.py). This file is not compiled as is.
//
// Replaces the Pallas TPU kernels repro/kernels/cwise_median.py::cwise_median
// (pallas_call at cwise_median.py:63) and
// repro/kernels/trimmed_mean.py::cwise_trimmed_mean (pallas_call at
// trimmed_mean.py:63).
//
// Bound on the H100: memory. The call must read X [W, d] once and write
// [d] once, (W + 1) * d * 4 bytes, against one min and one max per
// comparator per column (113 comparators at W = 25).
//
// Design: one thread per column, its W values in registers (a warp reads
// 32 neighbouring columns of a row, 128 coalesced bytes). The program is
// straight-line code on literal register indices, so it needs no local
// memory and no branches on data. min and max are exact, and the result is
// formed with __fadd_rn / __fmul_rn (never contracted into an FMA) in
// the order the reference's compiled program uses, so the output equals the plain PyTorch
// version bit for bit on finite input. NaN: like torch.minimum and
// torch.maximum, a NaN in either input is returned (bare fminf/fmaxf would
// drop it).
//
// Any W takes this layout. ptxas holds the programs in registers without a
// spill at W = 65 and 128 (79 and 166-168 registers, chip_smoke.py's build
// phase prints them); wider programs spill to local memory: correct, and
// slower.

#include <cuda_runtime.h>

#define SEL_W @W@
#define SEL_THREADS 256

__device__ __forceinline__ float nan_min(float a, float b) {
    return (a != a) ? a : ((b != b) ? b : fminf(a, b));
}

__device__ __forceinline__ float nan_max(float a, float b) {
    return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}

#define CX(i, j)                              \
    {                                         \
        const float lo_ = nan_min(v[i], v[j]); \
        const float hi_ = nan_max(v[i], v[j]); \
        v[i] = lo_;                           \
        v[j] = hi_;                           \
    }

__global__ void __launch_bounds__(SEL_THREADS)
select_kernel(const float* __restrict__ xs, float* __restrict__ out, long long d) {
    const long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (col >= d) return;
    float v[SEL_W];
#pragma unroll
    for (int w = 0; w < SEL_W; ++w) v[w] = xs[(long long)w * d + col];
    // @PROGRAM@
    float res;
    // @RESULT@
    out[col] = res;
}

extern "C" int select_launch(const float* xs, float* out, long long d,
                             cudaStream_t stream) {
    const long long blocks = (d + SEL_THREADS - 1) / SEL_THREADS;
    select_kernel<<<(unsigned)blocks, SEL_THREADS, 0, stream>>>(xs, out, d);
    return (int)cudaGetLastError();
}
