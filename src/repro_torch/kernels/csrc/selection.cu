// Template: coordinate-wise order statistics of W worker rows, any W >= 1.
//
// kernels/cwise_median.py and kernels/trimmed_mean.py fill the three
// @-placeholders with the worker count, the unrolled compare-exchange
// program of selection_network.selection_program(W, ranks) and the
// statements that form a column's result from the selected slots, prepend
// the element type of X (xtype.cuh: fp32, bf16 or fp16, converted to fp32
// at the load), then build the generated source (kernels/_build.py). This
// file is not compiled as is.
//
// Replaces the Pallas TPU kernels repro/kernels/cwise_median.py::cwise_median
// (pallas_call at cwise_median.py:63) and
// repro/kernels/trimmed_mean.py::cwise_trimmed_mean (pallas_call at
// trimmed_mean.py:63).
//
// Bound on the H100: the call reads X [W, d] once and writes [d] once,
// (W + 1) * d * 4 bytes for fp32 X ((2 W + 4) * d for 16-bit X), and runs a min or a max per live comparator
// output per column. sm_90 completes 64 min / max results a clock an SM, half
// its fp32 add rate, so the bytes bind at small W and the two meet near
// W = 128 (2,300 live min / max a column for the median there).
//
// What held the previous kernel back: the NaN-aware min / max at every
// comparator compiled to about 7.5 instructions, a branch among them, where
// one FMNMX does (it took 1.6x this kernel's time at X[27, 16.7 M] and 8x
// at X[128, 106,496]). Above 32
// rows, 256-thread blocks of 174 registers (W = 128) fit one to an SM, so
// d = 106,496 took four rounds of blocks. Design:
// - A thread holds one column's W values in registers and runs the program
//   on literal register indices (a warp reads 32 neighbouring columns of a
//   row, 128 coalesced bytes). NaN is tested once per column: a column with
//   no NaN runs the program with bare fminf / fmaxf, which is exactly
//   nan_min / nan_max on non-NaN input (signed zeros included: the same
//   fminf decides them); a column that holds a NaN runs it with nan_min /
//   nan_max, as before. The program is written once (sel_program<NANS>).
// - The wrapper picks the block size: up to 32 rows the fewest threads that
//   cover d with one block an SM (256 at d = 106,496); above, 64, so blocks
//   of many registers pack five to an SM at W = 128.
// - Tried and not kept (scripts/selection_ablation.py, PERF.md): 4 columns a
//   thread with 16-byte loads, a persistent grid staging the next tile
//   through shared memory by cp.async, and one prefetching it into L2: none
//   was faster at any shape timed. ptxas holds the program in registers
//   without a spill up to W = 128 (174 registers there); wider programs
//   spill to local memory: correct, and slower.
// min and max are exact, and the result is formed with __fadd_rn /
// __fmul_rn (never contracted into an FMA) in the order the reference's
// compiled program uses, so the output equals the plain PyTorch version bit
// for bit. NaN: like torch.minimum and torch.maximum, a NaN in either input
// is returned.

#define SEL_W @W@
#define SEL_THREADS 256  // most threads a block

__device__ __forceinline__ float nan_min(float a, float b) {
    return (a != a) ? a : ((b != b) ? b : fminf(a, b));
}

__device__ __forceinline__ float nan_max(float a, float b) {
    return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}

template <bool NANS>
__device__ __forceinline__ void sel_cx(float& a, float& b) {
    const float lo = NANS ? nan_min(a, b) : fminf(a, b);
    const float hi = NANS ? nan_max(a, b) : fmaxf(a, b);
    a = lo;
    b = hi;
}

#define CX(i, j) sel_cx<NANS>(v[i], v[j]);

template <bool NANS>
__device__ __forceinline__ void sel_program(float (&v)[SEL_W]) {
    // @PROGRAM@
}

// the program over a column, NaN-aware only where the column holds a NaN,
// and the result from the selected slots
__device__ __forceinline__ float sel_select(float (&v)[SEL_W]) {
    bool nan = false;
#pragma unroll
    for (int w = 0; w < SEL_W; ++w) nan |= v[w] != v[w];
    if (nan) {
        sel_program<true>(v);
    } else {
        sel_program<false>(v);
    }
    float res;
    // @RESULT@
    return res;
}

__global__ void __launch_bounds__(SEL_THREADS)
select_kernel(const xt* __restrict__ xs, float* __restrict__ out, long long d) {
    const long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (col >= d) return;
    float v[SEL_W];
#pragma unroll
    for (int w = 0; w < SEL_W; ++w) v[w] = xt_ldg(xs + (long long)w * d + col);
    out[col] = sel_select(v);
}

// xs [W, d] of X_T, out [d] fp32, contiguous; d >= 1; threads a multiple of 32 in
// 32 .. 256 (the wrapper picks it).
extern "C" int select_launch(const xt* xs, float* out, long long d, int threads,
                             cudaStream_t stream) {
    if (d < 1 || threads < 32 || threads > SEL_THREADS || threads % 32)
        return (int)cudaErrorInvalidValue;
    const long long blocks = (d + threads - 1) / threads;
    if (blocks > 0x7fffffffll) return (int)cudaErrorInvalidValue;
    select_kernel<<<(unsigned)blocks, threads, 0, stream>>>(xs, out, d);
    return (int)cudaGetLastError();
}
