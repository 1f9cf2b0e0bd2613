// Per-worker residual norms r_i = ||x_i - v||^2 for X [W, d] fp32, W <= 64.
// Needs row_sums.cuh before it (the wrapper prepends it).
//
// Replaces the Pallas TPU kernel repro/kernels/weiszfeld_norms.py::
// residual_norms (pallas_call at weiszfeld_norms.py:91): the inner loop of
// smoothed Weiszfeld (RFA) and the first norms pass of centered clipping.
// The centre v is given either as coefficients c [W] (v = c^T X, formed
// column by column in registers and never written out) or as an explicit
// row center [d].
//
// Bound on the H100: memory. The call must read X once (W * d * 4 bytes,
// plus d * 4 for an explicit centre) for 3 W d flops (2 W d more in the
// coefficient form): under 2 flops per byte.
//
// Design: one block per RS_TILE-column tile, one thread per column at a
// time. A warp reads 32 neighbouring columns of a row (128 coalesced
// bytes); the thread keeps its column's W values in registers, forms v_j
// from them (or loads center[j]) and adds (x_ij - v_j)^2 into W per-row
// register sums. The block's sums go to partial [W, n_tiles] and the fold
// kernel adds them up (row_sums.cuh). The TPU kernel sums its grid in
// order; this sum runs in another order, so the two agree to a tolerance,
// not bit for bit. The result does repeat bit for bit.

template <int MAX_W, bool COEFF>
__global__ void __launch_bounds__(RS_THREADS, RS_MIN_BLOCKS(MAX_W))
residual_norms_partial_kernel(const float* __restrict__ xs, const float* __restrict__ coeffs,
                              const float* __restrict__ center, float* __restrict__ partial,
                              int W, long long d, long long n_tiles) {
    __shared__ float sc[RS_MAX_W];
    if constexpr (COEFF) {
        if (threadIdx.x < W) sc[threadIdx.x] = coeffs[threadIdx.x];
        __syncthreads();
    }
    float acc[MAX_W];
#pragma unroll
    for (int w = 0; w < MAX_W; ++w) acc[w] = 0.0f;

    const long long c0 = (long long)blockIdx.x * RS_TILE;
    // one column at a time: unrolling would hold two columns' registers
#pragma unroll 1
    for (int k = threadIdx.x; k < RS_TILE && c0 + k < d; k += RS_THREADS) {
        const long long col = c0 + k;
        float x[MAX_W];
#pragma unroll
        for (int w = 0; w < MAX_W; ++w) x[w] = (w < W) ? xs[(long long)w * d + col] : 0.0f;
        float v;
        if constexpr (COEFF) {
            v = 0.0f;
#pragma unroll
            for (int w = 0; w < MAX_W; ++w)
                if (w < W) v = fmaf(sc[w], x[w], v);
        } else {
            v = center[col];
        }
#pragma unroll
        for (int w = 0; w < MAX_W; ++w) {
            if (w < W) {
                const float e = x[w] - v;
                acc[w] = fmaf(e, e, acc[w]);
            }
        }
    }
    rs_block_store<MAX_W>(acc, W, partial, n_tiles);
}

extern "C" int residual_norms_launch(const float* xs, const float* coeffs, const float* center,
                                     float* out, float* partial, int W, long long d,
                                     cudaStream_t stream) {
    const long long n_tiles = (d + RS_TILE - 1) / RS_TILE;
#define RN_LAUNCH(MW)                                                                      \
    if (coeffs) {                                                                          \
        residual_norms_partial_kernel<MW, true><<<(unsigned)n_tiles, RS_THREADS, 0, stream>>>( \
            xs, coeffs, center, partial, W, d, n_tiles);                                   \
    } else {                                                                               \
        residual_norms_partial_kernel<MW, false><<<(unsigned)n_tiles, RS_THREADS, 0, stream>>>( \
            xs, coeffs, center, partial, W, d, n_tiles);                                   \
    }
    RS_DISPATCH_W(W, RN_LAUNCH);
#undef RN_LAUNCH
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    rs_fold_kernel<<<W, RS_THREADS, 0, stream>>>(partial, out, n_tiles);
    return (int)cudaGetLastError();
}
