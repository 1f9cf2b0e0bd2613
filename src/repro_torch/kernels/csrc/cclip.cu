// Centered-clipping update v' = v + (1/W) sum_i lam_i (x_i - v) for
// X [W, d] fp32, any W >= 1, with the clip weights lam [W] already known.
// Needs row_sums.cuh before it (the wrapper prepends it). Two entries:
//
// cclip_fused_launch replaces the Pallas TPU kernel repro/kernels/
//   cclip_fused.py::cclip_fused_iter (pallas_call at cclip_fused.py:62):
//   it writes v' and, from the same registers, the next iteration's
//   residual norms r_i = ||x_i - v'||^2, so an iteration reads X once.
// cclip_combine_launch replaces repro/kernels/cclip_combine.py::
//   cclip_combine (pallas_call at cclip_combine.py:45): the update alone,
//   the unfused schedule's combine pass.
//
// Bound on the H100: memory. Each call must read X and v once and write v'
// once ((W + 2) d * 4 bytes) for 2 W d flops (5 W d fused): under 2 flops
// per byte.
//
// Design: one thread per column, as in bucket_mix.cu; lam sits in shared
// memory, read as a broadcast. The update sums w = 0 .. W-1 in order with
// fmaf and scales the sum by the fp32 reciprocal of W, the unpadded count,
// taken once: a division per column would put the IEEE division's
// slow-path call in the loop. The fused kernel keeps the
// column's W values in registers to reuse them for the norms, whose block
// sums are folded by row_sums.cuh's second kernel: bitwise repeatable.
// The combine needs no cross-block reduction and no fold.
//
// Above RS_MAX_W = 64 rows a column's values do not fit the register
// arrays: cclip_fused_rows_kernel forms the update with the same fmaf
// chain streaming the W rows, keeps each column's v' in shared memory, and
// then sums the norms 64 rows at a time over the same columns in the same
// order (X read twice, the second time mostly from L2); the combine reads
// lam from global memory instead of shared. Both are for correctness above
// 64 workers, not speed; at W <= 64 the code paths are as before.

template <int MAX_W>
__global__ void __launch_bounds__(RS_THREADS, RS_MIN_BLOCKS(MAX_W))
cclip_fused_partial_kernel(const float* __restrict__ xs, const float* __restrict__ v,
                           const float* __restrict__ lam, float* __restrict__ vout,
                           float* __restrict__ partial, int W, long long d, long long n_tiles) {
    __shared__ float sl[RS_MAX_W];
    if (threadIdx.x < W) sl[threadIdx.x] = lam[threadIdx.x];
    __syncthreads();
    const float inv_count = 1.0f / (float)W;
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
        const float vc = v[col];
        float upd = 0.0f;
#pragma unroll
        for (int w = 0; w < MAX_W; ++w)
            if (w < W) upd = fmaf(sl[w], x[w] - vc, upd);
        const float vn = vc + upd * inv_count;
        vout[col] = vn;
#pragma unroll
        for (int w = 0; w < MAX_W; ++w) {
            if (w < W) {
                const float e = x[w] - vn;
                acc[w] = fmaf(e, e, acc[w]);
            }
        }
    }
    rs_block_store<MAX_W>(acc, W, partial, n_tiles);
}

// W > RS_MAX_W: the update streamed over the rows, then the norms in
// groups of RS_MAX_W rows
__global__ void __launch_bounds__(RS_THREADS)
cclip_fused_rows_kernel(const float* __restrict__ xs, const float* __restrict__ v,
                        const float* __restrict__ lam, float* __restrict__ vout,
                        float* __restrict__ partial, int W, long long d, long long n_tiles) {
    __shared__ float svn[RS_TILE];
    const float inv_count = 1.0f / (float)W;
    const long long c0 = (long long)blockIdx.x * RS_TILE;
#pragma unroll 1
    for (int k = threadIdx.x; k < RS_TILE && c0 + k < d; k += RS_THREADS) {
        const long long col = c0 + k;
        const float vc = v[col];
        float upd = 0.0f;
#pragma unroll 8
        for (int w = 0; w < W; ++w)
            upd = fmaf(__ldg(lam + w), xs[(long long)w * d + col] - vc, upd);
        const float vn = vc + upd * inv_count;
        vout[col] = vn;
        svn[k] = vn;  // read back by this thread only
    }
    for (int g0 = 0; g0 < W; g0 += RS_MAX_W) {
        float acc[RS_MAX_W];
#pragma unroll
        for (int w = 0; w < RS_MAX_W; ++w) acc[w] = 0.0f;
#pragma unroll 1
        for (int k = threadIdx.x; k < RS_TILE && c0 + k < d; k += RS_THREADS) {
            const float* x = xs + (long long)g0 * d + c0 + k;
            const float vn = svn[k];
#pragma unroll
            for (int w = 0; w < RS_MAX_W; ++w) {
                if (g0 + w < W) {
                    const float e = x[(long long)w * d] - vn;
                    acc[w] = fmaf(e, e, acc[w]);
                }
            }
        }
        rs_block_store<RS_MAX_W>(acc, min(RS_MAX_W, W - g0), partial + (long long)g0 * n_tiles,
                                 n_tiles);
        __syncthreads();  // rs_block_store's shared sums are written again next group
    }
}

// SHARED_LAM: lam staged in shared memory (W <= RS_MAX_W), else read from
// global memory
template <bool SHARED_LAM>
__global__ void __launch_bounds__(RS_THREADS)
cclip_combine_kernel(const float* __restrict__ xs, const float* __restrict__ v,
                     const float* __restrict__ lam, float* __restrict__ out, int W, long long d) {
    __shared__ float sl[RS_MAX_W];
    if constexpr (SHARED_LAM) {
        if (threadIdx.x < W) sl[threadIdx.x] = lam[threadIdx.x];
        __syncthreads();
    }
    const long long col = (long long)blockIdx.x * RS_THREADS + threadIdx.x;
    if (col >= d) return;
    const float vc = v[col];
    float upd = 0.0f;
#pragma unroll 8
    for (int w = 0; w < W; ++w) {
        const float lw = SHARED_LAM ? sl[w] : __ldg(lam + w);
        upd = fmaf(lw, xs[(long long)w * d + col] - vc, upd);
    }
    out[col] = vc + upd * (1.0f / (float)W);
}

extern "C" int cclip_fused_launch(const float* xs, const float* v, const float* lam,
                                  float* vout, float* r2, float* partial, int W, long long d,
                                  cudaStream_t stream) {
    const long long n_tiles = (d + RS_TILE - 1) / RS_TILE;
#define CF_LAUNCH(MW)                                                                 \
    cclip_fused_partial_kernel<MW><<<(unsigned)n_tiles, RS_THREADS, 0, stream>>>(     \
        xs, v, lam, vout, partial, W, d, n_tiles)
    if (W > RS_MAX_W) {
        cclip_fused_rows_kernel<<<(unsigned)n_tiles, RS_THREADS, 0, stream>>>(
            xs, v, lam, vout, partial, W, d, n_tiles);
    } else {
        RS_DISPATCH_W(W, CF_LAUNCH);
    }
#undef CF_LAUNCH
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    rs_fold_kernel<<<W, RS_THREADS, 0, stream>>>(partial, r2, n_tiles);
    return (int)cudaGetLastError();
}

extern "C" int cclip_combine_launch(const float* xs, const float* v, const float* lam,
                                    float* out, int W, long long d, cudaStream_t stream) {
    const unsigned blocks = (unsigned)((d + RS_THREADS - 1) / RS_THREADS);
    if (W > RS_MAX_W) {
        cclip_combine_kernel<false><<<blocks, RS_THREADS, 0, stream>>>(xs, v, lam, out, W, d);
    } else {
        cclip_combine_kernel<true><<<blocks, RS_THREADS, 0, stream>>>(xs, v, lam, out, W, d);
    }
    return (int)cudaGetLastError();
}
