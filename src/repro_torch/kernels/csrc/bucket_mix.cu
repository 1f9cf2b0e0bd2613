// Mixing operator Y = M X for a row-stochastic M [m, W] and X [W, d], fp32.
//
// Replaces the Pallas TPU kernel repro/kernels/bucket_mix.py::bucket_mix
// (pallas_call at bucket_mix.py:42). On the main path it applies the
// bucketing / resampling matrix (Algorithm 1) and, with m = 1, the final
// weighted combine of the Gram route.
//
// Bound on the H100: memory. The call must read X once and write Y once,
// (W + m) * d * 4 bytes, against W * m * d FMAs: at W = 25, m = 13 that is
// about 2 FMAs per byte, far below the fp32 rate the card can sustain.
//
// Design: one thread per column. A warp reads 32 neighbouring columns of a
// row (128 coalesced bytes), so every byte of X is read once; the thread
// keeps its column's W values in registers and forms its m outputs from
// them, writing each output row coalesced the same way. The register array
// is sized by a template bound (8, 16, 32 or 64, the smallest >= W), so a
// small W does not pay 64 registers and the occupancy they cost. M (at
// most 64 x 64 floats, 16 KB) sits in shared memory, read as a broadcast.
// Each output sums w = 0 .. W-1 in that fixed order with fmaf, one thread
// per output and no atomics, so a result repeats bit for bit.

#include <cuda_runtime.h>

#define BM_MAX_M 64
#define BM_THREADS 256

template <int MAX_W>
__global__ void __launch_bounds__(BM_THREADS)
bucket_mix_kernel(const float* __restrict__ mix, const float* __restrict__ xs,
                  float* __restrict__ out, int m, int W, long long d) {
    __shared__ float sm[BM_MAX_M * 64];
    for (int t = threadIdx.x; t < m * W; t += blockDim.x) sm[t] = mix[t];
    __syncthreads();

    const long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (col >= d) return;

    float x[MAX_W];
#pragma unroll
    for (int w = 0; w < MAX_W; ++w) {
        x[w] = (w < W) ? xs[(long long)w * d + col] : 0.0f;
    }
    for (int i = 0; i < m; ++i) {
        const float* row = sm + i * W;
        float acc = 0.0f;
#pragma unroll
        for (int w = 0; w < MAX_W; ++w) {
            if (w < W) acc = fmaf(row[w], x[w], acc);
        }
        out[(long long)i * d + col] = acc;
    }
}

extern "C" int bucket_mix_launch(const float* mix, const float* xs, float* out,
                                 int m, int W, long long d, cudaStream_t stream) {
    const unsigned blocks = (unsigned)((d + BM_THREADS - 1) / BM_THREADS);
    if (W <= 8) {
        bucket_mix_kernel<8><<<blocks, BM_THREADS, 0, stream>>>(mix, xs, out, m, W, d);
    } else if (W <= 16) {
        bucket_mix_kernel<16><<<blocks, BM_THREADS, 0, stream>>>(mix, xs, out, m, W, d);
    } else if (W <= 32) {
        bucket_mix_kernel<32><<<blocks, BM_THREADS, 0, stream>>>(mix, xs, out, m, W, d);
    } else {
        bucket_mix_kernel<64><<<blocks, BM_THREADS, 0, stream>>>(mix, xs, out, m, W, d);
    }
    return (int)cudaGetLastError();
}
