// Centered-clipping update v' = v + (1/W) sum_i lam_i (x_i - v) for
// X [W, d] fp32, bf16 or fp16 (xtype.cuh: converted to fp32 at the load),
// any W >= 1, with the clip weights lam [W] already known; v, lam and v'
// fp32.
//
// Replaces the Pallas TPU kernel repro/kernels/cclip_combine.py::
// cclip_combine (pallas_call at cclip_combine.py:45): the update alone, the
// combine pass of the unfused schedule. The fused iteration (the update
// and the next residual norms in one pass) is the CLIP form of
// residual_norms.cu.
//
// Bound on the H100: memory. A call must read X and v once and write v'
// once ((W + 2) d * 4 bytes) for 3 W d flops: under 2 flops per byte.
//
// Design: one thread per column; lam sits in shared memory, read as a
// broadcast (from global memory above CC_MAX_W rows). The update sums
// w = 0 .. W-1 in order with fmaf and scales the sum by the fp32
// reciprocal of W, the unpadded count: a division per column would put
// the IEEE division's slow-path call in the loop. residual_norms.cu's CLIP
// form computes the same chain, so the two give the same bits. No
// cross-block reduction and no fold.

#define CC_THREADS 256
#define CC_MAX_W 64  // weights staged in shared memory up to this many rows

// SHARED_LAM: lam staged in shared memory (W <= CC_MAX_W), else read from
// global memory
template <bool SHARED_LAM>
__global__ void __launch_bounds__(CC_THREADS)
cclip_combine_kernel(const xt* __restrict__ xs, const float* __restrict__ v,
                     const float* __restrict__ lam, float* __restrict__ out, int W, long long d) {
    __shared__ float sl[CC_MAX_W];
    if constexpr (SHARED_LAM) {
        if (threadIdx.x < W) sl[threadIdx.x] = lam[threadIdx.x];
        __syncthreads();
    }
    const long long col = (long long)blockIdx.x * CC_THREADS + threadIdx.x;
    if (col >= d) return;
    const float vc = v[col];
    float upd = 0.0f;
#pragma unroll 8
    for (int w = 0; w < W; ++w) {
        const float lw = SHARED_LAM ? sl[w] : __ldg(lam + w);
        upd = fmaf(lw, xt_float(xs[(long long)w * d + col]) - vc, upd);
    }
    out[col] = vc + upd * (1.0f / (float)W);
}

extern "C" int cclip_combine_launch(const xt* xs, const float* v, const float* lam,
                                    float* out, int W, long long d, cudaStream_t stream) {
    const unsigned blocks = (unsigned)((d + CC_THREADS - 1) / CC_THREADS);
    if (W > CC_MAX_W) {
        cclip_combine_kernel<false><<<blocks, CC_THREADS, 0, stream>>>(xs, v, lam, out, W, d);
    } else {
        cclip_combine_kernel<true><<<blocks, CC_THREADS, 0, stream>>>(xs, v, lam, out, W, d);
    }
    return (int)cudaGetLastError();
}
