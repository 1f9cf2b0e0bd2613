// Mixing operator Y = M X for a row-stochastic M [m, W] and X [W, d], any
// m, W >= 1; X fp32, bf16 or fp16 (xtype.cuh), M and Y fp32.
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
// What held the previous kernel (one thread a column, M read by a scalar
// shared load per FMA) back: 325 shared loads per warp per 32 columns at
// W = 25, m = 13, which kept the shared-memory pipe about as busy as the
// bytes bound; 4-byte loads, W * 4 bytes in flight a thread; and at
// d = 106,496, 416 blocks of 256 threads spread unevenly over 132 SMs.
// Design:
// - A thread owns 4 neighbouring columns: one 16-byte load brings a row's
//   four values (a warp reads 512 contiguous bytes of a row).
// - M sits transposed in shared memory, Mt[w][i] for a chunk of MC output
//   rows, so the MC values M[i0 .. i0 + MC)[w] of one w are MC / 4 16-byte
//   loads, each feeding 16 FMAs (at MC = 1, the combine, one scalar load
//   feeds 4). M tiles of BM_WT rows of W take any W.
// - The MC output rows sit in registers (acc[MC][4], MC = 1, 2, 4, 8, 16
//   or 32, the smallest >= m); m above 32 goes in chunks of 32 rows, each
//   reading X again. So the paper's m = 13 and m = 27 (n = 53, s = 2) are
//   one pass.
// - WB rows of X a thread in flight: a batch's WB loads are all issued
//   before its first FMA, and the first batch's before the tile of M is
//   staged, so a small call waits for one round trip to memory, not two.
//   16 rows (256 bytes a thread), which takes more than the 128 registers
//   of two blocks an SM, so the build asks for one; but 8 rows and two
//   blocks an SM at MC = 16.
// - The block size is fitted to the card: T threads (64 .. 256, a multiple
//   of 32) cover d / 4 / n_SM column groups, so at d = 106,496 119 blocks of
//   224 threads fall one to an SM, not 3 or 4 to some and 2 to others.
// - Rows whose four elements are not one vector load (d % 4 != 0, or a
//   base off 16 bytes for fp32, 8 for a 16-bit X: the per-leaf oracle's
//   leaves) take predicated scalar loads and stores (ALIGNED = false); the
//   arithmetic is the same. A 16-bit X is read as 8-byte vectors and
//   converted to fp32 at the load (xtype.cuh): half the bytes, the same
//   FMAs, the fp32 kernel's bits.
// Each output is the fmaf chain over w = 0 .. W-1 from 0.0f in that order,
// one thread per output and no atomics; steps past W are skipped, not
// multiplied by zero (fmaf(0, 0, -0.0f) is +0.0f, and 0 * Inf is NaN). So
// the result equals the previous kernel bit for bit, repeats bit for bit,
// and a column's bits do not depend on where it sits.

#define BM_THREADS 256  // most threads a block (the wrapper picks 64 .. 256)
#define BM_WT 256       // rows of W a shared tile of M^T holds
// rows of X a thread keeps in flight, and blocks an SM the build asks for
#define BM_WB(MC) ((MC) == 16 ? 8 : 16)
#define BM_MIN_BLOCKS(MC) ((MC) == 16 ? 2 : 1)

__device__ __forceinline__ void bm_fma4(float (&a)[4], float m, const float4& x) {
    a[0] = fmaf(m, x.x, a[0]);
    a[1] = fmaf(m, x.y, a[1]);
    a[2] = fmaf(m, x.z, a[2]);
    a[3] = fmaf(m, x.w, a[3]);
}

// acc[i][k] += Mt[w][i] * x[k] for the MC rows of a chunk; mw = &Mt[w][0]
template <int MC>
__device__ __forceinline__ void bm_fma_rows(float (&acc)[MC][4], const float* mw,
                                            const float4& x) {
    if constexpr (MC == 1) {
        bm_fma4(acc[0], mw[0], x);
    } else if constexpr (MC == 2) {
        const float2 m2 = *reinterpret_cast<const float2*>(mw);
        bm_fma4(acc[0], m2.x, x);
        bm_fma4(acc[1], m2.y, x);
    } else {
#pragma unroll
        for (int q = 0; q < MC / 4; ++q) {
            const float4 m4 = reinterpret_cast<const float4*>(mw)[q];
            bm_fma4(acc[4 * q + 0], m4.x, x);
            bm_fma4(acc[4 * q + 1], m4.y, x);
            bm_fma4(acc[4 * q + 2], m4.z, x);
            bm_fma4(acc[4 * q + 3], m4.w, x);
        }
    }
}

// the loads of rows t0 + w0 .. t0 + w0 + WB - 1 below t0 + wt, for a live thread
template <int WB, bool ALIGNED>
__device__ __forceinline__ void bm_load_batch(float4 (&x)[WB], const xt* __restrict__ xs,
                                              int t0, int w0, int wt, long long c0, long long d,
                                              bool live) {
#pragma unroll
    for (int j = 0; j < WB; ++j) {
        const xt* row = xs + (long long)(t0 + w0 + j) * d;
        if (live && w0 + j < wt) x[j] = xt_load4<ALIGNED>(row, c0, d);
    }
}

template <int MC, bool ALIGNED>
__global__ void __launch_bounds__(BM_THREADS, BM_MIN_BLOCKS(MC))
bucket_mix_kernel(const float* __restrict__ mix, const xt* __restrict__ xs,
                  float* __restrict__ out, int m, int W, long long d) {
    constexpr int WB = BM_WB(MC);
    __shared__ __align__(16) float smt[BM_WT * MC];
    const long long c0 = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 4;
    const bool live = c0 < d;
    for (int i0 = 0; i0 < m; i0 += MC) {
        float acc[MC][4];
#pragma unroll
        for (int i = 0; i < MC; ++i) {
#pragma unroll
            for (int k = 0; k < 4; ++k) acc[i][k] = 0.0f;
        }
        for (int t0 = 0; t0 < W; t0 += BM_WT) {
            const int wt = min(BM_WT, W - t0);
            // the first batch of X is in flight while the tile of M is staged
            float4 x[WB];
            bm_load_batch<WB, ALIGNED>(x, xs, t0, 0, wt, c0, d, live);
            __syncthreads();  // the previous tile's readers are done with it
            // Mt[w][i] = M[i0 + i][t0 + w]; rows past m are zeros whose
            // outputs are never stored
#pragma unroll 4
            for (int e = threadIdx.x; e < wt * MC; e += blockDim.x) {
                const int w = e / MC, i = e % MC;
                smt[e] = i0 + i < m ? mix[(long long)(i0 + i) * W + t0 + w] : 0.0f;
            }
            __syncthreads();
            for (int w0 = 0; w0 < wt; w0 += WB) {
                if (w0 > 0) bm_load_batch<WB, ALIGNED>(x, xs, t0, w0, wt, c0, d, live);
                if (!live) continue;
#pragma unroll
                for (int j = 0; j < WB; ++j) {
                    if (w0 + j < wt) bm_fma_rows<MC>(acc, smt + (w0 + j) * MC, x[j]);
                }
            }
        }
        if (!live) continue;
#pragma unroll
        for (int i = 0; i < MC; ++i) {
            if (i0 + i >= m) break;
            float* row = out + (long long)(i0 + i) * d;
            if constexpr (ALIGNED) {
                *reinterpret_cast<float4*>(row + c0) =
                    make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
            } else {
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    if (c0 + k < d) row[c0 + k] = acc[i][k];
                }
            }
        }
    }
}

template <int MC>
static int bm_launch(const float* mix, const xt* xs, float* out, int m, int W, long long d,
                     bool aligned, unsigned blocks, int threads, cudaStream_t stream) {
    if (aligned) {
        bucket_mix_kernel<MC, true><<<blocks, threads, 0, stream>>>(mix, xs, out, m, W, d);
    } else {
        bucket_mix_kernel<MC, false><<<blocks, threads, 0, stream>>>(mix, xs, out, m, W, d);
    }
    return (int)cudaGetLastError();
}

// mix [m, W] and out [m, d] fp32, xs [W, d] of X_T, contiguous; m, W, d >= 1;
// threads a multiple of 32 in 32 .. 256 (the wrapper fits it to the card).
// Returns cudaGetLastError() after the launch.
extern "C" int bucket_mix_launch(const float* mix, const xt* xs, float* out, int m, int W,
                                 long long d, int threads, cudaStream_t stream) {
    if (m < 1 || W < 1 || d < 1 || threads < 32 || threads > BM_THREADS || threads % 32)
        return (int)cudaErrorInvalidValue;
    const long long n_vec = (d + 3) / 4;
    const long long blocks = (n_vec + threads - 1) / threads;
    if (blocks > 0x7fffffffll) return (int)cudaErrorInvalidValue;
    const bool aligned = d % 4 == 0 && xt_aligned(xs) &&
                         reinterpret_cast<uintptr_t>(out) % 16 == 0;
    const unsigned b = (unsigned)blocks;
    if (m == 1) return bm_launch<1>(mix, xs, out, m, W, d, aligned, b, threads, stream);
    if (m == 2) return bm_launch<2>(mix, xs, out, m, W, d, aligned, b, threads, stream);
    if (m <= 4) return bm_launch<4>(mix, xs, out, m, W, d, aligned, b, threads, stream);
    if (m <= 8) return bm_launch<8>(mix, xs, out, m, W, d, aligned, b, threads, stream);
    if (m <= 16) return bm_launch<16>(mix, xs, out, m, W, d, aligned, b, threads, stream);
    return bm_launch<32>(mix, xs, out, m, W, d, aligned, b, threads, stream);
}
