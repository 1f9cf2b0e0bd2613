// Worker Gram matrix G = acc + X X^T for X [W, d] fp32, W <= 64.
//
// Replaces the Pallas TPU kernel repro/kernels/pairwise_gram.py::pairwise_gram
// (pallas_call at pairwise_gram.py:70): the stats phase of Krum, RFA, CCLIP,
// ACClip and the mean on the Gram route of the packed engine.
//
// Bound on the H100: memory at the widths the path uses. The call must read
// X once (W * d * 4 bytes) for W (W + 1) d flops of the upper triangle:
// 6.5 flops per byte at W = 25, 16 at W = 64, under the ~20 flops per byte
// at which fp32 CUDA-core arithmetic (67 TFLOP/s) would take over. Shared
// memory bandwidth is the nearer limit for a kernel that re-reads its tile
// per pair; the 4 x 4 register tiles below cut those reads fourfold.
//
// Design. The TPU kernel carries its [W, W] sum across a sequential grid.
// Hopper blocks run in no order, so the sum is taken in two passes:
//   (a) gram_partial_kernel: one block per GR_TILE-column tile. The tile is
//       staged through shared memory `sub` columns at a time (rows padded
//       to a multiple of 4 with zeros; row stride sub + 1 to spread rows
//       over the banks; `sub` as wide as ~32 KB allows, so a narrow X
//       takes few staging rounds). The rows form 4-row blocks; a work item
//       is one upper-triangle block pair (I <= J) and one lane, and sums a
//       4 x 4 register tile of dot products over the columns k = lane
//       (mod L) of each sub-tile in order with fmaf: 8 shared loads feed 16
//       FMAs. The lanes' tiles are then added in lane order, and the
//       tile's upper triangle goes to scratch [n_tiles, P], P = W (W+1)/2.
//   (b) gram_fold_kernel: one thread per pair folds the partials serially
//       in tile order, starting from acc, and writes both G[i, j] and
//       G[j, i], so G is exactly symmetric when acc is.
// No atomics and a fixed order everywhere: G repeats bit for bit, and since
// a tile never depends on where it sits, a chain of calls over
// GR_TILE-aligned column segments, each seeded with the previous G as acc,
// performs the same fp32 operations as one call over the whole buffer (the
// packer pads every leaf to a multiple of 2048 columns for this).

#include <cuda_runtime.h>

#define GR_TILE 2048
#define GR_THREADS 256
#define GR_SMEM_FLOATS 8192  // staged tile budget: Wp * sub <= this
#define GR_FOLD_BATCH 32

// p-th pair (i <= j) of the row-major upper triangle of an n x n matrix
__device__ __forceinline__ void unpair(int p, int n, int* i, int* j) {
    int r = 0;
    while (p >= n - r) {
        p -= n - r;
        ++r;
    }
    *i = r;
    *j = r + p;
}

__device__ __forceinline__ int pair_index(int i, int j, int n) {
    return i * n - i * (i - 1) / 2 + (j - i);
}

__global__ void __launch_bounds__(GR_THREADS)
gram_partial_kernel(const float* __restrict__ xs, float* __restrict__ partial,
                    int W, long long d, int sub, int L) {
    extern __shared__ float smem[];
    const int Wp = (W + 3) & ~3;
    const int nb = Wp / 4;
    const int NB = nb * (nb + 1) / 2;
    const int P = W * (W + 1) / 2;
    const int stride = sub + 1;
    const int tid = threadIdx.x;
    const long long c0 = (long long)blockIdx.x * GR_TILE;

    const bool active = tid < NB * L;
    const int lane = tid / NB;
    int I = 0, J = 0;
    if (active) unpair(tid % NB, nb, &I, &J);
    const float* rowa = smem + 4 * I * stride;
    const float* rowb = smem + 4 * J * stride;

    float acc[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = 0.0f;

    for (int s = 0; s < GR_TILE && c0 + s < d; s += sub) {
        for (int t = tid; t < Wp * sub; t += GR_THREADS) {
            const int w = t / sub;
            const int k = t - w * sub;
            const long long c = c0 + s + k;
            smem[w * stride + k] = (w < W && c < d) ? xs[(long long)w * d + c] : 0.0f;
        }
        __syncthreads();
        if (active) {
            for (int k = lane; k < sub; k += L) {
                float a[4], b[4];
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    a[u] = rowa[u * stride + k];
                    b[u] = rowb[u * stride + k];
                }
#pragma unroll
                for (int u = 0; u < 4; ++u)
#pragma unroll
                    for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(a[u], b[v], acc[u][v]);
            }
        }
        __syncthreads();
    }

    // lane reduction in lane order, through the (now free) staging buffer
    float* red = smem;
    if (active) {
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int v = 0; v < 4; ++v) red[tid * 16 + u * 4 + v] = acc[u][v];
    }
    __syncthreads();
    for (int q = tid; q < NB * 16; q += GR_THREADS) {
        const int bp = q / 16;
        const int e = q - bp * 16;
        int BI, BJ;
        unpair(bp, nb, &BI, &BJ);
        const int i = 4 * BI + e / 4;
        const int j = 4 * BJ + e % 4;
        if (i >= W || j >= W || i > j) continue;
        float v = red[bp * 16 + e];
        for (int l = 1; l < L; ++l) v = __fadd_rn(v, red[(l * NB + bp) * 16 + e]);
        partial[(long long)blockIdx.x * P + pair_index(i, j, W)] = v;
    }
}

__global__ void gram_fold_kernel(const float* __restrict__ partial,
                                 const float* __restrict__ acc,
                                 float* __restrict__ out,
                                 int W, int P, long long n_tiles) {
    const int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= P) return;
    int i, j;
    unpair(p, W, &i, &j);
    float g_ij = acc ? acc[i * W + j] : 0.0f;
    float g_ji = acc ? acc[j * W + i] : 0.0f;
    long long t = 0;
    // loads of a batch are issued together; the adds stay in tile order
    for (; t + GR_FOLD_BATCH <= n_tiles; t += GR_FOLD_BATCH) {
        float v[GR_FOLD_BATCH];
#pragma unroll
        for (int u = 0; u < GR_FOLD_BATCH; ++u) v[u] = partial[(t + u) * P + p];
#pragma unroll
        for (int u = 0; u < GR_FOLD_BATCH; ++u) {
            g_ij = __fadd_rn(g_ij, v[u]);
            g_ji = __fadd_rn(g_ji, v[u]);
        }
    }
    for (; t < n_tiles; ++t) {
        const float v = partial[t * P + p];
        g_ij = __fadd_rn(g_ij, v);
        g_ji = __fadd_rn(g_ji, v);
    }
    out[i * W + j] = g_ij;
    out[j * W + i] = g_ji;
}

extern "C" int pairwise_gram_launch(const float* xs, const float* acc, float* out,
                                    float* partial, int W, long long d,
                                    cudaStream_t stream) {
    const int P = W * (W + 1) / 2;
    const int Wp = (W + 3) & ~3;
    const int nb = Wp / 4;
    const int NB = nb * (nb + 1) / 2;
    const int L = GR_THREADS / NB;  // NB <= 136 for W <= 64
    int sub = GR_TILE;
    while (Wp * sub > GR_SMEM_FLOATS) sub /= 2;
    const int tile_floats = Wp * (sub + 1);
    const int red_floats = NB * L * 16;
    const size_t smem = sizeof(float) * (tile_floats > red_floats ? tile_floats : red_floats);
    const long long n_tiles = (d + GR_TILE - 1) / GR_TILE;
    gram_partial_kernel<<<(unsigned)n_tiles, GR_THREADS, smem, stream>>>(xs, partial, W, d,
                                                                        sub, L);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    gram_fold_kernel<<<(P + 127) / 128, 128, 0, stream>>>(partial, acc, out, W, P, n_tiles);
    return (int)cudaGetLastError();
}
