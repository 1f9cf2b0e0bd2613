// Per-row sums over column tiles for cclip.cu (its wrapper prepends this
// text to the source before it is compiled).
//
// A kernel that reduces X [W, d] over its columns gives each block one
// RS_TILE-column tile. Its threads accumulate per-row partial sums in
// registers; rs_block_store adds them up in a fixed order (a warp
// butterfly, then the warps in index order) and writes the tile's W sums
// into partial [W, n_tiles], row-major so that a row's tiles lie together.
// rs_fold_kernel then gives each row one block: thread t sums tiles
// t, t + RS_THREADS, ... in order, and a fixed tree adds the threads' sums.
// No atomics and no order that depends on scheduling, so a result repeats
// bit for bit. The TPU kernels carry their sum through a sequential grid;
// blocks on Hopper run in no order, hence the second pass.

#include <cuda_runtime.h>

#define RS_TILE 2048
#define RS_THREADS 256
#define RS_WARPS (RS_THREADS / 32)
#define RS_MAX_W 64
// blocks per SM a register-held kernel asks the compiler to fit: two at
// MAX_W <= 32 (at most 128 registers a thread), one above
#define RS_MIN_BLOCKS(MAX_W) ((MAX_W) <= 32 ? 2 : 1)

template <int MAX_W>
__device__ __forceinline__ void rs_block_store(const float (&acc)[MAX_W], int W,
                                               float* __restrict__ partial,
                                               long long n_tiles) {
    __shared__ float red[RS_WARPS][MAX_W];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int w = 0; w < MAX_W; ++w) {
        if (w < W) {
            float s = acc[w];
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
                s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
            if (lane == 0) red[warp][w] = s;
        }
    }
    __syncthreads();
    if (threadIdx.x < W) {
        float s = red[0][threadIdx.x];
#pragma unroll
        for (int k = 1; k < RS_WARPS; ++k) s = __fadd_rn(s, red[k][threadIdx.x]);
        partial[(long long)threadIdx.x * n_tiles + blockIdx.x] = s;
    }
}

__global__ void __launch_bounds__(RS_THREADS)
rs_fold_kernel(const float* __restrict__ partial, float* __restrict__ out,
               long long n_tiles) {
    __shared__ float red[RS_THREADS];
    const float* row = partial + (long long)blockIdx.x * n_tiles;
    float s = 0.0f;
    for (long long t = threadIdx.x; t < n_tiles; t += RS_THREADS) s = __fadd_rn(s, row[t]);
    red[threadIdx.x] = s;
    __syncthreads();
    for (int half = RS_THREADS / 2; half > 0; half >>= 1) {
        if (threadIdx.x < half)
            red[threadIdx.x] = __fadd_rn(red[threadIdx.x], red[threadIdx.x + half]);
        __syncthreads();
    }
    if (threadIdx.x == 0) out[blockIdx.x] = red[0];
}

// Launch a kernel templated on the register bound MAX_W (8, 16, 32 or 64,
// the smallest >= W, for W <= RS_MAX_W), so a small W does not pay 64
// registers of each array.
#define RS_DISPATCH_W(W, LAUNCH) \
    do {                         \
        if ((W) <= 8) {          \
            LAUNCH(8);           \
        } else if ((W) <= 16) {  \
            LAUNCH(16);          \
        } else if ((W) <= 32) {  \
            LAUNCH(32);          \
        } else {                 \
            LAUNCH(64);          \
        }                        \
    } while (0)
