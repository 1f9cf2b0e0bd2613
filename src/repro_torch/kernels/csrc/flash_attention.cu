// Causal GQA attention with a sliding window and a query offset, by online
// softmax: fp32 math on fp32 or bf16 inputs, the output in the input's type.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::
// flash_attention (pallas_call at flash_attention.py:105). q [B, Sq, H, dh],
// k and v [B, Skv, KV, dh]; query head h reads kv head h / (H / KV); query
// row i sits at position q_offset + i. A key is visible when
// kpos <= qpos (causal) and kpos > qpos - window (window > 0).
//
// Bound on the H100: operations. Each visible query-key pair costs 4 dh
// flops (QK^T and PV) against 2 dh input elements per key row shared by a
// whole query tile; at the model shapes (S = 4096) the work is ~10^11 flops
// against ~10^8 bytes. This first version does them as plain fp32 FMAs on
// the CUDA cores (67 TFLOP/s peak), not on the tensor cores (989 TFLOP/s
// in bf16): tensor cores, TMA and pipelining are the next step.
//
// Design: one block of 256 threads per (query tile of 64 rows, head, batch
// row). The tile's Q (pre-scaled by dh^-1/2, as the reference kernel does)
// sits in shared memory in fp32; a loop over 64-key tiles stages K, then V,
// through one shared buffer, converted to fp32 on load. The threads form a
// 16 x 16 grid: each computes a 4 x 4 block of S = Q K^T (rows ty + 16 i,
// keys tx + 16 j) and owns a 4 x (DH / 16) block of the output (dims
// tx + 16 j). The 16 threads of a row are one half-warp, so a row's max and
// sum are shuffle reductions; the running m, l and acc stay in registers.
// Shared rows have an odd stride (DH + 1), so the column reads of the grid
// fall on distinct banks. DH is a template (32, 64, 128, 256; smaller head
// dims are zero-padded in shared memory), which sizes the register block;
// at DH = 256 the buffers take 148 KB, so shared memory is dynamic and the
// launcher raises the kernel's limit first.
//
// Tiles that no row of the query tile can see are skipped. That changes
// nothing for a row with a visible key: the reference's masked terms are
// wiped out exactly (exp(-1e30 - m) = 0). A row with no visible key at all
// gets the reference's value, the uniform softmax over its all-masked
// logits: the mean of V over all Skv keys, from a second pass over V that
// only a block holding such a row makes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define FA_BQ 64        // query rows per block
#define FA_BKV 64       // keys per tile
#define FA_THREADS 256  // a 16 x 16 grid of threads
#define FA_NEG_INF (-1e30f)

__device__ __forceinline__ float fa_load(const float* p) { return *p; }
__device__ __forceinline__ float fa_load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void fa_store(float* p, float x) { *p = x; }
__device__ __forceinline__ void fa_store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Rows [row0, row0 + ROWS) of head `head` of a [batch, S, n_heads, dh]
// tensor into a [ROWS][DH + 1] fp32 tile, times `scale`, zero past S and dh.
template <typename T, int DH, int ROWS>
__device__ __forceinline__ void fa_load_tile(float* tile, const T* __restrict__ src, int batch,
                                             int row0, int S, int n_heads, int head, int dh,
                                             float scale) {
    for (int idx = threadIdx.x; idx < ROWS * DH; idx += FA_THREADS) {
        const int r = idx / DH, d = idx % DH, row = row0 + r;
        float x = 0.0f;
        if (row < S && d < dh) {
            x = fa_load(src + (((long long)batch * S + row) * n_heads + head) * dh + d);
        }
        tile[r * (DH + 1) + d] = x * scale;
    }
}

template <typename T, int DH>
__global__ void __launch_bounds__(FA_THREADS, 1)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int Sq, int Skv, int H,
                       int KV, int dh, int causal, int window, int q_offset, float scale) {
    constexpr int ND = DH / 16;  // output dims per thread
    extern __shared__ float smem[];
    float* qs = smem;                      // [FA_BQ][DH + 1]
    float* kvs = qs + FA_BQ * (DH + 1);    // [FA_BKV][DH + 1], K then V
    float* ps = kvs + FA_BKV * (DH + 1);   // [FA_BQ][FA_BKV + 1]

    const int q0 = blockIdx.x * FA_BQ, h = blockIdx.y, b = blockIdx.z;
    const int g = h / (H / KV);
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

    fa_load_tile<T, DH, FA_BQ>(qs, q, b, q0, Sq, H, h, dh, scale);

    // the keys that some row of this tile can see
    const int q_last = min(q0 + FA_BQ, Sq) - 1;
    const int k_lo = window > 0 ? max(0, q_offset + q0 - window + 1) : 0;
    const int k_hi = causal ? min(Skv, q_offset + q_last + 1) : Skv;

    float m[4], l[4], acc[4][ND];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m[i] = FA_NEG_INF;
        l[i] = 0.0f;
#pragma unroll
        for (int j = 0; j < ND; ++j) acc[i][j] = 0.0f;
    }

    for (int c0 = (k_lo / FA_BKV) * FA_BKV; c0 < k_hi; c0 += FA_BKV) {
        __syncthreads();  // Q is in; the last tile's reads of kvs and ps are done
        fa_load_tile<T, DH, FA_BKV>(kvs, k, b, c0, Skv, KV, g, dh, 1.0f);
        __syncthreads();

        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
        for (int d = 0; d < DH; ++d) {
            float a[4], bk[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * (DH + 1) + d];
#pragma unroll
            for (int j = 0; j < 4; ++j) bk[j] = kvs[(tx + 16 * j) * (DH + 1) + d];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
        }

        // online softmax; a masked key (or one past Skv) adds nothing
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int qpos = q_offset + q0 + ty + 16 * i;
            bool vis[4];
            float mx = FA_NEG_INF;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int kpos = c0 + tx + 16 * j;
                vis[j] = kpos < Skv && (!causal || kpos <= qpos) &&
                         (window <= 0 || kpos > qpos - window);
                if (vis[j]) mx = fmaxf(mx, s[i][j]);
            }
#pragma unroll
            for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
            const float m_new = fmaxf(m[i], mx);
            const float corr = expf(m[i] - m_new);
            float rs = 0.0f;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float p = vis[j] ? expf(s[i][j] - m_new) : 0.0f;
                ps[(ty + 16 * i) * (FA_BKV + 1) + tx + 16 * j] = p;
                rs += p;
            }
#pragma unroll
            for (int o = 8; o > 0; o >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, o);
            l[i] = l[i] * corr + rs;
            m[i] = m_new;
#pragma unroll
            for (int j = 0; j < ND; ++j) acc[i][j] *= corr;
        }
        __syncthreads();  // every read of K is done and P is complete
        fa_load_tile<T, DH, FA_BKV>(kvs, v, b, c0, Skv, KV, g, dh, 1.0f);
        __syncthreads();

#pragma unroll 4
        for (int c = 0; c < FA_BKV; ++c) {
            float p[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) p[i] = ps[(ty + 16 * i) * (FA_BKV + 1) + c];
#pragma unroll
            for (int j = 0; j < ND; ++j) {
                const float x = kvs[c * (DH + 1) + tx + 16 * j];
#pragma unroll
                for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], x, acc[i][j]);
            }
        }
    }

    // rows with no visible key: the mean of V over all keys, as the reference
    int empty = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) empty |= (q0 + ty + 16 * i < Sq) && (m[i] == FA_NEG_INF);
    if (__syncthreads_or(empty)) {
        float sum[ND];
#pragma unroll
        for (int j = 0; j < ND; ++j) sum[j] = 0.0f;
        for (int c0 = 0; c0 < Skv; c0 += FA_BKV) {
            __syncthreads();
            fa_load_tile<T, DH, FA_BKV>(kvs, v, b, c0, Skv, KV, g, dh, 1.0f);
            __syncthreads();
            for (int c = 0; c < FA_BKV; ++c)  // rows past Skv were loaded as zeros
#pragma unroll
                for (int j = 0; j < ND; ++j) sum[j] += kvs[c * (DH + 1) + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            if (m[i] == FA_NEG_INF) {
                l[i] = (float)Skv;
#pragma unroll
                for (int j = 0; j < ND; ++j) acc[i][j] = sum[j];
            }
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int row = q0 + ty + 16 * i;
        if (row >= Sq) continue;
        T* o = out + (((long long)b * Sq + row) * H + h) * dh;
        const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
        for (int j = 0; j < ND; ++j) {
            const int d = tx + 16 * j;
            if (d < dh) fa_store(o + d, acc[i][j] / denom);
        }
    }
}

template <typename T, int DH>
static int fa_launch(const void* q, const void* k, const void* v, void* out, int B, int Sq,
                     int Skv, int H, int KV, int dh, int causal, int window, int q_offset,
                     float scale, cudaStream_t stream) {
    const int smem = (int)sizeof(float) *
                     (FA_BQ * (DH + 1) + FA_BKV * (DH + 1) + FA_BQ * (FA_BKV + 1));
    // above 48 KB a kernel must ask for its dynamic shared memory first
    cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T, DH>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)((Sq + FA_BQ - 1) / FA_BQ), (unsigned)H, (unsigned)B);
    flash_attention_kernel<T, DH><<<grid, FA_THREADS, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (T*)out, Sq, Skv, H, KV, dh, causal, window,
        q_offset, scale);
    return (int)cudaGetLastError();
}

template <typename T>
static int fa_dispatch(const void* q, const void* k, const void* v, void* out, int B, int Sq,
                       int Skv, int H, int KV, int dh, int causal, int window, int q_offset,
                       float scale, cudaStream_t stream) {
    if (dh <= 32)
        return fa_launch<T, 32>(q, k, v, out, B, Sq, Skv, H, KV, dh, causal, window, q_offset,
                                scale, stream);
    if (dh <= 64)
        return fa_launch<T, 64>(q, k, v, out, B, Sq, Skv, H, KV, dh, causal, window, q_offset,
                                scale, stream);
    if (dh <= 128)
        return fa_launch<T, 128>(q, k, v, out, B, Sq, Skv, H, KV, dh, causal, window, q_offset,
                                 scale, stream);
    if (dh <= 256)
        return fa_launch<T, 256>(q, k, v, out, B, Sq, Skv, H, KV, dh, causal, window, q_offset,
                                 scale, stream);
    return (int)cudaErrorInvalidValue;
}

// bf16 != 0: q, k, v and out are __nv_bfloat16, else float. Contiguous
// tensors; 1 <= dh <= 256, H % KV == 0, B and H <= 65535 (checked by the
// wrapper). Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int B, int Sq, int Skv, int H, int KV, int dh,
                                      int causal, int window, int q_offset, float scale,
                                      int bf16, cudaStream_t stream) {
    if (bf16)
        return fa_dispatch<__nv_bfloat16>(q, k, v, out, B, Sq, Skv, H, KV, dh, causal, window,
                                          q_offset, scale, stream);
    return fa_dispatch<float>(q, k, v, out, B, Sq, Skv, H, KV, dh, causal, window, q_offset,
                              scale, stream);
}
