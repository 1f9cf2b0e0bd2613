// Per-worker residual norms r_i = ||x_i - v||^2 for X [W, d], any W >= 1,
// against a centre v in one of three forms (FORM). X is fp32, bf16 or fp16
// (xtype.cuh: converted to fp32 at the load, 8-byte vectors of four for a
// 16-bit X); the centre, coefficients, lam and every output are fp32.
//
// RN_GIVEN, RN_COEFF: replace the Pallas TPU kernel repro/kernels/
//   weiszfeld_norms.py::residual_norms (pallas_call at weiszfeld_norms.py:91),
//   the inner loop of smoothed Weiszfeld (RFA) and the first norms pass of
//   centered clipping. The centre is an explicit row center [d] (GIVEN) or
//   coefficients c [W] (COEFF: v = c^T X, formed column by column in
//   registers and never written out). Entry: residual_norms_launch.
// RN_CLIP: replaces repro/kernels/cclip_fused.py::cclip_fused_iter
//   (pallas_call at cclip_fused.py:62), one iteration of centered clipping
//   with the clip weights lam [W] known: the centre is the update
//   v' = v + (1/W) sum_i lam_i (x_i - v) of the old centre v [d], written
//   out to vout [d], and the norms are taken against it, so an iteration
//   reads X once. Entry: cclip_fused_launch.
//
// Bound on the H100: memory. The call must read X once (W * d * 4 bytes, or
// W * d * 2 for a 16-bit X, plus d * 4 for an explicit or old centre, and
// d * 4 written in the CLIP form) for 3 W d flops (2 W d more in the
// coefficient form, 3 W d more in the CLIP form): under 2 flops per byte
// for fp32 X, under 4 for 16-bit.
//
// What held the previous kernel back (one 2048-column tile a block, one
// column a thread at a time, the fold a second kernel): 13 blocks for 132
// SMs at a rank's X[5, 26,624]; 8 dependent DRAM round trips a thread,
// each with W loads in flight; and a second graph node. Design:
// - A thread owns 4 neighbouring columns at a time and issues the 16-byte
//   loads of all the rows it holds (RC of them) before it uses them; the
//   coefficients are read beside them (a broadcast load), not staged
//   behind a barrier.
// - The grid is fitted to the card: G = min(ceil(d / 4 / 256), n_SM *
//   blocks an SM) blocks of 256 threads, each owning a contiguous range of
//   column groups, so the path's X[10, 106,496] is 104 blocks of one pass
//   each and the paper's X[25, 16.7 M] 132 blocks of 124. (Fewer threads a
//   block, to spread a rank's X[5, 26,624] over more SMs, was slower: more
//   partials to fold.) The wrapper computes G (weiszfeld_norms.geometry)
//   and sizes the partials [W, G] by it.
// - Rows go in passes over the block's columns, per-row sums acc[] in
//   registers. Up to 32 rows, one pass of RC (8, 16 or 32, the smallest
//   >= W) rows loaded together; in the coefficient and CLIP forms the
//   centre comes from those rows ("held"). Above 32 rows the given centre
//   takes passes of 32 rows, each reading its rows and the centre. The
//   coefficient form takes passes of 64 rows: a column group first streams
//   all W rows to form its centre (RN_WB rows at a time), then reads the
//   pass's rows again, 16 at a time (NSUB = 4), from the caches the first
//   read has just filled. So up to 64 rows X leaves memory once, as with
//   the previous kernel; above, once a pass. The CLIP form takes the same
//   64-row passes but streams the rows for its centre in the first pass
//   only: it stores v' there, and later passes read back the v' the same
//   thread stored (a thread owns the same column groups in every pass).
// - A block adds its threads' sums in a fixed order (a warp butterfly,
//   then the warps in index order) and writes one partial per row.
// - The fold runs in the same launch: after its partials, each block
//   draws a ticket (rn_draw); the block that draws the last one stages
//   the partials in shared memory (all its loads in flight at once), then
//   adds them, one warp a row, lane l summing blocks l, l + 32, ... in
//   order, then a butterfly. No block waits on another, so nothing needs
//   the grid to be co-resident. The last block sets the ticket back to 0,
//   so the counter is zero before every launch on its stream: the wrapper
//   keeps one counter per device, stream and graph capture.
// - Rows whose four elements are not one vector load (d % 4 != 0, or a
//   base of X off 16 bytes for fp32, 8 for 16-bit, or a centre off 16
//   bytes) take predicated scalar loads (ALIGNED = false).
// The centre of a column is the fmaf chain over w = 0 .. W-1 in order, as
// before. In the CLIP form that chain is upd = fmaf(lam_w, x_w - v, upd)
// from upd = 0, then v' = v + upd * (1/W) with the fp32 reciprocal taken
// once: cclip.cu's combine computes the same, so v' has its bits. The sums
// over columns run in another order than the TPU kernel's (and the
// previous kernels'), so they agree to a tolerance, not bit for bit; for a
// given card and shape the order is fixed, so a result repeats bit for bit.

#define RN_THREADS 256
#define RN_FOLD 4096  // partials the folding block stages at a time (16 KB)
#define RN_FOLD_LD 8  // loads a thread of the folding block keeps in flight
#define RN_WB 8  // rows a thread loads at once while it streams the centre
// blocks an SM the build asks for: two at RC = 8, one above, where the
// coefficient form needs more than the 128 registers of two blocks
// (weiszfeld_norms.geometry mirrors it)
#define RN_MIN_BLOCKS(RC) ((RC) <= 8 ? 2 : 1)
// the centre's form (FORM)
#define RN_GIVEN 0
#define RN_COEFF 1
#define RN_CLIP 2

template <bool ALIGNED>
__device__ __forceinline__ float4 rn_load4(const float* __restrict__ row, long long c0,
                                           long long d) {
    if constexpr (ALIGNED) {
        return __ldg(reinterpret_cast<const float4*>(row + c0));
    } else {
        float4 v;
        v.x = c0 < d ? __ldg(row + c0) : 0.0f;
        v.y = c0 + 1 < d ? __ldg(row + c0 + 1) : 0.0f;
        v.z = c0 + 2 < d ? __ldg(row + c0 + 2) : 0.0f;
        v.w = c0 + 3 < d ? __ldg(row + c0 + 3) : 0.0f;
        return v;
    }
}

__device__ __forceinline__ void rn_fma4(float4& v, float c, const float4& x) {
    v.x = fmaf(c, x.x, v.x);
    v.y = fmaf(c, x.y, v.y);
    v.z = fmaf(c, x.z, v.z);
    v.w = fmaf(c, x.w, v.w);
}

// v = c^T X at columns c0 .. c0 + 3, streaming all W rows RN_WB at a time
template <bool ALIGNED>
__device__ __forceinline__ float4 rn_stream_center(const xt* __restrict__ xs,
                                                   const float* __restrict__ coeffs, int W,
                                                   long long c0, long long d) {
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int w0 = 0; w0 < W; w0 += RN_WB) {
        float4 x[RN_WB];
#pragma unroll
        for (int j = 0; j < RN_WB; ++j) {
            if (w0 + j < W) x[j] = xt_load4<ALIGNED>(xs + (long long)(w0 + j) * d, c0, d);
        }
#pragma unroll
        for (int j = 0; j < RN_WB; ++j) {
            if (w0 + j < W) rn_fma4(v, __ldg(coeffs + w0 + j), x[j]);
        }
    }
    return v;
}

// The CLIP update at columns c0 .. c0 + 3: v + (1/W) sum_w lam_w (x_w - v),
// the chain over w = 0 .. W-1 in order. rn_clip_held takes the rows held
// in x (W <= RC); rn_stream_clip streams all W rows RN_WB at a time.
__device__ __forceinline__ void rn_clip_fma4(float4& u, float l, const float4& x,
                                             const float4& v) {
    u.x = fmaf(l, x.x - v.x, u.x);
    u.y = fmaf(l, x.y - v.y, u.y);
    u.z = fmaf(l, x.z - v.z, u.z);
    u.w = fmaf(l, x.w - v.w, u.w);
}

__device__ __forceinline__ float4 rn_clip_apply(const float4& v, const float4& u, float inv) {
    return make_float4(v.x + u.x * inv, v.y + u.y * inv, v.z + u.z * inv, v.w + u.w * inv);
}

template <int RC>
__device__ __forceinline__ float4 rn_clip_held(const float4 (&x)[RC],
                                               const float* __restrict__ lam, int W,
                                               const float4& v, float inv) {
    float4 u = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int r = 0; r < RC; ++r) {
        if (r < W) rn_clip_fma4(u, __ldg(lam + r), x[r], v);
    }
    return rn_clip_apply(v, u, inv);
}

template <bool ALIGNED>
__device__ __forceinline__ float4 rn_stream_clip(const xt* __restrict__ xs,
                                                 const float* __restrict__ lam, int W,
                                                 const float4& v, float inv, long long c0,
                                                 long long d) {
    float4 u = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int w0 = 0; w0 < W; w0 += RN_WB) {
        float4 x[RN_WB];
#pragma unroll
        for (int j = 0; j < RN_WB; ++j) {
            if (w0 + j < W) x[j] = xt_load4<ALIGNED>(xs + (long long)(w0 + j) * d, c0, d);
        }
#pragma unroll
        for (int j = 0; j < RN_WB; ++j) {
            if (w0 + j < W) rn_clip_fma4(u, __ldg(lam + w0 + j), x[j], v);
        }
    }
    return rn_clip_apply(v, u, inv);
}

// v' stored at columns c0 .. c0 + 3 (a column past d is not), and read
// back by the thread that stored it: by __ldcg, not by the read-only path,
// since this launch wrote it
template <bool ALIGNED>
__device__ __forceinline__ void rn_store4(float* __restrict__ row, long long c0, long long d,
                                          const float4& v) {
    if constexpr (ALIGNED) {
        *reinterpret_cast<float4*>(row + c0) = v;
    } else {
        if (c0 < d) row[c0] = v.x;
        if (c0 + 1 < d) row[c0 + 1] = v.y;
        if (c0 + 2 < d) row[c0 + 2] = v.z;
        if (c0 + 3 < d) row[c0 + 3] = v.w;
    }
}

template <bool ALIGNED>
__device__ __forceinline__ float4 rn_reload4(const float* __restrict__ row, long long c0,
                                             long long d) {
    if constexpr (ALIGNED) {
        return __ldcg(reinterpret_cast<const float4*>(row + c0));
    } else {
        float4 v;
        v.x = c0 < d ? __ldcg(row + c0) : 0.0f;
        v.y = c0 + 1 < d ? __ldcg(row + c0 + 1) : 0.0f;
        v.z = c0 + 2 < d ? __ldcg(row + c0 + 2) : 0.0f;
        v.w = c0 + 3 < d ? __ldcg(row + c0 + 3) : 0.0f;
        return v;
    }
}

// dst[r * stride] = the block's sum of acc[r] for r < rows: a butterfly in
// each warp, then the warps in index order. The RC butterflies run
// unconditionally (rows past `rows` hold zeros), so they interleave.
template <int RC>
__device__ __forceinline__ void rn_block_sum(const float (&acc)[RC], int rows,
                                             float* __restrict__ dst, long long stride) {
    __shared__ float red[RN_THREADS / 32][RC];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int r = 0; r < RC; ++r) {
        float s = acc[r];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
        if (lane == 0) red[warp][r] = s;
    }
    __syncthreads();
    if (threadIdx.x < rows) {
        float s = red[0][threadIdx.x];
        for (int k = 1; k < (int)(blockDim.x >> 5); ++k) s = __fadd_rn(s, red[k][threadIdx.x]);
        dst[(long long)threadIdx.x * stride] = s;
    }
    __syncthreads();  // red is written again by the next chunk
}

// The block's ticket: an acquire-release add at GPU scope. Drawn by one
// thread after a barrier, it releases every partial the block wrote (the
// barrier makes them the drawing thread's to release), and for the last
// block it acquires every other block's, which the barrier after it hands
// to all the block's threads: no separate fence on either side.
__device__ __forceinline__ unsigned rn_draw(unsigned* ticket) {
    unsigned old;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
                 : "=r"(old)
                 : "l"(ticket)
                 : "memory");
    return old;
}

// coeffs: c (COEFF) or lam (CLIP); center: the given (GIVEN) or the old
// (CLIP) centre; vout: v' (CLIP only)
template <int RC, int NSUB, int FORM, bool ALIGNED>
__global__ void __launch_bounds__(RN_THREADS, RN_MIN_BLOCKS(RC))
residual_norms_kernel(const xt* __restrict__ xs, const float* __restrict__ coeffs,
                      const float* __restrict__ center, float* __restrict__ vout,
                      float* __restrict__ out, float* __restrict__ partial,
                      unsigned* __restrict__ ticket, int W, long long d, long long per_block) {
    __shared__ float fold[RN_FOLD];
    __shared__ bool s_last;
    const int G = gridDim.x;
    const long long n_vec = (d + 3) / 4;
    const long long lo = (long long)blockIdx.x * per_block;
    const long long hi = lo + per_block < n_vec ? lo + per_block : n_vec;
    constexpr int RP = RC * NSUB;  // rows a pass sums
    constexpr bool COEFF = FORM == RN_COEFF, CLIP = FORM == RN_CLIP;
    // the centre from the rows in registers (only instances of one chunk)
    const bool held = (COEFF || CLIP) && NSUB == 1 && W <= RC;
    float inv = 0.0f;
    if constexpr (CLIP) inv = 1.0f / (float)W;
    // The CLIP form's held, aligned rows step each row's address by d from
    // the one before: with the update's four registers more than the
    // coefficient form, its 32-row instance spills when each address is
    // computed on its own. (Stepping in every form spills their unaligned
    // 32-row instances instead.)
    constexpr bool STEP_ROWS = CLIP && ALIGNED && NSUB == 1;

    for (int r0 = 0; r0 < W; r0 += RP) {
        const int rows = min(RP, W - r0);
        float acc[RP];
#pragma unroll
        for (int r = 0; r < RP; ++r) acc[r] = 0.0f;
        for (long long g = lo + threadIdx.x; g < hi; g += blockDim.x) {
            const long long c0 = g * 4;
            float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            if constexpr (COEFF) {
                if (!held) v = rn_stream_center<ALIGNED>(xs, coeffs, W, c0, d);
            } else if constexpr (CLIP) {
                if (held) {  // the old centre; v' is formed from the rows below
                    v = rn_load4<ALIGNED>(center, c0, d);
                } else if (r0 == 0) {
                    v = rn_stream_clip<ALIGNED>(xs, coeffs, W, rn_load4<ALIGNED>(center, c0, d),
                                                inv, c0, d);
                    rn_store4<ALIGNED>(vout, c0, d, v);
                } else {
                    v = rn_reload4<ALIGNED>(vout, c0, d);
                }
            } else {
                v = rn_load4<ALIGNED>(center, c0, d);
            }
#pragma unroll
            for (int s = 0; s < NSUB; ++s) {  // RC rows at a time
                float4 x[RC];
                if constexpr (STEP_ROWS) {
                    const xt* row = xs + (long long)(r0 + s * RC) * d;
#pragma unroll
                    for (int r = 0; r < RC; ++r) {
                        if (s * RC + r < rows) x[r] = xt_load4<ALIGNED>(row, c0, d);
                        row += d;
                    }
                } else {
#pragma unroll
                    for (int r = 0; r < RC; ++r) {
                        if (s * RC + r < rows)
                            x[r] = xt_load4<ALIGNED>(xs + (long long)(r0 + s * RC + r) * d, c0, d);
                    }
                }
                if (held) {
                    if constexpr (COEFF) {
#pragma unroll
                        for (int r = 0; r < RC; ++r) {
                            if (r < W) rn_fma4(v, __ldg(coeffs + r), x[r]);
                        }
                    } else if constexpr (CLIP) {
                        v = rn_clip_held<RC>(x, coeffs, W, v, inv);
                        rn_store4<ALIGNED>(vout, c0, d, v);
                    }
                }
                const float vk[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
                for (int r = 0; r < RC; ++r) {
                    if (s * RC + r < rows) {
                        const float xk[4] = {x[r].x, x[r].y, x[r].z, x[r].w};
#pragma unroll
                        for (int k = 0; k < 4; ++k) {
                            if (ALIGNED || c0 + k < d) {
                                const float e = xk[k] - vk[k];
                                acc[s * RC + r] = fmaf(e, e, acc[s * RC + r]);
                            }
                        }
                    }
                }
            }
        }
        rn_block_sum<RP>(acc, rows, partial + (long long)r0 * G + blockIdx.x, G);
    }

    // the fold: the block that draws the last ticket adds the partials
    if (threadIdx.x == 0) s_last = rn_draw(ticket) == (unsigned)G - 1u;
    __syncthreads();
    if (!s_last) return;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
    const int rows_per = RN_FOLD / G;  // whole rows of partials a turn (G <= RN_FOLD)
    for (int r0 = 0; r0 < W; r0 += rows_per) {
        const int n = min(rows_per, W - r0) * G;
        const float* src = partial + (long long)r0 * G;
        __syncthreads();  // the previous turn's readers are done
        for (int e0 = threadIdx.x; e0 < n; e0 += RN_FOLD_LD * blockDim.x) {
            float v[RN_FOLD_LD];  // loads in flight together, then stored
#pragma unroll
            for (int k = 0; k < RN_FOLD_LD; ++k) {
                const int e = e0 + k * blockDim.x;
                if (e < n) v[k] = __ldcg(src + e);
            }
#pragma unroll
            for (int k = 0; k < RN_FOLD_LD; ++k) {
                const int e = e0 + k * blockDim.x;
                if (e < n) fold[e] = v[k];
            }
        }
        __syncthreads();
        for (int r = warp; r * G < n; r += n_warps) {
            float s = 0.0f;
            for (int t = lane; t < G; t += 32) s = __fadd_rn(s, fold[r * G + t]);
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
                s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
            if (lane == 0) out[r0 + r] = s;
        }
    }
    if (threadIdx.x == 0) *ticket = 0u;  // every block has drawn: zero for the next launch
}

template <int RC, int NSUB, int FORM>
static void rn_launch(bool aligned, unsigned blocks, int threads, cudaStream_t stream,
                      const xt* xs, const float* coeffs, const float* center, float* vout,
                      float* out, float* partial, unsigned* ticket, int W, long long d,
                      long long per_block) {
    if (aligned) {
        residual_norms_kernel<RC, NSUB, FORM, true><<<blocks, threads, 0, stream>>>(
            xs, coeffs, center, vout, out, partial, ticket, W, d, per_block);
    } else {
        residual_norms_kernel<RC, NSUB, FORM, false><<<blocks, threads, 0, stream>>>(
            xs, coeffs, center, vout, out, partial, ticket, W, d, per_block);
    }
}

// xs [W, d] of X_T contiguous, W, d >= 1; exactly one of coeffs [W] and
// center [d]; out [W]; partial [W, blocks] scratch; ticket one unsigned,
// zero before the launch (the kernel leaves it zero). threads a multiple of
// 32 in 32 .. 256, 1 <= blocks <= RN_FOLD (weiszfeld_norms.geometry).
// Returns cudaGetLastError() after the launch.
extern "C" int residual_norms_launch(const xt* xs, const float* coeffs, const float* center,
                                     float* out, float* partial, unsigned* ticket, int W,
                                     long long d, int threads, int blocks,
                                     cudaStream_t stream) {
    if (W < 1 || d < 1 || threads < 32 || threads > RN_THREADS || threads % 32 || blocks < 1 ||
        blocks > RN_FOLD || (coeffs == nullptr) == (center == nullptr))
        return (int)cudaErrorInvalidValue;
    const long long n_vec = (d + 3) / 4;
    const long long per_block = (n_vec + blocks - 1) / blocks;
    const bool aligned = d % 4 == 0 && xt_aligned(xs) &&
                         (center == nullptr || reinterpret_cast<uintptr_t>(center) % 16 == 0);
    const unsigned b = (unsigned)blocks;
#define RN_ARGS \
    aligned, b, threads, stream, xs, coeffs, center, nullptr, out, partial, ticket, W, d, \
        per_block
    if (W <= 8) {
        if (coeffs) rn_launch<8, 1, RN_COEFF>(RN_ARGS); else rn_launch<8, 1, RN_GIVEN>(RN_ARGS);
    } else if (W <= 16) {
        if (coeffs) rn_launch<16, 1, RN_COEFF>(RN_ARGS); else rn_launch<16, 1, RN_GIVEN>(RN_ARGS);
    } else if (W <= 32 || !coeffs) {
        if (coeffs) rn_launch<32, 1, RN_COEFF>(RN_ARGS); else rn_launch<32, 1, RN_GIVEN>(RN_ARGS);
    } else {
        rn_launch<16, 4, RN_COEFF>(RN_ARGS);
    }
#undef RN_ARGS
    return (int)cudaGetLastError();
}

// The CLIP form: xs [W, d] of X_T contiguous, W, d >= 1; v [d] the old
// centre, lam [W] the clip weights; vout [d] gets v', out [W] the norms
// against it; partial, ticket, threads and blocks as for
// residual_norms_launch. Up to 32 rows held, above in 64-row passes (the
// coefficient form's instances). Returns cudaGetLastError() after the
// launch.
extern "C" int cclip_fused_launch(const xt* xs, const float* v, const float* lam,
                                  float* vout, float* out, float* partial, unsigned* ticket,
                                  int W, long long d, int threads, int blocks,
                                  cudaStream_t stream) {
    if (W < 1 || d < 1 || threads < 32 || threads > RN_THREADS || threads % 32 || blocks < 1 ||
        blocks > RN_FOLD)
        return (int)cudaErrorInvalidValue;
    const long long n_vec = (d + 3) / 4;
    const long long per_block = (n_vec + blocks - 1) / blocks;
    const bool aligned = d % 4 == 0 && xt_aligned(xs) &&
                         reinterpret_cast<uintptr_t>(v) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(vout) % 16 == 0;
    const unsigned b = (unsigned)blocks;
#define RN_CLIP_ARGS \
    aligned, b, threads, stream, xs, lam, v, vout, out, partial, ticket, W, d, per_block
    if (W <= 8) rn_launch<8, 1, RN_CLIP>(RN_CLIP_ARGS);
    else if (W <= 16) rn_launch<16, 1, RN_CLIP>(RN_CLIP_ARGS);
    else if (W <= 32) rn_launch<32, 1, RN_CLIP>(RN_CLIP_ARGS);
    else rn_launch<16, 4, RN_CLIP>(RN_CLIP_ARGS);
#undef RN_CLIP_ARGS
    return (int)cudaGetLastError();
}

// *id = the id of the graph capture under way on stream, 0 when none is
// (the wrapper keeps one ticket per capture). Returns the CUDA error.
extern "C" int rn_capture_id(cudaStream_t stream, unsigned long long* id) {
    cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
    *id = 0;
    const cudaError_t e = cudaStreamGetCaptureInfo(stream, &status, id);
    if (status != cudaStreamCaptureStatusActive) *id = 0;
    return (int)e;
}
