// Worker Gram matrix G = acc + X X^T for X [W, d], W <= 64: X fp32, bf16 or
// fp16 (xtype.cuh), acc and G fp32.
//
// Replaces the Pallas TPU kernel repro/kernels/pairwise_gram.py::pairwise_gram
// (pallas_call at pairwise_gram.py:70): the stats phase of Krum, RFA, CCLIP,
// ACClip and the mean on the Gram route of the packed engine.
//
// Bound on the H100: memory. The call reads X once (W d 4 bytes, 2 for a
// 16-bit X) for W (W + 1) d flops of the upper triangle: 6.5 flops per
// byte at W = 25, 16 at W = 64 (twice that for 16-bit X), under the ~20
// at which fp32 CUDA-core arithmetic (67 TFLOP/s) would take over, but
// for 16-bit X above W = 39. So the sums run on the CUDA cores, fed
// from shared memory, and not on the tensor cores: TF32 alone breaks the
// reference's rtol 1e-5, and 3xTF32 wgmma would pad M to 64 rows and
// triple the work for a product that is not the limit.
//
// The order of summation is the contract (repro/kernels/pairwise_gram.py's
// acc / full_blocks): every 2048-column unit gives a partial that depends
// only on its own columns (zeros past d), and G is acc folded with the
// unit partials strictly in unit order, one __fadd_rn per unit. A chain of
// calls over 2048-aligned column segments, each seeded with the previous G,
// therefore performs the same fp32 operations as one call (the packer pads
// every leaf to 2048 columns for this). Inside a unit the order is this
// kernel's own, fixed by W alone:
//
// - A unit is split over the CS CTAs of a thread-block cluster, a fixed
//   slice of 2048 / CS columns each: CS = 4 for W <= 24, where a unit is
//   little work (208 CTAs at X[10, 106,496]), else 2, which halves the
//   per-unit cost of the lane reduction and the cluster barrier against the
//   FMAs. Clusters are persistent: cluster c takes units c, c + n_clusters,
//   ... (as many clusters as fit on the card at once).
// - X streams through a ring of stages of 128 columns x Wp rows (Wp = W
//   rounded up to 8) in shared memory, on full and empty mbarriers: 4
//   stages of fp32, or 8 of a 16-bit X in the same bytes. One producer
//   warp fills it: by TMA with a 2-D tensor map of X's own type over
//   [W, d] (box Wp x 128; its out-of-bounds zero fill gives the padded rows
//   and the columns past d) when the rows are 16-byte aligned (d * the
//   element size % 16 == 0 and a 16-byte aligned base), else with predicated
//   loads that write the same layout, zeros included. The wrapper picks the
//   path before the launch (variant); everything after the staging is one
//   code path, so a unit's partial is bit for bit the same whichever path
//   loaded it. A 16-bit ring halves the bytes a stage, so twice the stages
//   are in flight for the same shared memory; the consumers widen 4
//   elements of one 8-byte shared load to fp32 in registers (exact) before
//   the fp32 kernel's fmaf chain. So the Gram of a 16-bit X is the Gram of
//   the same X cast to fp32, bit for bit, on either path. (Widening in the
//   producer instead, from a 16-bit staging ring into the fp32 ring, was
//   16-24 % slower on an H100 at W = 10 and 25: the staging ring takes
//   shared memory from the fp32 ring, down to one stage at W = 25.)
// - The rows form 8-row blocks; a consumer thread owns one upper-triangle
//   block pair (I <= J) and one of L lanes (L = 32, 16, 8 or 4 with the
//   number of block pairs). Per 128-column stage it takes 4 adjacent
//   columns at a time with 16-byte shared loads (float4 groups lane,
//   lane + L, ...): 16 loads feed 256 FMAs into an 8 x 8 register tile (the
//   previous kernel: 8 scalar loads per 16 FMAs). The L lanes of a block
//   pair are adjacent threads, so the 8 threads of a quarter-warp read 128
//   contiguous bytes of one row: no bank conflicts without a swizzle (but
//   for L = 4, below). Each accumulator adds its lane's columns in
//   ascending column order with fmaf.
// - The L lanes' tiles are reduced by recursive halving over shuffles
//   (a fixed tree: lanes l and l + L/2 first, then l + L/4, ...), which
//   leaves 64 / L sums per lane, written to the unit's tile in shared
//   memory. Units go in groups of up to 8 (two groups of tiles in 64 KB):
//   after a group's cluster barrier each CTA sums 1 / CS of the pairs of
//   each unit over the CS CTAs' tiles through distributed shared memory in
//   CTA-rank order, ((t0 + t1) + t2) + t3, and writes the unit partials to
//   scratch [n_units, PS] (PS = P rounded up to 4, P = W (W + 1) / 2). One
//   barrier a group, not a unit, so the CTAs wait on each other an eighth
//   as often.
// - The fold runs in the same launch. Each CTA takes a ticket from a
//   counter (zeroed by the wrapper per call: one memset node; a counter
//   reset by the kernel would race between calls on two streams) after its
//   partials are written; the last ceil(P / 4) CTAs (at most the grid) wait
//   for the rest and fold 4 pairs each: all their threads stream the
//   pairs' partials into a double buffer in shared memory while 4 threads
//   add them, one per pair, in unit order from acc, and write G[i, j] and
//   G[j, i] (exactly symmetric when acc is). Fewer pairs a CTA spread the
//   partials' reads over more SMs: 4 pairs fold faster than 8, 16 or 32.
// No atomics on values and a fixed order everywhere: G repeats bit for bit.

#include <cooperative_groups.h>

#include <cstring>
#include <type_traits>

namespace cg = cooperative_groups;

#define GR_UNIT 2048                  // columns per unit: the packed layout's tile
#define GR_C 128                      // columns per stage
#define GR_STAGES 4                   // depth of the ring in fp32 stages (its bytes)
#define GR_MAX_THREADS 256            // W <= 56: 28 block pairs x 8 lanes + the producer
#define GR_FOLD_PAIRS 4               // pairs a folding CTA adds
#define GR_FOLD_Q (GR_FOLD_PAIRS / 4)  // float4 a unit's row of them
#define GR_FOLD_LD 8                  // float4 loads a thread keeps in flight in the fold
#define GR_GROUP_MAX 8                // units a group: the tiles summed after one barrier
#define GR_RED_BYTES 65536            // shared memory for two groups of tiles
constexpr int GR_RING = GR_STAGES * 4 / (int)sizeof(xt);  // stages of the ring (X's type)

// four neighbouring elements of a shared row at index 4 i, as fp32 (exact)
__device__ __forceinline__ float4 ring4(const float* p, int i) {
    return reinterpret_cast<const float4*>(p)[i];
}
__device__ __forceinline__ float4 ring4(const __nv_bfloat16* p, int i) {
    return xt_float4(reinterpret_cast<const uint2*>(p)[i], __nv_bfloat16());
}
__device__ __forceinline__ float4 ring4(const __half* p, int i) {
    return xt_float4(reinterpret_cast<const uint2*>(p)[i], __half());
}

// X's element at p as it is, by the read-only path, or zero where !in (the
// predicated loads)
__device__ __forceinline__ xt ring_ld(const xt* p, bool in) {
    typedef std::conditional<sizeof(xt) == 4, unsigned, unsigned short>::type bits;
    const bits b = in ? __ldg(reinterpret_cast<const bits*>(p)) : bits(0);
    xt v;
    memcpy(&v, &b, sizeof(xt));
    return v;
}

// X's element type as a tensor map names it
static CUtensorMapDataType map_type(const float*) { return CU_TENSOR_MAP_DATA_TYPE_FLOAT32; }
static CUtensorMapDataType map_type(const __nv_bfloat16*) {
    return CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}
static CUtensorMapDataType map_type(const __half*) { return CU_TENSOR_MAP_DATA_TYPE_FLOAT16; }

// What the lane count fixes: CTAs a cluster (CS), the columns of a CTA's
// slice and its stages, the pairs a consumer thread sums over the cluster
// (at most 32 / L for every W that takes these lanes), and the threads a
// CTA and CTAs an SM each instance is built for. 16 lanes serve only
// W = 25..32 (10 block pairs, 192 threads), where two CTAs an SM keep the
// four schedulers busy (ptxas then keeps a thread under 168 registers).
template <int L>
struct GrShape {
    static constexpr int CS = L == 32 ? 4 : 2;
    static constexpr int SLICE = GR_UNIT / CS;
    static constexpr int NS = SLICE / GR_C;
    static constexpr int MAXE = 32 / L;
    static constexpr int THREADS = L == 16 ? 192 : GR_MAX_THREADS;
    static constexpr int BLOCKS = L == 16 ? 2 : 1;
};

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

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
        "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1)
        : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
    asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
    unsigned v;
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
    return v;
}

// Recursive halving over the L adjacent lanes of a block pair: after it,
// v[k] (k < 64 / L) holds element k + l * (64 / L) of the lanes' sum, added
// as a fixed tree (lane l with l + L/2, then with l + L/4, ...). One step
// per template instance, so every index into v is a constant and v stays
// in registers.
template <int O, int N>
__device__ __forceinline__ void halve_step(float (&v)[64], int l) {
    const bool hi = (l & O) != 0;
#pragma unroll
    for (int k = 0; k < N; ++k) {
        const float send = hi ? v[k] : v[k + N];
        const float keep = hi ? v[k + N] : v[k];
        v[k] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, O));
    }
    if constexpr (O > 1) halve_step<O / 2, N / 2>(v, l);
}

template <int L>
__device__ __forceinline__ void halve(float (&v)[64], int l) {
    halve_step<L / 2, 32>(v, l);
}

// The fold's staging: chunk c (fold_units units) of the GR_FOLD_PAIRS
// partials of pair group grp, a float4 (4 pairs of one unit) per thread and
// m, into registers and then into buffer c % 2 of fbuf
// [2][fold_units][GR_FOLD_PAIRS].
__device__ __forceinline__ void fold_load(float4 (&r)[GR_FOLD_LD], const float* partial,
                                          int grp, int c, int fold_units, int n_units, int PS,
                                          int tid, int nthreads) {
#pragma unroll
    for (int m = 0; m < GR_FOLD_LD; ++m) {
        const int t = tid + nthreads * m, u = c * fold_units + t / GR_FOLD_Q;
        if (t < fold_units * GR_FOLD_Q && u < n_units)
            r[m] = __ldcg(reinterpret_cast<const float4*>(partial + (long long)u * PS +
                                                          grp * GR_FOLD_PAIRS +
                                                          (t % GR_FOLD_Q) * 4));
    }
}

__device__ __forceinline__ void fold_store(const float4 (&r)[GR_FOLD_LD], float* fbuf, int c,
                                           int fold_units, int n_units, int tid, int nthreads) {
    float* dst = fbuf + (c & 1) * fold_units * GR_FOLD_PAIRS;
#pragma unroll
    for (int m = 0; m < GR_FOLD_LD; ++m) {
        const int t = tid + nthreads * m;
        if (t < fold_units * GR_FOLD_Q && c * fold_units + t / GR_FOLD_Q < n_units)
            *reinterpret_cast<float4*>(dst + t * 4) = r[m];
    }
}

template <int L>
__global__ void __launch_bounds__(GrShape<L>::THREADS, GrShape<L>::BLOCKS)
gram_kernel(const __grid_constant__ CUtensorMap map, const xt* __restrict__ xs,
            const float* __restrict__ acc, float* __restrict__ out,
            float* __restrict__ partial, unsigned* __restrict__ counter, int W, long long d,
            int n_units, int use_tma, int fold_units, int group) {
    using Sh = GrShape<L>;
    constexpr int CS = Sh::CS;
    cg::cluster_group cluster = cg::this_cluster();
    const int Wp = (W + 7) & ~7;
    const int nb = Wp / 8;
    const int NB = nb * (nb + 1) / 2;
    const int P = W * (W + 1) / 2;
    const int PS = (P + GR_FOLD_PAIRS - 1) & ~(GR_FOLD_PAIRS - 1);
    const int NCW = (NB * L + 31) / 32;  // consumer warps; the producer is warp NCW
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int rank = (int)cluster.block_rank();
    const int cid = blockIdx.x / CS, n_clusters = gridDim.x / CS;
    const int n_my = (n_units - 1 - cid) / n_clusters + 1;  // the host keeps cid < n_units
    const int stage_elems = Wp * GR_C;

    __shared__ __align__(8) uint64_t bars[2 * GR_RING];  // full[], empty[]
    __shared__ int s_fold;
    extern __shared__ uint8_t smem_raw[];
    xt* ring = reinterpret_cast<xt*>((reinterpret_cast<uintptr_t>(smem_raw) + 127) &
                                     ~static_cast<uintptr_t>(127));
    float* red = reinterpret_cast<float*>(ring + GR_RING * stage_elems);  // [2 group][NB 64]
    const uint32_t full0 = smem_u32(&bars[0]), empty0 = smem_u32(&bars[GR_RING]);

    if (tid == 0) {
        for (int s = 0; s < GR_RING; ++s) {
            mbar_init(full0 + 8 * s, 1);
            mbar_init(empty0 + 8 * s, NCW);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (warp == NCW) {
        // producer: the slice's stages of each unit, in order, through the ring
        for (int i = 0; i < n_my; ++i) {
            const long long col0 =
                (long long)(cid + i * n_clusters) * GR_UNIT + (long long)rank * Sh::SLICE;
            for (int s = 0; s < Sh::NS; ++s) {
                const int q = i * Sh::NS + s, slot = q % GR_RING;
                if (q >= GR_RING) mbar_wait(empty0 + 8 * slot, ((q / GR_RING) - 1) & 1);
                xt* dst = ring + slot * stage_elems;
                const long long c0 = col0 + s * GR_C;
                if (use_tma) {
                    if (lane == 0) {
                        mbar_expect_tx(full0 + 8 * slot, (uint32_t)(stage_elems * sizeof(xt)));
                        tma_load_2d(smem_u32(dst), &map, full0 + 8 * slot, (int)c0, 0);
                    }
                } else {
                    for (int r = 0; r < Wp; ++r) {
                        xt v[GR_C / 32];
#pragma unroll
                        for (int k = 0; k < GR_C / 32; ++k) {
                            const long long c = c0 + lane + 32 * k;
                            v[k] = ring_ld(xs + (long long)r * d + c, r < W && c < d);
                        }
#pragma unroll
                        for (int k = 0; k < GR_C / 32; ++k) dst[r * GR_C + lane + 32 * k] = v[k];
                    }
                    __syncwarp();
                    if (lane == 0) mbar_arrive(full0 + 8 * slot);
                }
            }
            // one cluster barrier per group of units, as the consumers:
            // arrive once the group's loads are issued, wait once the next
            // group's are
            if (i % group == group - 1 || i == n_my - 1) {
                if (i >= group) cluster_wait();
                cluster_arrive();
            }
        }
        cluster_wait();
    } else {
        // consumers
        const bool active = tid < NB * L;
        const int bp = tid / L, l = tid % L;
        int I = 0, J = 0;
        if (active) unpair(bp, nb, &I, &J);
        // the pairs this thread sums over the cluster: p = rank + CS (tid + 32 NCW k)
        int e_p[Sh::MAXE], e_off[Sh::MAXE];
#pragma unroll
        for (int k = 0; k < Sh::MAXE; ++k) {
            e_p[k] = rank + CS * (tid + 32 * NCW * k);
            e_off[k] = 0;
            if (e_p[k] < P) {
                int i, j;
                unpair(e_p[k], W, &i, &j);
                e_off[k] = pair_index(i / 8, j / 8, nb) * 64 + (i % 8) * 8 + (j % 8);
            }
        }
        const float* remote[CS];
#pragma unroll
        for (int q = 0; q < CS; ++q) remote[q] = cluster.map_shared_rank(red, q);

        for (int i = 0; i < n_my; ++i) {
            float v[64];
#pragma unroll
            for (int e = 0; e < 64; ++e) v[e] = 0.0f;
            for (int s = 0; s < Sh::NS; ++s) {
                const int q = i * Sh::NS + s, slot = q % GR_RING;
                mbar_wait(full0 + 8 * slot, (q / GR_RING) & 1);
                if (active) {
                    const xt* ra = ring + slot * stage_elems + 8 * I * GR_C;
                    const xt* rb = ring + slot * stage_elems + 8 * J * GR_C;
#pragma unroll 1
                    for (int gi = 0; gi < 32 / L; ++gi) {
                        const int g = l + L * gi;
                        float4 a[8];
#pragma unroll
                        for (int u = 0; u < 8; ++u) a[u] = ring4(ra, u * (GR_C / 4) + g);
#pragma unroll
                        for (int w = 0; w < 8; ++w) {
                            const float4 b = ring4(rb, w * (GR_C / 4) + g);
#pragma unroll
                            for (int u = 0; u < 8; ++u) {
                                float t = v[u * 8 + w];
                                t = fmaf(a[u].x, b.x, t);
                                t = fmaf(a[u].y, b.y, t);
                                t = fmaf(a[u].z, b.z, t);
                                t = fmaf(a[u].w, b.w, t);
                                v[u * 8 + w] = t;
                            }
                        }
                    }
                }
                __syncwarp();
                if (lane == 0) mbar_arrive(empty0 + 8 * slot);
            }
            halve<L>(v, l);
            if (active) {
                float* dst = red + (i % (2 * group)) * NB * 64 + bp * 64 + l * (64 / L);
#pragma unroll
                for (int k = 0; k < 64 / L; ++k) dst[k] = v[k];
            }
            if (i % group != group - 1 && i != n_my - 1) continue;
            // the group's tiles are in every CTA of the cluster: sum them
            cluster_arrive();
            cluster_wait();
            for (int u = i - i % group; u <= i; ++u) {
                const int buf = (u % (2 * group)) * NB * 64;
                const long long row = (long long)(cid + u * n_clusters) * PS;
#pragma unroll
                for (int k = 0; k < Sh::MAXE; ++k) {
                    if (e_p[k] < P) {
                        float t = remote[0][buf + e_off[k]];
#pragma unroll
                        for (int q = 1; q < CS; ++q) t = __fadd_rn(t, remote[q][buf + e_off[k]]);
                        partial[row + e_p[k]] = t;
                    }
                }
            }
        }
    }
    // no CTA leaves while another may still read its tiles
    cluster_arrive();
    cluster_wait();

    // ticket: the last F CTAs to finish fold (F = PS / 4 groups of 4 pairs,
    // at most the grid), once every CTA's partials are written
    __threadfence();
    __syncthreads();
    const int total = (int)gridDim.x;
    const int F = PS / GR_FOLD_PAIRS, Fe = F < total ? F : total;
    if (tid == 0) {
        const int t = (int)atomicAdd(counter, 1u);
        s_fold = t - (total - Fe);
        if (s_fold >= 0)
            while ((int)ld_acquire(counter) < total) __nanosleep(100);
    }
    __syncthreads();
    if (s_fold < 0) return;
    __threadfence();

    float* fbuf = reinterpret_cast<float*>(ring);  // [2][fold_units][GR_FOLD_PAIRS], the ring
    const int n_chunks = (n_units + fold_units - 1) / fold_units;
    const int nthreads = (int)blockDim.x;
    for (int grp = s_fold; grp < F; grp += Fe) {
        const int p = grp * GR_FOLD_PAIRS + tid;
        const bool folds = tid < GR_FOLD_PAIRS && p < P;
        int i = 0, j = 0;
        float g_ij = 0.0f, g_ji = 0.0f;
        if (folds) {
            unpair(p, W, &i, &j);
            if (acc) {
                g_ij = acc[i * W + j];
                g_ji = acc[j * W + i];
            }
        }
        float4 r[GR_FOLD_LD];
        fold_load(r, partial, grp, 0, fold_units, n_units, PS, tid, nthreads);
        fold_store(r, fbuf, 0, fold_units, n_units, tid, nthreads);
        __syncthreads();
        for (int c = 0; c < n_chunks; ++c) {
            // chunk c + 1 is in flight while the folding threads add chunk c
            if (c + 1 < n_chunks)
                fold_load(r, partial, grp, c + 1, fold_units, n_units, PS, tid, nthreads);
            if (folds) {
                const float* src = fbuf + (c & 1) * fold_units * GR_FOLD_PAIRS + tid;
                const int n = min(fold_units, n_units - c * fold_units);
                int k = 0;
                for (; k + 16 <= n; k += 16) {  // loads ahead of the chain of adds
                    float x[16];
#pragma unroll
                    for (int m = 0; m < 16; ++m) x[m] = src[(k + m) * GR_FOLD_PAIRS];
#pragma unroll
                    for (int m = 0; m < 16; ++m) {
                        g_ij = __fadd_rn(g_ij, x[m]);
                        g_ji = __fadd_rn(g_ji, x[m]);
                    }
                }
                for (; k < n; ++k) {
                    const float x = src[k * GR_FOLD_PAIRS];
                    g_ij = __fadd_rn(g_ij, x);
                    g_ji = __fadd_rn(g_ji, x);
                }
            }
            if (c + 1 < n_chunks) fold_store(r, fbuf, c + 1, fold_units, n_units, tid, nthreads);
            __syncthreads();
        }
        if (folds) {
            out[i * W + j] = g_ij;
            out[j * W + i] = g_ji;
        }
    }
}

// 32 lanes per block pair up to 7 block pairs (W <= 24), 16 up to 14
// (W <= 32), 8 up to 28 (W <= 56), else 4: at most 256 threads a CTA, so
// ptxas may give a thread up to 255 registers. With 4 lanes (W > 56) two
// block pairs share a quarter-warp: 2-way bank conflicts on their rows.
static int gram_lanes(int NB) { return NB <= 7 ? 32 : NB <= 14 ? 16 : NB <= 28 ? 8 : 4; }

template <int L>
static int gram_launch(const CUtensorMap& map, const xt* xs, const float* acc, float* out,
                       float* partial, unsigned* counter, int W, long long d, int use_tma,
                       cudaStream_t stream) {
    using Sh = GrShape<L>;
    const int Wp = (W + 7) & ~7, nb = Wp / 8, NB = nb * (nb + 1) / 2;
    const int threads = ((NB * L + 31) / 32 + 1) * 32;
    const int P = W * (W + 1) / 2;
    if (threads > Sh::THREADS || P > Sh::CS * (threads - 32) * Sh::MAXE)
        return (int)cudaErrorInvalidConfiguration;
    const int ring_bytes = GR_RING * Wp * GR_C * (int)sizeof(xt);  // an fp32 ring's bytes
    int group = GR_RED_BYTES / (2 * NB * 64 * 4);
    group = group < 1 ? 1 : group > GR_GROUP_MAX ? GR_GROUP_MAX : group;
    const int smem = 128 + ring_bytes + 2 * group * NB * 64 * 4;
    const long long n_units = (d + GR_UNIT - 1) / GR_UNIT;
    if (n_units > (1ll << 30)) return (int)cudaErrorInvalidValue;
    int fold_units = ring_bytes / (2 * GR_FOLD_PAIRS * 4);
    if (fold_units > threads * GR_FOLD_LD / GR_FOLD_Q)
        fold_units = threads * GR_FOLD_LD / GR_FOLD_Q;

    cudaError_t e = cudaFuncSetAttribute(gram_kernel<L>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = Sh::CS;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.blockDim = dim3((unsigned)threads);
    cfg.dynamicSmemBytes = (size_t)smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;

    // clusters that fit on the card at once, per device and block-pair count
    static int fit[16][9];
    int dev = 0;
    e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    int* slot = dev < 16 ? &fit[dev][nb] : nullptr;
    int n_fit = slot ? *slot : 0;
    if (n_fit == 0) {
        cfg.gridDim = dim3(Sh::CS);
        e = cudaOccupancyMaxActiveClusters(&n_fit, gram_kernel<L>, &cfg);
        if (e != cudaSuccess) return (int)e;
        if (n_fit < 1) return (int)cudaErrorInvalidConfiguration;
        if (slot) *slot = n_fit;
    }
    const int n_clusters = (int)(n_units < n_fit ? n_units : n_fit);
    cfg.gridDim = dim3((unsigned)(n_clusters * Sh::CS));
    e = cudaLaunchKernelEx(&cfg, gram_kernel<L>, map, xs, acc, out, partial, counter, W, d,
                           (int)n_units, use_tma, fold_units, group);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

// xs [W, d] of X_T, contiguous, 1 <= W <= 64, d >= 1; acc [W, W] or null;
// out [W, W]; partial [ceil(d / 2048), P rounded up to 32] scratch (rows
// of P rounded up to GR_FOLD_PAIRS are used); counter
// one zeroed unsigned. use_tma only where X's rows are 16-byte aligned (d *
// sizeof(X_T) % 16 == 0, xs 16-byte aligned; the wrapper's variant rule);
// a tensor map that does not encode returns an error, never another path.
// Returns cudaGetLastError() after the launch, or the error of a step
// before it.
extern "C" int pairwise_gram_launch(const xt* xs, const float* acc, float* out,
                                    float* partial, unsigned* counter, int W, long long d,
                                    int use_tma, cudaStream_t stream) {
    if (W < 1 || W > 64 || d < 1) return (int)cudaErrorInvalidValue;
    const int Wp = (W + 7) & ~7, nb = Wp / 8, NB = nb * (nb + 1) / 2;
    CUtensorMap map = {};
    if (use_tma) {
        if ((d * (long long)sizeof(xt)) % 16 != 0 ||
            reinterpret_cast<uintptr_t>(xs) % 16 != 0 || d + GR_UNIT >= (1ll << 31))
            return (int)cudaErrorInvalidValue;
        const TmaEncodeTiled encode = tma_encoder();
        if (encode == nullptr) return (int)cudaErrorNotSupported;
        // [W, d] of X's type, boxes of Wp rows x GR_C columns, zeros out of bounds
        const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)W};
        const cuuint64_t strides[1] = {(cuuint64_t)d * sizeof(xt)};
        const cuuint32_t box[2] = {GR_C, (cuuint32_t)Wp};
        const cuuint32_t elem[2] = {1, 1};
        const CUresult r = encode(&map, map_type(xs), 2,
                                  const_cast<xt*>(xs), dims, strides, box, elem,
                                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
        if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
    }
    switch (gram_lanes(NB)) {
        case 32:
            return gram_launch<32>(map, xs, acc, out, partial, counter, W, d, use_tma, stream);
        case 16:
            return gram_launch<16>(map, xs, acc, out, partial, counter, W, d, use_tma, stream);
        case 8:
            return gram_launch<8>(map, xs, acc, out, partial, counter, W, d, use_tma, stream);
        default:
            return gram_launch<4>(map, xs, acc, out, partial, counter, W, d, use_tma, stream);
    }
}
