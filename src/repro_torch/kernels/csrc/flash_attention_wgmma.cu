// Causal GQA attention with a sliding window and a query offset on Hopper's
// tensor cores: bf16 q, k, v and output, fp32 accumulation and softmax.
//
// Replaces, for bf16 inputs, the Pallas TPU kernel repro/kernels/
// flash_attention.py::flash_attention (pallas_call at flash_attention.py:105);
// fp32 inputs and bf16 inputs this kernel does not take (dh % 8 != 0, a
// pointer not 16-byte aligned) go to flash_attention.cu. The wrapper picks
// the kernel from dtype, dh and alignment before the launch. q [B, Sq, H, dh],
// k and v [B, Skv, KV, dh]; head h reads kv head h / (H / KV); query row i
// sits at position q_offset + i; a key is visible when kpos <= qpos (causal)
// and kpos > qpos - window (window > 0).
//
// Bound on the H100: operations, 4 dh flops per visible query-key pair
// against 989 TFLOP/s of bf16 tensor-core work (~10^11 flops against
// ~10^8 bytes at S = 4096).
//
// Design (one CTA per query tile x head x batch row, heaviest tiles first):
// - Warpgroup 0 is the producer: one thread loads Q once, then K and V tiles
//   into a 2-stage ring by TMA, with full and empty mbarriers. Tensor maps
//   are 4-D over [B, S, heads, dh] with a 64-element (128-byte) inner box and
//   128-byte swizzle: dh = 128 and 256 take 2 or 4 boxes per tile; dh < 64
//   uses the 64 tile, and TMA's zero fill pads dh and the rows past Sq and
//   Skv. Head h reads kv head h / (H / KV) through the TMA coordinate.
// - Two consumer warpgroups own 64 query rows each (128-row tiles, 384
//   threads); the producer hands them its registers with setmaxnreg. ptxas
//   still sizes every instance at the launch bound's 168 registers a
//   thread; at dh = 256, where the 64 x 256 fp32 O takes 128 of them, the
//   instance fits with nothing to spare (chip_smoke.py fails on a spill).
// - S = Q K^T is wgmma m64nBKVk16 from shared memory (both K-major), fp32
//   accumulator; S is scaled by dh^-1/2 log2(e) after the product and
//   exponentiated with the MUFU ex2. The online softmax works on the
//   accumulator fragment: a row lives in one quad of lanes, so its max takes
//   two shuffles; l sums the fp32 p per thread and is reduced once at the
//   end. Masks are evaluated only on tiles that cross the causal diagonal,
//   the window's edge or Skv (keys past Skv arrive as zeros, so they must be
//   masked, not given p = e^0). Tiles no row of the CTA can see are never
//   loaded; a warpgroup that cannot see a loaded tile skips its products.
// - O += P V with P split into P_hi = bf16(p) and P_lo = bf16(p - P_hi): two
//   wgmma m64nDHk16 per 16 keys into one fp32 accumulator, A from registers
//   (the S accumulator's layout is the A fragment's layout for 16-bit types),
//   B = V from shared memory, MN-major (transposed-B flag). A single bf16 P
//   would round p by 2^-9 relative, far above the tolerance near outputs
//   close to zero; the split keeps p to ~2^-17.
// - Rows with no visible key get the reference's value, the mean of V over
//   all Skv keys, from a pass over V in global memory that only a warp
//   holding such a row makes. Then O / max(l, 1e-30), one __float2bfloat16
//   (round to nearest even), stores guarded by row < Sq and col < dh.

// tma.cuh (prepended by the wrapper): mbarrier helpers and the tensor-map encoder
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define FW_BOX 64        // dh elements per TMA box: one 128-byte swizzled row

template <int DH>
struct FwShape {
    static constexpr int NC = 2;                      // consumer warpgroups of 64 rows
    static constexpr int BQ = 64 * NC;                // query rows per CTA
    static constexpr int THREADS = 128 * (NC + 1);    // and one producer warpgroup
    static constexpr int BKV = DH == 256 ? 64 : 128;  // keys per tile
    static constexpr int STAGES = 2;                  // depth of the K/V ring
    static constexpr int NBOX = DH / FW_BOX;
    static constexpr int Q_BYTES = BQ * DH * 2;
    static constexpr int KV_BYTES = BKV * DH * 2;  // one K or one V tile
    static constexpr int SMEM = Q_BYTES + STAGES * 2 * KV_BYTES;
};

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
        "l"((uint64_t)map), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
        : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle (layout type 1, bits
// 62-63); start address, leading and stride byte offsets in 16-byte units
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
           ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving accesses to registers that an in-flight
// wgmma reads or writes across the issue or the wait
template <int N>
__device__ __forceinline__ void reg_fence(float* d) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t* d) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// wgmma.mma_async m64nNk16, bf16 in, fp32 accumulator d[N / 2] per thread:
// ss takes A and B from shared memory (both K-major), rs takes A from
// registers (4 x bf16x2) and B from shared memory MN-major. scale_d = 0
// overwrites d.
template <int N>
struct Wgmma;

template <> struct Wgmma<64> {
    // d[32] += A (64 x 16, shared, K-major) * B (64 x 16, shared, K-major)
    static __device__ __forceinline__ void ss(float* d, uint64_t da, uint64_t db, int scale_d) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
            "{" 
            "%0, %1, %2, %3, %4, %5, %6, %7, "
            "%8, %9, %10, %11, %12, %13, %14, %15, "
            "%16, %17, %18, %19, %20, %21, %22, %23, "
            "%24, %25, %26, %27, %28, %29, %30, %31"
            "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
              "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
              "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
              "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
              "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
              "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
              "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
              "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
            : "l"(da), "l"(db), "r"(scale_d));
    }
    // d[32] += A (64 x 16, registers) * B (16 x 64, shared, MN-major)
    static __device__ __forceinline__ void rs(float* d, const uint32_t* a, uint64_t db, int scale_d) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
            "{" 
            "%0, %1, %2, %3, %4, %5, %6, %7, "
            "%8, %9, %10, %11, %12, %13, %14, %15, "
            "%16, %17, %18, %19, %20, %21, %22, %23, "
            "%24, %25, %26, %27, %28, %29, %30, %31"
            "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
              "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
              "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
              "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
              "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
              "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
              "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
              "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
    }
};

template <> struct Wgmma<128> {
    // d[64] += A (64 x 16, shared, K-major) * B (128 x 16, shared, K-major)
    static __device__ __forceinline__ void ss(float* d, uint64_t da, uint64_t db, int scale_d) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
            "{" 
            "%0, %1, %2, %3, %4, %5, %6, %7, "
            "%8, %9, %10, %11, %12, %13, %14, %15, "
            "%16, %17, %18, %19, %20, %21, %22, %23, "
            "%24, %25, %26, %27, %28, %29, %30, %31, "
            "%32, %33, %34, %35, %36, %37, %38, %39, "
            "%40, %41, %42, %43, %44, %45, %46, %47, "
            "%48, %49, %50, %51, %52, %53, %54, %55, "
            "%56, %57, %58, %59, %60, %61, %62, %63"
            "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
              "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
              "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
              "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
              "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
              "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
              "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
              "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
              "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
              "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
              "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
              "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
              "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
              "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
              "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
              "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
            : "l"(da), "l"(db), "r"(scale_d));
    }
    // d[64] += A (64 x 16, registers) * B (16 x 128, shared, MN-major)
    static __device__ __forceinline__ void rs(float* d, const uint32_t* a, uint64_t db, int scale_d) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
            "{" 
            "%0, %1, %2, %3, %4, %5, %6, %7, "
            "%8, %9, %10, %11, %12, %13, %14, %15, "
            "%16, %17, %18, %19, %20, %21, %22, %23, "
            "%24, %25, %26, %27, %28, %29, %30, %31, "
            "%32, %33, %34, %35, %36, %37, %38, %39, "
            "%40, %41, %42, %43, %44, %45, %46, %47, "
            "%48, %49, %50, %51, %52, %53, %54, %55, "
            "%56, %57, %58, %59, %60, %61, %62, %63"
            "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
              "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
              "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
              "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
              "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
              "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
              "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
              "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
              "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
              "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
              "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
              "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
              "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
              "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
              "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
              "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
    }
};

template <> struct Wgmma<256> {
    // d[128] += A (64 x 16, registers) * B (16 x 256, shared, MN-major)
    static __device__ __forceinline__ void rs(float* d, const uint32_t* a, uint64_t db, int scale_d) {
        asm volatile(
            "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
            "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
            "{" 
            "%0, %1, %2, %3, %4, %5, %6, %7, "
            "%8, %9, %10, %11, %12, %13, %14, %15, "
            "%16, %17, %18, %19, %20, %21, %22, %23, "
            "%24, %25, %26, %27, %28, %29, %30, %31, "
            "%32, %33, %34, %35, %36, %37, %38, %39, "
            "%40, %41, %42, %43, %44, %45, %46, %47, "
            "%48, %49, %50, %51, %52, %53, %54, %55, "
            "%56, %57, %58, %59, %60, %61, %62, %63, "
            "%64, %65, %66, %67, %68, %69, %70, %71, "
            "%72, %73, %74, %75, %76, %77, %78, %79, "
            "%80, %81, %82, %83, %84, %85, %86, %87, "
            "%88, %89, %90, %91, %92, %93, %94, %95, "
            "%96, %97, %98, %99, %100, %101, %102, %103, "
            "%104, %105, %106, %107, %108, %109, %110, %111, "
            "%112, %113, %114, %115, %116, %117, %118, %119, "
            "%120, %121, %122, %123, %124, %125, %126, %127"
            "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
              "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
              "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
              "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
              "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
              "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
              "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
              "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
              "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
              "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
              "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
              "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
              "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
              "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
              "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
              "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
              "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
              "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
              "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
              "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
              "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
              "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
              "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
              "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
              "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
              "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
              "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
              "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
              "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
              "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
              "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
              "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
    }
};

// 2^x on the MUFU unit (flushes subnormal results to zero: p below 2^-126
// adds nothing at bf16 and fp32 output precision)
__device__ __forceinline__ float fw_exp2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// p = P_hi + P_lo, both bf16 pairs (low half = first element)
__device__ __forceinline__ void split_bf16x2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    const float2 hf = __bfloat1622float2(h);
    const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = *reinterpret_cast<const uint32_t*>(&l);
}

template <int DH>
__global__ void __launch_bounds__(FwShape<DH>::THREADS, 1)
fa_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v, const __nv_bfloat16* __restrict__ v,
                __nv_bfloat16* __restrict__ out, int Sq, int Skv, int H, int KV, int dh,
                int causal, int window, int q_offset, float scale_log2) {
    using Sh = FwShape<DH>;
    constexpr int BQ = Sh::BQ, BKV = Sh::BKV, NBOX = Sh::NBOX, STAGES = Sh::STAGES;
    // q_full, k_full[STAGES], v_full[STAGES], empty[STAGES]
    __shared__ __align__(8) uint64_t bars[1 + 3 * STAGES];
    extern __shared__ uint8_t smem_raw[];
    // a 128-byte swizzle atom is 8 rows x 128 bytes: tiles start on 1024 bytes
    const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
    const uint32_t kv_s = q_s + Sh::Q_BYTES;  // stage s: K at + 2s KV_BYTES, V after it
    const uint32_t q_full = smem_u32(&bars[0]);
    const uint32_t k_full = smem_u32(&bars[1]), v_full = smem_u32(&bars[1 + STAGES]);
    const uint32_t empty = smem_u32(&bars[1 + 2 * STAGES]);

    // heaviest query tiles first: the causal tail does not straggle
    const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
    const int h = blockIdx.x, b = blockIdx.y, g = h / (H / KV);
    // the key tiles that some row of this CTA can see
    const int q_last = min(q0 + BQ, Sq) - 1;
    const int k_lo = window > 0 ? max(0, q_offset + q0 - window + 1) : 0;
    const int k_hi = causal ? min(Skv, q_offset + q_last + 1) : Skv;
    const int t_begin = k_lo / BKV;
    const int n_tiles = k_hi > k_lo ? (k_hi + BKV - 1) / BKV - t_begin : 0;

    if (threadIdx.x == 0) {
        mbar_init(q_full, 1);
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(k_full + 8 * s, 1);
            mbar_init(v_full + 8 * s, 1);
            mbar_init(empty + 8 * s, Sh::NC * 128);  // every consumer thread releases
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    const int wg = threadIdx.x / 128;
    if (wg == 0) {
        // producer warpgroup: one thread issues every copy
        // 24 + 2 x 240 registers: the 384 x 168 that the launch bound gives
        if constexpr (Sh::NC == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
        if (threadIdx.x == 0) {
            mbar_expect_tx(q_full, Sh::Q_BYTES);
            for (int bx = 0; bx < NBOX; ++bx)
                tma_load_4d(q_s + bx * BQ * 128, &tm_q, q_full, bx * FW_BOX, h, q0, b);
            for (int t = 0; t < n_tiles; ++t) {
                const int s = t % STAGES;
                const uint32_t kb = kv_s + 2 * s * Sh::KV_BYTES, vb = kb + Sh::KV_BYTES;
                const int c0 = (t_begin + t) * BKV;
                mbar_wait(empty + 8 * s, ((t / STAGES) & 1) ^ 1);  // round 0 passes
                mbar_expect_tx(k_full + 8 * s, Sh::KV_BYTES);
                for (int bx = 0; bx < NBOX; ++bx)
                    tma_load_4d(kb + bx * BKV * 128, &tm_k, k_full + 8 * s, bx * FW_BOX, g, c0, b);
                mbar_expect_tx(v_full + 8 * s, Sh::KV_BYTES);
                for (int bx = 0; bx < NBOX; ++bx)
                    tma_load_4d(vb + bx * BKV * 128, &tm_v, v_full + 8 * s, bx * FW_BOX, g, c0, b);
            }
        }
    } else {
        // consumer warpgroups 1 .. NC: rows q0 + 64 c .. q0 + 64 c + 63
        if constexpr (Sh::NC == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
        const int c = wg - 1;
        const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
        // accumulator fragment: d[4 j + e] is row r_in + 8 (e / 2), column
        // 8 j + 2 (lane % 4) + e % 2 of the warpgroup's 64-row tile
        const int r_in = 64 * c + 16 * warp + lane / 4;  // row in the CTA tile
        const int col0 = 2 * (lane % 4);
        const int qpos0 = q_offset + q0 + r_in;
        const int wg_lo = q_offset + q0 + 64 * c, wg_hi = wg_lo + 63;  // the warpgroup's positions
        const uint32_t q_wg = q_s + c * 64 * 128;

        float o[DH / 2];
    #pragma unroll
        for (int i = 0; i < DH / 2; ++i) o[i] = 0.0f;
        float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};

        mbar_wait(q_full, 0);
        for (int t = 0; t < n_tiles; ++t) {
            const int s = t % STAGES;
            const uint32_t par = (t / STAGES) & 1;
            const uint32_t kb = kv_s + 2 * s * Sh::KV_BYTES, vb = kb + Sh::KV_BYTES;
            const int c0 = (t_begin + t) * BKV;
            const bool seen = c0 < Skv && !(causal && c0 > wg_hi) &&
                              !(window > 0 && c0 + BKV - 1 <= wg_lo - window);
            mbar_wait(k_full + 8 * s, par);
            if (seen) {
                float sc[BKV / 2];
    #pragma unroll
                for (int i = 0; i < BKV / 2; ++i) sc[i] = 0.0f;
                reg_fence<BKV / 2>(sc);
                wg_fence();
    #pragma unroll
                for (int kk = 0; kk < DH / 16; ++kk) {
                    const uint32_t off = (kk % 4) * 32;  // 16 columns: 32 bytes
                    const uint64_t da = desc_sw128(q_wg + (kk / 4) * BQ * 128 + off, 16, 1024);
                    const uint64_t db = desc_sw128(kb + (kk / 4) * BKV * 128 + off, 16, 1024);
                    Wgmma<BKV>::ss(sc, da, db, 1);
                }
                wg_commit();
                wg_wait0();
                reg_fence<BKV / 2>(sc);

                // logits in log2 units; masked keys -> -inf, only on edge tiles
                const bool edge = c0 + BKV > Skv || (causal && c0 + BKV - 1 > wg_lo) ||
                                  (window > 0 && c0 <= wg_hi - window);
                if (edge) {
    #pragma unroll
                    for (int j = 0; j < BKV / 8; ++j)
    #pragma unroll
                        for (int e = 0; e < 4; ++e) {
                            const int kpos = c0 + 8 * j + col0 + (e & 1), qpos = qpos0 + 8 * (e >> 1);
                            const bool vis = kpos < Skv && (!causal || kpos <= qpos) &&
                                             (window <= 0 || kpos > qpos - window);
                            sc[4 * j + e] = vis ? sc[4 * j + e] * scale_log2 : -INFINITY;
                        }
                } else {
    #pragma unroll
                    for (int i = 0; i < BKV / 2; ++i) sc[i] *= scale_log2;
                }
                float mx[2] = {m[0], m[1]};
    #pragma unroll
                for (int j = 0; j < BKV / 8; ++j)
    #pragma unroll
                    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * j + e]);
                float corr[2], mu[2];
    #pragma unroll
                for (int r = 0; r < 2; ++r) {
                    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
                    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
                    mu[r] = mx[r] == -INFINITY ? 0.0f : mx[r];  // no visible key yet: p = 0
                    corr[r] = fw_exp2(m[r] - mu[r]);
                    m[r] = mx[r];
                    l[r] *= corr[r];
                }
    #pragma unroll
                for (int j = 0; j < BKV / 8; ++j)
    #pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const float p = fw_exp2(sc[4 * j + e] - mu[e >> 1]);
                        sc[4 * j + e] = p;
                        l[e >> 1] += p;
                    }
    #pragma unroll
                for (int j = 0; j < DH / 8; ++j) {
                    o[4 * j + 0] *= corr[0];
                    o[4 * j + 1] *= corr[0];
                    o[4 * j + 2] *= corr[1];
                    o[4 * j + 3] *= corr[1];
                }
                // A fragment of keys 16 kt .. 16 kt + 15: registers q = 0..3 hold
                // (row, key pair) = (r, 2 col), (r + 8, 2 col), (r, 8 + 2 col), (r + 8, 8 + 2 col)
                uint32_t ph[BKV / 16][4], pl[BKV / 16][4];
    #pragma unroll
                for (int kt = 0; kt < BKV / 16; ++kt)
    #pragma unroll
                    for (int q = 0; q < 4; ++q)
                        split_bf16x2(sc[8 * kt + 2 * q], sc[8 * kt + 2 * q + 1], ph[kt][q], pl[kt][q]);

                mbar_wait(v_full + 8 * s, par);
                reg_fence<DH / 2>(o);
                wg_fence();
    #pragma unroll
                for (int kt = 0; kt < BKV / 16; ++kt) {
                    // V rows 16 kt .. 16 kt + 15: 8-key groups 1024 bytes apart,
                    // 64-column boxes BKV * 128 bytes apart
                    const uint64_t dv = desc_sw128(vb + kt * 16 * 128, BKV * 128, 1024);
                    Wgmma<DH>::rs(o, ph[kt], dv, 1);
                    Wgmma<DH>::rs(o, pl[kt], dv, 1);
                }
                wg_commit();
                wg_wait0();
                reg_fence<DH / 2>(o);
                reg_fence<BKV / 4>(&ph[0][0]);
                reg_fence<BKV / 4>(&pl[0][0]);
            } else {
                mbar_wait(v_full + 8 * s, par);
            }
            mbar_arrive(empty + 8 * s);
        }

    #pragma unroll
        for (int r = 0; r < 2; ++r) {
            l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
            l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        }
        // rows with no visible key: the mean of V over all keys, as the reference
        const bool empty0 = q0 + r_in < Sq && m[0] == -INFINITY;
        const bool empty1 = q0 + r_in + 8 < Sq && m[1] == -INFINITY;
        if (__any_sync(0xffffffffu, empty0 || empty1)) {
            for (int key = 0; key < Skv; ++key) {
                const __nv_bfloat16* vr = v + (((long long)b * Skv + key) * KV + g) * dh;
    #pragma unroll
                for (int j = 0; j < DH / 8; ++j) {
                    const int col = 8 * j + col0;
                    if (col < dh) {
                        const float2 x = __bfloat1622float2(
                            *reinterpret_cast<const __nv_bfloat162*>(vr + col));
                        if (empty0) {
                            o[4 * j + 0] += x.x;
                            o[4 * j + 1] += x.y;
                        }
                        if (empty1) {
                            o[4 * j + 2] += x.x;
                            o[4 * j + 3] += x.y;
                        }
                    }
                }
            }
            if (empty0) l[0] = (float)Skv;
            if (empty1) l[1] = (float)Skv;
        }

    #pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int row = q0 + r_in + 8 * r;
            if (row >= Sq) continue;
            __nv_bfloat16* dst = out + (((long long)b * Sq + row) * H + h) * dh;
            const float den = fmaxf(l[r], 1e-30f);
    #pragma unroll
            for (int j = 0; j < DH / 8; ++j) {
                const int col = 8 * j + col0;
                if (col < dh)
                    *reinterpret_cast<__nv_bfloat162*>(dst + col) =
                        __floats2bfloat162_rn(o[4 * j + 2 * r] / den, o[4 * j + 2 * r + 1] / den);
            }
        }
    }
}

// a bf16 [batch, S, heads, dh] tensor, read in boxes of 64 x 1 x rows x 1,
// 128-byte swizzle, zeros out of bounds
static int fw_map(CUtensorMap* map, const void* ptr, int batch, int S, int heads, int dh,
                  int rows) {
    const TmaEncodeTiled encode = tma_encoder();
    if (encode == nullptr) return (int)cudaErrorNotSupported;
    const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)heads, (cuuint64_t)S,
                                (cuuint64_t)batch};
    const cuuint64_t strides[3] = {(cuuint64_t)dh * 2, (cuuint64_t)heads * dh * 2,
                                   (cuuint64_t)S * heads * dh * 2};
    const cuuint32_t box[4] = {FW_BOX, 1, (cuuint32_t)rows, 1};
    const cuuint32_t elem[4] = {1, 1, 1, 1};
    const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                              dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int DH>
static int fw_launch(const void* q, const void* k, const void* v, void* out, int B, int Sq,
                     int Skv, int H, int KV, int dh, int causal, int window, int q_offset,
                     float scale_log2, cudaStream_t stream) {
    using Sh = FwShape<DH>;
    const int n_qt = (Sq + Sh::BQ - 1) / Sh::BQ;
    if (n_qt > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
    CUtensorMap mq, mk, mv;
    int err = fw_map(&mq, q, B, Sq, H, dh, Sh::BQ);
    if (err == 0) err = fw_map(&mk, k, B, Skv, KV, dh, Sh::BKV);
    if (err == 0) err = fw_map(&mv, v, B, Skv, KV, dh, Sh::BKV);
    if (err != 0) return err;
    // 1024 bytes of slack for the alignment; at least 116 KB, so that one CTA
    // holds an SM: the consumers' setmaxnreg.inc waits for the registers the
    // producer frees, which a second CTA on the SM could take
    const int smem = Sh::SMEM + 1024 > 116 * 1024 ? Sh::SMEM + 1024 : 116 * 1024;
    cudaError_t e = cudaFuncSetAttribute(fa_wgmma_kernel<DH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((unsigned)H, (unsigned)B, (unsigned)n_qt);
    fa_wgmma_kernel<DH><<<grid, Sh::THREADS, smem, stream>>>(
        mq, mk, mv, (const __nv_bfloat16*)v, (__nv_bfloat16*)out, Sq, Skv, H, KV, dh, causal,
        window, q_offset, scale_log2);
    return (int)cudaGetLastError();
}

// bf16 q, k, v, out; contiguous, 16-byte aligned; dh % 8 == 0, 8 <= dh <= 256,
// H % KV == 0 (checked by the wrapper). scale_log2 = dh^-1/2 log2(e).
// Returns cudaGetLastError() after the launch, or the error of a step before it.
extern "C" int flash_attention_wgmma_launch(const void* q, const void* k, const void* v,
                                            void* out, int B, int Sq, int Skv, int H, int KV,
                                            int dh, int causal, int window, int q_offset,
                                            float scale_log2, cudaStream_t stream) {
    if (dh <= 64)
        return fw_launch<64>(q, k, v, out, B, Sq, Skv, H, KV, dh, causal, window, q_offset,
                             scale_log2, stream);
    if (dh <= 128)
        return fw_launch<128>(q, k, v, out, B, Sq, Skv, H, KV, dh, causal, window, q_offset,
                              scale_log2, stream);
    if (dh <= 256)
        return fw_launch<256>(q, k, v, out, B, Sq, Skv, H, KV, dh, causal, window, q_offset,
                              scale_log2, stream);
    return (int)cudaErrorInvalidValue;
}
