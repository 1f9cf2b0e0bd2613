// The element type of the worker rows X, shared by the aggregation kernels
// (bucket_mix.cu, pairwise_gram.cu, selection.cu, residual_norms.cu,
// cclip.cu). The wrapper prepends "#define X_T <type>" and this text to a
// source before it is built (_build.x_source): float, __nv_bfloat16 or
// __half, one library per type.
//
// X is converted to fp32 where it is loaded (__bfloat162float and
// __half2float are exact) and every instruction after the load is the fp32
// kernel's, so kernel(X16) equals kernel(X16.float()) bit for bit. The Gram
// (pairwise_gram.cu) loads X by TMA into shared memory as it is, and
// converts where it reads a shared stage (xt_float4). Every other input
// (mixing matrix, coefficients, centre, lam, acc) and every output stays
// fp32.
//
// Four neighbouring elements are one vector load: 16 bytes for fp32, 8 for
// a 16-bit type (XT_VEC_BYTES). A kernel takes its vector path where a
// row's four elements at c0 % 4 == 0 lie on that boundary: d % 4 == 0 and
// a base aligned to XT_VEC_BYTES.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

#ifndef X_T
#error "X_T (the element type of X) must be defined before xtype.cuh"
#endif

typedef X_T xt;

#define XT_VEC_BYTES (4 * (int)sizeof(xt))

__device__ __forceinline__ float xt_float(float v) { return v; }
__device__ __forceinline__ float xt_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float xt_float(__half v) { return __half2float(v); }

// one element of X, by the read-only path, as fp32
__device__ __forceinline__ float xt_ldg(const float* p) { return __ldg(p); }
__device__ __forceinline__ float xt_ldg(const __nv_bfloat16* p) {
    return __bfloat162float(__ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
}
__device__ __forceinline__ float xt_ldg(const __half* p) {
    return __half2float(__ushort_as_half(__ldg(reinterpret_cast<const unsigned short*>(p))));
}

// four neighbouring 16-bit elements held in 8 bytes, as fp32 (the second
// argument names their type)
__device__ __forceinline__ float4 xt_float4(uint2 u, __nv_bfloat16) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 xt_float4(uint2 u, __half) {
    const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&u.x));
    const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&u.y));
    return make_float4(a.x, a.y, b.x, b.y);
}

// four neighbouring elements of X at an XT_VEC_BYTES-aligned address, as fp32
__device__ __forceinline__ float4 xt_ldg4(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 xt_ldg4(const __nv_bfloat16* p) {
    return xt_float4(__ldg(reinterpret_cast<const uint2*>(p)), __nv_bfloat16());
}
__device__ __forceinline__ float4 xt_ldg4(const __half* p) {
    return xt_float4(__ldg(reinterpret_cast<const uint2*>(p)), __half());
}

// X's four elements at c0 .. c0 + 3 of a row, the vector load where ALIGNED,
// else predicated element loads with zeros past d
template <bool ALIGNED>
__device__ __forceinline__ float4 xt_load4(const xt* __restrict__ row, long long c0,
                                           long long d) {
    if constexpr (ALIGNED) {
        return xt_ldg4(row + c0);
    } else {
        float4 v;
        v.x = c0 < d ? xt_ldg(row + c0) : 0.0f;
        v.y = c0 + 1 < d ? xt_ldg(row + c0 + 1) : 0.0f;
        v.z = c0 + 2 < d ? xt_ldg(row + c0 + 2) : 0.0f;
        v.w = c0 + 3 < d ? xt_ldg(row + c0 + 3) : 0.0f;
        return v;
    }
}

// X's row base aligned for the vector path (d % 4 == 0 is the caller's test)
__host__ __device__ __forceinline__ bool xt_aligned(const void* p) {
    return reinterpret_cast<uintptr_t>(p) % XT_VEC_BYTES == 0;
}
