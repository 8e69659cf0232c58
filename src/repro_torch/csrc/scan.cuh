// Operand access that K9 (selective_scan.cu) and K9b (selective_scan_bwd.cu)
// share for their two carrier types: fp32, and bf16 (QConfig.scan_dtype
// "bf16").  A thread holds 4 consecutive states of a channel, so it moves
// 4 elements at once: a float4 in fp32, a uint2 of 4 bf16 values in bf16.
// Arithmetic is fp32 either way: a bf16 value widens to fp32 exactly, and
// a result rounds once from fp32 to bf16, to nearest even (the same
// rounding as PyTorch's .to(torch.bfloat16), which the plain versions in
// kernels/ref.py use).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

template <typename T> struct Vec4;
template <> struct Vec4<float> { using raw = float4; };
template <> struct Vec4<__nv_bfloat16> { using raw = uint2; };

__device__ __forceinline__ float4 f4(const float4& v) { return v; }

__device__ __forceinline__ float4 f4(const uint2& v) {
    const float2 lo = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&v.x));
    const float2 hi = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&v.y));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// 4 elements at p (8- or 16-byte aligned), raw: read-only through the
// texture path, streaming (read once), or a plain load (shared memory)
template <typename T>
__device__ __forceinline__ typename Vec4<T>::raw ldg_raw(const T* p) {
    return __ldg(reinterpret_cast<const typename Vec4<T>::raw*>(p));
}

template <typename T>
__device__ __forceinline__ typename Vec4<T>::raw ldcs_raw(const T* p) {
    return __ldcs(reinterpret_cast<const typename Vec4<T>::raw*>(p));
}

template <typename T>
__device__ __forceinline__ float4 ld4(const T* p) {
    return f4(*reinterpret_cast<const typename Vec4<T>::raw*>(p));
}

__device__ __forceinline__ void st4(float* p, const float (&v)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void st4(__nv_bfloat16* p, const float (&v)[4]) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 u;
    u.x = *reinterpret_cast<const uint32_t*>(&lo);
    u.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p) = u;
}

// one fp32 value stored as T (bf16: rounded to nearest even), and read back
__device__ __forceinline__ void put1(float* p, float v) { *p = v; }

__device__ __forceinline__ void put1(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float get1(float v) { return v; }

__device__ __forceinline__ float get1(__nv_bfloat16 v) {
    return __bfloat162float(v);
}
