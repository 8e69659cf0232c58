// K2: fused payload quantization, clip(rint(x * inv_step), +-lim) -> int8.
// K8: stochastic CQ payload (at the end of this file).
//
// Replaces repro/kernels/quantize.py::quantize_fused (_quant_kernel), the
// Pallas kernel behind every payload of 8 bits or fewer (qact and the
// per-forward qweight of every weight), and
// repro/kernels/quantize.py::cq_stochastic (_cq_kernel).
//
// Bound: bytes.  5 bytes move per element (4 read, 1 written) and the
// arithmetic is one multiply, one rint and one clamp, so the kernel can
// only approach the memory rate.  Design: a grid-stride loop with 16-byte
// float4 loads and 4-byte char4 stores (one vector per thread per trip),
// the scalar inv_step read once per thread from device memory (no host
// sync for the amax-derived scale), and a scalar tail.  rintf rounds half
// to even, as jnp.round / torch.round.
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ int8_t quant1(float x, float inv, float lim) {
    float v = rintf(__fmul_rn(x, inv));
    return (int8_t)fminf(fmaxf(v, -lim), lim);
}

__global__ void quantize_kernel(const float* __restrict__ x,
                                const float* __restrict__ inv_step,
                                float lim, int8_t* __restrict__ out,
                                long long n, int vec) {
    const float inv = *inv_step;
    const long long stride = (long long)gridDim.x * blockDim.x;
    const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    long long done = 0;
    if (vec) {
        const long long n4 = n / 4;
        const float4* x4 = reinterpret_cast<const float4*>(x);
        char4* o4 = reinterpret_cast<char4*>(out);
        for (long long i = tid; i < n4; i += stride) {
            float4 v = x4[i];
            char4 o;
            o.x = quant1(v.x, inv, lim);
            o.y = quant1(v.y, inv, lim);
            o.z = quant1(v.z, inv, lim);
            o.w = quant1(v.w, inv, lim);
            o4[i] = o;
        }
        done = n4 * 4;
    }
    for (long long i = done + tid; i < n; i += stride)
        out[i] = quant1(x[i], inv, lim);
}

extern "C" int quantize_launch(const void* x, const void* inv_step, float lim,
                               void* out, long long n, void* stream) {
    if (n <= 0) return 0;
    const int threads = 256;
    const int vec = ((uintptr_t)x % 16 == 0) && ((uintptr_t)out % 4 == 0);
    long long want = (vec ? n / 4 : n) / threads + 1;
    int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
    quantize_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const float*)x, (const float*)inv_step, lim, (int8_t*)out, n, vec);
    return (int)cudaGetLastError();
}

// K8: clip(floor(v) + [u < v - floor(v)], +-(dr - 1)) -> int16 with
// v = x * inv_step (one fp32 multiply) and u = (bits & 0xFFFFFF) * 2^-24,
// the paper's stochastic rounding (Eq. 7) from a plane of given random
// bits.  The bits arrive as int32 holding the uint32 pattern; the mask
// keeps the low 24, so the value is non-negative and exact in fp32, and
// v - floor(v) is exact too.  No path of the port launches it: the
// optimizer's CQ draws threefry noise, as the reference's does.
//
// Bound: bytes.  10 bytes move per element (x and bits read, the int16
// payload written) for a few flops.  Design: a grid-stride loop, one
// element per thread per trip, the scalar read once per thread.
__global__ void cq_kernel(const float* __restrict__ x,
                          const int32_t* __restrict__ bits,
                          const float* __restrict__ inv_step, float dr,
                          int16_t* __restrict__ out, long long n) {
    const float inv = *inv_step;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n; i += stride) {
        const float v = __fmul_rn(x[i], inv);
        const float f = floorf(v);
        const float u = (float)(bits[i] & 0xFFFFFF) * 5.9604644775390625e-08f;
        float y = f + ((u < v - f) ? 1.f : 0.f);
        y = fminf(fmaxf(y, -dr + 1.f), dr - 1.f);
        out[i] = (int16_t)y;
    }
}

extern "C" int cq_launch(const void* x, const void* bits,
                         const void* inv_step, float dr, void* out,
                         long long n, void* stream) {
    if (n <= 0) return 0;
    long long want = (n + 255) / 256;
    int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
    cq_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
        (const float*)x, (const int32_t*)bits, (const float*)inv_step, dr,
        (int16_t*)out, n);
    return (int)cudaGetLastError();
}
