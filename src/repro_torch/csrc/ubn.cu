// K4: fused UBN, per-row statistics + normalize + the five direct
// quantizers, one pass over the row, fp32 grid output.
//
// Replaces repro/kernels/ubn.py::ubn_norm (_ubn_kernel).  On this slice it
// is every RMSNorm (ln1, ln2, final_norm) of the LM, kind "rms"; kind
// "layer" is here too.  Kind "batch" (statistics per column over the whole
// flattened batch) needs a two-phase column reduction and is not ported
// yet: the wrapper raises.
//
// Bound: bytes.  A row of N fp32 values is read once for the statistics,
// read again from L1/L2 for the normalize, and written once; the work per
// element is a handful of flops.  Design: one block per row; each thread
// sums its strided elements, a warp-shuffle tree and a pass over the warp
// partials in fixed order give the block's sums; thread 0's statistics
// reach every thread through shared memory.  The row sums accumulate in
// float64 (each x*x is exact there) and round once to fp32, so the
// statistic does not depend on the summation order: the plain version
// sums in float64 too and the two agree bit for bit (unless a float64 sum
// lands within its own rounding error of an fp32 tie).  Every fp32 division
// and sqrt is taken in float64 and rounded once, which is the correctly
// rounded fp32 result (53 >= 2 * 24 + 2 bits) whatever either side's
// compiler flags; the plain version does the same.  The build uses
// -fmad=false, so no multiply and add fuse where PyTorch rounds twice.
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ float qd(float x, float s) {  // Q(x, k), s = 2^(k-1)
    return rintf(x * s) / s;
}

// correctly rounded fp32 a / b and sqrt(a), through float64
__device__ __forceinline__ float div32(float a, float b) {
    return (float)((double)a / (double)b);
}

__device__ __forceinline__ float sqrt32(float a) {
    return (float)sqrt((double)a);
}

__device__ __forceinline__ double warp_sum(double v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

__global__ void ubn_kernel(const float* __restrict__ x,
                           const float* __restrict__ gamma,
                           const float* __restrict__ beta,
                           float* __restrict__ out, int n, int layer,
                           float s_mu, float s_sigma, float s_bn,
                           float s_gamma, float s_beta, float eps) {
    __shared__ double part[2][32];
    __shared__ float stats[2];
    const float* xr = x + (long long)blockIdx.x * n;
    float* yr = out + (long long)blockIdx.x * n;
    double ss = 0.0, s = 0.0;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        double v = xr[i];
        ss += v * v;
        s += v;
    }
    ss = warp_sum(ss);
    s = warp_sum(s);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int nw = (blockDim.x + 31) >> 5;
    if (lane == 0) { part[0][warp] = ss; part[1][warp] = s; }
    __syncthreads();
    if (threadIdx.x == 0) {
        double tss = 0.0, ts = 0.0;
        for (int w = 0; w < nw; ++w) { tss += part[0][w]; ts += part[1][w]; }
        const float nf = (float)n;
        const float mean_sq = div32((float)tss, nf);
        if (layer) {
            const float mu = div32((float)ts, nf);
            const float var = mean_sq - mu * mu;
            stats[0] = qd(mu, s_mu);
            stats[1] = qd(sqrt32(fmaxf(var, 0.f)), s_sigma) + eps;
        } else {
            stats[0] = 0.f;
            stats[1] = qd(sqrt32(mean_sq), s_sigma) + eps;
        }
    }
    __syncthreads();
    const float mu_q = stats[0], denom = stats[1];
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        float v = xr[i];
        float xh = qd(div32(layer ? v - mu_q : v, denom), s_bn);
        float y = qd(gamma[i], s_gamma) * xh;
        if (layer) y = y + qd(beta[i], s_beta);
        yr[i] = y;
    }
}

extern "C" int ubn_launch(const void* x, const void* gamma, const void* beta,
                          void* out, int m, int n, int layer, float s_mu,
                          float s_sigma, float s_bn, float s_gamma,
                          float s_beta, float eps, void* stream) {
    if (m <= 0) return 0;
    ubn_kernel<<<m, 256, 0, (cudaStream_t)stream>>>(
        (const float*)x, (const float*)gamma, (const float*)beta,
        (float*)out, n, layer, s_mu, s_sigma, s_bn, s_gamma, s_beta, eps);
    return (int)cudaGetLastError();
}
