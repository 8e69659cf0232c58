// K4: fused UBN, statistics + normalize + the five direct quantizers,
// fp32 grid output.
//
// Replaces repro/kernels/ubn.py::ubn_norm (_ubn_kernel).  Kind "rms" is
// every RMSNorm (ln1, ln2, final_norm) of the LM, kind "layer" is here too:
// statistics per row (ubn_kernel below).  Kind "batch" is every quantized
// BN of the ResNet: statistics per column over the whole flattened batch
// (ubn_batch_* at the end of this file).
//
// Rows ("rms", "layer").  Bound: bytes.  A row of N fp32 values is read once for the statistics,
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

// ---------------------------------------------------------------------------
// Kind "batch": x (M, C), M = N*H*W of an NHWC activation, statistics per
// column over all M rows (M runs from 1,568 to 100,352 on ResNet-50 at
// batch 32).  The TPU kernel holds a whole column in one VMEM block; no
// Hopper block holds 100 k rows, so the reduction runs in two phases and
// the normalize in a third launch:
//
//   A  grid (column tiles of 32, chunks of `chunk` rows).  A warp reads
//      32 consecutive channels of one row (coalesced: C is the fast axis
//      of NHWC); 8 warps stride the chunk's rows; each block writes the
//      float64 partial sums of x and x*x of its chunk into a workspace, in
//      a fixed order.  The chunk is a constant of the wrapper (UBN_CHUNK in
//      kernels/ops.py), so the sums' order depends on M alone, never on the
//      SM count; no atomics (a float64 atomic sum is order-dependent).
//   B  one thread per column adds the partials in chunk order, rounds once
//      to fp32 and forms mean, mean square, var = msq - mu^2 (fp32), sigma
//      (sqrt through float64), and the quantized mu_q, sigma_q + eps,
//      gamma_q and beta_q, exactly as the row kernel above and
//      kernels/ref.py::ubn_norm do.
//   C  elementwise normalize and quantize over (M, C), the division in
//      float64 rounded once.
//
// Bound: bytes.  x is read twice (A and C) and y written once: 12 bytes per
// element.  The float64 sums are exact for grid-valued inputs of the
// path's magnitudes, and otherwise agree with the plain version's float64
// sum (another order) once rounded to fp32, unless the sum lands within
// its own rounding error of an fp32 tie.
#define UBN_COLS 32
#define UBN_WARPS 8

__global__ void ubn_batch_partial(const float* __restrict__ x,
                                  double* __restrict__ part, int m, int n,
                                  int chunk) {
    __shared__ double acc[2][UBN_WARPS][UBN_COLS];
    const int c = blockIdx.x * UBN_COLS + threadIdx.x;
    const long long r0 = (long long)blockIdx.y * chunk;
    const long long r1 = min(r0 + chunk, (long long)m);
    double s = 0.0, ss = 0.0;
    if (c < n) {
        for (long long r = r0 + threadIdx.y; r < r1; r += UBN_WARPS) {
            const double v = x[r * n + c];
            s += v;
            ss += v * v;
        }
    }
    acc[0][threadIdx.y][threadIdx.x] = s;
    acc[1][threadIdx.y][threadIdx.x] = ss;
    __syncthreads();
    if (threadIdx.y == 0 && c < n) {
        double ts = 0.0, tss = 0.0;
        for (int w = 0; w < UBN_WARPS; ++w) {
            ts += acc[0][w][threadIdx.x];
            tss += acc[1][w][threadIdx.x];
        }
        double* p = part + (long long)blockIdx.y * 2 * n;
        p[c] = ts;
        p[n + c] = tss;
    }
}

// stats rows: mu_q, sigma_q + eps, gamma_q, beta_q
__global__ void ubn_batch_stats(const double* __restrict__ part,
                                const float* __restrict__ gamma,
                                const float* __restrict__ beta,
                                float* __restrict__ stats, int m, int n,
                                int chunks, float s_mu, float s_sigma,
                                float s_gamma, float s_beta, float eps) {
    const int c = blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= n) return;
    double ts = 0.0, tss = 0.0;
    for (int k = 0; k < chunks; ++k) {
        ts += part[(long long)k * 2 * n + c];
        tss += part[(long long)k * 2 * n + n + c];
    }
    const float mf = (float)m;
    const float mean_sq = div32((float)tss, mf);
    const float mu = div32((float)ts, mf);
    const float var = mean_sq - mu * mu;
    stats[c] = qd(mu, s_mu);
    stats[n + c] = qd(sqrt32(fmaxf(var, 0.f)), s_sigma) + eps;
    stats[2 * n + c] = qd(gamma[c], s_gamma);
    stats[3 * n + c] = qd(beta[c], s_beta);
}

__global__ void ubn_batch_apply(const float* __restrict__ x,
                                const float* __restrict__ stats,
                                float* __restrict__ out, long long total,
                                int n, float s_bn) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < total; i += stride) {
        const int c = (int)(i % n);
        const float xh = qd(div32(x[i] - stats[c], stats[n + c]), s_bn);
        out[i] = stats[2 * n + c] * xh + stats[3 * n + c];
    }
}

extern "C" int ubn_batch_launch(const void* x, const void* gamma,
                                const void* beta, void* out, void* part,
                                void* stats, int m, int n, int chunk,
                                float s_mu,
                                float s_sigma, float s_bn, float s_gamma,
                                float s_beta, float eps, void* stream) {
    if (m <= 0 || n <= 0 || chunk <= 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    const int chunks = (m + chunk - 1) / chunk;
    dim3 grid_a((n + UBN_COLS - 1) / UBN_COLS, chunks);
    ubn_batch_partial<<<grid_a, dim3(UBN_COLS, UBN_WARPS), 0, st>>>(
        (const float*)x, (double*)part, m, n, chunk);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ubn_batch_stats<<<(n + 127) / 128, 128, 0, st>>>(
        (const double*)part, (const float*)gamma, (const float*)beta,
        (float*)stats, m, n, chunks, s_mu, s_sigma, s_gamma, s_beta, eps);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const long long total = (long long)m * n;
    long long want = (total + 255) / 256;
    const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
    ubn_batch_apply<<<blocks, 256, 0, st>>>(
        (const float*)x, (const float*)stats, (float*)out, total, n, s_bn);
    return (int)cudaGetLastError();
}
