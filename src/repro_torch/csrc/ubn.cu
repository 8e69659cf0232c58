// K4: fused UBN, statistics + normalize + the five direct quantizers,
// fp32 grid output.
//
// Replaces repro/kernels/ubn.py::ubn_norm (_ubn_kernel).  Kind "rms" is
// every RMSNorm (ln1, ln2, final_norm) of the LM, kind "layer" is here too:
// statistics per row (ubn_rows below).  Kind "batch" is every quantized
// BN of the ResNet: statistics per column over the whole flattened batch
// (ubn_batch_* at the end of this file).
//
// Rows ("rms", "layer").  Bound: bytes.  A row of N fp32 values is read
// once and written once; the work per element is a handful of flops.
// Design:
//   * A row is split over a thread-block cluster of `cl` blocks (1, 2, 4
//     or 8; kernels/ops.py ubn_cluster picks it from M alone), so that the
//     4 rows of a decode step or the 16 of a prefill page spread over many
//     SMs; at the training shape (4096 rows) a block takes a row.
//   * Each thread keeps its elements (float4 where N % 4 == 0) in
//     registers between the statistics and the normalize, so x is read
//     once (a slice longer than the registers hold is read again for the
//     rest).
//   * Each warp sums its part of a slice in float64 (each x*x is exact
//     there) with a shuffle tree and writes the partials into every block
//     of the cluster through distributed shared memory; after one cluster
//     barrier each warp adds all of them in a fixed order, so every block
//     forms the same statistics.  The sums round once to fp32, so the statistic does
//     not depend on the summation order: the plain version sums in float64
//     too and the two agree bit for bit (unless a float64 sum lands within
//     its own rounding error of an fp32 tie).
//   * Divisions and square roots are the correctly rounded fp32 __fdiv_rn
//     and __fsqrt_rn, which equal the plain version's float64 operation
//     rounded once (53 >= 2 * 24 + 2 bits); fp32_check below holds them
//     equal on the card over every sqrt input and 2^28 random divisions.
//     The build uses -fmad=false, so no multiply and add fuse where
//     PyTorch rounds twice.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

#define UBN_THREADS 256
#define UBN_REGS 8     // VEC-element groups a thread keeps in registers

__device__ __forceinline__ float qd(float x, float s) {  // Q(x, k), s = 2^(k-1)
    return rintf(x * s) / s;
}

// correctly rounded fp32 a / b and sqrt(a), through float64 (the K4 batch
// kernels and fp32_check's reference)
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

template <int VEC> struct Vec;
template <> struct Vec<4> {
    using T = float4;
    static __device__ __forceinline__ float get(const T& v, int k) {
        return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
    }
    static __device__ __forceinline__ void set(T& v, int k, float f) {
        if (k == 0) v.x = f; else if (k == 1) v.y = f;
        else if (k == 2) v.z = f; else v.w = f;
    }
};
template <> struct Vec<1> {
    using T = float;
    static __device__ __forceinline__ float get(const T& v, int) { return v; }
    static __device__ __forceinline__ void set(T& v, int, float f) { v = f; }
};

struct UbnArgs {
    const float* x;
    const float* gamma;
    const float* beta;
    float* out;
    int n, cl, layer;
    float s_mu, s_sigma, s_bn, s_gamma, s_beta, eps;
};

template <int VEC>
__device__ __forceinline__ typename Vec<VEC>::T
norm_group(const UbnArgs& a, typename Vec<VEC>::T v, int i, float mu_q,
           float denom) {
    using V = Vec<VEC>;
    const typename V::T gm = reinterpret_cast<const typename V::T*>(a.gamma)[i];
    typename V::T bt = gm;
    if (a.layer) bt = reinterpret_cast<const typename V::T*>(a.beta)[i];
    typename V::T y;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
        const float xv = V::get(v, k);
        const float xh = qd(__fdiv_rn(a.layer ? xv - mu_q : xv, denom), a.s_bn);
        float r = qd(V::get(gm, k), a.s_gamma) * xh;
        if (a.layer) r = r + qd(V::get(bt, k), a.s_beta);
        V::set(y, k, r);
    }
    return y;
}

// grid (M * cl): block rank r of a row's cluster takes the r-th slice of
// the row's N / VEC groups.  Lane 0 of each warp writes the warp's float64
// partial sums into slot (rank, warp) of every block of the cluster; after
// one cluster barrier each warp adds the cl * 8 slots in the same fixed
// order, so every warp of every block forms the same statistics with no
// further barrier.
template <int VEC>
__global__ void __launch_bounds__(UBN_THREADS) ubn_rows(UbnArgs a) {
    using V = Vec<VEC>;
    using T = typename V::T;
    constexpr int W = UBN_THREADS / 32;
    __shared__ double slot[8 * W][2];
    const int rank = blockIdx.x % a.cl;
    const long long row = blockIdx.x / a.cl;
    if (a.cl > 1)   // every block of the cluster runs before any writes to it
        asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
    const int groups = a.n / VEC, per = (groups + a.cl - 1) / a.cl;
    const int g0 = rank * per, g1 = min(groups, g0 + per);
    const T* xr = reinterpret_cast<const T*>(a.x + row * a.n);
    T* yr = reinterpret_cast<T*>(a.out + row * a.n);
    T v[UBN_REGS];
    double ss = 0.0, s = 0.0;
#pragma unroll
    for (int j = 0; j < UBN_REGS; ++j) {
        const int i = g0 + threadIdx.x + j * UBN_THREADS;
        if (i < g1) {
            v[j] = xr[i];
#pragma unroll
            for (int k = 0; k < VEC; ++k) {
                const double d = V::get(v[j], k);
                ss += d * d;
                s += d;
            }
        }
    }
    for (int i = g0 + threadIdx.x + UBN_REGS * UBN_THREADS; i < g1;
         i += UBN_THREADS) {
        const T w = xr[i];
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
            const double d = V::get(w, k);
            ss += d * d;
            s += d;
        }
    }
    ss = warp_sum(ss);
    s = warp_sum(s);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int at = rank * W + warp;
    if (a.cl > 1) {
        cg::cluster_group cluster = cg::this_cluster();
        asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
        if (lane < a.cl) {
            double* dst = cluster.map_shared_rank(&slot[0][0], lane);
            dst[2 * at] = ss;
            dst[2 * at + 1] = s;
        }
        cluster.sync();          // every slot written; no later remote access
    } else {
        if (lane == 0) { slot[at][0] = ss; slot[at][1] = s; }
        __syncthreads();
    }
    // the cl * W slots in a fixed order: lane l holds slots l and l + 32
    const int ns = a.cl * W;
    double tss = 0.0, ts = 0.0;
    if (lane < ns) { tss = slot[lane][0]; ts = slot[lane][1]; }
    if (lane + 32 < ns) { tss += slot[lane + 32][0]; ts += slot[lane + 32][1]; }
    tss = warp_sum(tss);
    ts = warp_sum(ts);
    const float nf = (float)a.n;
    const float mean_sq = __fdiv_rn((float)tss, nf);
    float mu_q = 0.f, denom;
    if (a.layer) {
        const float mu = __fdiv_rn((float)ts, nf);
        const float var = mean_sq - mu * mu;
        mu_q = qd(mu, a.s_mu);
        denom = qd(__fsqrt_rn(fmaxf(var, 0.f)), a.s_sigma) + a.eps;
    } else {
        denom = qd(__fsqrt_rn(mean_sq), a.s_sigma) + a.eps;
    }
#pragma unroll
    for (int j = 0; j < UBN_REGS; ++j) {
        const int i = g0 + threadIdx.x + j * UBN_THREADS;
        if (i < g1) yr[i] = norm_group<VEC>(a, v[j], i, mu_q, denom);
    }
    for (int i = g0 + threadIdx.x + UBN_REGS * UBN_THREADS; i < g1;
         i += UBN_THREADS)
        yr[i] = norm_group<VEC>(a, xr[i], i, mu_q, denom);
}

// vec 4 needs N % 4 == 0 and 16-byte aligned x, gamma, beta and out; cl in
// {1, 2, 4, 8} (the wrapper checks)
extern "C" int ubn_launch(const void* x, const void* gamma, const void* beta,
                          void* out, int m, int n, int layer, int cl,
                          int vec, float s_mu, float s_sigma, float s_bn,
                          float s_gamma, float s_beta, float eps,
                          void* stream) {
    if (m <= 0) return 0;
    UbnArgs a;
    a.x = (const float*)x; a.gamma = (const float*)gamma;
    a.beta = (const float*)beta; a.out = (float*)out;
    a.n = n; a.cl = cl; a.layer = layer;
    a.s_mu = s_mu; a.s_sigma = s_sigma; a.s_bn = s_bn;
    a.s_gamma = s_gamma; a.s_beta = s_beta; a.eps = eps;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)((long long)m * cl));
    cfg.blockDim = dim3(UBN_THREADS);
    cfg.stream = (cudaStream_t)stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cl;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = cl > 1 ? 1 : 0;
    cudaError_t err = vec == 4 ? cudaLaunchKernelEx(&cfg, ubn_rows<4>, a)
                               : cudaLaunchKernelEx(&cfg, ubn_rows<1>, a);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32_check: __fdiv_rn and __fsqrt_rn against the float64 operation
// rounded once (div32, sqrt32), bit for bit (NaN against NaN counts as
// equal).  miss[0]: `pairs` divisions of hashed bit patterns, half of them
// any pattern (denormals, huge, tiny, inf, NaN), half with both exponents
// within 2^-16 .. 2^16; miss[1]: every pair of the `n_edge` edge values;
// miss[2]: the square root of every one of the 2^32 bit patterns.

__device__ __forceinline__ uint32_t mix32(uint64_t z) {
    z += 0x9E3779B97F4A7C15ull;
    z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
    z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
    return (uint32_t)(z ^ (z >> 31));
}

__device__ __forceinline__ bool same(float x, float y) {
    return (x != x && y != y) || __float_as_uint(x) == __float_as_uint(y);
}

__device__ __forceinline__ float near_one(uint32_t u) {   // 2^-16 .. 2^16
    const uint32_t ex = 127 - 16 + (u >> 23) % 33;
    return __uint_as_float((u & 0x807FFFFFu) | (ex << 23));
}

__global__ void fp32_check(unsigned long long pairs, const float* edge,
                           int n_edge, unsigned long long* miss) {
    const unsigned long long stride = (unsigned long long)gridDim.x * blockDim.x;
    const unsigned long long i0 = (unsigned long long)blockIdx.x * blockDim.x
                                  + threadIdx.x;
    unsigned long long bad[3] = {0, 0, 0};
    for (unsigned long long i = i0; i < pairs; i += stride) {
        const uint32_t ua = mix32(2 * i), ub = mix32(2 * i + 1);
        float a = __uint_as_float(ua), b = __uint_as_float(ub);
        if (i & 1) { a = near_one(ua); b = near_one(ub); }
        bad[0] += !same(__fdiv_rn(a, b), div32(a, b));
    }
    for (unsigned long long i = i0; i < (unsigned long long)n_edge * n_edge;
         i += stride) {
        const float a = edge[i / n_edge], b = edge[i % n_edge];
        bad[1] += !same(__fdiv_rn(a, b), div32(a, b));
    }
    for (unsigned long long u = i0; u < (1ull << 32); u += stride) {
        const float a = __uint_as_float((uint32_t)u);
        bad[2] += !same(__fsqrt_rn(a), sqrt32(a));
    }
    for (int k = 0; k < 3; ++k)
        if (bad[k]) atomicAdd(miss + k, bad[k]);
}

extern "C" int fp32_check_launch(long long pairs, const void* edge,
                                 int n_edge, void* miss, void* stream) {
    fp32_check<<<132 * 8, 256, 0, (cudaStream_t)stream>>>(
        (unsigned long long)pairs, (const float*)edge, n_edge,
        (unsigned long long*)miss);
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
