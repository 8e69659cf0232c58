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

// correctly rounded fp32 a / b and sqrt(a), through float64 (fp32_check's
// reference for __fdiv_rn and __fsqrt_rn)
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
// column over all M rows (ResNet-50 at batch 32: M from 1,568 to 100,352,
// C from 64 to 2,048).  The TPU kernel holds a whole column in one VMEM
// block.  Here a block takes a group of `cw` columns and a run of rows.  C
// is the fast axis of NHWC, so a row's cw columns are one 64-byte (cw 16)
// or 128-byte (cw 32) segment, read as float4 (VEC 4: C % 4 == 0 and x
// 16-byte aligned) or as floats.
//
// Bound: bytes, 8 per element (x read once, y written once).  Two routes,
// which kernels/ops.py ubn_batch_plan picks from (M, C) and the SM count:
//
//   strip     (M 1,568 and 6,272 on the path) a strip of 16 columns over
//             all M rows fits in the shared memory of a thread-block
//             cluster of `cl` blocks (1, 2 or 4) and the strips fill the
//             card: each block copies its M / cl rows in with cp.async (in
//             four groups, each summed as soon as it lands), writes its
//             partials into every block of the cluster (distributed shared
//             memory), and after one cluster barrier every block forms the
//             same statistics and normalizes its rows from shared memory.
//             One launch; x is read once.
//   two-pass  (M 25,088 and 100,352) ubn_batch_part: a block sums a chunk
//             of rows of a 32-column group, 4 rows in flight a thread; the
//             last block of the group to arrive (a counter per group, which
//             that block resets, so the next call needs no memset) adds the
//             group's partials and writes the statistics.  ubn_batch_norm:
//             a 2-D grid (column group x span of rows), the group's
//             statistics in registers, walks the spans in the reverse of
//             the partial pass's order, so the rows read last, still in L2,
//             are read again first.  x is read twice less what L2 keeps: 12
//             bytes an element at most.
//
// The sums are float64 (each x*x is exact there) in an order the plan
// fixes: within a thread in row order, over a warp's row lanes by a shuffle
// tree, over the warps in order, then over the cluster's blocks in rank
// order (strip), or over the chunks in eight runs of consecutive chunks,
// each added in order, the eight in order (two-pass, whose chunks follow
// from M alone).  No float64 atomics.  Rounded once to fp32 the sums agree
// with the plain version's float64 sum (another order) unless a sum lands
// within its own rounding error of an fp32 tie.  Division and sqrt are
// __fdiv_rn and __fsqrt_rn, equal to the plain version's float64 operations
// rounded once (fp32_check above).
#define UBN_BT 256                 // threads of a batch block
#define UBN_BW (UBN_BT / 32)       // its warps
#define UBN_MAXCW 32               // columns of a group at most
#define UBN_MAXCL 4                // blocks of a strip's cluster at most
#define UBN_FOLD 8                 // runs of chunks the last block adds
#define UBN_FOLD_RUN 16            // chunks of a run at most (chunks <= 128)
#define UBN_FOLD_LOADS 8           // of which loaded together
#define UBN_SPAN_MAX 65535         // spans of the two-pass normalize
#define UBN_LOADS 4                // cp.async groups of a strip block
// shared memory of a strip block before its tile: the warps' and the
// cluster's float64 partials, then the column statistics
#define UBN_STRIP_HEAD ((UBN_BW + UBN_MAXCL) * UBN_MAXCW * 16 + UBN_MAXCW * 16)
#define UBN_STRIP_SMEM (227 * 1024)

struct BatchArgs {
    const float* x;
    const float* gamma;
    const float* beta;
    float* out;
    double* part;        // two-pass: (chunks, 2, C) float64 partials
    float* stats;        // two-pass: (4, C) mu_q, sigma_q + eps, gamma_q, beta_q
    int* count;          // two-pass: arrivals per column group (left at 0)
    long long m;
    long long rows;      // strip: rows a block holds; two-pass: a chunk's
    long long span;      // two-pass normalize: rows a block
    int n, cw, cl, chunks;
    float s_mu, s_sigma, s_bn, s_gamma, s_beta, eps;
    float inv_bn;        // 1 / s_bn, exact (a power of two)
};

struct Stat { float mu_q, den, g, b; };

__device__ __forceinline__ Stat col_stat(const BatchArgs& a, int c,
                                         double ts, double tss) {
    const float mf = (float)a.m;
    const float mean_sq = __fdiv_rn((float)tss, mf);
    const float mu = __fdiv_rn((float)ts, mf);
    const float var = __fsub_rn(mean_sq, __fmul_rn(mu, mu));
    Stat r;
    r.mu_q = qd(mu, a.s_mu);
    r.den = __fadd_rn(qd(__fsqrt_rn(fmaxf(var, 0.f)), a.s_sigma), a.eps);
    r.g = qd(a.gamma[c], a.s_gamma);
    r.b = qd(a.beta[c], a.s_beta);
    return r;
}

// the normalize of one element; Q(., k_BN) multiplies by the exact inverse
// of its power-of-two step instead of dividing (the same correctly rounded
// value: rint(.) * 2^-(k-1) is exact)
__device__ __forceinline__ float norm1(float x, const Stat& t,
                                       const BatchArgs& a) {
    const float q = __fdiv_rn(__fsub_rn(x, t.mu_q), t.den);
    const float xh = __fmul_rn(rintf(__fmul_rn(q, a.s_bn)), a.inv_bn);
    return __fadd_rn(__fmul_rn(t.g, xh), t.b);
}

template <int VEC>
__device__ __forceinline__ typename Vec<VEC>::T ldx(const float* p) {
    return __ldg(reinterpret_cast<const typename Vec<VEC>::T*>(p));
}

// wait until at most k of this thread's cp.async groups are pending
__device__ __forceinline__ void cp_async_wait(int k) {
    switch (k) {
        case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
        case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
        case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
        default: asm volatile("cp.async.wait_group 3;\n" ::: "memory");
    }
}

template <int VEC>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
    const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    if (VEC == 4)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                     :: "r"(d), "l"(src) : "memory");
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                     :: "r"(d), "l"(src) : "memory");
}

// a thread's place in a block over a column group of cw columns: tpr
// threads a row (VEC columns each), rpi rows an iteration; column lane j,
// row lane i0
struct Lanes {
    int tpr, rpi, j, i0, col;
    __device__ Lanes(int cw, int vec) {
        tpr = cw / vec;
        rpi = UBN_BT / tpr;
        j = threadIdx.x % tpr;
        i0 = threadIdx.x / tpr;
        col = j * vec;
    }
};

template <int VEC>
__device__ __forceinline__ void add_row(double (&s)[VEC], double (&ss)[VEC],
                                        const typename Vec<VEC>::T& v) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
        const double d = Vec<VEC>::get(v, k);
        s[k] = __dadd_rn(s[k], d);
        ss[k] = __fma_rn(d, d, ss[k]);       // d*d is exact: one rounding
    }
}

// the block's float64 sums per column of the group from each thread's
// partials: a shuffle tree over the warp's row lanes, then the warps in
// order.  Thread t < cw gets column t's sums in (ts, tss).
template <int VEC>
__device__ __forceinline__ void block_sums(double (&s)[VEC],
                                           double (&ss)[VEC], int tpr,
                                           int cw,
                                           double (*red)[UBN_MAXCW][2],
                                           double& ts, double& tss) {
    for (int o = tpr; o < 32; o <<= 1) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
            s[k] = __dadd_rn(s[k], __shfl_xor_sync(0xffffffffu, s[k], o));
            ss[k] = __dadd_rn(ss[k], __shfl_xor_sync(0xffffffffu, ss[k], o));
        }
    }
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    if (lane < tpr) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
            red[w][lane * VEC + k][0] = s[k];
            red[w][lane * VEC + k][1] = ss[k];
        }
    }
    __syncthreads();
    ts = 0.0;
    tss = 0.0;
    if ((int)threadIdx.x < cw) {
        for (int q = 0; q < UBN_BW; ++q) {
            ts = __dadd_rn(ts, red[q][threadIdx.x][0]);
            tss = __dadd_rn(tss, red[q][threadIdx.x][1]);
        }
    }
}

// strip route: grid (strips * cl) in clusters of cl; block rank r of strip
// s holds rows [r * rows, (r + 1) * rows) of columns [s * cw, s * cw + cw)
template <int VEC>
__global__ void __launch_bounds__(UBN_BT) ubn_batch_strip(BatchArgs a) {
    using T = typename Vec<VEC>::T;
    extern __shared__ __align__(16) unsigned char sm[];
    auto red = reinterpret_cast<double (*)[UBN_MAXCW][2]>(sm);
    auto slot = reinterpret_cast<double (*)[UBN_MAXCW][2]>(
        sm + UBN_BW * UBN_MAXCW * 16);
    Stat* st = reinterpret_cast<Stat*>(sm + (UBN_BW + UBN_MAXCL)
                                       * UBN_MAXCW * 16);
    float* tile = reinterpret_cast<float*>(sm + UBN_STRIP_HEAD);
    const int rank = blockIdx.x % a.cl, strip = blockIdx.x / a.cl;
    if (a.cl > 1)   // every block of the cluster runs before any writes to it
        asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
    const int c0 = strip * a.cw, cw = min(a.cw, a.n - c0);
    const long long r0 = (long long)rank * a.rows;
    const int nr = (int)max(0LL, min(a.m - r0, a.rows));
    const Lanes L(a.cw, VEC);
    const bool live = L.col < cw;
    // the rows in UBN_LOADS groups of whole iterations: all copies are
    // issued at once, and each group is summed as soon as it has landed
    // (a thread's rows still in row order)
    const float* xs = a.x + r0 * a.n + c0 + L.col;
    const int per = (nr + L.rpi * UBN_LOADS - 1) / (L.rpi * UBN_LOADS)
                    * L.rpi;
#pragma unroll
    for (int q = 0; q < UBN_LOADS; ++q) {
        if (live)
            for (int r = q * per + L.i0; r < min(nr, (q + 1) * per);
                 r += L.rpi)
                cp_async<VEC>(tile + r * a.cw + L.col,
                              xs + (long long)r * a.n);
        asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
    double s[VEC], ss[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) { s[k] = 0.0; ss[k] = 0.0; }
#pragma unroll
    for (int q = 0; q < UBN_LOADS; ++q) {
        cp_async_wait(UBN_LOADS - 1 - q);          // own group q landed
        if (live)
            for (int r = q * per + L.i0; r < min(nr, (q + 1) * per);
                 r += L.rpi)
                add_row<VEC>(s, ss, *reinterpret_cast<const T*>(
                    tile + r * a.cw + L.col));
    }
    double ts, tss;
    block_sums<VEC>(s, ss, L.tpr, cw, red, ts, tss);
    const int t = threadIdx.x;
    if (a.cl > 1) {
        cg::cluster_group cluster = cg::this_cluster();
        asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
        if (t < cw)
            for (int q = 0; q < a.cl; ++q) {
                double* dst = cluster.map_shared_rank(&slot[0][0][0], q);
                dst[(rank * UBN_MAXCW + t) * 2] = ts;
                dst[(rank * UBN_MAXCW + t) * 2 + 1] = tss;
            }
        cluster.sync();          // every slot written; no later remote access
    } else if (t < cw) {
        slot[0][t][0] = ts;
        slot[0][t][1] = tss;
    }
    if (t < cw) {
        double us = 0.0, uss = 0.0;
        for (int q = 0; q < a.cl; ++q) {
            us = __dadd_rn(us, slot[q][t][0]);
            uss = __dadd_rn(uss, slot[q][t][1]);
        }
        st[t] = col_stat(a, c0 + t, us, uss);
    }
    __syncthreads();
    if (!live) return;
    Stat sv[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) sv[k] = st[L.col + k];
    float* ys = a.out + r0 * a.n + c0 + L.col;
    for (int r = L.i0; r < nr; r += L.rpi) {
        const T v = *reinterpret_cast<const T*>(tile + r * a.cw + L.col);
        T y;
#pragma unroll
        for (int k = 0; k < VEC; ++k)
            Vec<VEC>::set(y, k, norm1(Vec<VEC>::get(v, k), sv[k], a));
        *reinterpret_cast<T*>(ys + (long long)r * a.n) = y;
    }
}

// two-pass route, pass 1: grid (column groups, chunks)
template <int VEC>
__global__ void __launch_bounds__(UBN_BT, 4) ubn_batch_part(BatchArgs a) {
    using T = typename Vec<VEC>::T;
    __shared__ double red[UBN_BW][UBN_MAXCW][2];
    __shared__ int last;
    const int grp = blockIdx.x, chunk = blockIdx.y;
    const int c0 = grp * a.cw, cw = min(a.cw, a.n - c0);
    const long long r0 = (long long)chunk * a.rows;
    const int nr = (int)min(a.m - r0, a.rows);
    const Lanes L(a.cw, VEC);
    double s[VEC], ss[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) { s[k] = 0.0; ss[k] = 0.0; }
    if (L.col < cw) {
        const long long step = (long long)L.rpi * a.n;
        const float* xp = a.x + (r0 + L.i0) * a.n + c0 + L.col;
        int r = L.i0;
        for (; r + 3 * L.rpi < nr; r += 4 * L.rpi, xp += 4 * step) {
            T v[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) v[u] = ldx<VEC>(xp + u * step);
#pragma unroll
            for (int u = 0; u < 4; ++u) add_row<VEC>(s, ss, v[u]);
        }
        for (; r < nr; r += L.rpi, xp += step)
            add_row<VEC>(s, ss, ldx<VEC>(xp));
    }
    double ts, tss;
    block_sums<VEC>(s, ss, L.tpr, cw, red, ts, tss);
    const int t = threadIdx.x;
    if (t < cw) {
        double* p = a.part + (long long)chunk * 2 * a.n + c0 + t;
        p[0] = ts;
        p[a.n] = tss;
    }
    __threadfence();
    __syncthreads();
    if (t == 0) last = atomicAdd(a.count + grp, 1) == a.chunks - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    // the group's statistics: thread (column fc, run q) adds the q-th run of
    // consecutive chunks in order, UBN_FOLD_LOADS loads issued together;
    // then the eight runs in order
    const int fc = t % UBN_MAXCW, q = t / UBN_MAXCW;
    const int per = (a.chunks + UBN_FOLD - 1) / UBN_FOLD;
    const int k0 = q * per, k1 = min(a.chunks, k0 + per);
    double us = 0.0, uss = 0.0;
    if (fc < cw) {
        const double* p = a.part + c0 + fc;
        for (int kb = k0; kb < k1; kb += UBN_FOLD_LOADS) {
            double v0[UBN_FOLD_LOADS], v1[UBN_FOLD_LOADS];
#pragma unroll
            for (int u = 0; u < UBN_FOLD_LOADS; ++u)
                if (kb + u < k1) {
                    v0[u] = __ldcg(p + (long long)(kb + u) * 2 * a.n);
                    v1[u] = __ldcg(p + (long long)(kb + u) * 2 * a.n + a.n);
                }
#pragma unroll
            for (int u = 0; u < UBN_FOLD_LOADS; ++u)
                if (kb + u < k1) {
                    us = __dadd_rn(us, v0[u]);
                    uss = __dadd_rn(uss, v1[u]);
                }
        }
    }
    red[q][fc][0] = us;          // block_sums' last reads of red are done
    red[q][fc][1] = uss;         // (two barriers since)
    __syncthreads();
    if (t < cw) {
        double gs = 0.0, gss = 0.0;
        for (int k = 0; k < UBN_FOLD; ++k) {
            gs = __dadd_rn(gs, red[k][t][0]);
            gss = __dadd_rn(gss, red[k][t][1]);
        }
        const Stat r = col_stat(a, c0 + t, gs, gss);
        float* st = a.stats + c0 + t;
        st[0] = r.mu_q;
        st[a.n] = r.den;
        st[2 * a.n] = r.g;
        st[3 * a.n] = r.b;
    }
    if (t == 0) a.count[grp] = 0;
}

// two-pass route, pass 2: grid (column groups, spans); block y takes span
// spans - 1 - y and walks its rows from the last
template <int VEC>
__global__ void __launch_bounds__(UBN_BT, 4) ubn_batch_norm(BatchArgs a) {
    using T = typename Vec<VEC>::T;
    const int grp = blockIdx.x;
    const long long sp = (long long)gridDim.y - 1 - blockIdx.y;
    const int c0 = grp * a.cw, cw = min(a.cw, a.n - c0);
    const Lanes L(a.cw, VEC);
    if (L.col >= cw) return;
    Stat sv[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
        const float* st = a.stats + c0 + L.col + k;
        sv[k] = Stat{st[0], st[a.n], st[2 * a.n], st[3 * a.n]};
    }
    const long long r0 = sp * a.span;
    const int nr = (int)min(a.m - r0, a.span);
    const long long step = (long long)L.rpi * a.n;
    int r = nr - 1 - L.i0;
    const long long at = (r0 + r) * a.n + c0 + L.col;
    const float* xp = a.x + at;
    float* yp = a.out + at;
    for (; r - 3 * L.rpi >= 0; r -= 4 * L.rpi, xp -= 4 * step,
                               yp -= 4 * step) {
        T v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) v[u] = ldx<VEC>(xp - u * step);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            T y;
#pragma unroll
            for (int k = 0; k < VEC; ++k)
                Vec<VEC>::set(y, k, norm1(Vec<VEC>::get(v[u], k), sv[k], a));
            __stcs(reinterpret_cast<T*>(yp - u * step), y);
        }
    }
    for (; r >= 0; r -= L.rpi, xp -= step, yp -= step) {
        const T v = ldx<VEC>(xp);
        T y;
#pragma unroll
        for (int k = 0; k < VEC; ++k)
            Vec<VEC>::set(y, k, norm1(Vec<VEC>::get(v, k), sv[k], a));
        __stcs(reinterpret_cast<T*>(yp), y);
    }
}

template <int VEC>
static cudaError_t batch_route(const BatchArgs& a, int route,
                               cudaStream_t st) {
    const int groups = (a.n + a.cw - 1) / a.cw;
    if (route == 0) {
        static bool sized = false;     // once per instantiation
        if (!sized) {
            cudaError_t e = cudaFuncSetAttribute(
                ubn_batch_strip<VEC>,
                cudaFuncAttributeMaxDynamicSharedMemorySize, UBN_STRIP_SMEM);
            if (e != cudaSuccess) return e;
            sized = true;
        }
        cudaLaunchConfig_t cfg = {};
        cfg.gridDim = dim3((unsigned)(groups * a.cl));
        cfg.blockDim = dim3(UBN_BT);
        cfg.dynamicSmemBytes = UBN_STRIP_HEAD + (size_t)a.rows * a.cw * 4;
        cfg.stream = st;
        cudaLaunchAttribute attr[1];
        attr[0].id = cudaLaunchAttributeClusterDimension;
        attr[0].val.clusterDim.x = a.cl;
        attr[0].val.clusterDim.y = 1;
        attr[0].val.clusterDim.z = 1;
        cfg.attrs = attr;
        cfg.numAttrs = a.cl > 1 ? 1 : 0;
        return cudaLaunchKernelEx(&cfg, ubn_batch_strip<VEC>, a);
    }
    ubn_batch_part<VEC><<<dim3(groups, a.chunks), UBN_BT, 0, st>>>(a);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    const long long spans = (a.m + a.span - 1) / a.span;
    ubn_batch_norm<VEC><<<dim3(groups, (unsigned)spans), UBN_BT, 0, st>>>(a);
    return cudaGetLastError();
}

// route 0 strip (cw, cl, rows), 1 two-pass (cw, rows = chunk rows, chunks,
// span; work = chunks * 2 * n doubles then 4 * n floats; count: one int per
// column group, all 0, left at 0).  vec 4 needs n % 4 == 0 and x and out
// 16-byte aligned (kernels/ops.py ubn_batch_plan and ubn_norm).
extern "C" int ubn_batch_launch(const void* x, const void* gamma,
                                const void* beta, void* out, void* work,
                                void* count, long long m, int n, int route,
                                int vec, int cw, int cl, long long rows,
                                int chunks, long long span, float s_mu,
                                float s_sigma, float s_bn, float s_gamma,
                                float s_beta, float eps, void* stream) {
    if (m <= 0 || n <= 0) return 0;
    const bool ok = (cw == 16 || cw == 32) && (vec == 1 || vec == 4)
        && (route == 0
            ? ((cl == 1 || cl == 2 || cl == 4) && rows * cl >= m
               && UBN_STRIP_HEAD + rows * cw * 4 <= UBN_STRIP_SMEM)
            : (route == 1 && chunks > 0 && chunks <= UBN_FOLD * UBN_FOLD_RUN
               && rows * chunks >= m && span > 0
               && (m + span - 1) / span <= UBN_SPAN_MAX));
    if (!ok) return (int)cudaErrorInvalidValue;
    BatchArgs a;
    a.x = (const float*)x; a.gamma = (const float*)gamma;
    a.beta = (const float*)beta; a.out = (float*)out;
    a.part = (double*)work;
    a.stats = route == 1 ? (float*)(a.part + (long long)chunks * 2 * n)
                         : nullptr;
    a.count = (int*)count;
    a.m = m; a.rows = rows; a.span = span;
    a.n = n; a.cw = cw; a.cl = route == 0 ? cl : 1; a.chunks = chunks;
    a.s_mu = s_mu; a.s_sigma = s_sigma; a.s_bn = s_bn;
    a.s_gamma = s_gamma; a.s_beta = s_beta; a.eps = eps;
    a.inv_bn = 1.0f / s_bn;
    cudaStream_t st = (cudaStream_t)stream;
    const cudaError_t e = vec == 4 ? batch_route<4>(a, route, st)
                                   : batch_route<1>(a, route, st);
    return (int)e;
}
