// K9: the Mamba1 selective scan, h_t = a_t * h_{t-1} + b_t and
// y_t = sum_n c_t[n] * h_t[n], with a carried state in and out.
//
// Replaces repro/kernels/selective_scan.py::selective_scan (_ssm_kernel).
// The TPU kernel keeps a (bd, N) block of states in VMEM scratch across a
// sequential seq grid; it starts from zero state and returns y only.  Here
// every recurrence of the SSM path (train, chunk and decode modes) comes
// through this one kernel, so it also takes the carried state h0 (or none:
// zeros, which is exactly the TPU kernel's function) and returns h_last.
//
// Bound: bytes.  a and b are (B, S, D, N) fp32 and read once, c (B, S, N)
// once, y (B, S, D) written once, h0 read and h_last written once: 8N + 4
// bytes per (t, d) for some 4N flops.  The recurrence is sequential in t
// and a channel's N states are independent of every other channel's.
// Design:
//   * A channel's N states are split over N / 4 threads, a float4 each
//     (4 threads at N = 16, one at N = 4), so a prefill page at B = 1
//     (D = 8192) runs 32768 threads; a 128-thread block takes 128 / (N / 4)
//     channels of one batch row.
//   * y_t: each thread forms its four products h[n] * c[n] (exact in
//     float64); the channel's first thread receives the other threads'
//     products by warp shuffles and adds all N in n order, one rounding to
//     fp32 at the end: the plain version's order, bit for bit.
//   * staged route (S > 1): a, b and c do not depend on h, so a tile of
//     `tile` steps of the block's channels is copied into shared memory
//     with cp.async.bulk (one copy per step and operand: a block's channels
//     of a step are contiguous in (B, S, D, N)), completing on an mbarrier,
//     in a ring of `stages` tiles, before the recurrence reads it.  A page
//     of 16 steps is one tile: one memory latency, then arithmetic; a long
//     S keeps up to `stages` tiles in flight.
//   * direct route (S <= 1, a decode step): one step is pure bytes; each
//     thread loads its float4s of a, b, c and h0 and stores h_last.
// kernels/ops.py sscan_plan picks the route, tile and stages from the
// shape and the SM count.
//
// Numerics (the plain version in kernels/ref.py matches them bit for bit):
// h = a * h rounded, then + b rounded (explicit __fmul_rn / __fadd_rn, and
// the build uses -fmad=false); y_t is the float64 sum of the products
// h[n] * c[n] in n order, rounded once to fp32.  No atomics: the result is
// deterministic.
//
// bf16 carriers (QConfig.scan_dtype "bf16", sscan_bf16_launch): a, b, c and
// h0 are bf16 and widen exactly to fp32 on load, so the bulk tiles and the
// loads are half the bytes; h stays in fp32 registers and the arithmetic is
// the fp32 route's; y (float64 -> fp32 -> bf16) and h_last (fp32 -> bf16)
// round once more to nearest even on the store.  A 4-state channel's step
// is 8 bytes in bf16, narrower than a bulk copy's 16-byte granule, so bf16
// at N = 4 takes the direct route at every S (ops.sscan_plan).
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "scan.cuh"

#define SS_THREADS 128
#define SS_MAX_STAGES 8
#define SS_HEAD 64                  // shared bytes for the stages' mbarriers
#define SS_SMEM (227 * 1024)

template <typename T>
struct ScanArgs {
    const T* a;
    const T* b;
    const T* c;
    const T* h0;
    T* y;
    T* h_last;
    int B, S, D, tile, stages;
};

// one step of the four states this thread holds, then the channel's y_t on
// its first thread (the value on the other threads is not used).  Every
// lane of the warp runs the shuffles.
template <int N>
__device__ __forceinline__ double scan_step(float (&h)[4], const float4& av,
                                            const float4& bv,
                                            const float4& cv) {
    constexpr int G = N / 4;
    const float a4[4] = {av.x, av.y, av.z, av.w};
    const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
    const float c4[4] = {cv.x, cv.y, cv.z, cv.w};
    double p[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        h[k] = __fadd_rn(__fmul_rn(a4[k], h[k]), b4[k]);
        p[k] = __dmul_rn((double)h[k], (double)c4[k]);
    }
    double acc = p[0];
#pragma unroll
    for (int k = 1; k < 4; ++k) acc = __dadd_rn(acc, p[k]);
    if (G > 1) {
        const int base = (threadIdx.x & 31) & ~(G - 1);
#pragma unroll
        for (int j = 1; j < G; ++j)
#pragma unroll
            for (int k = 0; k < 4; ++k)
                acc = __dadd_rn(acc, __shfl_sync(0xffffffffu, p[k],
                                                 base + j));
    }
    return acc;
}

template <typename T>
__device__ __forceinline__ void load_h(float (&h)[4], const T* h0,
                                       long long at, bool live) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (live && h0) v = f4(ldg_raw(h0 + at));
    h[0] = v.x; h[1] = v.y; h[2] = v.z; h[3] = v.w;
}

// grid (ceil(D / CH), B); thread (channel d, quarter g) holds states
// 4g .. 4g + 3 of (b, d)
template <int N, typename T>
__global__ void __launch_bounds__(SS_THREADS) sscan_direct(ScanArgs<T> s) {
    constexpr int G = N / 4, CH = SS_THREADS / G;
    const int g = threadIdx.x % G;
    const int d = blockIdx.x * CH + threadIdx.x / G;
    const long long bi = blockIdx.y;
    const bool live = d < s.D;
    const long long hat = (bi * s.D + d) * N + 4 * g;
    float h[4];
    load_h(h, s.h0, hat, live);
    for (int t = 0; t < s.S; ++t) {
        const long long bt = bi * s.S + t;
        float4 av = make_float4(0.f, 0.f, 0.f, 0.f), bv = av, cv = av;
        if (live) {
            const long long at = (bt * s.D + d) * N + 4 * g;
            av = f4(ldcs_raw(s.a + at));
            bv = f4(ldcs_raw(s.b + at));
            cv = f4(ldg_raw(s.c + bt * N + 4 * g));
        }
        const double acc = scan_step<N>(h, av, bv, cv);
        if (live && g == 0) put1(s.y + bt * s.D + d, (float)acc);
    }
    if (live) st4(s.h_last + hat, h);
}

// one stage of the ring: a [tile][CH][N], b [tile][CH][N], c [tile][N]
template <int N, typename T>
__device__ __forceinline__ T* stage_base(unsigned char* sm, int tile, int q) {
    constexpr int CH = SS_THREADS / (N / 4);
    return reinterpret_cast<T*>(
        sm + SS_HEAD + (size_t)q * tile * (2 * CH * N + N) * sizeof(T));
}

// thread 0: tile k of the block's channels [d0, d0 + nd) into its stage
template <int N, typename T>
__device__ __forceinline__ void issue_tile(const ScanArgs<T>& s,
                                           unsigned char* sm, uint64_t* bar,
                                           long long bi, int d0, int nd,
                                           int k) {
    constexpr int CH = SS_THREADS / (N / 4);
    constexpr uint32_t E = sizeof(T);
    const int q = k % s.stages, t0 = k * s.tile;
    const int nt = min(s.tile, s.S - t0);
    T* as = stage_base<N, T>(sm, s.tile, q);
    T* bs = as + s.tile * CH * N;
    T* cs = bs + s.tile * CH * N;
    const uint32_t row = (uint32_t)nd * N * E;
    mbar_expect_tx(&bar[q], (uint32_t)nt * (2 * row + N * E));
    for (int u = 0; u < nt; ++u) {
        const long long off = ((bi * s.S + t0 + u) * s.D + d0) * N;
        bulk_g2s(as + u * CH * N, s.a + off, row, &bar[q]);
        bulk_g2s(bs + u * CH * N, s.b + off, row, &bar[q]);
    }
    bulk_g2s(cs, s.c + (bi * s.S + t0) * N, (uint32_t)nt * N * E, &bar[q]);
}

template <int N, typename T>
__global__ void __launch_bounds__(SS_THREADS) sscan_staged(ScanArgs<T> s) {
    constexpr int G = N / 4, CH = SS_THREADS / G;
    extern __shared__ __align__(128) unsigned char sm[];
    uint64_t* bar = reinterpret_cast<uint64_t*>(sm);
    const int g = threadIdx.x % G, ch = threadIdx.x / G;
    const int d0 = blockIdx.x * CH, d = d0 + ch;
    const int nd = min(CH, s.D - d0);
    const long long bi = blockIdx.y;
    const bool live = d < s.D;
    const int tiles = (s.S + s.tile - 1) / s.tile;
    if (threadIdx.x == 0) {
        for (int q = 0; q < s.stages; ++q) mbar_init(&bar[q], 1);
        mbar_fence_init();
    }
    __syncthreads();
    if (threadIdx.x == 0)
        for (int k = 0; k < min(s.stages, tiles); ++k)
            issue_tile<N, T>(s, sm, bar, bi, d0, nd, k);
    const long long hat = (bi * s.D + d) * N + 4 * g;
    float h[4];
    load_h(h, s.h0, hat, live);
    for (int k = 0; k < tiles; ++k) {
        const int q = k % s.stages, t0 = k * s.tile;
        const int nt = min(s.tile, s.S - t0);
        mbar_wait(&bar[q], (uint32_t)(k / s.stages) & 1);
        const T* as = stage_base<N, T>(sm, s.tile, q);
        const T* bs = as + s.tile * CH * N;
        const T* cs = bs + s.tile * CH * N;
        for (int u = 0; u < nt; ++u) {
            const int e = (u * CH + ch) * N + 4 * g;
            const double acc = scan_step<N>(h, ld4(as + e), ld4(bs + e),
                                            ld4(cs + u * N + 4 * g));
            if (live && g == 0)
                put1(s.y + (bi * s.S + t0 + u) * s.D + d, (float)acc);
        }
        __syncthreads();                        // stage q read by all
        if (threadIdx.x == 0 && k + s.stages < tiles)
            issue_tile<N, T>(s, sm, bar, bi, d0, nd, k + s.stages);
    }
    if (live) st4(s.h_last + hat, h);
}

template <int N, typename T>
static cudaError_t launch(const ScanArgs<T>& s, int route, cudaStream_t st) {
    constexpr int CH = SS_THREADS / (N / 4);
    const dim3 grid((s.D + CH - 1) / CH, s.B);
    if (route == 0) {
        sscan_direct<N, T><<<grid, SS_THREADS, 0, st>>>(s);
        return cudaGetLastError();
    }
    static bool sized = false;          // once per instantiation
    if (!sized) {
        const cudaError_t e = cudaFuncSetAttribute(
            sscan_staged<N, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            SS_SMEM);
        if (e != cudaSuccess) return e;
        sized = true;
    }
    const size_t smem = SS_HEAD + (size_t)s.stages * s.tile
                        * (2 * CH * N + N) * sizeof(T);
    sscan_staged<N, T><<<grid, SS_THREADS, smem, st>>>(s);
    return cudaGetLastError();
}

template <typename T>
static int checked_launch(const ScanArgs<T>& s, int N, int route,
                          cudaStream_t stream) {
    if (s.B <= 0 || s.D <= 0 || s.S < 0 || s.B > 65535
        || (N != 4 && N != 16))
        return (int)cudaErrorInvalidValue;
    // a staged step row of a block is nd * N elements: the bulk copies need
    // whole 16-byte granules, so 4 states of bf16 (8 bytes) go direct
    if (route == 1 && (s.tile <= 0 || s.stages <= 0
                       || s.stages > SS_MAX_STAGES || N * sizeof(T) < 16
                       || SS_HEAD + (long long)s.stages * s.tile
                          * (2 * SS_THREADS * 4 + N) * sizeof(T) > SS_SMEM))
        return (int)cudaErrorInvalidValue;
    if (route != 0 && route != 1) return (int)cudaErrorInvalidValue;
    return (int)(N == 4 ? launch<4, T>(s, route, stream)
                        : launch<16, T>(s, route, stream));
}

// a, b (B, S, D, N), c (B, S, N), h0 (B, D, N) or null, y (B, S, D),
// h_last (B, D, N); all fp32, contiguous; a, b, c, h0 and h_last 16-byte
// aligned.  N is 4 or 16.  route 0 direct, 1 staged (tile steps a stage,
// `stages` stages).
extern "C" int sscan_launch(const float* a, const float* b, const float* c,
                            const float* h0, float* y, float* h_last, int B,
                            int S, int D, int N, int route, int tile,
                            int stages, cudaStream_t stream) {
    const ScanArgs<float> s{a, b, c, h0, y, h_last, B, S, D, tile, stages};
    return checked_launch(s, N, route, stream);
}

// the same with bf16 carriers: every operand and output bf16, h fp32
// inside; route 1 only at N = 16
extern "C" int sscan_bf16_launch(const __nv_bfloat16* a,
                                 const __nv_bfloat16* b,
                                 const __nv_bfloat16* c,
                                 const __nv_bfloat16* h0, __nv_bfloat16* y,
                                 __nv_bfloat16* h_last, int B, int S, int D,
                                 int N, int route, int tile, int stages,
                                 cudaStream_t stream) {
    const ScanArgs<__nv_bfloat16> s{a, b, c, h0, y, h_last, B, S, D, tile,
                                    stages};
    return checked_launch(s, N, route, stream);
}
