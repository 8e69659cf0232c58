// K9b: the backward of the Mamba1 selective scan (K9).  With g_t the
// gradient of h_t, from t = S-1 down to 0:
//   g_t  = a_{t+1} * g_{t+1} + dy_t (x) c_t      (the carry starts at dh_last)
//   db_t = g_t,  da_t = g_t * h_{t-1},  dh0 = a_0 * g_0,
//   dc_t[n] = sum_d dy_t[d] * h_t[d, n].
//
// Replaces no TPU kernel: the reference trains the SSM by autodiff of its
// XLA associative scan (repro/models/ssm.py _sscan_chunked).  The port runs
// every recurrence through K9, so the gradient of K9 is this kernel; its
// plain version is kernels/ref.py selective_scan_bwd, which it matches bit
// for bit.
//
// Bound: bytes.  da and db are written once and a and b must be read at
// least once: 16N bytes per (t, d) (at 1 x 4096 x 8192 x 16, 8.6 GB).
// This kernel reads a and b twice (12.9 GB), since h_{t-1} is needed in
// reverse order and is not kept.
// Design:
//   * The forward's h is recomputed, with its two roundings a step
//     (__fmul_rn then __fadd_rn, and -fmad=false), so da uses the exact
//     bits of K9's h.  Phase 1 runs the forward over the whole sequence
//     and leaves the state before every chunk of SB_CHUNK steps in da's
//     first step of that chunk (the thread that reads it back is the one
//     that later overwrites it, so no other buffer holds the 2 GB of h).
//   * Phase 2 walks the chunks backwards: from the checkpoint, recompute
//     the chunk's h into shared memory (beside a, dy and c), then run the
//     reverse recurrence over the chunk.  The next chunk's a, b, dy, c
//     and checkpoint are loaded into registers before the reverse
//     recurrence starts, so their latency hides behind it (a block holds
//     too few threads to hide it otherwise: 2 blocks of 128 an SM at
//     B = 1, D = 8192).
//   * Threads as in K9: a channel's N states over N / 4 threads, a float4
//     each; a 128-thread block takes 512 / N channels of one batch row.
//   * dc sums over every channel, across blocks.  No atomics: each warp
//     folds its channels' float64 products (exact) in channel order by
//     shuffles, the block adds its four warps' sums in order and writes
//     the partial; a second kernel adds the blocks' partials in block
//     order and rounds once to fp32 (the order ref.selective_scan_bwd
//     states, padded channels giving +0 products).  So dc is the same
//     bits on every run.
//   * bf16 carriers (sscan_bwd_bf16_launch, QConfig.scan_dtype "bf16"):
//     every operand and output is bf16 and widens exactly to fp32 on load;
//     the arithmetic is the fp32 route's, and da, db, dh0 (fp32 -> bf16)
//     and dc (float64 -> fp32 -> bf16) round once more, to nearest even,
//     on the store.  A bf16 slot of da cannot hold the fp32 state, so the
//     checkpoints go to a (B, ceil(S / 8), D, N) fp32 buffer of their own
//     (268 MB at 1 x 4096 x 8192 x 16).  Bound: half the fp32 bytes.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "scan.cuh"

#define SB_THREADS 128
#define SB_CHUNK 8                  // steps recomputed from one checkpoint
#define SB_WARPS (SB_THREADS / 32)

template <typename T>
struct BwdArgs {
    const T* a;
    const T* b;
    const T* c;
    const T* h0;           // or null: zeros
    const T* dy;
    const T* dh_last;      // or null: zeros
    T* da;
    T* db;
    double* part;          // (B, S, tiles, N)
    T* dh0;                // or null
    float* ck;             // bf16: (B, chunks, D, N) checkpoints; fp32: null
    int B, S, D;
};

__device__ __forceinline__ void get4(float (&v)[4], const float4& x) {
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}

// grid (tiles, B); thread (channel ch, quarter g) holds states 4g .. 4g+3
// of channel d = tile * CH + ch of batch row blockIdx.y
template <int N, typename T>
__global__ void __launch_bounds__(SB_THREADS) sscan_bwd(BwdArgs<T> s) {
    using Raw = typename Vec4<T>::raw;
    constexpr int G = N / 4, CH = SB_THREADS / G, W = 32 / G;
    __shared__ float4 a_s[SB_CHUNK][SB_THREADS];
    __shared__ float4 h_s[SB_CHUNK][SB_THREADS];
    __shared__ float dy_s[SB_CHUNK][CH];
    __shared__ __align__(16) float c_s[SB_CHUNK][N];
    __shared__ double w_s[SB_CHUNK][SB_WARPS][N];
    const int tid = threadIdx.x, g = tid % G, ch = tid / G;
    const int lane = tid % 32, warp = tid / 32;
    const int d = blockIdx.x * CH + ch;
    const bool live = d < s.D;
    const long long bi = blockIdx.y;
    const int chunks = (s.S + SB_CHUNK - 1) / SB_CHUNK;
    // element (t, d, 4g) of a (B, S, D, N) tensor
    auto at = [&](int t) { return ((bi * s.S + t) * s.D + d) * N + 4 * g; };
    const long long hat = (bi * s.D + d) * N + 4 * g;
    // the fp32 state before chunk k: in da's first step of the chunk (fp32)
    // or in the checkpoint buffer (bf16)
    auto ckpt = [&](int k) -> float* {
        if constexpr (std::is_same<T, float>::value)
            return s.da + at(k * SB_CHUNK);
        else
            return s.ck + ((bi * chunks + k) * s.D + d) * N + 4 * g;
    };

    // phase 1: the forward, leaving each chunk's starting state
    float h[4] = {0.f, 0.f, 0.f, 0.f};
    if (live && s.h0) get4(h, f4(ldg_raw(s.h0 + hat)));
    for (int k = 0; k < chunks; ++k) {
        const int t0 = k * SB_CHUNK, nt = min(SB_CHUNK, s.S - t0);
        if (live) st4(ckpt(k), h);
        Raw av[SB_CHUNK], bv[SB_CHUNK];
#pragma unroll
        for (int u = 0; u < SB_CHUNK; ++u)
            if (live && u < nt) {
                av[u] = ldg_raw(s.a + at(t0 + u));
                bv[u] = ldg_raw(s.b + at(t0 + u));
            }
#pragma unroll
        for (int u = 0; u < SB_CHUNK; ++u)
            if (live && u < nt) {
                float a4[4], b4[4];
                get4(a4, f4(av[u]));
                get4(b4, f4(bv[u]));
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    h[j] = __fadd_rn(__fmul_rn(a4[j], h[j]), b4[j]);
            }
    }

    // phase 2: the chunks in reverse
    float carry[4] = {0.f, 0.f, 0.f, 0.f};
    if (live && s.dh_last) get4(carry, f4(ldg_raw(s.dh_last + hat)));
    const int tiles = gridDim.x;
    // chunk k's operands, loaded into registers one chunk ahead: a, b, the
    // checkpoint h_{t0-1}, dy (on each channel's first thread) and c (on
    // channel 0's threads)
    Raw av[SB_CHUNK], bv[SB_CHUNK], cv[SB_CHUNK];
    float4 ck;
    float dyr[SB_CHUNK];
    auto fetch = [&](int k) {
        const int t0 = k * SB_CHUNK, nt = min(SB_CHUNK, s.S - t0);
        ck = make_float4(0.f, 0.f, 0.f, 0.f);
        if (live) ck = ld4(ckpt(k));
#pragma unroll
        for (int u = 0; u < SB_CHUNK; ++u) {
            av[u] = Raw{};
            bv[u] = av[u];
            cv[u] = av[u];
            dyr[u] = 0.f;
            if (u < nt) {
                const long long bt = bi * s.S + t0 + u;
                if (live) {
                    av[u] = ldg_raw(s.a + at(t0 + u));
                    bv[u] = ldg_raw(s.b + at(t0 + u));
                    if (g == 0) dyr[u] = get1(s.dy[bt * s.D + d]);
                }
                if (ch == 0) cv[u] = ldg_raw(s.c + bt * N + 4 * g);
            }
        }
    };
    if (chunks > 0) fetch(chunks - 1);
    for (int k = chunks - 1; k >= 0; --k) {
        const int t0 = k * SB_CHUNK, nt = min(SB_CHUNK, s.S - t0);
        float hp0[4];                            // h_{t0-1}
        get4(hp0, ck);
        float hr[4] = {hp0[0], hp0[1], hp0[2], hp0[3]};
#pragma unroll
        for (int u = 0; u < SB_CHUNK; ++u)
            if (u < nt) {
                const float4 af = f4(av[u]);
                float a4[4], b4[4];
                get4(a4, af);
                get4(b4, f4(bv[u]));
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    hr[j] = __fadd_rn(__fmul_rn(a4[j], hr[j]), b4[j]);
                a_s[u][tid] = af;
                h_s[u][tid] = make_float4(hr[0], hr[1], hr[2], hr[3]);
                if (g == 0) dy_s[u][ch] = dyr[u];
                if (ch == 0)
                    *reinterpret_cast<float4*>(&c_s[u][4 * g]) = f4(cv[u]);
            }
        if (k > 0) fetch(k - 1);                 // in flight meanwhile
        __syncthreads();
        for (int u = nt - 1; u >= 0; --u) {
            const float dyv = dy_s[u][ch];
            float c4[4], a4[4], h4[4], hp[4], gk[4], dav[4];
            get4(c4, *reinterpret_cast<const float4*>(&c_s[u][4 * g]));
            get4(a4, a_s[u][tid]);
            get4(h4, h_s[u][tid]);
            if (u > 0) {
                get4(hp, h_s[u - 1][tid]);
            } else {
#pragma unroll
                for (int j = 0; j < 4; ++j) hp[j] = hp0[j];
            }
            double p[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                gk[j] = __fadd_rn(carry[j], __fmul_rn(dyv, c4[j]));
                dav[j] = __fmul_rn(gk[j], hp[j]);
                carry[j] = __fmul_rn(a4[j], gk[j]);
                p[j] = __dmul_rn((double)dyv, (double)h4[j]);
            }
            if (live) {
                st4(s.db + at(t0 + u), gk);
                st4(s.da + at(t0 + u), dav);
            }
            // this warp's channels in channel order: channel j's quarter g
            // sits on lane j * G + g
            double acc[4];
#pragma unroll
            for (int j = 0; j < 4; ++j)
                acc[j] = __shfl_sync(0xffffffffu, p[j], g);
#pragma unroll
            for (int m = 1; m < W; ++m)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    acc[j] = __dadd_rn(acc[j], __shfl_sync(
                        0xffffffffu, p[j], m * G + g));
            if (lane < G)
#pragma unroll
                for (int j = 0; j < 4; ++j) w_s[u][warp][4 * g + j] = acc[j];
        }
        __syncthreads();
        // the block's partial: its warps' sums in order
        for (int i = tid; i < nt * N; i += SB_THREADS) {
            const int u = i / N, n = i % N;
            double v = w_s[u][0][n];
#pragma unroll
            for (int w = 1; w < SB_WARPS; ++w) v = __dadd_rn(v, w_s[u][w][n]);
            s.part[((bi * s.S + t0 + u) * tiles + blockIdx.x) * N + n] = v;
        }
        __syncthreads();            // before the next chunk rewrites smem
    }
    if (live && s.dh0) st4(s.dh0 + hat, carry);
}

// dc[r, n] = the tiles' partials of row r = (b, t) added in tile order,
// rounded once to fp32 (then once to bf16 for bf16 carriers)
template <typename T>
__global__ void sscan_bwd_dc(const double* part, T* dc, long long total,
                             int tiles, int N) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= total) return;
    const long long r = i / N;
    const int n = (int)(i % N);
    const double* p = part + r * tiles * N + n;
    double v = p[0];
    for (int k = 1; k < tiles; ++k) v = __dadd_rn(v, p[(long long)k * N]);
    put1(dc + i, __double2float_rn(v));
}

template <int N, typename T>
static cudaError_t launch(const BwdArgs<T>& s, T* dc, cudaStream_t st) {
    constexpr int CH = SB_THREADS / (N / 4);
    const int tiles = (s.D + CH - 1) / CH;
    sscan_bwd<N, T><<<dim3(tiles, s.B), SB_THREADS, 0, st>>>(s);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    const long long total = (long long)s.B * s.S * N;
    if (total == 0) return cudaSuccess;
    const int th = 256;
    sscan_bwd_dc<T><<<(unsigned)((total + th - 1) / th), th, 0, st>>>(
        s.part, dc, total, tiles, N);
    return cudaGetLastError();
}

template <typename T>
static int checked_launch(const BwdArgs<T>& s, T* dc, int N,
                          cudaStream_t stream) {
    if (s.B <= 0 || s.D <= 0 || s.S < 0 || s.B > 65535
        || (N != 4 && N != 16))
        return (int)cudaErrorInvalidValue;
    return (int)(N == 4 ? launch<4, T>(s, dc, stream)
                        : launch<16, T>(s, dc, stream));
}

// a, b (B, S, D, N), c (B, S, N), h0 (B, D, N) or null, dy (B, S, D),
// dh_last (B, D, N) or null; outputs da, db (B, S, D, N), dc (B, S, N),
// dh0 (B, D, N) or null; part the (B, S, ceil(D / (512 / N)), N) float64
// workspace.  All contiguous; a, b, c, h0, dh_last, da, db and dh0 16-byte
// aligned.  N is 4 or 16.
extern "C" int sscan_bwd_launch(const float* a, const float* b,
                                const float* c, const float* h0,
                                const float* dy, const float* dh_last,
                                float* da, float* db, double* part, float* dc,
                                float* dh0, int B, int S, int D, int N,
                                cudaStream_t stream) {
    const BwdArgs<float> s{a, b, c, h0, dy, dh_last, da, db, part, dh0,
                           nullptr, B, S, D};
    return checked_launch(s, dc, N, stream);
}

// the same with bf16 carriers (every operand and output bf16; 8-byte
// aligned) and ck, the (B, ceil(S / 8), D, N) fp32 checkpoint buffer
extern "C" int sscan_bwd_bf16_launch(
        const __nv_bfloat16* a, const __nv_bfloat16* b,
        const __nv_bfloat16* c, const __nv_bfloat16* h0,
        const __nv_bfloat16* dy, const __nv_bfloat16* dh_last,
        __nv_bfloat16* da, __nv_bfloat16* db, double* part,
        __nv_bfloat16* dc, __nv_bfloat16* dh0, float* ck, int B, int S,
        int D, int N, cudaStream_t stream) {
    if (ck == nullptr) return (int)cudaErrorInvalidValue;
    const BwdArgs<__nv_bfloat16> s{a, b, c, h0, dy, dh_last, da, db, part,
                                   dh0, ck, B, S, D};
    return checked_launch(s, dc, N, stream);
}
