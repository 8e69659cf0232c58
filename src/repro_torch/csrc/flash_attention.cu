// K5: tiled online-softmax attention on int8 payloads (training forward).
//
// Replaces repro/kernels/paged_attention.py::flash_attention (_flash_kernel
// and _tile_dots).  It is the attention forward of every layer of the
// training step and of the serving engine's monolithic prefill
// (chunked_attention's fused route); the backward is autograd of the plain
// chunked body, as in the reference.
//
// The TPU kernel holds a whole (B, q_chunk, heads) block per grid step, so
// it derives every per-chunk grid decomposition (q, k, v and the
// probabilities, each amax over the whole block) in-register.  A Hopper
// block holds 128 query rows of one (batch, KV head), so the block-wide
// scales come from reductions across blocks, in six launches
// (ops.flash_attention makes three fa_launch calls):
//   (a) fa_init zeroes the chunk statistics and finds the p-code
//       thresholds; fa_amax gathers each q, k and v chunk's largest
//       |payload| (atomicMax), which gives the chunk's grid step;
//   (b) fa_prep_q / fa_prep_kv: q, k and v regridded once onto their
//       chunks' steps;
//   (c) fa_kernel<stats>: each row's masked score maximum rowmax_j in each
//       kv chunk, its running max m_j, and per (q chunk, kv chunk) the
//       probability amax over the block, max round(exp(rowmax_j - m_j)
//       2^(k-1)) / 2^(k-1) (atomicMax), which gives the probability step
//       (the saturate-at-pow2-amax corner included);
//   (d) fa_kernel<main>: recompute the scores, p = exp(s - m_j) onto the
//       Q_A grid unnormalized, the int8 p payload, int32 p.v over the chunk,
//       and the rescale l = l * alpha + sum p, o = o * alpha + pv;
//       o / max(l, 1e-9).
// Every step matches the plain version (kernels/ref.py flash_attention)
// bit for bit: integer dots are exact, exp and the final division are taken
// in float64 and rounded once on both sides (p's codes from exact
// thresholds of that exp, below), the sums of quantized probabilities are
// exact (kept as integer code sums), and the build uses -fmad=false.  Any
// k_a from 2 to 8 is taken (ps = 2^(k_a-1) and lim = ps - 1 come in).
//
// Bound: operations (two int8 dots of S * T * H * dh each, plus an exp per
// score; causal: the half below the diagonal).  Design:
//   * fa_prep_q / fa_prep_kv write every operand once, regridded, as
//     tiles in the byte image wgmma reads (K-major, swizzled, zero
//     padded): Q as 128-row
//     tiles [row][d] (a row is one (position, query head) pair of the KV
//     group), K as 64-position tiles [t][d] (128B swizzle) and V transposed
//     as [d][t] (64B swizzle), since int8 wgmma takes both operands K-major
//     and p.v contracts over t.  Within each 32 positions V's columns are
//     permuted so that the s32 score accumulator's own bytes, packed in
//     place, are p's A fragment: no shuffle and no shared tile for p.  It
//     also records per 64-position tile the smallest valid key position,
//     the largest position and whether every key is valid.
//   * fa_kernel: 2 warpgroups of 64 rows (256 threads: a larger block
//     would cap a thread at 168 registers, and the main launch holds o,
//     the p.v accumulator and the scores, 160 of them at dh = 128).
//     Thread 0 copies the block's Q tile once and streams the K (and V)
//     tiles it visits, one cp.async.bulk each, into a 4-stage ring
//     completing on mbarriers, refilling a stage once all 8 warps have
//     released it; the warpgroups run q.k as wgmma m64n64k32 from shared
//     memory and p.v as wgmma m64n{DP}k32 with p from registers, DP = dh
//     rounded up to a multiple of 32 (dh 112 runs p.v at 128).
//   * dh is any multiple of 16 up to 128.  The operand passes zero every
//     16-byte column at or past dh, so q.k contracts over DP bytes of
//     which the padding adds nothing, and V^T's rows dh .. DP - 1 are zero,
//     so p.v's columns past dh are zero and are not stored.
//   * Tiles whose keys are masked for every row of the block (decided from
//     the block's largest q position and the tile's smallest valid key
//     position, so offset positions stay exact) are skipped: in the stats
//     launch always (a chunk with a skipped tile takes NEG_INF into its
//     maximum, which is what those scores were), in the main launch only
//     where every row of the block already has a finite running max m_j:
//     there a masked score gives exp(NEG_INF - m_j) = 0 exactly, while a
//     row whose m_j is still NEG_INF gets p = 1 for masked keys, as the
//     plain version does.  Tiles with every key valid and wholly below
//     the diagonal skip the mask test.
//   * A prompt shorter than the kv chunk is one ragged chunk (T no
//     multiple of 64); ops.flash_attention pads it to the next multiple of
//     64 with zero payloads marked absent (kval -1).  Zeros change no
//     chunk's amax, an absent key's score is masked, and its p code is 0
//     even in a row whose m_j is still NEG_INF, so the result is the plain
//     version's at kv_chunk = T.
//   * p's code rint(exp(x) 2^(k_a-1)) (x = s - m_j) comes from a fast exp2
//     guess corrected against exact thresholds (pcode below): no float64
//     exp per score, and the same code as the float64 exp for every fp32
//     x <= 0, which fa_pcode_check verifies exhaustively on the card.  The
//     float64 exp stays for alpha, once per row and kv chunk.
#include "hopper.cuh"

#define NEG_INF_F (-1e9f)
#define QTILE 16384         // 128 rows x 128 bytes
#define KTILE 8192          // 64 positions x 128 bytes
#define VTILE 8192          // up to 128 d x 64 bytes
#define STAGES 4
#define NTHREADS 256        // 2 warpgroups; thread 0 also feeds the ring

enum { SKIP = 0, PART = 1, FULL = 2 };

struct FaArgs {
    const int8_t* q8;       // (B, S, H, dh)
    const int8_t* k8;       // (B, T, KV, dh)
    const int8_t* v8;       // (B, T, KV, dh)
    const int32_t* qpos;    // (S,)
    const int32_t* kpos;    // (T,)
    const int32_t* kval;    // (T,) 1 valid, 0 masked, -1 absent
    const float* scales;    // [q_scale, k_scale, v_scale]
    int* stat;              // chunk statistics, zeroed by fa_init: the
                            // largest |payload| of each q chunk (nq), k
                            // chunk (nk) and v chunk (nk), then the
                            // probability amax (nq, nk) as fp32 bits
    float* mrun;            // (B, S, H, nk) running max m (stats out)
    float* out;             // (B, S, H, dh)
    uint8_t* qr;            // (B, KV, nrb) Q tiles
    uint8_t* kr;            // (B, KV, nt) K tiles
    uint8_t* vt;            // (B, KV, nt) V^T tiles
    int4* tinfo;            // (nt,) [min valid kpos, max kpos, all valid, 0]
    float* pthr;            // (ps + 2,) p code thresholds (fa_thresholds)
    unsigned long long* visits;   // [stats, main] tiles visited, or null
    float sm_scale, ps, lim;
    int causal, B, S, T, H, KV, dh, qc, kc, nq, nk, nt, nrb;
};

__device__ __forceinline__ float exp32(float x) { return (float)exp((double)x); }

// The least power of two >= m, 1 for m <= 0 or NaN (ref._pow2_ceil)
__device__ __forceinline__ float pow2_ceil(float m) {
    if (!(m > 0.0f)) return 1.0f;
    int ex;
    const float mant = frexpf(m, &ex);
    if (mant == 0.5f) ex -= 1;
    ex = min(max(ex, -126), 127);
    return __int_as_float((ex + 127) << 23);
}

// The grid step of a block whose amax is m (ref.grid_decompose):
// max(pow2_ceil(m), 2^-24) * 2^(1-k_a), k_a = log2(ps) + 1; exact pow2s
__device__ __forceinline__ float grid_step(float m, float ps) {
    return __fmul_rn(fmaxf(pow2_ceil(m), 0x1p-24f), __fdiv_rn(1.0f, ps));
}

// the step of q chunk iq, k chunk j (seg 1) or v chunk j (seg 2)
__device__ __forceinline__ float chunk_step(const FaArgs& a, int seg, int c) {
    const int off = seg == 0 ? 0 : (seg == 1 ? a.nq : a.nq + a.nk);
    return grid_step(__fmul_rn((float)a.stat[off + c], a.scales[seg]),
                     a.ps);
}

// The p code of a score offset x = s - m_j <= 0, n = rint(exp32(x) * ps)
// (ps = 2^(k_a-1)), as the plain version computes it.
__device__ __forceinline__ int pcode_ref(float x, float ps) {
    return (int)rintf(__fmul_rn(exp32(x), ps));
}

// n(x) is monotone in x, so it is the count of thresholds X_1 <= ... <=
// X_ps at or below x, X_n the least float x <= 0 with pcode_ref(x) >= n.
// fa_thresholds finds each X_n by bisection over the float bit patterns
// with the same float64 exp; thr[0] = -inf and thr[ps + 1] = +inf.
__device__ __forceinline__ float neg_key_float(int k) {    // k <= 0
    return __uint_as_float(0x80000000u | (uint32_t)(-k));
}

__device__ void thresholds(float* thr, float ps) {
    const int ips = (int)ps;
    for (int n = threadIdx.x + 1; n <= ips; n += blockDim.x) {
        int lo = -0x7f800000, hi = 0;            // -inf: code 0; -0: ps
        while (hi - lo > 1) {
            const int mid = lo + (hi - lo) / 2;
            if (pcode_ref(neg_key_float(mid), ps) >= n) hi = mid;
            else lo = mid;
        }
        thr[n] = neg_key_float(hi);
    }
    if (threadIdx.x == 0) {
        thr[0] = -INFINITY;
        thr[ips + 1] = INFINITY;
    }
}

__global__ void fa_thresholds(float* thr, float ps) { thresholds(thr, ps); }

// one block: the p-code thresholds and the zeroed chunk statistics
__global__ void fa_init(FaArgs a) {
    thresholds(a.pthr, a.ps);
    const int n = a.nq + 2 * a.nk + a.nq * a.nk;
    for (int i = threadIdx.x; i < n; i += blockDim.x) a.stat[i] = 0;
}

#define AMAX_SPAN 65536     // payload bytes one fa_amax block reduces

// the largest |payload| of each q (blockIdx.z 0), k (1) and v (2) chunk:
// a chunk of batch b is one contiguous span of chunk x heads x dh bytes,
// which blocks reduce AMAX_SPAN bytes at a time into one atomicMax each
__global__ void __launch_bounds__(256) fa_amax(FaArgs a) {
    __shared__ int wmax[8];
    const int seg = blockIdx.z;
    const int L = seg == 0 ? a.S : a.T, chunk = seg == 0 ? a.qc : a.kc;
    const int nch = L / chunk;
    const long long rowb = (long long)(seg == 0 ? a.H : a.KV) * a.dh;
    const long long span = (long long)chunk * rowb;
    const long long lo = (long long)blockIdx.x * AMAX_SPAN;
    if ((int)blockIdx.y >= a.B * nch || lo >= span) return;
    const int b = blockIdx.y / nch, c = blockIdx.y % nch;
    const int8_t* x = (seg == 0 ? a.q8 : seg == 1 ? a.k8 : a.v8)
                      + ((long long)b * L + (long long)c * chunk) * rowb;
    const long long hi = min(span, lo + AMAX_SPAN);
    int m = 0;
    for (long long o = lo + 16 * threadIdx.x; o < hi; o += 16 * blockDim.x) {
        const int4 v = *reinterpret_cast<const int4*>(x + o);
        const int w4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int j = 0; j < 4; ++j)
                m = max(m, abs((int)(int8_t)(w4[q] >> (8 * j))));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
        m = max(m, __shfl_xor_sync(0xffffffffu, m, o));
    if ((threadIdx.x & 31) == 0) wmax[threadIdx.x >> 5] = m;
    __syncthreads();
    if (threadIdx.x == 0) {
        for (int w = 1; w < 8; ++w) m = max(m, wmax[w]);
        const int off = seg == 0 ? 0 : (seg == 1 ? a.nq : a.nq + a.nk);
        atomicMax(a.stat + off + c, m);
    }
}

// The kernel's p code: a fast exp2 guess, within one code of n(x) for the
// x that can round to a non-zero code (its relative error is some 2^-20),
// corrected by the two thresholds around it.  Equal to pcode_ref for every
// fp32 x <= 0 (fa_pcode_check sweeps them all on the card).
__device__ __forceinline__ int pcode(float x, float ps, int ips,
                                     const float* thr) {
    int n = (int)rintf(__fmul_rn(__expf(x), ps));
    n = min(n, ips);                     // __expf >= 0: n >= 0
    return n + (x >= thr[n + 1]) - (x < thr[n]);
}

// 4 payload bytes regridded: clip(rint(n * scale * inv), +-lim) each
__device__ __forceinline__ uint32_t regrid4(uint32_t w, float scale,
                                            float inv, float lim) {
    uint32_t o = 0u;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const float v = (float)(int8_t)(uint8_t)(w >> (8 * j));
        const float q = rintf(__fmul_rn(__fmul_rn(v, scale), inv));
        o |= (uint32_t)(uint8_t)(int8_t)(int)fminf(fmaxf(q, -lim), lim)
             << (8 * j);
    }
    return o;
}

// position (within 32) of the key whose p byte is column k of p's A
// fragment: the accumulator holds columns 8 i + 2 tg + e, and a thread
// packs blocks (i, i + 1) for k = 4 tg + j (j < 4) and (i + 2, i + 3) for
// k = 16 + 4 tg + j
__device__ __forceinline__ int vperm(int k) {
    const int j = k & 3;
    return 16 * (k >> 4) + 8 * (j >> 1) + 2 * ((k >> 2) & 3) + (j & 1);
}

// Q tiles: one block per (128-row tile, KV head, batch)
__global__ void __launch_bounds__(256) fa_prep_q(FaArgs a) {
    const int rb = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
    const int G = a.H / a.KV;
    const float qs = a.scales[0];
    uint8_t* tile = a.qr + (((long long)b * a.KV + kvh) * a.nrb + rb) * QTILE;
#pragma unroll
    for (int it = 0; it < 4; ++it) {
        const int u = threadIdx.x + it * 256, r = u >> 3, c = u & 7;
        const int R = rb * 128 + r;
        uint32_t w[4] = {0u, 0u, 0u, 0u};
        if (R < a.S * G && c * 16 < a.dh) {
            const int pos = R / G, head = kvh * G + R % G;
            const float inv = __fdiv_rn(1.0f, chunk_step(a, 0, pos / a.qc));
            const int4 v = *reinterpret_cast<const int4*>(
                a.q8 + (((long long)b * a.S + pos) * a.H + head) * a.dh
                + c * 16);
            w[0] = regrid4(v.x, qs, inv, a.lim);
            w[1] = regrid4(v.y, qs, inv, a.lim);
            w[2] = regrid4(v.z, qs, inv, a.lim);
            w[3] = regrid4(v.w, qs, inv, a.lim);
        }
        *reinterpret_cast<int4*>(tile + swz128(r, c * 16)) =
            make_int4((int)w[0], (int)w[1], (int)w[2], (int)w[3]);
    }
}

// K and V^T tiles and the tile mask summary: one block per (64-position
// tile, KV head, batch)
__global__ void __launch_bounds__(256) fa_prep_kv(FaArgs a) {
    __shared__ __align__(16) uint8_t Vs[64 * 144];          // [t][d]
    const int tt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
    const int t0 = tt * 64, j = t0 / a.kc;
    const float ks = a.scales[1], kinv = __fdiv_rn(1.0f, chunk_step(a, 1, j));
    const float vs = a.scales[2], vinv = __fdiv_rn(1.0f, chunk_step(a, 2, j));
    const long long tix = ((long long)b * a.KV + kvh) * a.nt + tt;
    uint8_t* kt = a.kr + tix * KTILE;
    uint8_t* vt = a.vt + tix * VTILE;
#pragma unroll
    for (int it = 0; it < 2; ++it) {
        const int u = threadIdx.x + it * 256, r = u >> 3, c = u & 7;
        uint32_t wk[4] = {0u, 0u, 0u, 0u};
        if (c * 16 < a.dh) {
            const long long off = (((long long)b * a.T + t0 + r) * a.KV + kvh)
                                  * a.dh + c * 16;
            const int4 k = *reinterpret_cast<const int4*>(a.k8 + off);
            const int4 v = *reinterpret_cast<const int4*>(a.v8 + off);
            wk[0] = regrid4(k.x, ks, kinv, a.lim);
            wk[1] = regrid4(k.y, ks, kinv, a.lim);
            wk[2] = regrid4(k.z, ks, kinv, a.lim);
            wk[3] = regrid4(k.w, ks, kinv, a.lim);
            *reinterpret_cast<int4*>(Vs + r * 144 + c * 16) = make_int4(
                (int)regrid4(v.x, vs, vinv, a.lim),
                (int)regrid4(v.y, vs, vinv, a.lim),
                (int)regrid4(v.z, vs, vinv, a.lim),
                (int)regrid4(v.w, vs, vinv, a.lim));
        }
        *reinterpret_cast<int4*>(kt + swz128(r, c * 16)) =
            make_int4((int)wk[0], (int)wk[1], (int)wk[2], (int)wk[3]);
    }
    __syncthreads();
    // V^T: row d, 64 columns in 4 chunks of 16, column k holding the key
    // 32 (k / 32) + vperm(k % 32)
    // (rows dh .. DP - 1 zero)
    const int dp = (a.dh + 31) & ~31;
    for (int u = threadIdx.x; u < dp * 4; u += 256) {
        const int d = u >> 2, c = u & 3;
        uint32_t w[4] = {0u, 0u, 0u, 0u};
        if (d < a.dh)
#pragma unroll
            for (int i = 0; i < 16; ++i) {
                const int k = c * 16 + i;
                const int t = (k & 32) + vperm(k & 31);
                w[i >> 2] |= (uint32_t)Vs[t * 144 + d] << (8 * (i & 3));
            }
        *reinterpret_cast<int4*>(vt + swz64(d, c * 16)) =
            make_int4((int)w[0], (int)w[1], (int)w[2], (int)w[3]);
    }
    if (b == 0 && kvh == 0 && threadIdx.x < 32) {
        int kmin = 0x7fffffff, kmax = -0x7fffffff - 1, all = 1;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int t = t0 + threadIdx.x + 32 * h;
            const int kp = a.kpos[t];
            if (a.kval[t] > 0) kmin = min(kmin, kp);
            else all = 0;
            kmax = max(kmax, kp);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
            kmin = min(kmin, __shfl_xor_sync(0xffffffffu, kmin, o));
            kmax = max(kmax, __shfl_xor_sync(0xffffffffu, kmax, o));
        }
        all = __all_sync(0xffffffffu, all);
        if (threadIdx.x == 0) a.tinfo[tt] = make_int4(kmin, kmax, all, 0);
    }
}

__device__ __forceinline__ int tile_cat(const FaArgs& a, int tt, int qmin,
                                        int qmax) {
    const int4 ti = a.tinfo[tt];
    if (ti.x == 0x7fffffff || (a.causal && qmax < ti.x)) return SKIP;
    if (ti.z && (!a.causal || qmin >= ti.y)) return FULL;
    return PART;
}

template <int DH>
__device__ __forceinline__ void pv_mma(int* pv, const uint32_t* af,
                                       uint64_t db) {
    if constexpr (DH == 128) wgmma_rs_n128_s8s8(pv, af, db);
    else if constexpr (DH == 96) wgmma_rs_n96_s8s8(pv, af, db);
    else if constexpr (DH == 64) wgmma_rs_n64_s8s8(pv, af, db);
    else wgmma_rs_n32_s8s8(pv, af, db);
}

__device__ __forceinline__ uint32_t pack4(uint32_t b0, uint32_t b1,
                                          uint32_t b2, uint32_t b3) {
    return b0 | (b1 << 8) | (b2 << 16) | (b3 << 24);
}

template <bool MAIN>
__device__ __forceinline__ void load_tile(const FaArgs& a, uint8_t* ring,
                                           uint64_t* full, long long tbase,
                                           int s, int tt) {
    constexpr int STAGE = KTILE + (MAIN ? VTILE : 0);
    uint8_t* st = ring + s * STAGE;
    mbar_expect_tx(&full[s], STAGE);
    bulk_g2s(st, a.kr + (tbase + tt) * KTILE, KTILE, &full[s]);
    if (MAIN)
        bulk_g2s(st + KTILE, a.vt + (tbase + tt) * VTILE, VTILE, &full[s]);
}

// DH: dh rounded up to a multiple of 32 (q.k's depth and p.v's width)
template <int DH, bool MAIN>
__global__ void __launch_bounds__(NTHREADS, 1) fa_kernel(FaArgs a) {
    constexpr int STAGE = KTILE + (MAIN ? VTILE : 0);
    extern __shared__ uint8_t raw[];
    uint8_t* sm = reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(raw) + 1023) & ~(uintptr_t)1023);
    uint8_t* Qs = sm;
    uint8_t* ring = sm + QTILE;
    uint64_t* qbar = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE);
    uint64_t* full = qbar + 1;
    uint64_t* empty = full + STAGES;
    float* thr = reinterpret_cast<float*>(empty + STAGES);       // (ps + 2,)
    uint8_t* cat = reinterpret_cast<uint8_t*>(thr + 130);       // (nt,)
    uint8_t* fin = cat + a.nt;                                  // (nk,)
    const int rb = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int G = a.H / a.KV;
    const int R0 = rb * 128, Rend = min(R0 + 128, a.S * G);
    const int tpc = a.kc / 64;               // tiles per kv chunk
    const long long tbase = ((long long)b * a.KV + kvh) * a.nt;
    if (tid == 0) {
        mbar_init(qbar, 1);
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], 8);         // one arrival per warp
        }
        mbar_fence_init();
    }
    // the block's query position range (every warp computes it) and, for
    // the main launch, which kv chunks every row enters with a finite m
    int qmin = 0x7fffffff, qmax = -0x7fffffff - 1;
    for (int p = R0 / G + lane; p <= (Rend - 1) / G; p += 32) {
        qmin = min(qmin, a.qpos[p]);
        qmax = max(qmax, a.qpos[p]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        qmin = min(qmin, __shfl_xor_sync(0xffffffffu, qmin, o));
        qmax = max(qmax, __shfl_xor_sync(0xffffffffu, qmax, o));
    }
    const int ips = (int)a.ps;
    if (MAIN)
        for (int n = tid; n < ips + 2; n += NTHREADS) thr[n] = a.pthr[n];
    if (MAIN)
        for (int j = warp; j < a.nk; j += NTHREADS / 32) {
            bool ok = true;
            for (int R = R0 + lane; R < Rend; R += 32)
                ok = ok && a.mrun[(((long long)b * a.S + R / G) * a.H
                                   + kvh * G + R % G) * a.nk + j] > NEG_INF_F;
            ok = __all_sync(0xffffffffu, ok);
            if (lane == 0) fin[j] = ok;
        }
    __syncthreads();
    // each tile's treatment in this launch: SKIP (no copy, no math), PART
    // (masked per key) or FULL
    for (int tt = tid; tt < a.nt; tt += NTHREADS) {
        int c = tile_cat(a, tt, qmin, qmax);
        if (MAIN && c == SKIP && !fin[tt / tpc]) c = PART;
        cat[tt] = (uint8_t)c;
    }
    __syncthreads();
    // thread 0 also feeds the ring: the Q tile, then the first STAGES
    // visited tiles; after each visited tile it refills the previous one's
    // stage once all 8 warps have released it
    int pt = 0;
    if (tid == 0) {
        mbar_expect_tx(qbar, QTILE);
        bulk_g2s(Qs, a.qr + (((long long)b * a.KV + kvh) * a.nrb + rb)
                         * QTILE, QTILE, qbar);
        for (int s = 0; s < STAGES; ++s) {
            while (pt < a.nt && cat[pt] == SKIP) ++pt;
            if (pt >= a.nt) break;
            load_tile<MAIN>(a, ring, full, tbase, s, pt++);
        }
    }

    // warpgroup wg holds rows 64 wg .. 64 wg + 63 of the block; this
    // thread rows g and g + 8 of its warp's 16
    const int wg = warp >> 2, g = lane >> 2, tg = lane & 3;
    int pos[2], head[2], iq[2], qp[2];
    bool valid[2];
    long long mrow[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
        const int R = R0 + wg * 64 + (warp & 3) * 16 + g + 8 * rr;
        valid[rr] = R < a.S * G;
        const int Rc = valid[rr] ? R : 0;
        pos[rr] = Rc / G;
        head[rr] = kvh * G + Rc % G;
        iq[rr] = pos[rr] / a.qc;
        qp[rr] = a.qpos[pos[rr]];
        mrow[rr] = (((long long)b * a.S + pos[rr]) * a.H + head[rr]) * a.nk;
    }
    const uint8_t* Qw = Qs + wg * 8192;
    float o[MAIN ? DH / 2 : 1], l[2] = {0.f, 0.f};
    float run[2] = {NEG_INF_F, NEG_INF_F};
#pragma unroll
    for (int e = 0; e < (MAIN ? DH / 2 : 1); ++e) o[e] = 0.f;
    const float inv_ps = 1.0f / a.ps;
    mbar_wait(qbar, 0);

    int i = 0;
    for (int j = 0; j < a.nk; ++j) {
        float qk[2], mx[2] = {-3.0e38f, -3.0e38f};
        float mj[2], mprev[2], pvs[2];
        int cmul[2], nsum[2] = {0, 0};
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
            qk[rr] = __fmul_rn(chunk_step(a, 0, iq[rr]), chunk_step(a, 1, j));
            if (MAIN) {
                mj[rr] = a.mrun[mrow[rr] + j];
                mprev[rr] = j > 0 ? a.mrun[mrow[rr] + j - 1] : NEG_INF_F;
                const float pst = grid_step(__int_as_float(
                    a.stat[a.nq + 2 * a.nk + iq[rr] * a.nk + j]), a.ps);
                // p's payload is rint(n / ps / pst) = n * cmul exactly:
                // cmul = 1 / (ps pst) = 1 / max(pow2_ceil(pmax), 2^-24) is
                // a power of two >= 1 (pmax <= 1), and n * cmul <= ps
                cmul[rr] = (int)__fdiv_rn(1.0f, __fmul_rn(pst, a.ps));
                pvs[rr] = __fmul_rn(pst, chunk_step(a, 2, j));
            }
        }
        bool skipped = false;
        int pv[MAIN ? DH / 2 : 1];
#pragma unroll
        for (int e = 0; e < (MAIN ? DH / 2 : 1); ++e) pv[e] = 0;

        for (int tt = j * tpc; tt < (j + 1) * tpc; ++tt) {
            const int cat_t = cat[tt];
            if (cat_t == SKIP) {
                skipped = true;
                continue;
            }
            const int s = i % STAGES;
            mbar_wait(&full[s], (i / STAGES) & 1);
            const uint8_t* Ks = ring + s * STAGE;
            int acc[32];
#pragma unroll
            for (int e = 0; e < 32; ++e) acc[e] = 0;
            fence_regs<32>(acc);
            wg_fence();
#pragma unroll
            for (int ks = 0; ks < DH / 32; ++ks)
                wgmma_ss_n64_s8s8(acc, wg_desc(Qw + ks * 32, 1024, 1),
                                  wg_desc(Ks + ks * 32, 1024, 1));
            wg_commit();
            wg_wait0();
            fence_regs<32>(acc);
            if constexpr (!MAIN) {
                __syncwarp();
                if (lane == 0) mbar_arrive(&empty[s]);
            }
            // the mask of this thread's 16 keys (partial tiles only), and
            // which of them are absent (padding past a ragged chunk)
            bool ok[2][16], gone[16];
            const int t0 = tt * 64;
#pragma unroll
            for (int c = 0; c < 16; ++c) {
                const int t = t0 + (c >> 1) * 8 + tg * 2 + (c & 1);
                int kv = 1, kp = 0;
                if (cat_t != FULL) {
                    kv = a.kval[t];
                    kp = a.kpos[t];
                }
                gone[c] = kv < 0;
#pragma unroll
                for (int rr = 0; rr < 2; ++rr)
                    ok[rr][c] = cat_t == FULL
                        || (kv > 0 && (!a.causal || qp[rr] >= kp));
            }
            uint32_t pb[32];
#pragma unroll
            for (int e = 0; e < 32; ++e) {
                const int rr = (e >> 1) & 1, c = (e >> 2) * 2 + (e & 1);
                float sc = __fmul_rn(__fmul_rn((float)acc[e], qk[rr]),
                                     a.sm_scale);
                if (!ok[rr][c]) sc = NEG_INF_F;
                if (!MAIN) {
                    mx[rr] = fmaxf(mx[rr], sc);
                    continue;
                }
                // p onto the Q_A grid (unnormalized) and its payload; an
                // absent key adds nothing, even to a row whose m_j is
                // still NEG_INF
                const int n = gone[c] ? 0
                    : pcode(__fsub_rn(sc, mj[rr]), a.ps, ips, thr);
                nsum[rr] += n;
                pb[e] = (uint32_t)min(n * cmul[rr], ips - 1);
            }
            if constexpr (MAIN) {
                // A fragments of the two 32-deep steps, from this thread's
                // own bytes (V^T's columns are permuted to match)
                uint32_t af[2][4];
#pragma unroll
                for (int kb = 0; kb < 2; ++kb) {
                    const int i0 = 16 * kb, i1 = i0 + 4, i2 = i0 + 8,
                              i3 = i0 + 12;
                    af[kb][0] = pack4(pb[i0], pb[i0 + 1], pb[i1], pb[i1 + 1]);
                    af[kb][1] = pack4(pb[i0 + 2], pb[i0 + 3], pb[i1 + 2],
                                      pb[i1 + 3]);
                    af[kb][2] = pack4(pb[i2], pb[i2 + 1], pb[i3], pb[i3 + 1]);
                    af[kb][3] = pack4(pb[i2 + 2], pb[i2 + 3], pb[i3 + 2],
                                      pb[i3 + 3]);
                }
                const uint8_t* Vs = Ks + KTILE;
                fence_regs<DH / 2>(pv);
                wg_fence();
                pv_mma<DH>(pv, af[0], wg_desc(Vs, 512, 2));
                pv_mma<DH>(pv, af[1], wg_desc(Vs + 32, 512, 2));
                wg_commit();
                wg_wait0();
                fence_regs<DH / 2>(pv);
                __syncwarp();
                if (lane == 0) mbar_arrive(&empty[s]);
            }
            // refill the previous visited tile's stage with the next tile
            if (tid == 0 && i > 0) {
                while (pt < a.nt && cat[pt] == SKIP) ++pt;
                if (pt < a.nt) {
                    const int sp = (i - 1) % STAGES;
                    mbar_wait(&empty[sp], ((i - 1) / STAGES) & 1);
                    load_tile<MAIN>(a, ring, full, tbase, sp, pt++);
                }
            }
            __syncwarp();
            ++i;
        }

        if constexpr (!MAIN) {
            // the row's max and running max, and its largest quantized p
            // in the chunk, round(exp(rowmax_j - m_j) ps) / ps
            float pq[2];
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
                // skipped tiles' scores are all NEG_INF for every row
                if (skipped) mx[rr] = fmaxf(mx[rr], NEG_INF_F);
#pragma unroll
                for (int o = 1; o < 4; o <<= 1)
                    mx[rr] = fmaxf(mx[rr],
                                   __shfl_xor_sync(0xffffffffu, mx[rr], o));
                run[rr] = fmaxf(run[rr], mx[rr]);
                if (tg == 0 && valid[rr]) a.mrun[mrow[rr] + j] = run[rr];
                pq[rr] = valid[rr] ? __fmul_rn(rintf(__fmul_rn(
                    exp32(__fsub_rn(mx[rr], run[rr])), a.ps)), inv_ps) : 0.f;
            }
            // the (q chunk, kv chunk) block's amax of p (non-negative, so
            // its fp32 bits order as ints): a warp max over the rows in
            // lane 0's q chunk, one atomic each for rows in another
            int* pmax = a.stat + a.nq + 2 * a.nk + j;
            const int iq0 = __shfl_sync(0xffffffffu, iq[0], 0);
            float w = 0.f;
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
                if (iq[rr] == iq0) w = fmaxf(w, pq[rr]);
                else if (tg == 0 && valid[rr])
                    atomicMax(pmax + iq[rr] * a.nk, __float_as_int(pq[rr]));
            }
#pragma unroll
            for (int o = 16; o > 0; o >>= 1)
                w = fmaxf(w, __shfl_xor_sync(0xffffffffu, w, o));
            if (lane == 0) atomicMax(pmax + iq0 * a.nk, __float_as_int(w));
        } else {
            // the chunk's online rescale: sum p = nsum / ps, exact in fp32
            // (as the plain version's sum of grid values is)
#pragma unroll
            for (int rr = 0; rr < 2; ++rr)
#pragma unroll
                for (int o = 1; o < 4; o <<= 1)
                    nsum[rr] += __shfl_xor_sync(0xffffffffu, nsum[rr], o);
            float alpha[2];
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
                alpha[rr] = exp32(__fsub_rn(mprev[rr], mj[rr]));
                l[rr] = __fadd_rn(__fmul_rn(l[rr], alpha[rr]),
                                  __fmul_rn((float)nsum[rr], inv_ps));
            }
#pragma unroll
            for (int e = 0; e < DH / 2; ++e) {
                const int rr = (e >> 1) & 1;
                o[e] = __fadd_rn(__fmul_rn(o[e], alpha[rr]),
                                 __fmul_rn((float)pv[e], pvs[rr]));
            }
        }
    }
    if (a.visits != nullptr && tid == 0)
        atomicAdd(a.visits + (MAIN ? 1 : 0), (unsigned long long)i);
    if constexpr (MAIN) {
#pragma unroll
        for (int i8 = 0; i8 < DH / 8; ++i8)
#pragma unroll
            for (int rr = 0; rr < 2; ++rr) {
                if (!valid[rr] || i8 * 8 >= a.dh) continue;
                const double den = (double)fmaxf(l[rr], 1e-9f);
                float2 v;
                v.x = (float)((double)o[4 * i8 + 2 * rr] / den);
                v.y = (float)((double)o[4 * i8 + 2 * rr + 1] / den);
                *reinterpret_cast<float2*>(
                    a.out + ((((long long)b * a.S + pos[rr]) * a.H + head[rr])
                             * a.dh + i8 * 8 + tg * 2)) = v;
            }
    }
}

template <int DH, bool MAIN>
static int run(const FaArgs& a, dim3 grid, cudaStream_t st) {
    constexpr int fixed = 1024 + QTILE + STAGES * (KTILE + (MAIN ? VTILE : 0))
                          + (1 + 2 * STAGES) * 8 + 130 * 4;
    const int smem = fixed + a.nt + a.nk;
    auto kern = fa_kernel<DH, MAIN>;
    int rc = (int)cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != 0) return rc;
    kern<<<grid, NTHREADS, smem, st>>>(a);
    return (int)cudaGetLastError();
}

template <bool MAIN>
static int run_dh(const FaArgs& a, dim3 grid, cudaStream_t st) {
    switch ((a.dh + 31) / 32) {       // dh rounded up to a multiple of 32
        case 1: return run<32, MAIN>(a, grid, st);
        case 2: return run<64, MAIN>(a, grid, st);
        case 3: return run<96, MAIN>(a, grid, st);
        default: return run<128, MAIN>(a, grid, st);
    }
}

// phase 2: the chunk statistics and the operand pass (fa_init, fa_amax,
// the Q, K and V^T tiles and the tile summary); phase 0: statistics (the
// running max mrun and the probability amaxes); phase 1: main pass (out).
// S, T multiples of qc and kc, kc a multiple of 64 (kval: 1 valid, 0
// masked, -1 absent), dh a multiple of 16 up
// to 128, the heads a multiple of KV; q8, k8, v8 16-byte aligned.  ps =
// 2^(k_a-1), lim = ps - 1.  Scratch: stat nq + 2 nk + nq nk ints, pthr 130
// floats, tinfo nt int4, qr/kr/vt the tiles (ops.flash_attention sizes
// them).  visits, when not null, gathers the 64-position tiles each of
// phases 0 and 1 visited (the rest were skipped).
extern "C" int fa_launch(int phase, const void* q8, const void* k8,
                         const void* v8, const void* qpos, const void* kpos,
                         const void* kval, const void* scales, void* mrun,
                         void* out, void* qr, void* kr, void* vt, void* tinfo,
                         void* pthr, void* stat, void* visits, float sm_scale,
                         float ps, float lim, int causal, int B, int S, int T,
                         int H, int KV, int dh, int qc, int kc,
                         void* stream) {
    if (B <= 0 || S <= 0 || T <= 0) return 0;
    FaArgs a;
    a.q8 = (const int8_t*)q8;
    a.k8 = (const int8_t*)k8;
    a.v8 = (const int8_t*)v8;
    a.qpos = (const int32_t*)qpos;
    a.kpos = (const int32_t*)kpos;
    a.kval = (const int32_t*)kval;
    a.scales = (const float*)scales;
    a.mrun = (float*)mrun;
    a.out = (float*)out;
    a.qr = (uint8_t*)qr;
    a.kr = (uint8_t*)kr;
    a.vt = (uint8_t*)vt;
    a.tinfo = (int4*)tinfo;
    a.pthr = (float*)pthr;
    a.stat = (int*)stat;
    a.visits = (unsigned long long*)visits;
    a.sm_scale = sm_scale;
    a.ps = ps;
    a.lim = lim;
    a.causal = causal;
    a.B = B; a.S = S; a.T = T; a.H = H; a.KV = KV; a.dh = dh;
    a.qc = qc; a.kc = kc; a.nq = S / qc; a.nk = T / kc; a.nt = T / 64;
    const int G = H / KV;
    a.nrb = (S * G + 127) / 128;
    cudaStream_t st = (cudaStream_t)stream;
    if (phase == 2) {
        fa_init<<<1, 128, 0, st>>>(a);
        const long long span = max((long long)qc * H, (long long)kc * KV) * dh;
        fa_amax<<<dim3((unsigned)((span + AMAX_SPAN - 1) / AMAX_SPAN),
                       B * max(a.nq, a.nk), 3), 256, 0, st>>>(a);
        fa_prep_q<<<dim3(a.nrb, KV, B), 256, 0, st>>>(a);
        fa_prep_kv<<<dim3(a.nt, KV, B), 256, 0, st>>>(a);
        return (int)cudaGetLastError();
    }
    dim3 grid(a.nrb, KV, B);
    return phase == 0 ? run_dh<false>(a, grid, st) : run_dh<true>(a, grid, st);
}

// Every fp32 x <= 0 (+0, -0 down to -inf; the NaN patterns excluded) for
// each k_a from 2 to 8: miss[k_a - 2] counts the x where pcode differs from
// pcode_ref.
__global__ void __launch_bounds__(256)
fa_pcode_sweep(const float* __restrict__ thr_all,
               unsigned long long* __restrict__ miss) {
    __shared__ float thr[7][130];
    for (int u = threadIdx.x; u < 7 * 130; u += blockDim.x)
        thr[u / 130][u % 130] = thr_all[u];
    __syncthreads();
    unsigned long long cnt[7] = {0, 0, 0, 0, 0, 0, 0};
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i <= 0x7f800001LL; i += stride) {
        const float x = i == 0x7f800001LL
            ? 0.0f : __uint_as_float(0x80000000u | (uint32_t)i);
        const float e = exp32(x);
#pragma unroll
        for (int k = 0; k < 7; ++k) {
            const float ps = (float)(2 << k);
            const int want = (int)rintf(__fmul_rn(e, ps));
            cnt[k] += pcode(x, ps, 2 << k, thr[k]) != want;
        }
    }
#pragma unroll
    for (int k = 0; k < 7; ++k) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
            cnt[k] += __shfl_xor_sync(0xffffffffu, cnt[k], o);
        if ((threadIdx.x & 31) == 0 && cnt[k]) atomicAdd(&miss[k], cnt[k]);
    }
}

// thr_all: 7 x 130 floats of scratch; miss: 7 zeroed counters
extern "C" int fa_pcode_check(void* thr_all, void* miss, void* stream) {
    cudaStream_t st = (cudaStream_t)stream;
    float* thr = (float*)thr_all;
    for (int k = 0; k < 7; ++k)
        fa_thresholds<<<1, 128, 0, st>>>(thr + 130 * k, (float)(2 << k));
    fa_pcode_sweep<<<132 * 8, 256, 0, st>>>(thr,
                                            (unsigned long long*)miss);
    return (int)cudaGetLastError();
}
