// K5: tiled online-softmax attention on int8 payloads (training forward).
//
// Replaces repro/kernels/paged_attention.py::flash_attention (_flash_kernel
// and _tile_dots).  On this slice it is the attention forward of every
// layer of the training step (chunked_attention's fused route); the
// backward is autograd of the plain chunked body, as in the reference.
//
// The TPU kernel holds a whole (B, q_chunk, heads) block per grid step, so
// it derives every per-chunk grid decomposition (q, k, v and the
// probabilities, each amax over the whole block) in-register.  A Hopper
// block holds 64 query rows of one (batch, KV head), so the block-wide
// scales are computed around the kernels (ops.flash_attention):
//   (a) per-chunk amaxes of the q, k and v payloads, reduced on the device,
//       give each chunk's grid step;
//   (b) fa_stats: each row's masked score maximum in each kv chunk;
//   (c) glue on the device: the running max m_j (a cummax over kv chunks)
//       and, per (q chunk, kv chunk), the probability amax over the block,
//       max round(exp(rowmax_j - m_j) * 2^(k-1)) / 2^(k-1), which gives the
//       probability step (the saturate-at-pow2-amax corner included);
//   (d) fa_main: recompute the scores, p = exp(s - m_j) onto the Q_A grid
//       unnormalized, the int8 p payload, int32 p.v over the chunk, and the
//       rescale l = l * alpha + sum p, o = o * alpha + pv; o / max(l, 1e-9).
// Every step matches the plain version (kernels/ref.py flash_attention)
// bit for bit: integer dots are exact, exp and the final division are taken
// in float64 and rounded once on both sides, the sums of quantized
// probabilities are exact in fp32, and the build uses -fmad=false.
//
// Bound: operations (two int8 dots of S * T * H * dh each, plus an exp per
// score).  Design (right first, not yet fast): 4 warps, each 16 query rows
// (a row is one (position, query head) pair of the KV group); kv streams in
// 64-position tiles requantized into shared memory (K as [t][d], V
// transposed 4x4 bytes at a time into [d][t]); q.k and p.v run on int8
// mma.sync m16n8k32 with int32 accumulators; the p payload goes through a
// per-warp shared tile to reach the A-operand layout.  Every kv chunk is
// visited (causal chunks wholly above the diagonal included, as in the
// reference); skipping them is later work.
#include <cuda_runtime.h>
#include <stdint.h>

#define NEG_INF_F (-1e9f)
#define KT 64
#define LDK 144
#define LDV 80
#define LDP 80

struct FaArgs {
    const int8_t* q8;       // (B, S, H, dh)
    const int8_t* k8;       // (B, T, KV, dh)
    const int8_t* v8;       // (B, T, KV, dh)
    const int32_t* qpos;    // (S,)
    const int32_t* kpos;    // (T,)
    const int32_t* kval;    // (T,)
    const float* scales;    // [q_scale, k_scale, v_scale]
    const float* qstep;     // (nq, 2): [inv, step]
    const float* kstep;     // (nk, 2)
    const float* vstep;     // (nk, 2)
    const float* pstep;     // (nq, nk, 2)
    float* rowmax;          // (B, S, H, nk) stats out / running max m in
    float* out;             // (B, S, H, dh)
    float sm_scale;
    int causal, B, S, T, H, KV, dh, qc, kc, nk;
};

__device__ __forceinline__ void mma_s8(int* c, const int* a, const int* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float exp32(float x) { return (float)exp((double)x); }

// 4 payload bytes regridded: clip(rint(n * scale * inv), +-127) each
__device__ __forceinline__ uint32_t regrid4(uint32_t w, float scale,
                                            float inv) {
    uint32_t o = 0u;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const float v = (float)(int8_t)(uint8_t)(w >> (8 * j));
        const float q = rintf(__fmul_rn(__fmul_rn(v, scale), inv));
        o |= (uint32_t)(uint8_t)(int8_t)(int)fminf(fmaxf(q, -127.f), 127.f)
             << (8 * j);
    }
    return o;
}

__device__ __forceinline__ void transpose4(const uint32_t* r, uint32_t* w) {
    const uint32_t lo01 = __byte_perm(r[0], r[1], 0x5140);
    const uint32_t hi01 = __byte_perm(r[0], r[1], 0x7362);
    const uint32_t lo23 = __byte_perm(r[2], r[3], 0x5140);
    const uint32_t hi23 = __byte_perm(r[2], r[3], 0x7362);
    w[0] = __byte_perm(lo01, lo23, 0x5410);
    w[1] = __byte_perm(lo01, lo23, 0x7632);
    w[2] = __byte_perm(hi01, hi23, 0x5410);
    w[3] = __byte_perm(hi01, hi23, 0x7632);
}

struct RowInfo {
    int valid, pos, head, iq;
};

__device__ __forceinline__ RowInfo row_info(const FaArgs& a, int R, int kvh) {
    const int G = a.H / a.KV;
    RowInfo r;
    r.valid = R < a.S * G;
    const int Rc = r.valid ? R : 0;
    r.pos = Rc / G;
    r.head = kvh * G + Rc % G;
    r.iq = r.pos / a.qc;
    return r;
}

// the warp's Q fragments (16 rows x dh), regridded onto each row's q-chunk
// step; qf[ks] holds the m16n8k32 A operand of contraction step ks
__device__ __forceinline__ void load_q(const FaArgs& a, int b, const RowInfo* ri,
                                       int g, int tg, int qf[4][4]) {
    const float qs = a.scales[0];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int rr = e & 1;                    // a0/a2 row g, a1/a3 row g+8
            const int d = ks * 32 + (e >= 2 ? 16 : 0) + tg * 4;
            uint32_t w = 0u;
            if (ri[rr].valid && d < a.dh) {
                const int8_t* src = a.q8 + (((long long)b * a.S + ri[rr].pos)
                                            * a.H + ri[rr].head) * a.dh + d;
                w = regrid4(*reinterpret_cast<const uint32_t*>(src), qs,
                            a.qstep[2 * ri[rr].iq]);
            }
            qf[ks][e] = (int)w;
        }
}

// K tile [t][d] of kv positions t0..t0+63, regridded onto chunk j's step
__device__ __forceinline__ void stage_k(const FaArgs& a, int b, int kvh, int t0,
                                        int j, uint8_t* Ks) {
    const float ks = a.scales[1], kinv = a.kstep[2 * j];
    const int wpr = a.dh / 4;
    for (int u = threadIdx.x; u < KT * wpr; u += blockDim.x) {
        const int t = u / wpr, d = (u % wpr) * 4;
        const int8_t* src = a.k8 + (((long long)b * a.T + t0 + t) * a.KV + kvh)
                                   * a.dh + d;
        *reinterpret_cast<uint32_t*>(Ks + t * LDK + d) =
            regrid4(*reinterpret_cast<const uint32_t*>(src), ks, kinv);
    }
}

// scores of the warp's 16 rows against the 64 staged positions
__device__ __forceinline__ void tile_scores(const FaArgs& a, const uint8_t* Ks,
                                            const int qf[4][4], int g, int tg,
                                            int acc[8][4]) {
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[ni][e] = 0;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
        if (ks * 32 >= a.dh) break;
#pragma unroll
        for (int ni = 0; ni < 8; ++ni) {
            const uint8_t* base = Ks + (ni * 8 + g) * LDK + ks * 32 + tg * 4;
            int bf[2];
            bf[0] = *reinterpret_cast<const int*>(base);
            bf[1] = *reinterpret_cast<const int*>(base + 16);
            mma_s8(acc[ni], qf[ks], bf);
        }
    }
}

// fp32 score of element e of n-tile ni: acc * (q_step * k_step) * sm, or
// NEG_INF where masked
__device__ __forceinline__ float score(const FaArgs& a, const RowInfo& r,
                                       int t, int acc, float qk) {
    const float s = __fmul_rn(__fmul_rn((float)acc, qk), a.sm_scale);
    bool ok = a.kval[t] != 0;
    if (a.causal) ok = ok && a.qpos[r.pos] >= a.kpos[t];
    return ok ? s : NEG_INF_F;
}

__global__ void __launch_bounds__(128) fa_stats(FaArgs a) {
    __shared__ __align__(16) uint8_t Ks[KT * LDK];
    const int b = blockIdx.z, kvh = blockIdx.y;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, tg = lane & 3;
    const int R0 = blockIdx.x * 64 + warp * 16;
    RowInfo ri[2] = {row_info(a, R0 + g, kvh), row_info(a, R0 + g + 8, kvh)};
    int qf[4][4];
    load_q(a, b, ri, g, tg, qf);
    for (int j = 0; j < a.nk; ++j) {
        float mx[2] = {-3.0e38f, -3.0e38f};
        const float qk0 = __fmul_rn(a.qstep[2 * ri[0].iq + 1], a.kstep[2 * j + 1]);
        const float qk1 = __fmul_rn(a.qstep[2 * ri[1].iq + 1], a.kstep[2 * j + 1]);
        for (int t0 = j * a.kc; t0 < (j + 1) * a.kc; t0 += KT) {
            __syncthreads();
            stage_k(a, b, kvh, t0, j, Ks);
            __syncthreads();
            int acc[8][4];
            tile_scores(a, Ks, qf, g, tg, acc);
#pragma unroll
            for (int ni = 0; ni < 8; ++ni)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int rr = e >> 1;
                    const int t = t0 + ni * 8 + tg * 2 + (e & 1);
                    const float s = score(a, ri[rr], t, acc[ni][e],
                                          rr ? qk1 : qk0);
                    mx[rr] = fmaxf(mx[rr], s);
                }
        }
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
            mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
            mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
            if (tg == 0 && ri[rr].valid)
                a.rowmax[(((long long)b * a.S + ri[rr].pos) * a.H + ri[rr].head)
                         * a.nk + j] = mx[rr];
        }
    }
}

__global__ void __launch_bounds__(128) fa_main(FaArgs a) {
    __shared__ __align__(16) uint8_t Ks[KT * LDK];
    __shared__ __align__(16) uint8_t Vt[128 * LDV];          // Vt[d][t]
    __shared__ __align__(16) uint8_t Ps[4][16 * LDP];        // per warp
    const int b = blockIdx.z, kvh = blockIdx.y;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, tg = lane & 3;
    const int R0 = blockIdx.x * 64 + warp * 16;
    const int nt = a.dh / 8;
    RowInfo ri[2] = {row_info(a, R0 + g, kvh), row_info(a, R0 + g + 8, kvh)};
    int qf[4][4];
    load_q(a, b, ri, g, tg, qf);
    long long mrow[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr)
        mrow[rr] = (((long long)b * a.S + ri[rr].pos) * a.H + ri[rr].head) * a.nk;

    float o[16][4], l[2] = {0.f, 0.f};
#pragma unroll
    for (int ni = 0; ni < 16; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[ni][e] = 0.f;
    uint8_t* P = Ps[warp];

    for (int j = 0; j < a.nk; ++j) {
        float mj[2], mprev[2], pinv[2], pvs[2], qk[2], psum[2] = {0.f, 0.f};
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
            mj[rr] = a.rowmax[mrow[rr] + j];
            mprev[rr] = j > 0 ? a.rowmax[mrow[rr] + j - 1] : NEG_INF_F;
            const float* ps = a.pstep + 2 * (ri[rr].iq * a.nk + j);
            pinv[rr] = ps[0];
            pvs[rr] = __fmul_rn(ps[1], a.vstep[2 * j + 1]);
            qk[rr] = __fmul_rn(a.qstep[2 * ri[rr].iq + 1], a.kstep[2 * j + 1]);
        }
        int pv[16][4];
#pragma unroll
        for (int ni = 0; ni < 16; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) pv[ni][e] = 0;

        for (int t0 = j * a.kc; t0 < (j + 1) * a.kc; t0 += KT) {
            __syncthreads();
            stage_k(a, b, kvh, t0, j, Ks);
            {   // V tile, regridded, transposed 4x4 bytes into Vt[d][t]
                const float vs = a.scales[2], vinv = a.vstep[2 * j];
                const int dq = a.dh / 4;
                for (int u = threadIdx.x; u < (KT / 4) * dq; u += blockDim.x) {
                    const int tq = u / dq, d = (u % dq) * 4;
                    uint32_t r[4], w[4];
#pragma unroll
                    for (int i = 0; i < 4; ++i) {
                        const int8_t* src = a.v8 + (((long long)b * a.T + t0
                                                     + tq * 4 + i) * a.KV + kvh)
                                                   * a.dh + d;
                        r[i] = regrid4(*reinterpret_cast<const uint32_t*>(src),
                                       vs, vinv);
                    }
                    transpose4(r, w);
#pragma unroll
                    for (int i = 0; i < 4; ++i)
                        *reinterpret_cast<uint32_t*>(Vt + (d + i) * LDV + tq * 4) = w[i];
                }
            }
            __syncthreads();
            int acc[8][4];
            tile_scores(a, Ks, qf, g, tg, acc);
            // p onto the Q_A grid (unnormalized) and its int8 payload
#pragma unroll
            for (int ni = 0; ni < 8; ++ni)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int rr = e >> 1;
                    const int col = ni * 8 + tg * 2 + (e & 1);
                    const float s = score(a, ri[rr], t0 + col, acc[ni][e], qk[rr]);
                    const float p = exp32(__fsub_rn(s, mj[rr]));
                    const float pq = __fmul_rn(rintf(__fmul_rn(p, 128.f)),
                                               1.0f / 128.f);
                    psum[rr] = __fadd_rn(psum[rr], pq);
                    const float q = rintf(__fmul_rn(pq, pinv[rr]));
                    P[(g + 8 * rr) * LDP + col] =
                        (uint8_t)(int8_t)(int)fminf(fmaxf(q, -127.f), 127.f);
                }
            __syncwarp();
#pragma unroll
            for (int ks = 0; ks < 2; ++ks) {
                int af[4];
                const uint8_t* pa = P + g * LDP + ks * 32 + tg * 4;
                af[0] = *reinterpret_cast<const int*>(pa);
                af[1] = *reinterpret_cast<const int*>(pa + 8 * LDP);
                af[2] = *reinterpret_cast<const int*>(pa + 16);
                af[3] = *reinterpret_cast<const int*>(pa + 8 * LDP + 16);
#pragma unroll
                for (int ni = 0; ni < 16; ++ni) {
                    if (ni >= nt) break;
                    const uint8_t* base = Vt + (ni * 8 + g) * LDV + ks * 32 + tg * 4;
                    int bf[2];
                    bf[0] = *reinterpret_cast<const int*>(base);
                    bf[1] = *reinterpret_cast<const int*>(base + 16);
                    mma_s8(pv[ni], af, bf);
                }
            }
            __syncwarp();
        }
        // the chunk's online rescale (sums of quantized p are exact)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
            psum[rr] = __fadd_rn(psum[rr], __shfl_xor_sync(0xffffffffu, psum[rr], 1));
            psum[rr] = __fadd_rn(psum[rr], __shfl_xor_sync(0xffffffffu, psum[rr], 2));
        }
        float alpha[2];
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
            alpha[rr] = exp32(__fsub_rn(mprev[rr], mj[rr]));
            l[rr] = __fadd_rn(__fmul_rn(l[rr], alpha[rr]), psum[rr]);
        }
#pragma unroll
        for (int ni = 0; ni < 16; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int rr = e >> 1;
                o[ni][e] = __fadd_rn(__fmul_rn(o[ni][e], alpha[rr]),
                                     __fmul_rn((float)pv[ni][e], pvs[rr]));
            }
    }
#pragma unroll
    for (int ni = 0; ni < 16; ++ni) {
        if (ni >= nt) break;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int rr = e >> 1;
            if (!ri[rr].valid) continue;
            const int d = ni * 8 + tg * 2 + (e & 1);
            const double den = (double)fmaxf(l[rr], 1e-9f);
            a.out[(((long long)b * a.S + ri[rr].pos) * a.H + ri[rr].head) * a.dh
                  + d] = (float)((double)o[ni][e] / den);
        }
    }
}

static FaArgs make_args(const void* q8, const void* k8, const void* v8,
                        const void* qpos, const void* kpos, const void* kval,
                        const void* scales, const void* qstep,
                        const void* kstep, const void* vstep,
                        const void* pstep, void* rowmax, void* out,
                        float sm_scale, int causal, int B, int S, int T,
                        int H, int KV, int dh, int qc, int kc) {
    FaArgs a;
    a.q8 = (const int8_t*)q8;
    a.k8 = (const int8_t*)k8;
    a.v8 = (const int8_t*)v8;
    a.qpos = (const int32_t*)qpos;
    a.kpos = (const int32_t*)kpos;
    a.kval = (const int32_t*)kval;
    a.scales = (const float*)scales;
    a.qstep = (const float*)qstep;
    a.kstep = (const float*)kstep;
    a.vstep = (const float*)vstep;
    a.pstep = (const float*)pstep;
    a.rowmax = (float*)rowmax;
    a.out = (float*)out;
    a.sm_scale = sm_scale;
    a.causal = causal;
    a.B = B; a.S = S; a.T = T; a.H = H; a.KV = KV; a.dh = dh;
    a.qc = qc; a.kc = kc; a.nk = T / kc;
    return a;
}

// phase 0: statistics (rowmax written); phase 1: main pass (rowmax read as
// the running max m, out written).  S, T multiples of qc and kc, kc a
// multiple of 64, dh a multiple of 32 up to 128, the heads a multiple of KV.
extern "C" int fa_launch(int phase, const void* q8, const void* k8,
                         const void* v8, const void* qpos, const void* kpos,
                         const void* kval, const void* scales,
                         const void* qstep, const void* kstep,
                         const void* vstep, const void* pstep, void* rowmax,
                         void* out, float sm_scale, int causal, int B, int S,
                         int T, int H, int KV, int dh, int qc, int kc,
                         void* stream) {
    if (B <= 0 || S <= 0 || T <= 0) return 0;
    FaArgs a = make_args(q8, k8, v8, qpos, kpos, kval, scales, qstep, kstep,
                         vstep, pstep, rowmax, out, sm_scale, causal, B, S, T,
                         H, KV, dh, qc, kc);
    const int G = H / KV;
    dim3 grid((S * G + 63) / 64, KV, B);
    cudaStream_t st = (cudaStream_t)stream;
    if (phase == 0)
        fa_stats<<<grid, 128, 0, st>>>(a);
    else
        fa_main<<<grid, 128, 0, st>>>(a);
    return (int)cudaGetLastError();
}
