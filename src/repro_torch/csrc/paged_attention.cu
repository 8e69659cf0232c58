// K6: paged int8 decode attention, two launches with scalar glue between.
//
// Replaces repro/kernels/paged_attention.py::paged_attention
// (_decode_ml_kernel and _decode_out_kernel).  On this slice it is every
// decode step's attention and each token of a ragged prompt tail (B = 1).
//
//   pass 1 (pa_stats)  masked int32 q.k scores -> per-row softmax max m
//                      and sum l, (B, H) fp32.
//   glue (PyTorch, on the device)  the probability step comes from ONE
//                      batch-global amax: round(max(1/l) * 2^(k-1)) /
//                      2^(k-1), pow2_ceil, as kernels/paged_attention.py
//                      computes it between its two pallas_calls.
//   pass 2 (pa_out)    recompute the scores, p = exp(s - m) / l onto the
//                      Q_A grid, p8 = clip(rint(p * pinv)), int32 p.v,
//                      output (B, H, dh) fp32 = acc * (step * v_scale).
//
// Bound: bytes.  Per lane the K and V pages of its context are the data;
// the scores are a few int8 dot products per byte.  Design: one block
// (4 warps) per (lane, KV head) serves the g query heads of that group; a
// warp takes one position at a time, lane l holding dims 4l..4l+3 as one
// 32-bit word, so each K/V row is one coalesced 128-byte load, the g dot
// products are __dp4a and an integer warp-shuffle sum (exact in any
// order).  The score row is never stored: pass 1 sweeps the pages twice
// (max, then the sum of exp(s - m)), so m is exact, and l accumulates in
// float64 and rounds once to fp32, so it does not depend on the summation
// order (the plain version sums in float64 too).  exp and the division by l
// are taken in float64 and rounded once to fp32 on both sides, so the two
// do not hang on how each compiler builds the fp32 expf and division: the
// kernel and its plain version agree bit for bit on the card.  Pass 2
// keeps the int32 p.v partials
// in registers and sums the warps' partials through shared memory.  An
// optional p8 output (B, H, T) exposes the probability payload to tests.
#include <cuda_runtime.h>
#include <stdint.h>

#define PA_WARPS 4
#define PA_MAXG 8
#define NEG_INF_F (-1e9f)

struct PaArgs {
    const int8_t* q8;        // (B, H, dh)
    const int8_t* kp;        // (P, page, KV, dh)
    const int8_t* vp;        // (P, page, KV, dh)
    const int32_t* table;    // (B, NB)
    const int32_t* qpos;     // (B,)
    const int32_t* tvalid;   // scalar
    const float* kq;         // scalar q_scale * k_scale
    float sm_scale;
    int P, page, KV, G, dh, NB;
};

// exp(x) and a / b in fp32, each through float64 and rounded once
__device__ __forceinline__ float exp32(float x) { return (float)exp((double)x); }

__device__ __forceinline__ float div32(float a, float b) {
    return (float)((double)a / (double)b);
}

__device__ __forceinline__ int warp_isum(int v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

__device__ __forceinline__ long long row_off(const PaArgs& a, int b, int kvh,
                                             int t) {
    int j = t / a.page, off = t - j * a.page;
    int pid = a.table[(long long)b * a.NB + j];
    pid = pid < 0 ? 0 : (pid >= a.P ? a.P - 1 : pid);
    return (((long long)pid * a.page + off) * a.KV + kvh) * a.dh;
}

// scores of the g heads of (b, kvh) at position t into s[]; every lane
// ends with the same values
__device__ __forceinline__ void scores(const PaArgs& a, const int* qw, int b,
                                       int kvh, int t, int lane, int qpos,
                                       int tval, float kq, float* s) {
    const int nw = a.dh >> 2;
    int kw = 0;
    if (lane < nw)
        kw = *reinterpret_cast<const int*>(a.kp + row_off(a, b, kvh, t)
                                           + 4 * lane);
    const bool ok = (t <= qpos) && (t < tval);
#pragma unroll
    for (int g = 0; g < PA_MAXG; ++g) {
        if (g < a.G) {
            int acc = warp_isum(__dp4a(qw[g], kw, 0));
            s[g] = ok ? ((float)acc * kq) * a.sm_scale : NEG_INF_F;
        }
    }
}

__device__ __forceinline__ void load_q(const PaArgs& a, int b, int kvh,
                                       int lane, int* qw) {
    const int nw = a.dh >> 2, h_all = a.KV * a.G;
#pragma unroll
    for (int g = 0; g < PA_MAXG; ++g) {
        qw[g] = 0;
        if (g < a.G && lane < nw)
            qw[g] = *reinterpret_cast<const int*>(
                a.q8 + ((long long)b * h_all + kvh * a.G + g) * a.dh
                + 4 * lane);
    }
}

__global__ void __launch_bounds__(PA_WARPS * 32)
pa_stats(PaArgs a, float* __restrict__ m_out, float* __restrict__ l_out) {
    __shared__ float red[PA_WARPS][PA_MAXG];
    __shared__ double red64[PA_WARPS][PA_MAXG];
    __shared__ float mrow[PA_MAXG];
    const int b = blockIdx.x, kvh = blockIdx.y;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int T = a.NB * a.page;
    const int qpos = a.qpos[b], tval = *a.tvalid;
    const float kq = *a.kq;
    int qw[PA_MAXG];
    load_q(a, b, kvh, lane, qw);
    float s[PA_MAXG], acc[PA_MAXG];
#pragma unroll
    for (int g = 0; g < PA_MAXG; ++g) acc[g] = -3.402823466e38f;
    for (int t = warp; t < T; t += PA_WARPS) {             // sweep 1: max
        scores(a, qw, b, kvh, t, lane, qpos, tval, kq, s);
#pragma unroll
        for (int g = 0; g < PA_MAXG; ++g)
            if (g < a.G) acc[g] = fmaxf(acc[g], s[g]);
    }
    if (lane == 0)
        for (int g = 0; g < a.G; ++g) red[warp][g] = acc[g];
    __syncthreads();
    if (threadIdx.x < a.G) {
        float m = red[0][threadIdx.x];
        for (int w = 1; w < PA_WARPS; ++w) m = fmaxf(m, red[w][threadIdx.x]);
        mrow[threadIdx.x] = m;
    }
    __syncthreads();
    double sum[PA_MAXG];
#pragma unroll
    for (int g = 0; g < PA_MAXG; ++g) sum[g] = 0.0;
    for (int t = warp; t < T; t += PA_WARPS) {             // sweep 2: sum
        scores(a, qw, b, kvh, t, lane, qpos, tval, kq, s);
#pragma unroll
        for (int g = 0; g < PA_MAXG; ++g)
            if (g < a.G) sum[g] += (double)exp32(s[g] - mrow[g]);
    }
    if (lane == 0)
        for (int g = 0; g < a.G; ++g) red64[warp][g] = sum[g];
    __syncthreads();
    if (threadIdx.x < a.G) {
        double l = 0.0;
        for (int w = 0; w < PA_WARPS; ++w) l += red64[w][threadIdx.x];
        const long long row = (long long)b * a.KV * a.G + kvh * a.G
                              + threadIdx.x;
        m_out[row] = mrow[threadIdx.x];
        l_out[row] = (float)l;
    }
}

__global__ void __launch_bounds__(PA_WARPS * 32)
pa_out(PaArgs a, const float* __restrict__ m_in, const float* __restrict__ l_in,
       const float* __restrict__ pinv_p, const float* __restrict__ pv_p,
       float s_grid, float lim, float* __restrict__ out,
       int8_t* __restrict__ p8_out) {
    __shared__ int red[PA_WARPS][PA_MAXG][128];
    const int b = blockIdx.x, kvh = blockIdx.y;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int T = a.NB * a.page, H = a.KV * a.G, nw = a.dh >> 2;
    const int qpos = a.qpos[b], tval = *a.tvalid;
    const float kq = *a.kq, pinv = *pinv_p;
    int qw[PA_MAXG];
    load_q(a, b, kvh, lane, qw);
    float m[PA_MAXG], l[PA_MAXG], s[PA_MAXG];
    int acc[PA_MAXG][4];
#pragma unroll
    for (int g = 0; g < PA_MAXG; ++g) {
        const long long row = (long long)b * H + kvh * a.G + g;
        m[g] = g < a.G ? m_in[row] : 0.f;
        l[g] = g < a.G ? l_in[row] : 1.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[g][i] = 0;
    }
    for (int t = warp; t < T; t += PA_WARPS) {
        scores(a, qw, b, kvh, t, lane, qpos, tval, kq, s);
        int vw = 0;
        if (lane < nw)
            vw = *reinterpret_cast<const int*>(a.vp + row_off(a, b, kvh, t)
                                               + 4 * lane);
        const int v0 = (int)(int8_t)(vw & 0xff);
        const int v1 = (int)(int8_t)((vw >> 8) & 0xff);
        const int v2 = (int)(int8_t)((vw >> 16) & 0xff);
        const int v3 = (int)(int8_t)((vw >> 24) & 0xff);
#pragma unroll
        for (int g = 0; g < PA_MAXG; ++g) {
            if (g < a.G) {
                float p = div32(exp32(s[g] - m[g]), l[g]);
                float pg = rintf(p * s_grid) / s_grid;         // Q_A grid
                int p8 = (int)fminf(fmaxf(rintf(pg * pinv), -lim), lim);
                if (p8_out != nullptr && lane == 0)
                    p8_out[((long long)b * H + kvh * a.G + g) * T + t] =
                        (int8_t)p8;
                acc[g][0] += p8 * v0;
                acc[g][1] += p8 * v1;
                acc[g][2] += p8 * v2;
                acc[g][3] += p8 * v3;
            }
        }
    }
    if (lane < nw) {
#pragma unroll
        for (int g = 0; g < PA_MAXG; ++g)
            if (g < a.G)
#pragma unroll
                for (int i = 0; i < 4; ++i) red[warp][g][4 * lane + i] = acc[g][i];
    }
    __syncthreads();
    const float pv = *pv_p;
    for (int e = threadIdx.x; e < a.G * a.dh; e += blockDim.x) {
        const int g = e / a.dh, d = e - g * a.dh;
        int tot = 0;
        for (int w = 0; w < PA_WARPS; ++w) tot += red[w][g][d];
        out[((long long)b * H + kvh * a.G + g) * a.dh + d] = (float)tot * pv;
    }
}

static PaArgs make_args(const void* q8, const void* kp, const void* vp,
                        const void* table, const void* qpos,
                        const void* tvalid, const void* kq, float sm_scale,
                        int P, int page, int KV, int G, int dh, int NB) {
    PaArgs a;
    a.q8 = (const int8_t*)q8; a.kp = (const int8_t*)kp;
    a.vp = (const int8_t*)vp; a.table = (const int32_t*)table;
    a.qpos = (const int32_t*)qpos; a.tvalid = (const int32_t*)tvalid;
    a.kq = (const float*)kq; a.sm_scale = sm_scale;
    a.P = P; a.page = page; a.KV = KV; a.G = G; a.dh = dh; a.NB = NB;
    return a;
}

// dh must be a multiple of 4 and <= 128, G <= 8 (the wrapper checks)
extern "C" int pa_stats_launch(const void* q8, const void* kp,
                               const void* table, const void* qpos,
                               const void* tvalid, const void* kq,
                               float sm_scale, int B, int P, int page, int KV,
                               int G, int dh, int NB, void* m_out, void* l_out,
                               void* stream) {
    if (B <= 0) return 0;
    PaArgs a = make_args(q8, kp, nullptr, table, qpos, tvalid, kq, sm_scale,
                         P, page, KV, G, dh, NB);
    pa_stats<<<dim3(B, KV), PA_WARPS * 32, 0, (cudaStream_t)stream>>>(
        a, (float*)m_out, (float*)l_out);
    return (int)cudaGetLastError();
}

extern "C" int pa_out_launch(const void* q8, const void* kp, const void* vp,
                             const void* table, const void* qpos,
                             const void* tvalid, const void* kq,
                             float sm_scale, int B, int P, int page, int KV,
                             int G, int dh, int NB, const void* m_in,
                             const void* l_in, const void* pinv,
                             const void* pv, float s_grid, float lim,
                             void* out, void* p8_out, void* stream) {
    if (B <= 0) return 0;
    PaArgs a = make_args(q8, kp, vp, table, qpos, tvalid, kq, sm_scale, P,
                         page, KV, G, dh, NB);
    pa_out<<<dim3(B, KV), PA_WARPS * 32, 0, (cudaStream_t)stream>>>(
        a, (const float*)m_in, (const float*)l_in, (const float*)pinv,
        (const float*)pv, s_grid, lim, (float*)out, (int8_t*)p8_out);
    return (int)cudaGetLastError();
}
