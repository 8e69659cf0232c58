// K6: paged int8 decode attention over each lane's live positions, in
// three launches with nothing between them.
//
// Replaces repro/kernels/paged_attention.py::paged_attention
// (_decode_ml_kernel and _decode_out_kernel).  On this slice it is every
// decode step's attention and each token of a ragged prompt tail (B = 1).
//
//   pa_scores   grid (spans, KV, B): the masked scores of one span of a
//               lane's positions for the g query heads of a KV head go to a
//               workspace, with the span's max per head; the blocks also
//               zero the accumulator and counters of the next two launches.
//   pa_exp      same grid: each head's row max m is the max of its span
//               maxima; exp(s - m) overwrites the span's scores and its
//               float64 sum goes to the workspace.  The last block of a
//               (lane, KV head) adds the spans' sums in span order into l;
//               the last of those over the batch forms the probability
//               step from the batch-global amax, round(max 1/l * 2^(k-1)) /
//               2^(k-1), pow2_ceil, as kernels/paged_attention.py does
//               between its two pallas_calls.
//   pa_out      same grid: p = exp(s - m) / l onto the Q_A grid, p8 =
//               clip(rint(p * pinv)), the span's int32 p.v added into the
//               accumulator with integer atomics (exact in any order); the
//               last block of a (lane, KV head) writes the output (B, H, dh)
//               fp32 = acc * (step * v_scale).
//
// Bound: bytes.  Per lane the K and V rows of its live positions are the
// data; the scores are a few int8 dot products per byte.  Design:
//   * Only live positions are swept.  A lane's positions past end =
//     min(q_pos + 1, t_valid, T) are masked to -1e9; once a live score
//     exists, exp(-1e9 - m) is exactly 0, so they add 0 to l and to p.v
//     and their p8 is 0: stopping the sweep at `end` is exact.  That needs
//     every live score above -1e9 + 200, which the scales bound (|score|
//     <= 128 * 128 * dh * |q_scale * k_scale| * sm_scale, checked in
//     sweep_len); where that bound fails, and for a lane with no live
//     position (end <= 0: m = -1e9, every p equal), the lane sweeps all T
//     positions as the plain version does.
//   * Spans of 32, 64 or 128 positions (the wrapper picks from the shapes
//     alone) make the grid B x KV x spans, so four lanes fill the card;
//     blocks past a lane's end leave at once.
//   * K and V rows reach shared memory by 16-byte cp.async; a thread holds
//     one K row in registers and takes its dot products with the group's
//     query rows (shared memory, read as broadcasts) by __dp4a.  Any number
//     of query heads per KV head (up to 64) takes the same path.  p.v takes
//     four positions per __dp4a.
//   * Each score is computed once and its exp once, every span in
//     parallel.  m is exact (a max); l is a float64 sum rounded once, in a
//     fixed order, as the plain version's float64 sum (which agrees unless
//     the sum lands within its own rounding error of an fp32 tie).  exp is
//     taken in float64 and rounded once on both sides; the divisions are
//     fp32 __fdiv_rn, the correctly rounded quotient, which is the plain
//     version's float64 quotient rounded once (53 >= 2 * 24 + 2; ubn.cu's
//     fp32_check holds the two equal on the card).  So the kernel and its
//     plain version agree bit for bit.
//   * The glue between the TPU kernel's two passes runs in pa_exp's last
//     block: no PyTorch op between the launches.
#include <cuda_runtime.h>
#include <stdint.h>

#define PA_THREADS 128
#define NEG_INF_F (-1e9f)

struct PaArgs {
    const int8_t* q8;        // (B, H, dh)
    const int8_t* kp;        // (P, page, KV, dh)
    const int8_t* vp;        // (P, page, KV, dh)
    const int32_t* table;    // (B, NB)
    const int32_t* qpos;     // (B,)
    const int32_t* tvalid;   // scalar, or null: then tv_imm
    const float* qs;         // scalars: q, k and v payload scales
    const float* ks;
    const float* vs;
    float sm_scale, s_grid, lim;
    int tv_imm;
    int B, P, page, KV, G, dh, NB, T, span, nspan;
    int* acc;                // (B, H, dh) int32 p.v, zeroed by pa_scores
    int* cnt;                // 2 * B * KV + 1 counters, zeroed likewise
    long long zero16;        // 16-byte words of acc and cnt
    float* glue;             // [pinv, pv]
    float* m_out;            // (B, H)
    float* l_out;            // (B, H)
    double* lsum;            // (B, H, nspan) the spans' sums of exp
    float* smax;             // (B, H, nspan) span maxima
    float* e;                // (B, H, T) scores, then exp(s - m)
    float* out;              // (B, H, dh)
    int8_t* p8_out;          // (B, H, T) or null
};

__device__ __forceinline__ float exp32(float x) { return (float)exp((double)x); }

__device__ __forceinline__ float warp_fmax(float v) {
    for (int o = 16; o > 0; o >>= 1)
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

__device__ __forceinline__ double warp_dsum(double v) {
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp16(void* dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_wait_all() {
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n"
                 ::: "memory");
}

// smallest power of two >= m, 1 for m <= 0, from the exponent bits
__device__ __forceinline__ float pow2_ceil(float m) {
    if (!(m > 0.f)) return 1.f;
    int ex;
    const float mant = frexpf(m, &ex);
    if (mant == 0.5f) ex -= 1;
    ex = max(-126, min(127, ex));
    return __int_as_float((ex + 127) << 23);
}

__device__ __forceinline__ int t_valid(const PaArgs& a) {
    return a.tvalid != nullptr ? *a.tvalid : a.tv_imm;
}

// positions lane b sweeps (kernels/ops.py pa_sweep repeats this)
__device__ __forceinline__ int sweep_len(const PaArgs& a, int b, float kq) {
    long long end = (long long)a.qpos[b] + 1;
    const long long tv = t_valid(a);
    if (tv < end) end = tv;
    if ((long long)a.T < end) end = a.T;
    const double big = 16384.0 * a.dh * fabs((double)kq)
                       * fabs((double)a.sm_scale);
    return (end > 0 && big < 9.0e8) ? (int)end : a.T;
}

// shared-memory pitch of a K row: an odd number of 16-byte units, so the
// threads of a quarter warp reading one unit of their own rows hit
// different banks
__device__ __forceinline__ int kpitch(int dh) {
    return ((dh >> 4) & 1) ? dh : dh + 16;
}

__device__ __forceinline__ long long row_off(const PaArgs& a, int b, int kvh,
                                             int t) {
    const int j = t / a.page, off = t - j * a.page;
    int pid = a.table[(long long)b * a.NB + j];
    pid = pid < 0 ? 0 : (pid >= a.P ? a.P - 1 : pid);
    return (((long long)pid * a.page + off) * a.KV + kvh) * a.dh;
}

// 16-byte rows of positions [t0, t0 + n) of (b, kvh) into dst (pitch bytes
// a row)
__device__ __forceinline__ void stage_rows(const PaArgs& a, const int8_t* pool,
                                           int8_t* dst, int pitch, int b,
                                           int kvh, int t0, int n) {
    const int cpr = a.dh >> 4;
    for (int i = threadIdx.x; i < n * cpr; i += PA_THREADS) {
        const int r = i / cpr, c = i - r * cpr;
        cp16(dst + r * pitch + 16 * c, pool + row_off(a, b, kvh, t0 + r) + 16 * c);
    }
}

// true in every thread of the block that arrives last at counter *c, of
// `want` arrivals; every block's global writes before the call are visible
// to it (a block barrier, then one thread's fence and atomic, as
// cooperative groups' grid barrier does)
__device__ __forceinline__ bool last_block(int* c, int want) {
    __shared__ int last;
    __syncthreads();
    if (threadIdx.x == 0) {
        __threadfence();
        last = atomicAdd(c, 1) == want - 1;
        if (last) __threadfence();
    }
    __syncthreads();
    return last;
}

// MAXC: 16-byte units of the longest K row a thread keeps in registers
// (8 for dh <= 128, 16 for dh <= 256)
template <int MAXC>
__global__ void __launch_bounds__(PA_THREADS) pa_scores(PaArgs a) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int span = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    {   // the next launches' accumulator and counters, over the grid
        const long long nblk = (long long)gridDim.x * gridDim.y * gridDim.z;
        const long long bid = span + (long long)gridDim.x
                              * (kvh + (long long)gridDim.y * b);
        for (long long i = bid * PA_THREADS + tid; i < a.zero16;
             i += nblk * PA_THREADS)
            reinterpret_cast<int4*>(a.acc)[i] = make_int4(0, 0, 0, 0);
    }
    const float kq = (*a.qs) * (*a.ks);
    const int sw = sweep_len(a, b, kq);
    const int t0 = span * a.span;
    if (t0 >= sw) return;
    const int n = min(a.span, sw - t0);
    const int G = a.G, dh = a.dh, H = a.KV * G, pitch = kpitch(dh);
    const int cpr = dh >> 4;
    const long long row0 = (long long)b * H + kvh * G;
    int8_t* sq = (int8_t*)smem;                        // G x dh
    int8_t* sk = sq + G * dh;                          // span x pitch
    float* ss = (float*)(sk + a.span * pitch);         // G x span
    stage_rows(a, a.kp, sk, pitch, b, kvh, t0, n);
    const int4* qsrc = (const int4*)(a.q8 + row0 * dh);
    for (int i = tid; i < G * cpr; i += PA_THREADS) ((int4*)sq)[i] = qsrc[i];
    cp_wait_all();
    __syncthreads();

    // scores: thread (position p, heads g0, g0 + hs, ..), its K row in
    // registers, each query row read from shared memory as a broadcast
    const int hs = PA_THREADS / a.span, p = tid % a.span, g0 = tid / a.span;
    if (p < n) {
        const int t = t0 + p;
        const bool ok = t <= a.qpos[b] && t < t_valid(a);
        int4 kr[MAXC];
        const int4* krow = (const int4*)(sk + p * pitch);
#pragma unroll
        for (int c = 0; c < MAXC; ++c)
            if (c < cpr) kr[c] = krow[c];
        for (int g = g0; g < G; g += hs) {
            const int4* qr = (const int4*)(sq + g * dh);
            int acc = 0;
#pragma unroll
            for (int c = 0; c < MAXC; ++c) {
                if (c < cpr) {
                    const int4 q = qr[c];
                    acc = __dp4a(kr[c].x, q.x, acc);
                    acc = __dp4a(kr[c].y, q.y, acc);
                    acc = __dp4a(kr[c].z, q.z, acc);
                    acc = __dp4a(kr[c].w, q.w, acc);
                }
            }
            ss[g * a.span + p] = ok ? ((float)acc * kq) * a.sm_scale
                                    : NEG_INF_F;
        }
    }
    __syncthreads();
    float* erow = a.e + row0 * a.T + t0;
    for (int i = tid; i < G * n; i += PA_THREADS) {
        const int g = i / n, q = i - g * n;
        erow[(long long)g * a.T + q] = ss[g * a.span + q];
    }
    for (int g = warp; g < G; g += PA_THREADS / 32) {
        float mx = -3.402823466e38f;
        for (int q = lane; q < n; q += 32) mx = fmaxf(mx, ss[g * a.span + q]);
        mx = warp_fmax(mx);
        if (lane == 0) a.smax[(row0 + g) * a.nspan + span] = mx;
    }
}

__global__ void __launch_bounds__(PA_THREADS) pa_exp(PaArgs a) {
    __shared__ float red[PA_THREADS / 32];
    const int span = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int sw = sweep_len(a, b, (*a.qs) * (*a.ks));
    const int t0 = span * a.span;
    if (t0 >= sw) return;
    const int n = min(a.span, sw - t0), nsp = (sw + a.span - 1) / a.span;
    const int G = a.G, H = a.KV * G;
    const long long row0 = (long long)b * H + kvh * G;
    // a warp per head: m, exp(s - m) over the span (over the scores) and
    // their float64 sum, lane-strided in order; the span's scores and the
    // span maxima are loaded together
    for (int g = warp; g < G; g += PA_THREADS / 32) {
        float* er = a.e + (row0 + g) * a.T + t0;
        float x[4];                                  // span <= 128
#pragma unroll
        for (int u = 0; u < 4; ++u)
            if (lane + 32 * u < n) x[u] = er[lane + 32 * u];
        float mx = -3.402823466e38f;
        const float* sp = a.smax + (row0 + g) * a.nspan;
        for (int s = lane; s < nsp; s += 32) mx = fmaxf(mx, sp[s]);
        mx = warp_fmax(mx);
        if (sw < a.T) mx = fmaxf(mx, NEG_INF_F);   // the masked rest's score
        double sum = 0.0;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            if (lane + 32 * u < n) {
                const float y = exp32(x[u] - mx);
                er[lane + 32 * u] = y;
                sum += (double)y;
            }
        }
        sum = warp_dsum(sum);
        if (lane == 0) {
            a.lsum[(row0 + g) * a.nspan + span] = sum;
            if (span == 0) a.m_out[row0 + g] = mx;
        }
    }
    if (!last_block(a.cnt + b * a.KV + kvh, nsp)) return;
    // the row's last block: l, the spans' sums added in span order
    for (int g = tid; g < G; g += PA_THREADS) {
        const double* ls = a.lsum + (row0 + g) * a.nspan;
        double l = 0.0;
        for (int s0 = 0; s0 < nsp; s0 += 16) {
            double x[16];
#pragma unroll
            for (int u = 0; u < 16; ++u)
                x[u] = s0 + u < nsp ? __ldcg(ls + s0 + u) : 0.0;
#pragma unroll
            for (int u = 0; u < 16; ++u)
                if (s0 + u < nsp) l += x[u];
        }
        a.l_out[row0 + g] = (float)l;
    }
    if (!last_block(a.cnt + 2 * a.B * a.KV, a.B * a.KV)) return;
    // the batch's last block: max p of a row is exp(0) / l = 1 / l, so the
    // GridQuantizer amax of the quantized probabilities reduces over l;
    // round(amax * 2^(k-1)) / 2^(k-1), pow2_ceil with a 2^-24 floor, times
    // 2^(1-k)
    float mx = 0.f;
    for (int i = tid; i < a.B * H; i += PA_THREADS)
        mx = fmaxf(mx, __fdiv_rn(1.f, __ldcg(a.l_out + i)));
    mx = warp_fmax(mx);
    if (lane == 0) red[warp] = mx;
    __syncthreads();
    if (tid == 0) {
        for (int w = 0; w < PA_THREADS / 32; ++w) mx = fmaxf(mx, red[w]);
        const float amax = rintf(mx * a.s_grid) / a.s_grid;
        const float step = fmaxf(pow2_ceil(amax), 5.9604644775390625e-08f)
                           / a.s_grid;
        a.glue[0] = __fdiv_rn(1.f, step);
        a.glue[1] = step * (*a.vs);
    }
}

__global__ void __launch_bounds__(PA_THREADS) pa_out(PaArgs a) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int span = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
    const int tid = threadIdx.x;
    const float kq = (*a.qs) * (*a.ks);
    const int sw = sweep_len(a, b, kq);
    const int G = a.G, dh = a.dh, H = a.KV * G;
    const long long row0 = (long long)b * H + kvh * G;
    const int t0 = span * a.span, tend = min(t0 + a.span, a.T);
    const int n = max(0, min(a.span, sw - t0));
    int8_t* sv = (int8_t*)smem;                        // span x dh
    int8_t* sp = sv + a.span * dh;                     // G x span p8 codes
    if (n > 0) stage_rows(a, a.vp, sv, dh, b, kvh, t0, n);
    const float pinv = a.glue[0], pv = a.glue[1];
    // probability codes; 0 past the sweep, where the plain version's p is 0
    for (int i = tid; i < G * a.span; i += PA_THREADS) {
        const int g = i / a.span, q = i - g * a.span;
        int code = 0;
        if (q < n) {
            const float pr = __fdiv_rn(a.e[(row0 + g) * a.T + t0 + q],
                                       a.l_out[row0 + g]);
            const float pg = rintf(pr * a.s_grid) / a.s_grid;   // Q_A grid
            code = (int)fminf(fmaxf(rintf(pg * pinv), -a.lim), a.lim);
        }
        sp[g * a.span + q] = (int8_t)code;      // 0 past the sweep
        if (a.p8_out != nullptr && t0 + q < tend)
            a.p8_out[(row0 + g) * a.T + t0 + q] = (int8_t)code;
    }
    if (n == 0) return;
    cp_wait_all();
    __syncthreads();
    // int32 p.v of the span: thread (head g, dims 4w..4w+3) over its
    // positions four at a time: the four codes are one word, the four V
    // words transpose bytewise into one word a dim, and __dp4a takes each
    // (codes past n are 0, so the rows past n that were not staged add 0)
    const int nw = dh >> 2;
    for (int i = tid; i < G * nw; i += PA_THREADS) {
        const int g = i / nw, w = i - g * nw;
        const int* pc = reinterpret_cast<const int*>(sp + g * a.span);
        int a0 = 0, a1 = 0, a2 = 0, a3 = 0;
        for (int q = 0; q < n; q += 4) {
            const int c = pc[q >> 2];
            if (c == 0) continue;             // four codes of 0 add nothing
            const int* vr = reinterpret_cast<const int*>(sv + q * dh) + w;
            const int r0 = vr[0], r1 = vr[nw], r2 = vr[2 * nw], r3 = vr[3 * nw];
            const int lo01 = __byte_perm(r0, r1, 0x5140);
            const int hi01 = __byte_perm(r0, r1, 0x7362);
            const int lo23 = __byte_perm(r2, r3, 0x5140);
            const int hi23 = __byte_perm(r2, r3, 0x7362);
            a0 = __dp4a(c, (int)__byte_perm(lo01, lo23, 0x5410), a0);
            a1 = __dp4a(c, (int)__byte_perm(lo01, lo23, 0x7632), a1);
            a2 = __dp4a(c, (int)__byte_perm(hi01, hi23, 0x5410), a2);
            a3 = __dp4a(c, (int)__byte_perm(hi01, hi23, 0x7632), a3);
        }
        int* dst = a.acc + (row0 + g) * dh + 4 * w;
        if (a0) atomicAdd(dst, a0);
        if (a1) atomicAdd(dst + 1, a1);
        if (a2) atomicAdd(dst + 2, a2);
        if (a3) atomicAdd(dst + 3, a3);
    }
    const int nsp = (sw + a.span - 1) / a.span;
    if (!last_block(a.cnt + a.B * a.KV + b * a.KV + kvh, nsp)) return;
    for (int i = tid; i < G * dh; i += PA_THREADS)
        a.out[row0 * dh + i] = (float)__ldcg(a.acc + row0 * dh + i) * pv;
}

static size_t smem_scores(int G, int dh, int span) {
    return (size_t)G * dh + (size_t)span * (((dh >> 4) & 1) ? dh : dh + 16)
           + (size_t)G * span * 4;
}

static size_t smem_out(int G, int dh, int span) {
    return (size_t)span * dh + (size_t)G * span;
}

// dh % 16 == 0, dh <= 256, G <= 64, span in {32, 64, 128}, 16-byte aligned
// q8 and pools, and the workspace laid out by kernels/ops.py pa_layout (the
// wrapper checks); its first `zero_bytes` (accumulator and counters) are
// zeroed by pa_scores
extern "C" int pa_launch(const void* q8, const void* kp, const void* vp,
                         const void* table, const void* qpos,
                         const void* tvalid, int tv_imm, const void* qs,
                         const void* ks, const void* vs, float sm_scale,
                         float s_grid,
                         float lim, int B, int P, int page, int KV, int G,
                         int dh, int NB, int span, void* ws, long long zero_bytes,
                         long long off_glue, long long off_ml,
                         long long off_lsum, long long off_smax,
                         long long off_e, void* out,
                         void* p8_out, void* stream) {
    if (B <= 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    PaArgs a;
    a.q8 = (const int8_t*)q8; a.kp = (const int8_t*)kp;
    a.vp = (const int8_t*)vp; a.table = (const int32_t*)table;
    a.qpos = (const int32_t*)qpos; a.tvalid = (const int32_t*)tvalid;
    a.tv_imm = tv_imm;
    a.qs = (const float*)qs; a.ks = (const float*)ks; a.vs = (const float*)vs;
    a.sm_scale = sm_scale; a.s_grid = s_grid; a.lim = lim;
    a.B = B; a.P = P; a.page = page; a.KV = KV; a.G = G; a.dh = dh;
    a.NB = NB; a.T = NB * page; a.span = span;
    a.nspan = (a.T + span - 1) / span;
    char* w = (char*)ws;
    const long long H = (long long)KV * G;
    a.acc = (int*)w;
    a.cnt = (int*)(w + 4 * B * H * dh);
    a.zero16 = zero_bytes / 16;
    a.glue = (float*)(w + off_glue);
    a.lsum = (double*)(w + off_lsum);
    a.m_out = (float*)(w + off_ml);
    a.l_out = a.m_out + B * H;
    a.smax = (float*)(w + off_smax);
    a.e = (float*)(w + off_e);
    a.out = (float*)out;
    a.p8_out = (int8_t*)p8_out;
    cudaError_t err;
    const size_t s1 = smem_scores(G, dh, span), s2 = smem_out(G, dh, span);
    void (*scores)(PaArgs) = dh <= 128 ? pa_scores<8> : pa_scores<16>;
    static size_t s1_set[2] = {48 * 1024, 48 * 1024}, s2_set = 48 * 1024;
    size_t& s1_cur = s1_set[dh <= 128 ? 0 : 1];
    if (s1 > s1_cur) {
        err = cudaFuncSetAttribute(scores,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)s1);
        if (err != cudaSuccess) return (int)err;
        s1_cur = s1;
    }
    if (s2 > s2_set) {
        err = cudaFuncSetAttribute(pa_out,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)s2);
        if (err != cudaSuccess) return (int)err;
        s2_set = s2;
    }
    const dim3 grid(a.nspan, KV, B);
    scores<<<grid, PA_THREADS, s1, st>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    pa_exp<<<grid, PA_THREADS, 0, st>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    pa_out<<<grid, PA_THREADS, s2, st>>>(a);
    return (int)cudaGetLastError();
}
