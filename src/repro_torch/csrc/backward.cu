// K3: the two Alg. 2 backward dots with Q_E2 fused into the prologue.
//
// Replaces repro/kernels/backward.py::bwd_dgrad and ::bwd_wgrad
// (_quantize_block and _bwd_kernel).  On this slice they are the backward
// of every qdense of the training step (wq, wk, wv, wo, w_gate, w_up,
// w_down): dgrad is the input error e4 = e3 . W^T, wgrad the weight
// gradient g_W = x0^T . e3, where e3 = Q_E2(g) is never stored: each block
// loads fp32 error tiles and quantizes them in registers into the payload
// plane(s), as the TPU kernel does in VMEM.
//
//   dgrad  g (M, N) f32, b8 (K, N) int8 -> (M, K) f32, contraction over N
//   wgrad  a8 (M, K) int8, g (M, N) f32 -> (K, N) f32, contraction over M
//
// Prologue modes (scal = [inv, s1, s2] on the device, no host sync):
//   affine k <= 8   one int8 plane clip(rint(g * inv), +-lim)
//   affine k = 16   one int16 plane; Hopper has no int16 tensor-core path,
//                   so each payload q splits into q = 256 * hi + lo with
//                   hi = q >> 8 (s8) and lo = q & 255 (u8), the two halves
//                   run as s8.s8 and u8.s8 (or s8.u8) mma.sync products, and
//                   256 * acc_hi + acc_lo is combined in wrapping 32-bit
//                   arithmetic: exactly the int32 sum, wrap included, that
//                   the reference's int16 x int8 -> int32 einsum gives
//   flag  k = 8     the two disjoint int8 planes of Eq. 17 (the isbig
//                   regime split of backward.py:55-61), one accumulator each
// Epilogue: out = acc1 * s1 (+ acc2 * s2), fp32, built with -fmad=false.
//
// Bound: operations at the training shapes (M = 4096 tokens: each error
// element feeds K multiply-adds).  Design (right first, not yet fast): 64x64
// output tiles, 4 warps of 32x32 each on int8 mma.sync m16n8k32, 64-deep
// contraction steps staged in shared memory with 80-byte rows.  dgrad's
// operands are both contiguous along the contraction; wgrad contracts over
// the slow axis of a8 and g, so both tiles are transposed 4x4 bytes at a
// time with __byte_perm (as K1 stages its column operand).  When the tiles
// cannot fill the card the contraction splits across blocks and the int32
// partials meet by atomicAdd (exact, order-free modulo 2^32) in a workspace
// that a second launch scales.  wgmma and TMA come later.
#include <cuda_runtime.h>
#include <stdint.h>

#define BM 64
#define BN 64
#define BK 64
#define LDS 80

enum { AFF8 = 0, AFF16 = 1, FLAG = 2 };

template <bool AU, bool BU>
__device__ __forceinline__ void mma8(int* c, const int* a, const int* b) {
    if (!AU && !BU)
        asm volatile(
            "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
              "r"(b[1]));
    else if (AU)
        asm volatile(
            "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
              "r"(b[1]));
    else
        asm volatile(
            "mma.sync.aligned.m16n8k32.row.col.s32.s8.u8.s32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
              "r"(b[1]));
}

// One error element -> its payload bytes: plane 0 (s8: the affine payload,
// its high half at k = 16, or the flag hi plane) and plane 1 (the u8 low
// half at k = 16, or the flag lo plane; 0 for affine k <= 8).
template <int MODE>
__device__ __forceinline__ void quant_e(float g, float inv, float lim,
                                       uint32_t& p0, uint32_t& p1) {
    if (MODE == FLAG) {
        const float n = __fmul_rn(g, inv);
        const float nlo = rintf(__fmul_rn(n, lim + 1.0f));
        const bool big = fabsf(n) >= 1.0f || fabsf(nlo) >= lim + 1.0f;
        const float hi = big ? fminf(fmaxf(rintf(n), -lim), lim) : 0.0f;
        const float lo = big ? 0.0f : fminf(fmaxf(nlo, -lim), lim);
        p0 = (uint32_t)(uint8_t)(int8_t)(int)hi;
        p1 = (uint32_t)(uint8_t)(int8_t)(int)lo;
    } else {
        const int q = (int)fminf(fmaxf(rintf(__fmul_rn(g, inv)), -lim), lim);
        if (MODE == AFF16) {
            p0 = (uint32_t)(uint8_t)(int8_t)(q >> 8);
            p1 = (uint32_t)(q & 255);
        } else {
            p0 = (uint32_t)(uint8_t)(int8_t)q;
            p1 = 0u;
        }
    }
}

// transpose a 4x4 block of bytes: r[i] holds row i's 4 bytes; w[j] gets
// column j's 4 bytes (row 0 in the low byte)
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

__device__ __forceinline__ float4 load_g4(const float* g, long long ld,
                                          int row, int col, int rows,
                                          int cols, int kend_col, int gvec) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row >= rows) return v;
    const float* src = g + (long long)row * ld + col;
    if (gvec && col + 4 <= kend_col) return *reinterpret_cast<const float4*>(src);
    float t[4] = {0.f, 0.f, 0.f, 0.f};
    for (int j = 0; j < 4; ++j)
        if (col + j < kend_col && col + j < cols) t[j] = src[j];
    return make_float4(t[0], t[1], t[2], t[3]);
}

// DGRAD: C (M x Kout) = Qe(G (M x N)) . B8 (Kout x N)^T, contraction N.
// WGRAD: C (Kout x N) = A8 (M x Kout)^T . Qe(G (M x N)), contraction M.
// Rows of C index the mma's A operand, columns its B operand.
template <int MODE, bool DGRAD>
__global__ void __launch_bounds__(128)
bwd_kernel(const float* __restrict__ G, const int8_t* __restrict__ X8,
           const float* __restrict__ scal, float* __restrict__ out,
           int32_t* __restrict__ ws1, int32_t* __restrict__ ws2, float lim,
           int M, int N, int Kd, int splits, int kchunk, int gvec, int xvec) {
    constexpr int NP = MODE == AFF8 ? 1 : 2;
    __shared__ __align__(16) uint8_t As[NP][BM * LDS];   // As[row][c]
    __shared__ __align__(16) uint8_t Bs[NP][BN * LDS];   // Bs[col][c]
    const int rows = DGRAD ? M : Kd, cols = DGRAD ? Kd : N;
    const int depth = DGRAD ? N : M;
    const int split = blockIdx.z;
    const int r0 = blockIdx.y * BM, c0 = blockIdx.x * BN;
    const int kbeg = split * kchunk, kend = min(depth, kbeg + kchunk);
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
    const int g = lane >> 2, tg = lane & 3;
    const float inv = scal[0];

    int acc[NP][2][4][4];
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[p][i][j][e] = 0;

    for (int k0 = kbeg; k0 < kend; k0 += BK) {
        if (DGRAD) {
            // A: Qe(G) rows r0.., contraction cols k0..; 8 float4 per thread
#pragma unroll
            for (int it = 0; it < 8; ++it) {
                const int u = tid + it * 128, r = u >> 4, c = (u & 15) * 4;
                const float4 v = load_g4(G, N, r0 + r, k0 + c, M, N, kend, gvec);
                uint32_t w0 = 0u, w1 = 0u;
                const float e4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    uint32_t p0, p1;
                    quant_e<MODE>(e4[j], inv, lim, p0, p1);
                    if (r0 + r >= M || k0 + c + j >= kend) p0 = p1 = 0u;
                    w0 |= p0 << (8 * j);
                    w1 |= p1 << (8 * j);
                }
                *reinterpret_cast<uint32_t*>(&As[0][r * LDS + c]) = w0;
                if (NP == 2) *reinterpret_cast<uint32_t*>(&As[NP - 1][r * LDS + c]) = w1;
            }
            // B: b8 rows c0.. (Kout), contraction cols k0..; 16-byte chunks
#pragma unroll
            for (int it = 0; it < 2; ++it) {
                const int u = tid + it * 128, r = u >> 2, kc = (u & 3) * 16;
                const int gr = c0 + r, gk = k0 + kc;
                int4 v = make_int4(0, 0, 0, 0);
                if (gr < Kd) {
                    const int8_t* src = X8 + (long long)gr * N + gk;
                    if (xvec && gk + 16 <= kend) {
                        v = *reinterpret_cast<const int4*>(src);
                    } else {
                        uint32_t w[4] = {0u, 0u, 0u, 0u};
                        for (int i = 0; i < 16; ++i)
                            if (gk + i < kend)
                                w[i >> 2] |= (uint32_t)(uint8_t)src[i] << (8 * (i & 3));
                        v = make_int4((int)w[0], (int)w[1], (int)w[2], (int)w[3]);
                    }
                }
                *reinterpret_cast<int4*>(&Bs[0][r * LDS + kc]) = v;
            }
        } else {
            // A: a8 (M x Kout) tile, m = k0.. (contraction), kout = r0..;
            // 4x4-byte units transposed into As[kout][m]
#pragma unroll
            for (int it = 0; it < 2; ++it) {
                const int u = tid + it * 128, mq = u >> 4, kq = u & 15;
                const int gm = k0 + mq * 4, gk = r0 + kq * 4;
                uint32_t r[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    r[i] = 0u;
                    if (gm + i < kend) {
                        const int8_t* src = X8 + (long long)(gm + i) * Kd + gk;
                        if (xvec && gk + 4 <= Kd) {
                            r[i] = *reinterpret_cast<const uint32_t*>(src);
                        } else {
                            for (int j = 0; j < 4; ++j)
                                if (gk + j < Kd)
                                    r[i] |= (uint32_t)(uint8_t)src[j] << (8 * j);
                        }
                    }
                }
                uint32_t w[4];
                transpose4(r, w);
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    *reinterpret_cast<uint32_t*>(&As[0][(kq * 4 + j) * LDS + mq * 4]) = w[j];
            }
            // B: Qe(G) tile, m = k0.. (contraction), n = c0..; quantized,
            // then transposed into Bs[plane][n][m]
#pragma unroll
            for (int it = 0; it < 2; ++it) {
                const int u = tid + it * 128, mq = u >> 4, nq = u & 15;
                const int gm = k0 + mq * 4, gn = c0 + nq * 4;
                uint32_t r0w[4], r1w[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    r0w[i] = 0u;
                    r1w[i] = 0u;
                    if (gm + i >= kend) continue;
                    const float4 v = load_g4(G, N, gm + i, gn, M, N, N, gvec);
                    const float e4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        uint32_t p0, p1;
                        quant_e<MODE>(e4[j], inv, lim, p0, p1);
                        if (gn + j >= N) p0 = p1 = 0u;
                        r0w[i] |= p0 << (8 * j);
                        r1w[i] |= p1 << (8 * j);
                    }
                }
                uint32_t w[4];
                transpose4(r0w, w);
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    *reinterpret_cast<uint32_t*>(&Bs[0][(nq * 4 + j) * LDS + mq * 4]) = w[j];
                if (NP == 2) {
                    transpose4(r1w, w);
#pragma unroll
                    for (int j = 0; j < 4; ++j)
                        *reinterpret_cast<uint32_t*>(&Bs[NP - 1][(nq * 4 + j) * LDS + mq * 4]) = w[j];
                }
            }
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; kk += 32) {
            int af[NP][2][4], bf[NP][4][2];
#pragma unroll
            for (int p = 0; p < NP; ++p) {
                // dgrad's second plane lives in A, wgrad's in B
                const int pa = DGRAD ? p : 0, pb = DGRAD ? 0 : p;
#pragma unroll
                for (int mi = 0; mi < 2; ++mi) {
                    const uint8_t* base = &As[pa][(wm + mi * 16 + g) * LDS + kk + tg * 4];
                    af[p][mi][0] = *reinterpret_cast<const int*>(base);
                    af[p][mi][1] = *reinterpret_cast<const int*>(base + 8 * LDS);
                    af[p][mi][2] = *reinterpret_cast<const int*>(base + 16);
                    af[p][mi][3] = *reinterpret_cast<const int*>(base + 8 * LDS + 16);
                }
#pragma unroll
                for (int ni = 0; ni < 4; ++ni) {
                    const uint8_t* base = &Bs[pb][(wn + ni * 8 + g) * LDS + kk + tg * 4];
                    bf[p][ni][0] = *reinterpret_cast<const int*>(base);
                    bf[p][ni][1] = *reinterpret_cast<const int*>(base + 16);
                }
            }
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
#pragma unroll
                for (int ni = 0; ni < 4; ++ni) {
                    mma8<false, false>(acc[0][mi][ni], af[0][mi], bf[0][ni]);
                    if (NP == 2) {
                        if (MODE == AFF16 && DGRAD)
                            mma8<true, false>(acc[NP - 1][mi][ni], af[NP - 1][mi], bf[NP - 1][ni]);
                        else if (MODE == AFF16)
                            mma8<false, true>(acc[NP - 1][mi][ni], af[NP - 1][mi], bf[NP - 1][ni]);
                        else
                            mma8<false, false>(acc[NP - 1][mi][ni], af[NP - 1][mi], bf[NP - 1][ni]);
                    }
                }
        }
        __syncthreads();
    }

    const float s1 = scal[1], s2 = scal[2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int row = r0 + wm + mi * 16 + g + (e >= 2 ? 8 : 0);
                const int col = c0 + wn + ni * 8 + tg * 2 + (e & 1);
                if (row >= rows || col >= cols) continue;
                const long long o = (long long)row * cols + col;
                int v1 = acc[0][mi][ni][e], v2 = 0;
                if (MODE == AFF16) {
                    v1 = (int)((uint32_t)v1 * 256u + (uint32_t)acc[NP - 1][mi][ni][e]);
                } else if (MODE == FLAG) {
                    v2 = acc[NP - 1][mi][ni][e];
                }
                if (splits > 1) {
                    atomicAdd(ws1 + o, v1);
                    if (MODE == FLAG) atomicAdd(ws2 + o, v2);
                } else {
                    float y = __fmul_rn((float)v1, s1);
                    if (MODE == FLAG) y = __fadd_rn(y, __fmul_rn((float)v2, s2));
                    out[o] = y;
                }
            }
}

__global__ void bwd_epilogue(const int32_t* __restrict__ ws1,
                             const int32_t* __restrict__ ws2,
                             const float* __restrict__ scal,
                             float* __restrict__ out, long long n) {
    const float s1 = scal[1], s2 = scal[2];
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n; i += stride) {
        float y = __fmul_rn((float)ws1[i], s1);
        if (ws2 != nullptr) y = __fadd_rn(y, __fmul_rn((float)ws2[i], s2));
        out[i] = y;
    }
}

template <int MODE, bool DGRAD>
static void launch_mode(dim3 grid, cudaStream_t st, const float* g,
                        const int8_t* x8, const float* scal, float* out,
                        int32_t* ws1, int32_t* ws2, float lim, int M, int N,
                        int Kd, int splits, int kchunk, int gvec, int xvec) {
    bwd_kernel<MODE, DGRAD><<<grid, 128, 0, st>>>(
        g, x8, scal, out, ws1, ws2, lim, M, N, Kd, splits, kchunk, gvec,
        xvec);
}

// dgrad = 1: out (M, Kd) from g (M, N) and x8 = b8 (Kd, N);
// dgrad = 0: out (Kd, N) from x8 = a8 (M, Kd) and g (M, N).
// mode: 0 affine k <= 8, 1 affine k = 16, 2 flag.  With splits > 1 the
// caller passes zeroed int32 workspaces of the output's size (two for
// flag) and this launches the scaling pass after the products.
extern "C" int bwd_launch(const void* g, const void* x8, const void* scal,
                          void* out, void* ws1, void* ws2, int mode,
                          int dgrad, float lim, int M, int N, int Kd,
                          int splits, int kchunk, void* stream) {
    if (M <= 0 || N <= 0 || Kd <= 0) return 0;
    const int rows = dgrad ? M : Kd, cols = dgrad ? Kd : N;
    const int gvec = (N % 4 == 0) && ((uintptr_t)g % 16 == 0);
    const int xvec = dgrad ? ((N % 16 == 0) && ((uintptr_t)x8 % 16 == 0))
                           : ((Kd % 4 == 0) && ((uintptr_t)x8 % 4 == 0));
    dim3 grid((cols + BN - 1) / BN, (rows + BM - 1) / BM, splits);
    cudaStream_t st = (cudaStream_t)stream;
    const float* G = (const float*)g;
    const int8_t* X = (const int8_t*)x8;
    const float* S = (const float*)scal;
    float* O = (float*)out;
    int32_t* W1 = (int32_t*)ws1;
    int32_t* W2 = (int32_t*)ws2;
#define LAUNCH(MD, DG) launch_mode<MD, DG>(grid, st, G, X, S, O, W1, W2, lim, \
                                           M, N, Kd, splits, kchunk, gvec, xvec)
    if (dgrad) {
        if (mode == AFF8) LAUNCH(AFF8, true);
        else if (mode == AFF16) LAUNCH(AFF16, true);
        else LAUNCH(FLAG, true);
    } else {
        if (mode == AFF8) LAUNCH(AFF8, false);
        else if (mode == AFF16) LAUNCH(AFF16, false);
        else LAUNCH(FLAG, false);
    }
#undef LAUNCH
    int rc = (int)cudaGetLastError();
    if (rc != 0 || splits <= 1) return rc;
    const long long n = (long long)rows * cols;
    long long want = n / 256 + 1;
    const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
    bwd_epilogue<<<blocks, 256, 0, st>>>(W1, mode == FLAG ? W2 : nullptr, S,
                                         O, n);
    return (int)cudaGetLastError();
}
