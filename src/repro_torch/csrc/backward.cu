// K3: the two Alg. 2 backward dots with Q_E2 fused into their operand pass.
//
// Replaces repro/kernels/backward.py::bwd_dgrad and ::bwd_wgrad
// (_quantize_block and _bwd_kernel).  On this slice they are the backward
// of every qdense of the training step (wq, wk, wv, wo, w_gate, w_up,
// w_down): dgrad is the input error e4 = e3 . W^T, wgrad the weight
// gradient g_W = x0^T . e3, where e3 = Q_E2(g).
//
//   dgrad  g (M, N) f32, b8 (K, N) int8 -> (M, K) f32, contraction over N
//   wgrad  a8 (M, K) int8, g (M, N) f32 -> (K, N) f32, contraction over M
//
// Prologue modes (scal = [inv, s1, s2] on the device, no host sync):
//   affine k <= 8   one int8 plane clip(rint(g * inv), +-lim)
//   affine k = 16   one int16 plane; Hopper has no int16 tensor-core path,
//                   so each payload q splits into q = 256 * hi + lo with
//                   hi = q >> 8 (s8) and lo = q & 255 (u8), the two halves
//                   run as s8.s8 and u8.s8 (or s8.u8) wgmma products, and
//                   256 * acc_hi + acc_lo is combined in wrapping 32-bit
//                   arithmetic: exactly the int32 sum, wrap included, that
//                   the reference's int16 x int8 -> int32 einsum gives
//   flag  k = 8     the two disjoint int8 planes of Eq. 17 (the isbig
//                   regime split of backward.py:55-61), one accumulator each
// Epilogue: out = acc1 * s1 (+ acc2 * s2), fp32, built with -fmad=false.
//
// Bound: operations at the training shapes (M = 4096 tokens: each error
// element feeds K multiply-adds).  Design, in two launches (three with a
// split contraction):
//   1. operand pass (bwd_prep_rows / bwd_prep_cols, on the shared
//      op_prep_rows / op_prep_cols of hopper.cuh): every operand is
//      written once as 128 x 128-byte tiles, K-major, 128B-swizzled and
//      zero padded to whole tiles, in the byte image the tensor cores read:
//      dgrad's A = the Q_E2 plane(s) of g (quantized here, rows of g are
//      already K-major) and B = b8; wgrad's A = a8^T and B = the Q_E2
//      planes of g^T, transposed through shared memory.  int8 wgmma takes
//      no transposed operand, so wgrad's contraction over the slow axis of
//      both operands needs this transpose somewhere; doing it once here
//      rather than in every block's staging keeps the mainloop one plain
//      K-major product for all six (mode, dot) cases, and ragged M, N and
//      K become zero tiles that add nothing.  dgrad
//      takes the same pass: its planes cost 1 byte per error element of
//      traffic against the 4 of the fp32 error every block would
//      otherwise load again (the TPU kernel quantizes in VMEM; here the
//      int8 planes are the cheaper thing to re-read).  At 4096 x 12800 the
//      pass moves about 0.3 GB, some 0.1 ms against the 0.43 ms bound.
//   2. bwd_gemm: 128 x 128 output tiles (blocks ordered in groups of 8
//      row tiles for L2 reuse), one producer warpgroup and two consumer
//      warpgroups of 64 rows.  The producer's one thread streams
//      each 128-deep k step (all planes of it) into a 4-stage ring with one
//      cp.async.bulk per 16 KB tile, completing on the stage's mbarrier;
//      the consumers run wgmma m64n128k32 from shared memory (s8.s8, u8.s8
//      or s8.u8) into one int32 accumulator per plane and release the stage
//      on a second mbarrier.  When the tiles cannot fill the card the
//      contraction splits across blocks and the int32 partials meet by
//      atomicAdd (exact, order-free modulo 2^32) in a workspace that
//      bwd_epilogue scales.
#include "hopper.cuh"

#define TILE OP_TILE        // 128 rows x 128 bytes
#define STAGES 4
#define GROUP 8             // row tiles a run of consecutive blocks shares

// The operand pass (hopper.cuh): rows of the source (R, K) are the tile
// rows, or columns of the source (K, R) are.  SRC is COPY8 for the int8
// operand, the prologue mode for the error.
template <int SRC>
__global__ void __launch_bounds__(256)
bwd_prep_rows(const void* __restrict__ src, uint8_t* __restrict__ dst,
              const float* __restrict__ scal, float lim, int R, int K,
              int ktiles, long long pstride, int vec) {
    op_prep_rows<SRC>(src, dst, scal, lim, R, K, K, ktiles, pstride, vec);
}

template <int SRC>
__global__ void __launch_bounds__(256)
bwd_prep_cols(const void* __restrict__ src, uint8_t* __restrict__ dst,
              const float* __restrict__ scal, float lim, int R, int K,
              int ktiles, long long pstride, int vec) {
    op_prep_cols<SRC>(src, dst, scal, lim, R, K, R, ktiles, pstride, vec);
}

// C (rows x cols) = sum over planes of A_p . B_p^T from the tiled operands:
// dgrad's planes are in A (B = b8 shared), wgrad's in B (A = a8^T shared).
template <int MODE, bool DGRAD>
__global__ void __launch_bounds__(384, 1)
bwd_gemm(const uint8_t* __restrict__ A, const uint8_t* __restrict__ B,
         const float* __restrict__ scal, float* __restrict__ out,
         int32_t* __restrict__ ws1, int32_t* __restrict__ ws2, int rows,
         int cols, int ktiles, int kper, long long aps, long long bps,
         int splits) {
    constexpr int NP = MODE == AFF8 ? 1 : 2;
    constexpr int NA = DGRAD ? NP : 1, NB = DGRAD ? 1 : NP;
    constexpr int STAGE = (NA + NB) * TILE;
    extern __shared__ uint8_t raw[];
    uint8_t* sm = reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(raw) + 1023) & ~(uintptr_t)1023);
    uint64_t* full = reinterpret_cast<uint64_t*>(sm + STAGES * STAGE);
    uint64_t* empty = full + STAGES;
    // blocks in flight cover GROUP row tiles x a run of column tiles, so
    // both operands' panels stay in L2 (a plain row-major order streams
    // every column panel from device memory once per wave)
    const int rtn = (rows + 127) / 128, ctn = (cols + 127) / 128;
    const int first = (blockIdx.x / (GROUP * ctn)) * GROUP;
    const int gsz = min(rtn - first, GROUP);
    const int local = blockIdx.x % (GROUP * ctn);
    const int rt = first + local % gsz, ct = local / gsz;
    const int kt0 = blockIdx.y * kper;
    const int nkt = min(ktiles, kt0 + kper) - kt0;
    const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31;
    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], 8);        // one arrival per consumer warp
        }
        mbar_fence_init();
    }
    __syncthreads();

    if (wg == 0) {                          // producer
        regs_dec<40>();
        if (threadIdx.x == 0) {
            for (int i = 0; i < nkt; ++i) {
                const int s = i % STAGES;
                mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
                mbar_expect_tx(&full[s], STAGE);
                uint8_t* st = sm + s * STAGE;
                const long long kt = kt0 + i;
#pragma unroll
                for (int a = 0; a < NA; ++a)
                    bulk_g2s(st + a * TILE,
                             A + a * aps + ((long long)rt * ktiles + kt) * TILE,
                             TILE, &full[s]);
#pragma unroll
                for (int b = 0; b < NB; ++b)
                    bulk_g2s(st + (NA + b) * TILE,
                             B + b * bps + ((long long)ct * ktiles + kt) * TILE,
                             TILE, &full[s]);
            }
        }
        return;
    }

    regs_inc<232>();
    const int cw = wg - 1;                  // consumer: rows 64 cw ..
    int acc[NP][64];
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int e = 0; e < 64; ++e) acc[p][e] = 0;
    for (int i = 0; i < nkt; ++i) {
        const int s = i % STAGES;
        mbar_wait(&full[s], (i / STAGES) & 1);
        const uint8_t* st = sm + s * STAGE;
#pragma unroll
        for (int p = 0; p < NP; ++p) fence_regs<64>(acc[p]);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
            for (int p = 0; p < NP; ++p) {
                const uint8_t* at = st + (DGRAD ? p : 0) * TILE + cw * 8192
                                    + kk * 32;
                const uint8_t* bt = st + (NA + (DGRAD ? 0 : p)) * TILE
                                    + kk * 32;
                const uint64_t da = wg_desc(at, 1024, 1);
                const uint64_t db = wg_desc(bt, 1024, 1);
                if (p == 1 && MODE == AFF16 && DGRAD)
                    wgmma_ss_n128_u8s8(acc[p], da, db);
                else if (p == 1 && MODE == AFF16)
                    wgmma_ss_n128_s8u8(acc[p], da, db);
                else
                    wgmma_ss_n128_s8s8(acc[p], da, db);
            }
        }
        wg_commit();
        wg_wait0();
#pragma unroll
        for (int p = 0; p < NP; ++p) fence_regs<64>(acc[p]);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
    }

    const float s1 = scal[1], s2 = scal[2];
    const int warp = (threadIdx.x >> 5) & 3, g = lane >> 2, tg = lane & 3;
#pragma unroll
    for (int i = 0; i < 16; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int row = rt * 128 + cw * 64 + warp * 16 + g + 8 * (e >> 1);
            const int col = ct * 128 + i * 8 + tg * 2 + (e & 1);
            if (row >= rows || col >= cols) continue;
            const long long o = (long long)row * cols + col;
            int v1 = acc[0][4 * i + e], v2 = 0;
            if (MODE == AFF16)
                v1 = (int)((uint32_t)v1 * 256u + (uint32_t)acc[NP - 1][4 * i + e]);
            else if (MODE == FLAG)
                v2 = acc[NP - 1][4 * i + e];
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

template <int SRC>
static void prep(bool by_rows, const void* src, uint8_t* dst,
                 const float* scal, float lim, int R, int K, int ktiles,
                 long long pstride, int vec, cudaStream_t st) {
    dim3 grid(ktiles, (R + 127) / 128);
    if (by_rows)
        bwd_prep_rows<SRC><<<grid, 256, 0, st>>>(src, dst, scal, lim, R, K,
                                                 ktiles, pstride, vec);
    else
        bwd_prep_cols<SRC><<<grid, 256, 0, st>>>(src, dst, scal, lim, R, K,
                                                 ktiles, pstride, vec);
}

template <int MODE, bool DGRAD>
static int gemm(dim3 grid, cudaStream_t st, const uint8_t* A,
                const uint8_t* B, const float* scal, float* out,
                int32_t* ws1, int32_t* ws2, int rows, int cols, int ktiles,
                int kper, long long aps, long long bps, int splits) {
    constexpr int NP = MODE == AFF8 ? 1 : 2;
    const int smem = STAGES * (NP + 1) * TILE + 1024 + 2 * STAGES * 8;
    auto kern = bwd_gemm<MODE, DGRAD>;
    int rc = (int)cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc != 0) return rc;
    kern<<<grid, 384, smem, st>>>(A, B, scal, out, ws1, ws2, rows, cols,
                                  ktiles, kper, aps, bps, splits);
    return (int)cudaGetLastError();
}

// dgrad = 1: out (M, Kd) from g (M, N) and x8 = b8 (Kd, N);
// dgrad = 0: out (Kd, N) from x8 = a8 (M, Kd) and g (M, N).
// mode: 0 affine k <= 8, 1 affine k = 16, 2 flag.  abuf and bbuf hold the
// tiled operands: (planes of A) x ceil(rows/128) x ktiles tiles and (planes
// of B) x ceil(cols/128) x ktiles tiles of 16 KB, ktiles = ceil(depth/128).
// With splits > 1 the caller passes zeroed int32 workspaces of the
// output's size (two for flag), each split takes kper k tiles, and this
// launches the scaling pass after the products.
extern "C" int bwd_launch(const void* g, const void* x8, const void* scal,
                          void* out, void* ws1, void* ws2, void* abuf,
                          void* bbuf, int mode, int dgrad, float lim, int M,
                          int N, int Kd, int splits, int kper, void* stream) {
    if (M <= 0 || N <= 0 || Kd <= 0) return 0;
    const int rows = dgrad ? M : Kd, cols = dgrad ? Kd : N;
    const int depth = dgrad ? N : M;
    const int ktiles = (depth + 127) / 128;
    const long long aps = (long long)((rows + 127) / 128) * ktiles * TILE;
    const long long bps = (long long)((cols + 127) / 128) * ktiles * TILE;
    cudaStream_t st = (cudaStream_t)stream;
    const float* S = (const float*)scal;
    uint8_t* Ab = (uint8_t*)abuf;
    uint8_t* Bb = (uint8_t*)bbuf;
    const bool gal = (uintptr_t)g % 16 == 0, xal = (uintptr_t)x8 % 16 == 0;
    const int gvec = gal && N % 4 == 0;
    // operand pass: the error's plane(s) and the int8 operand
    const bool grows = dgrad != 0;
    uint8_t* gdst = dgrad ? Ab : Bb;
    const long long gps = dgrad ? aps : bps;
    const int gR = dgrad ? M : N;
    if (mode == AFF8)
        prep<AFF8>(grows, g, gdst, S, lim, gR, dgrad ? N : M, ktiles, gps,
                   gvec, st);
    else if (mode == AFF16)
        prep<AFF16>(grows, g, gdst, S, lim, gR, dgrad ? N : M, ktiles, gps,
                    gvec, st);
    else
        prep<FLAG>(grows, g, gdst, S, lim, gR, dgrad ? N : M, ktiles, gps,
                   gvec, st);
    if (dgrad)      // b8 (Kd, N): rows are B's tile rows
        prep<COPY8>(true, x8, Bb, S, lim, Kd, N, ktiles, bps,
                    xal && N % 16 == 0, st);
    else            // a8 (M, Kd): columns are A's tile rows
        prep<COPY8>(false, x8, Ab, S, lim, Kd, M, ktiles, aps,
                    xal && Kd % 16 == 0, st);
    int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;

    dim3 grid(((cols + 127) / 128) * ((rows + 127) / 128), splits);
    float* O = (float*)out;
    int32_t* W1 = (int32_t*)ws1;
    int32_t* W2 = (int32_t*)ws2;
#define GEMM(MD, DG) gemm<MD, DG>(grid, st, Ab, Bb, S, O, W1, W2, rows, cols, \
                                  ktiles, kper, aps, bps, splits)
    if (dgrad)
        rc = mode == AFF8 ? GEMM(AFF8, true)
           : mode == AFF16 ? GEMM(AFF16, true) : GEMM(FLAG, true);
    else
        rc = mode == AFF8 ? GEMM(AFF8, false)
           : mode == AFF16 ? GEMM(AFF16, false) : GEMM(FLAG, false);
#undef GEMM
    if (rc != 0 || splits <= 1) return rc;
    const long long n = (long long)rows * cols;
    long long want = n / 256 + 1;
    const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
    bwd_epilogue<<<blocks, 256, 0, st>>>(W1, mode == FLAG ? W2 : nullptr, S,
                                         O, n);
    return (int)cudaGetLastError();
}
