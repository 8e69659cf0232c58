// K1: int8 (M, K) x int8 (K, N) -> int32 (M, N), optionally batched, with
// an optional requantize epilogue clip(rint(acc * inv), +-lim) -> int8.
//
// Replaces repro/kernels/qmatmul.py::qmatmul (_qmm_kernel and
// _qmm_requant_kernel).  On this slice it runs every qdense (wq/wk/wv/wo,
// w_gate/w_up/w_down) and, batched over KV heads, the two integer
// contractions of chunked-prefill attention.
//
// Bound: bytes on the serving path.  M is the token count (4 decode lanes,
// or one 16-token prefill page), so the int8 weight (K, N) is read once
// for 2*M operations per byte: far below the tensor cores' rate.  Design
// (a first version that is right, not yet fast): 64x64 output tiles per
// block of 4 warps, each warp a 32x32 sub-tile of mma.sync m16n8k32
// s8.s8.s32 products; A and B tiles of 64 along K staged in shared memory
// with 80-byte rows (conflict-free fragment reads); B arrives row-major
// (K, N) and is transposed 4x4 bytes at a time with __byte_perm into the
// [n][k] layout the mma's column operand wants.  When the tiles cannot
// fill the card, K splits across blocks and the int32 partials meet by
// atomicAdd, which is exact and order-free for integers.  wgmma and TMA
// come later.
#include <cuda_runtime.h>
#include <stdint.h>

#define BM 64
#define BN 64
#define BK 64
#define LDS 80

__device__ __forceinline__ void mma_s8(int* c, const int* a, const int* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(128)
qmm_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B,
           int32_t* __restrict__ C, int8_t* __restrict__ C8,
           const float* __restrict__ inv_p, float lim, int M, int N, int K,
           int splits, int kchunk, int avec, int bvec) {
    __shared__ __align__(16) int8_t As[BM * LDS];
    __shared__ __align__(16) int8_t Bs[BN * LDS];   // Bs[n][k]
    const int bz = blockIdx.z, batch = bz / splits, split = bz % splits;
    A += (long long)batch * M * K;
    B += (long long)batch * K * N;
    const long long coff = (long long)batch * M * N;
    const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
    const int kbeg = split * kchunk;
    const int kend = min(K, kbeg + kchunk);
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
    const int g = lane >> 2, tg = lane & 3;

    int acc[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

    for (int k0 = kbeg; k0 < kend; k0 += BK) {
        // A tile: 64 rows x 64 bytes, 16-byte chunks, 2 per thread
#pragma unroll
        for (int it = 0; it < 2; ++it) {
            const int c = tid + it * 128, r = c >> 2, kc = (c & 3) * 16;
            const int gm = m0 + r, gk = k0 + kc;
            int4 v = make_int4(0, 0, 0, 0);
            if (gm < M) {
                const int8_t* src = A + (long long)gm * K + gk;
                if (avec && gk + 16 <= kend) {
                    v = *reinterpret_cast<const int4*>(src);
                } else {
                    uint32_t w[4] = {0u, 0u, 0u, 0u};
                    for (int i = 0; i < 16; ++i)
                        if (gk + i < kend)
                            w[i >> 2] |= (uint32_t)(uint8_t)src[i]
                                         << (8 * (i & 3));
                    v = make_int4((int)w[0], (int)w[1], (int)w[2], (int)w[3]);
                }
            }
            *reinterpret_cast<int4*>(As + r * LDS + kc) = v;
        }
        // B tile: 64 k x 64 n in 4x4-byte units, transposed into Bs[n][k]
#pragma unroll
        for (int it = 0; it < 2; ++it) {
            const int u = tid + it * 128, kq = u >> 4, nq = u & 15;
            const int gk = k0 + kq * 4, gn = n0 + nq * 4;
            uint32_t r[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                r[i] = 0u;
                if (gk + i < kend) {
                    const int8_t* src = B + (long long)(gk + i) * N + gn;
                    if (bvec && gn + 4 <= N) {
                        r[i] = *reinterpret_cast<const uint32_t*>(src);
                    } else {
                        for (int j = 0; j < 4; ++j)
                            if (gn + j < N)
                                r[i] |= (uint32_t)(uint8_t)src[j] << (8 * j);
                    }
                }
            }
            const uint32_t lo01 = __byte_perm(r[0], r[1], 0x5140);
            const uint32_t hi01 = __byte_perm(r[0], r[1], 0x7362);
            const uint32_t lo23 = __byte_perm(r[2], r[3], 0x5140);
            const uint32_t hi23 = __byte_perm(r[2], r[3], 0x7362);
            uint32_t w[4];
            w[0] = __byte_perm(lo01, lo23, 0x5410);
            w[1] = __byte_perm(lo01, lo23, 0x7632);
            w[2] = __byte_perm(hi01, hi23, 0x5410);
            w[3] = __byte_perm(hi01, hi23, 0x7632);
#pragma unroll
            for (int j = 0; j < 4; ++j)
                *reinterpret_cast<uint32_t*>(Bs + (nq * 4 + j) * LDS
                                             + kq * 4) = w[j];
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; kk += 32) {
            int af[2][4], bf[4][2];
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
                const int8_t* base = As + (wm + mi * 16 + g) * LDS + kk + tg * 4;
                af[mi][0] = *reinterpret_cast<const int*>(base);
                af[mi][1] = *reinterpret_cast<const int*>(base + 8 * LDS);
                af[mi][2] = *reinterpret_cast<const int*>(base + 16);
                af[mi][3] = *reinterpret_cast<const int*>(base + 8 * LDS + 16);
            }
#pragma unroll
            for (int ni = 0; ni < 4; ++ni) {
                const int8_t* base = Bs + (wn + ni * 8 + g) * LDS + kk + tg * 4;
                bf[ni][0] = *reinterpret_cast<const int*>(base);
                bf[ni][1] = *reinterpret_cast<const int*>(base + 16);
            }
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
#pragma unroll
                for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bf[ni]);
        }
        __syncthreads();
    }

    const float inv = C8 != nullptr ? *inv_p : 0.f;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int row = m0 + wm + mi * 16 + g + (e >= 2 ? 8 : 0);
                const int col = n0 + wn + ni * 8 + tg * 2 + (e & 1);
                if (row >= M || col >= N) continue;
                const long long o = coff + (long long)row * N + col;
                const int v = acc[mi][ni][e];
                if (C8 != nullptr) {
                    float q = rintf((float)v * inv);
                    C8[o] = (int8_t)fminf(fmaxf(q, -lim), lim);
                } else if (splits > 1) {
                    atomicAdd(C + o, v);
                } else {
                    C[o] = v;
                }
            }
}

// out32 must be zeroed by the caller when splits > 1; with out8 given
// (requant epilogue) splits must be 1
extern "C" int qmatmul_launch(const void* a, const void* b, void* out32,
                              void* out8, const void* inv, float lim,
                              int batch, int M, int N, int K, int splits,
                              int kchunk, void* stream) {
    if (batch <= 0 || M <= 0 || N <= 0) return 0;
    const int avec = (K % 16 == 0) && ((uintptr_t)a % 16 == 0);
    const int bvec = (N % 4 == 0) && ((uintptr_t)b % 4 == 0);
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, batch * splits);
    qmm_kernel<<<grid, 128, 0, (cudaStream_t)stream>>>(
        (const int8_t*)a, (const int8_t*)b, (int32_t*)out32, (int8_t*)out8,
        (const float*)inv, lim, M, N, K, splits, kchunk, avec, bvec);
    return (int)cudaGetLastError();
}
