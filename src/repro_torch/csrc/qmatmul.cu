// K1: int8 (b, M, K) x int8 (b, K, N) -> int32 (b, M, N), or int8 through
// the requantize epilogue clip(rint(float(acc) * inv), +-lim).
//
// Replaces repro/kernels/qmatmul.py:107 qmatmul (_qmm_kernel and
// _qmm_requant_kernel).  On the port's paths it runs every qdense forward
// (wq/wk/wv/wo, w_gate/w_up/w_down; the SSM's in/x/dt/out projections),
// the attention-chunk contractions of the training step's backward, and
// the two contractions of each chunked-prefill page.
//
// Operands.  Each is described by its start, up to three batch strides
// (0 where it broadcasts) over batch sizes (n0, n1, n2), a row pitch `ld`
// and a layout flag: row-major (element (i, j) at i * ld + j) or
// transposed (at j * ld + i: the matrix's last two dimensions swapped and
// contiguous).  So permuted views of the attention payloads and the
// transposed operands of the qdense backward are read as they lie, with
// no copy.  The output is contiguous (b, M, N).
//
// The route follows from M, the rows per batch:
//
//   wide, M > 16 (training and attention shapes).  Bound: operations
//   (4096 x 4096 x 12800 is 0.43 TOP, 0.22 ms at the int8 peak).  int8
//   wgmma reads both operands K-major from shared memory, so an operand
//   pass (op_prep_rows / op_prep_cols of hopper.cuh, shared with K3)
//   writes A and B once as 128 x 128-byte K-major, 128B-swizzled tiles,
//   zero padded to whole tiles: a transposed A or an (N, K) B is a plain
//   row pass, the others go through K3's shared-memory transpose, and
//   ragged M, N and K become zero tiles.  qmm_wide then computes one
//   128 x 128 output tile per block with two warpgroups of 64 rows
//   running wgmma m64n128k32 s8.s8 from shared memory; thread 0 keeps a
//   ring of up to 3 stages of 32 KB filled with one cp.async.bulk per
//   tile on the stage's mbarrier (the ring is sized from the depth, so a
//   128-deep attention chunk reserves one stage, and two blocks share an
//   SM: one's epilogue overlaps the other's loads).  Blocks run in groups
//   of 8 row tiles so both operands' panels stay in L2.  Only when the
//   tiles cannot fill the SMs does the contraction split across blocks.
//
//   narrow, M <= 16 (decode lanes, one prefill page, the SSM's
//   projections).  Bound: bytes, the weight (K, N) read once for 2 M
//   operations per byte (4 x 4096 x 12800: 52 MB, 0.016 ms).  No operand
//   pass runs: it would double those bytes.  Each block of 4 warps owns
//   128 columns and a slice of the contraction; B streams from device
//   memory in 16-byte cp.async loads through a 4-stage ring of 64-deep
//   stages (chunks XOR-swizzled so the fragment reads are free of bank
//   conflicts), and each warp builds mma.sync m16n8k32 fragments from it:
//   a row-major B is transposed 4 x 4 bytes at a time with __byte_perm, an
//   (N, K) B is already the column operand.  A is padded to 16 rows, not
//   to a 64-row tile.  The contraction splits until there are about four
//   blocks per SM, so enough bytes are in flight to reach the memory rate.
//
// Split contractions write int32 partials to a workspace (split, b, M, N);
// qmm_combine adds them in split order in wrapping 32-bit arithmetic (the
// exact sum modulo 2^32, as the int32 accumulator of one pass gives) and
// applies the epilogue, so the requantize epilogue follows a split too.
// The epilogue is float(acc) * inv rounded to nearest even, clipped, as
// the plain version computes it (built with -fmad=false).
#include "hopper.cuh"

#define GROUP 8             // wide: row tiles a run of consecutive blocks shares
#define WSTAGES 3           // wide: ring stages at most (two blocks an SM)
#define WSTAGE (2 * OP_TILE)
#define NN 128              // narrow: columns per block (4 warps x 32)
#define NK 64               // narrow: depth per ring stage
#define NSTAGES 4
#define APITCH 80           // narrow: A rows in shared memory (16 + 64 bytes)
#define CPITCH (NN + 4)     // narrow: output tile rows in shared memory (words)

struct Opnd {
    const int8_t* p;
    long long s0, s1, s2, ld;
    int trans;
};

// start of batch z of an operand; z runs over (n0, n1, n2) in row-major order
__device__ __forceinline__ long long zoff(const Opnd& o, int z, int n1,
                                          int n2) {
    return (long long)(z / (n1 * n2)) * o.s0
           + (long long)((z / n2) % n1) * o.s1 + (long long)(z % n2) * o.s2;
}

__device__ __forceinline__ void cp16(void* dst, const void* src, int bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void mma_s8(int* c, const int* a,
                                       const uint32_t* b) {
    asm volatile(
        "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ int8_t requant(int v, float inv, float lim) {
    const float q = rintf((float)v * inv);
    return (int8_t)fminf(fmaxf(q, -lim), lim);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

// ---------------------------------------------------------------------------
// wide route
// ---------------------------------------------------------------------------

// operand pass of batch blockIdx.z: rows of the source are the tile rows
// (A row-major, B given as (N, K)), or its columns are (A given as (K, M),
// B row-major)
__global__ void __launch_bounds__(256)
qmm_prep_rows(Opnd o, uint8_t* __restrict__ tiles, int R, int K, int ktiles,
              int n1, int n2, int vec) {
    const int z = blockIdx.z;
    op_prep_rows<COPY8>(o.p + zoff(o, z, n1, n2),
                        tiles + (long long)z * ((R + 127) / 128) * ktiles
                                * OP_TILE,
                        nullptr, 0.f, R, K, o.ld, ktiles, 0, vec);
}

__global__ void __launch_bounds__(256)
qmm_prep_cols(Opnd o, uint8_t* __restrict__ tiles, int R, int K, int ktiles,
              int n1, int n2, int vec) {
    const int z = blockIdx.z;
    op_prep_cols<COPY8>(o.p + zoff(o, z, n1, n2),
                        tiles + (long long)z * ((R + 127) / 128) * ktiles
                                * OP_TILE,
                        nullptr, 0.f, R, K, o.ld, ktiles, 0, vec);
}

// C (or split blockIdx.y's slice of the workspace) = A . B^T over this
// block's k tiles; REQ: int8 through the requantize epilogue
template <bool REQ>
__global__ void __launch_bounds__(256, 2)
qmm_wide(const uint8_t* __restrict__ At, const uint8_t* __restrict__ Bt,
         int32_t* __restrict__ C, int8_t* __restrict__ C8,
         const float* __restrict__ inv_p, float lim, int M, int N, int ktiles,
         int kper, int stages) {
    extern __shared__ uint8_t raw[];
    uint8_t* sm = reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(raw) + 1023) & ~(uintptr_t)1023);
    uint64_t* full = reinterpret_cast<uint64_t*>(sm + stages * WSTAGE);
    uint64_t* empty = full + WSTAGES;
    const int z = blockIdx.z;
    const int rtn = (M + 127) / 128, ctn = (N + 127) / 128;
    const int first = (blockIdx.x / (GROUP * ctn)) * GROUP;
    const int gsz = min(rtn - first, GROUP);
    const int local = blockIdx.x % (GROUP * ctn);
    const int rt = first + local % gsz, ct = local / gsz;
    const uint8_t* Az = At + ((long long)z * rtn + rt) * ktiles * OP_TILE;
    const uint8_t* Bz = Bt + ((long long)z * ctn + ct) * ktiles * OP_TILE;
    const int kt0 = blockIdx.y * kper;
    const int nkt = max(0, min(ktiles, kt0 + kper) - kt0);
    const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
    if (tid == 0) {
        for (int s = 0; s < stages; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&empty[s], 8);        // one arrival per warp
        }
        mbar_fence_init();
    }
    __syncthreads();
    auto load = [&](int s, int i) {
        uint8_t* st = sm + s * WSTAGE;
        mbar_expect_tx(&full[s], WSTAGE);
        bulk_g2s(st, Az + (long long)(kt0 + i) * OP_TILE, OP_TILE, &full[s]);
        bulk_g2s(st + OP_TILE, Bz + (long long)(kt0 + i) * OP_TILE, OP_TILE,
                 &full[s]);
    };
    if (tid == 0)
        for (int i = 0; i < min(stages, nkt); ++i) load(i, i);

    int acc[64];
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] = 0;
    for (int i = 0; i < nkt; ++i) {
        const int s = i % stages;
        mbar_wait(&full[s], (i / stages) & 1);
        const uint8_t* st = sm + s * WSTAGE;
        fence_regs<64>(acc);
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
            wgmma_ss_n128_s8s8(acc, wg_desc(st + wg * 8192 + kk * 32, 1024, 1),
                               wg_desc(st + OP_TILE + kk * 32, 1024, 1));
        wg_commit();
        wg_wait0();
        fence_regs<64>(acc);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[s]);
        // refill the previous tile's stage once every warp released it
        if (tid == 0 && i > 0 && i - 1 + stages < nkt) {
            const int sp = (i - 1) % stages;
            mbar_wait(&empty[sp], ((i - 1) / stages) & 1);
            load(sp, i - 1 + stages);
        }
        __syncwarp();
    }

    const float inv = REQ ? *inv_p : 0.f;
    const int warp = (tid >> 5) & 3, g = lane >> 2, tg = lane & 3;
    // (split, batch) slice: a split writes its own partials
    const long long zo = ((long long)blockIdx.y * gridDim.z + z) * M * N;
    const bool pair = (N & 1) == 0;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
        const int col = ct * 128 + i * 8 + tg * 2;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int row = rt * 128 + wg * 64 + warp * 16 + g + 8 * h;
            if (row >= M || col >= N) continue;
            const long long o = zo + (long long)row * N + col;
            const int v0 = acc[4 * i + 2 * h], v1 = acc[4 * i + 2 * h + 1];
            if (REQ) {
                C8[o] = requant(v0, inv, lim);
                if (col + 1 < N) C8[o + 1] = requant(v1, inv, lim);
            } else if (pair && col + 1 < N) {
                *reinterpret_cast<int2*>(C + o) = make_int2(v0, v1);
            } else {
                C[o] = v0;
                if (col + 1 < N) C[o + 1] = v1;
            }
        }
    }
}

// ---------------------------------------------------------------------------
// narrow route
// ---------------------------------------------------------------------------

// 16 rows x 64 bytes of A into As ([m][k], pitch APITCH), rows >= M and
// depths >= kend zero
__device__ __forceinline__ void narrow_load_a(int8_t* As, const int8_t* a,
                                              const Opnd& A, int M, int k0,
                                              int kend, int avec) {
    const int tid = threadIdx.x;
    if (tid >= 64) return;
    const int r = tid >> 2, kc = k0 + (tid & 3) * 16;
    int8_t* dst = As + r * APITCH + (tid & 3) * 16;
    if (avec) {
        const int n = r < M ? clampi(kend - kc, 0, 16) : 0;
        cp16(dst, n > 0 ? a + (long long)r * A.ld + kc : a, n);
        return;
    }
    uint32_t w[4] = {0u, 0u, 0u, 0u};
    if (r < M)
        for (int j = 0; j < 16; ++j)
            if (kc + j < kend) {
                const long long off = A.trans
                    ? (long long)(kc + j) * A.ld + r
                    : (long long)r * A.ld + kc + j;
                w[j >> 2] |= (uint32_t)(uint8_t)a[off] << (8 * (j & 3));
            }
    *reinterpret_cast<int4*>(dst) =
        make_int4((int)w[0], (int)w[1], (int)w[2], (int)w[3]);
}

// 64 deep x 128 columns of B into Bs: a row-major B as [k][128 bytes]
// with 16-byte chunk c of row k at c ^ 2 ((k >> 2) & 3); an (N, K) B as
// [n][64 bytes] with chunk c of row n at c ^ ((n >> 1) & 3)
template <bool BT>
__device__ __forceinline__ void narrow_load_b(int8_t* Bs, const int8_t* b,
                                              const Opnd& B, int N, int n0,
                                              int k0, int kend, int bvec) {
#pragma unroll
    for (int it = 0; it < 4; ++it) {
        const int u = threadIdx.x + it * 128;
        int8_t* dst;
        long long off;
        int n;
        if (BT) {
            const int r = u >> 2, c = u & 3, kc = k0 + c * 16;
            dst = Bs + r * 64 + ((c ^ ((r >> 1) & 3)) << 4);
            n = n0 + r < N ? clampi(kend - kc, 0, 16) : 0;
            off = (long long)(n0 + r) * B.ld + kc;
        } else {
            const int r = u >> 3, c = u & 7, nc = n0 + c * 16;
            dst = Bs + r * 128 + ((c ^ (2 * ((r >> 2) & 3))) << 4);
            n = k0 + r < kend ? clampi(N - nc, 0, 16) : 0;
            off = (long long)(k0 + r) * B.ld + nc;
        }
        if (bvec) {
            cp16(dst, n > 0 ? b + off : b, n);
            continue;
        }
        uint32_t w[4] = {0u, 0u, 0u, 0u};
        for (int j = 0; j < n; ++j)
            w[j >> 2] |= (uint32_t)(uint8_t)b[off + j] << (8 * (j & 3));
        *reinterpret_cast<int4*>(dst) =
            make_int4((int)w[0], (int)w[1], (int)w[2], (int)w[3]);
    }
}

// 4 x 4 byte transpose: out[j] holds byte j of r[0..3] (one column's four
// depths) in order
__device__ __forceinline__ void transpose4(const uint32_t* r, uint32_t* out) {
    const uint32_t lo01 = __byte_perm(r[0], r[1], 0x5140);
    const uint32_t hi01 = __byte_perm(r[0], r[1], 0x7362);
    const uint32_t lo23 = __byte_perm(r[2], r[3], 0x5140);
    const uint32_t hi23 = __byte_perm(r[2], r[3], 0x7362);
    out[0] = __byte_perm(lo01, lo23, 0x5410);
    out[1] = __byte_perm(lo01, lo23, 0x7632);
    out[2] = __byte_perm(hi01, hi23, 0x5410);
    out[3] = __byte_perm(hi01, hi23, 0x7632);
}

// One block: 16 (padded) rows x 128 columns over the depth slice
// [blockIdx.y * kper, + kper).  Warp w owns columns 32 w .. 32 w + 31 as
// four m16n8 tiles; with a row-major B, mma column c of tile j is column
// 4 c + j of the warp's 32 (each thread's 32-bit shared read then holds
// four columns, one per tile), with an (N, K) B it is column 8 j + c.
template <bool BT>
__global__ void __launch_bounds__(128)
qmm_narrow(Opnd A, Opnd B, int32_t* __restrict__ C, int8_t* __restrict__ C8,
           const float* __restrict__ inv_p, float lim, int M, int N, int K,
           int n1, int n2, int kper, int avec, int bvec) {
    __shared__ __align__(128) int8_t As[NSTAGES][16 * APITCH];
    __shared__ __align__(128) int8_t Bs[NSTAGES][NK * NN];
    const int z = blockIdx.z, n0 = blockIdx.x * NN;
    const int8_t* a = A.p + zoff(A, z, n1, n2);
    const int8_t* b = B.p + zoff(B, z, n1, n2);
    const int kbeg = blockIdx.y * kper, kend = min(K, kbeg + kper);
    const int nk = kend > kbeg ? (kend - kbeg + NK - 1) / NK : 0;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, tg = lane & 3;

#pragma unroll
    for (int s = 0; s < NSTAGES - 1; ++s) {
        if (s < nk) {
            narrow_load_a(As[s], a, A, M, kbeg + s * NK, kend, avec);
            narrow_load_b<BT>(Bs[s], b, B, N, n0, kbeg + s * NK, kend, bvec);
        }
        cp_commit();
    }
    int acc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0;

    for (int i = 0; i < nk; ++i) {
        cp_wait<NSTAGES - 2>();
        __syncthreads();
        // the stage consumed in the last iteration takes step i + 3
        const int nx = i + NSTAGES - 1, sx = nx % NSTAGES;
        if (nx < nk) {
            narrow_load_a(As[sx], a, A, M, kbeg + nx * NK, kend, avec);
            narrow_load_b<BT>(Bs[sx], b, B, N, n0, kbeg + nx * NK, kend, bvec);
        }
        cp_commit();
        const int8_t* as = As[i % NSTAGES];
        const int8_t* bs = Bs[i % NSTAGES];
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
            int af[4];
            const int8_t* ab = as + g * APITCH + kk * 32 + tg * 4;
            af[0] = *reinterpret_cast<const int*>(ab);
            af[1] = *reinterpret_cast<const int*>(ab + 8 * APITCH);
            af[2] = *reinterpret_cast<const int*>(ab + 16);
            af[3] = *reinterpret_cast<const int*>(ab + 8 * APITCH + 16);
            uint32_t bf[4][2];
            if (BT) {
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const int n = warp * 32 + j * 8 + g;
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        const int c = (2 * kk + h) ^ ((n >> 1) & 3);
                        bf[j][h] = *reinterpret_cast<const uint32_t*>(
                            bs + n * 64 + c * 16 + tg * 4);
                    }
                }
            } else {
                // rows kk*32 + 16 h + 4 tg + q: (row >> 2) & 3 == tg
                const int c = (warp * 2 + (g >> 2)) ^ (2 * tg);
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    uint32_t r[4], w[4];
#pragma unroll
                    for (int q = 0; q < 4; ++q)
                        r[q] = *reinterpret_cast<const uint32_t*>(
                            bs + (kk * 32 + h * 16 + tg * 4 + q) * 128
                            + c * 16 + (g & 3) * 4);
                    transpose4(r, w);
#pragma unroll
                    for (int j = 0; j < 4; ++j) bf[j][h] = w[j];
                }
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) mma_s8(acc[j], af, bf[j]);
        }
    }
    cp_wait<0>();
    __syncthreads();

    // the 16 x 128 tile through shared memory (the ring's B stages), so
    // the rows leave in 16-byte stores
    int* Cs = reinterpret_cast<int*>(&Bs[0][0]);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            const int row = g + 8 * (e >> 1), c = tg * 2 + (e & 1);
            Cs[row * CPITCH + warp * 32 + (BT ? 8 * j + c : 4 * c + j)] =
                acc[j][e];
        }
    __syncthreads();
    const float inv = C8 != nullptr ? *inv_p : 0.f;
    const long long zo = ((long long)blockIdx.y * gridDim.z + z) * M * N;
    const bool quad = (N & 3) == 0;
    for (int u = tid; u < M * (NN / 4); u += 128) {
        const int row = u / (NN / 4), col = n0 + (u % (NN / 4)) * 4;
        if (col >= N) continue;
        const int* v = Cs + row * CPITCH + (col - n0);
        const long long o = zo + (long long)row * N + col;
        if (quad && C8 != nullptr) {
            *reinterpret_cast<char4*>(C8 + o) = make_char4(
                requant(v[0], inv, lim), requant(v[1], inv, lim),
                requant(v[2], inv, lim), requant(v[3], inv, lim));
        } else if (quad) {
            *reinterpret_cast<int4*>(C + o) = make_int4(v[0], v[1], v[2],
                                                        v[3]);
        } else {
            for (int q = 0; q < 4 && col + q < N; ++q) {
                if (C8 != nullptr)
                    C8[o + q] = requant(v[q], inv, lim);
                else
                    C[o + q] = v[q];
            }
        }
    }
}

// ---------------------------------------------------------------------------
// split contractions: the partials' sum in split order, then the epilogue
// ---------------------------------------------------------------------------

__global__ void qmm_combine(const int32_t* __restrict__ ws, int splits,
                            long long n, int32_t* __restrict__ C,
                            int8_t* __restrict__ C8,
                            const float* __restrict__ inv_p, float lim) {
    const float inv = C8 != nullptr ? *inv_p : 0.f;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n; i += stride) {
        uint32_t s = 0u;
        for (int p = 0; p < splits; ++p) s += (uint32_t)ws[p * n + i];
        if (C8 != nullptr)
            C8[i] = requant((int)s, inv, lim);
        else
            C[i] = (int)s;
    }
}

static bool vec16(const void* p, const long long* d) {
    return (uintptr_t)p % 16 == 0 && d[0] % 16 == 0 && d[1] % 16 == 0
           && d[2] % 16 == 0 && d[3] % 16 == 0;
}

// desc (12 values): A's batch strides s0, s1, s2, its row pitch ld and
// layout flag (0 row-major, 1 transposed), the same five for B, then the
// batch sizes n1 and n2 (batch = n0 n1 n2).  The output is out32 (int32)
// or, with out8, int8 through the requantize epilogue (inv on the device).
// splits > 1 splits the contraction into slices of kper (a multiple of
// 128 for M > 16, of 64 otherwise) and needs ws, an int32 workspace of
// splits x batch x M x N; M > 16 needs abuf and bbuf, the operand tiles
// (batch x ceil(M/128) and batch x ceil(N/128) times ceil(K/128) tiles
// of 16 KB).  K >= 1.
extern "C" int qmatmul_launch(const void* a, const void* b, void* out32,
                              void* out8, const void* inv, float lim,
                              const long long* desc, int batch, int M, int N,
                              int K, int splits, int kper, void* ws,
                              void* abuf, void* bbuf, void* stream) {
    if (batch <= 0 || M <= 0 || N <= 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    const Opnd A{(const int8_t*)a, desc[0], desc[1], desc[2], desc[3],
                 (int)desc[4]};
    const Opnd B{(const int8_t*)b, desc[5], desc[6], desc[7], desc[8],
                 (int)desc[9]};
    const int n1 = (int)desc[10], n2 = (int)desc[11];
    const float* I = (const float*)inv;
    int32_t* C = splits > 1 ? (int32_t*)ws : (int32_t*)out32;
    int8_t* C8 = splits > 1 ? nullptr : (int8_t*)out8;
    if (M <= 16) {
        const int avec = !A.trans && vec16(a, desc);
        const int bvec = vec16(b, desc + 5);
        dim3 grid((N + NN - 1) / NN, splits, batch);
        if (B.trans)
            qmm_narrow<true><<<grid, 128, 0, st>>>(A, B, C, C8, I, lim, M, N,
                                                  K, n1, n2, kper, avec, bvec);
        else
            qmm_narrow<false><<<grid, 128, 0, st>>>(A, B, C, C8, I, lim, M, N,
                                                   K, n1, n2, kper, avec,
                                                   bvec);
    } else {
        const int ktiles = (K + 127) / 128;
        const int rtn = (M + 127) / 128, ctn = (N + 127) / 128;
        uint8_t* At = (uint8_t*)abuf;
        uint8_t* Bt = (uint8_t*)bbuf;
        const int av = vec16(a, desc), bv = vec16(b, desc + 5);
        if (A.trans)
            qmm_prep_cols<<<dim3(ktiles, rtn, batch), 256, 0, st>>>(
                A, At, M, K, ktiles, n1, n2, av);
        else
            qmm_prep_rows<<<dim3(ktiles, rtn, batch), 256, 0, st>>>(
                A, At, M, K, ktiles, n1, n2, av);
        if (B.trans)
            qmm_prep_rows<<<dim3(ktiles, ctn, batch), 256, 0, st>>>(
                B, Bt, N, K, ktiles, n1, n2, bv);
        else
            qmm_prep_cols<<<dim3(ktiles, ctn, batch), 256, 0, st>>>(
                B, Bt, N, K, ktiles, n1, n2, bv);
        int rc = (int)cudaGetLastError();
        if (rc != 0) return rc;
        const int kpt = kper / 128;
        const int stages = kpt < WSTAGES ? kpt : WSTAGES;
        const int smem = stages * WSTAGE + 1024 + 2 * WSTAGES * 8;
        dim3 grid(rtn * ctn, splits, batch);
        if (C8 != nullptr) {
            rc = (int)cudaFuncSetAttribute(
                qmm_wide<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                smem);
            if (rc != 0) return rc;
            qmm_wide<true><<<grid, 256, smem, st>>>(At, Bt, C, C8, I, lim, M,
                                                    N, ktiles, kpt, stages);
        } else {
            rc = (int)cudaFuncSetAttribute(
                qmm_wide<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                smem);
            if (rc != 0) return rc;
            qmm_wide<false><<<grid, 256, smem, st>>>(At, Bt, C, C8, I, lim, M,
                                                     N, ktiles, kpt, stages);
        }
    }
    int rc = (int)cudaGetLastError();
    if (rc != 0 || splits <= 1) return rc;
    const long long n = (long long)batch * M * N;
    const long long want = n / 256 + 1;
    qmm_combine<<<(int)(want < 132 * 8 ? want : 132 * 8), 256, 0, st>>>(
        (const int32_t*)ws, splits, n, (int32_t*)out32, (int8_t*)out8, I,
        lim);
    return (int)cudaGetLastError();
}
