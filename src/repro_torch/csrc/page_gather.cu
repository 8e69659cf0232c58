// K7: paged KV gather, pool[clamp(table[b, j])] -> out[b, j] (int8 copy),
// for one pool or two (K and V) through one table in one launch.
//
// Replaces repro/kernels/page_gather.py:48 page_gather (_gather_kernel),
// the Pallas kernel that copies one (lane, block) page per grid cell
// behind a scalar-prefetched page table.  On the port's path it feeds
// every chunked-prefill page's attention (models/layers.py
// paged_prefill_attention): one launch a layer and page gathers K and V.
//
// Bound: host issue and launch, not bytes.  One prefill page of granite-
// 3-8b gathers 32 pages of 16 KB a pool, about 2 MB moved for both pools:
// 0.6 us at the memory rate, below a launch's own latency.  So the design
// cuts calls and host work: one launch for both pools (two calls and two
// launches before), and the wrapper does no per-call tensor work beyond
// allocating the outputs (no view for the page size, no conversion of a
// table that is already device int32).  On the card, each block copies
// one (lane, page, KV head, pool) cell, page rows of dh bytes with 16-byte
// vector loads and stores (a byte loop where sizes or addresses are not
// 16-byte multiples), so the grid covers the card even for one lane; each
// block loads its own page id from the table and clamps it to [0, P) (id
// 0 is the trash page).  With head_major the block writes its rows into
// (B, KV, NB * page, dh), each head's positions in one run: the layout the
// prefill contractions read with no copy.
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void __launch_bounds__(128)
page_gather_kernel(const int8_t* __restrict__ p0, const int8_t* __restrict__ p1,
                   const int32_t* __restrict__ table, int8_t* __restrict__ o0,
                   int8_t* __restrict__ o1, int n_pages, int nb, int page,
                   int kv, long long row, int head_major, int vec) {
    const int pool = blockIdx.z, b = blockIdx.y;
    const int j = blockIdx.x / kv, h = blockIdx.x % kv;
    const int8_t* pages = pool ? p1 : p0;
    int8_t* out = pool ? o1 : o0;
    int pid = table[(long long)b * nb + j];
    pid = pid < 0 ? 0 : (pid >= n_pages ? n_pages - 1 : pid);
    // rows r < page: source (pid, r, h) of (P, page, kv, row); destination
    // (b, j, r, h) of (B, NB, page, kv, row) or (b, h, j page + r) of
    // (B, kv, NB page, row)
    const int8_t* src = pages + ((long long)pid * page * kv + h) * row;
    const long long sstride = (long long)kv * row;
    int8_t* dst;
    long long dstride;
    if (head_major) {
        dst = out + (((long long)b * kv + h) * nb * page + (long long)j * page)
                    * row;
        dstride = row;
    } else {
        dst = out + (((long long)b * nb + j) * page * kv + h) * row;
        dstride = sstride;
    }
    if (vec) {
        const long long cpr = row / 16, total = cpr * page;
        for (long long i = threadIdx.x; i < total; i += blockDim.x) {
            const long long r = i / cpr, c = i % cpr;
            *reinterpret_cast<int4*>(dst + r * dstride + c * 16) =
                *reinterpret_cast<const int4*>(src + r * sstride + c * 16);
        }
    } else {
        const long long total = row * page;
        for (long long i = threadIdx.x; i < total; i += blockDim.x) {
            const long long r = i / row, c = i % row;
            dst[r * dstride + c] = src[r * sstride + c];
        }
    }
}

// pools: 1 or 2 (pages2 / out2 are read only then); pages (n_pages, page,
// kv, row) int8 each, table (b, nb) int32 on the device
extern "C" int page_gather_launch(const void* pages, const void* pages2,
                                  const void* table, void* out, void* out2,
                                  int pools, int n_pages, int b, int nb,
                                  int page, int kv, long long row,
                                  int head_major, void* stream) {
    if (b <= 0 || nb <= 0 || page <= 0 || kv <= 0 || row <= 0) return 0;
    int vec = row % 16 == 0;
    const void* ptrs[4] = {pages, pages2, out, out2};
    for (int i = 0; i < 4; ++i) vec = vec && (uintptr_t)ptrs[i] % 16 == 0;
    dim3 grid(nb * kv, b, pools);
    page_gather_kernel<<<grid, 128, 0, (cudaStream_t)stream>>>(
        (const int8_t*)pages, (const int8_t*)pages2, (const int32_t*)table,
        (int8_t*)out, (int8_t*)out2, n_pages, nb, page, kv, row, head_major,
        vec);
    return (int)cudaGetLastError();
}
