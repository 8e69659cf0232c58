// K7: paged KV gather, pages[clamp(table[b, j])] -> out[b, j] (int8 copy).
//
// Replaces repro/kernels/page_gather.py::page_gather (_gather_kernel), the
// Pallas kernel that copies one (lane, block) page per grid cell behind a
// scalar-prefetched page table.  On this slice it feeds every chunked-
// prefill page's attention (models/layers.py paged_prefill_attention).
//
// Bound: bytes (a copy: each gathered page is read once and written once).
// Design: one block per (lane, block) cell loads its own page id from the
// table, clamps it to [0, P) (id 0 is the trash page), and copies the
// page with 16-byte vector loads and stores; a byte loop covers pages
// whose size or addresses are not 16-byte multiples.
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void page_gather_kernel(const int8_t* __restrict__ pages,
                                   const int32_t* __restrict__ table,
                                   int8_t* __restrict__ out, int n_pages,
                                   int nb, long long page_bytes, int vec) {
    const int b = blockIdx.y, j = blockIdx.x;
    int pid = table[(long long)b * nb + j];
    pid = pid < 0 ? 0 : (pid >= n_pages ? n_pages - 1 : pid);
    const int8_t* src = pages + (long long)pid * page_bytes;
    int8_t* dst = out + ((long long)b * nb + j) * page_bytes;
    if (vec) {
        const int4* s4 = reinterpret_cast<const int4*>(src);
        int4* d4 = reinterpret_cast<int4*>(dst);
        for (long long i = threadIdx.x; i < page_bytes / 16; i += blockDim.x)
            d4[i] = s4[i];
    } else {
        for (long long i = threadIdx.x; i < page_bytes; i += blockDim.x)
            dst[i] = src[i];
    }
}

extern "C" int page_gather_launch(const void* pages, const void* table,
                                  void* out, int n_pages, int b, int nb,
                                  long long page_bytes, void* stream) {
    if (b <= 0 || nb <= 0) return 0;
    const int vec = page_bytes % 16 == 0 && (uintptr_t)pages % 16 == 0
                    && (uintptr_t)out % 16 == 0;
    dim3 grid(nb, b);
    page_gather_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
        (const int8_t*)pages, (const int32_t*)table, (int8_t*)out, n_pages,
        nb, page_bytes, vec);
    return (int)cudaGetLastError();
}
