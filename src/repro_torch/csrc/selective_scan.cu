// K9: the Mamba1 selective scan, h_t = a_t * h_{t-1} + b_t and
// y_t = sum_n c_t[n] * h_t[n], with a carried state in and out.
//
// Replaces repro/kernels/selective_scan.py::selective_scan (_ssm_kernel).
// The TPU kernel keeps a (bd, N) block of states in VMEM scratch across a
// sequential seq grid; it starts from zero state and returns y only.  Here
// every recurrence of the SSM path (train, chunk and decode modes) comes
// through this one kernel, so it also takes the carried state h0 (or none:
// zeros, which is exactly the TPU kernel's function) and returns h_last.
//
// Bound: bytes.  a and b are (B, S, D, N) fp32 and read once, c (B, S, N)
// once, y (B, S, D) written once: 8N + 4 bytes per (t, d) for some 4N
// flops.  Design: one thread per (b, d) channel holds its N states in
// registers and walks t in order (the recurrence is sequential in t, and
// a channel's N states are independent of every other channel's).  A
// channel's a and b rows are N contiguous floats (64 B at N = 16), so a
// warp reads 32 consecutive rows, 2 KB contiguous, as float4 loads; c's row
// is the same for every thread of a batch row (an L1 broadcast).  Step
// t+1's rows are loaded into registers before step t computes, so one load
// latency is in flight behind each step's arithmetic.  At B = 1 only D
// threads run (8192 for falcon-mamba-7b): 64-thread blocks spread them over
// 128 SMs, and the loop pays about one memory latency per step.  Deeper
// prefetch (cp.async/TMA), seq-chunk parallelism with a carry pass, and
// computing a = exp(dt A) and b = dt x B in the kernel so that a and b
// never reach memory are later work.
//
// Numerics (the plain version in kernels/ref.py matches them bit for bit):
// h = a * h rounded, then + b rounded (explicit __fmul_rn / __fadd_rn, and
// the build uses -fmad=false); y_t is the float64 sum of the products
// h[n] * c[n] (each exact in float64) in n order, rounded once to fp32.  No
// atomics: the result is deterministic.
#include <cuda_runtime.h>
#include <stdint.h>

template <int N>
struct Row {
    float4 v[N / 4];
};

template <int N>
__device__ __forceinline__ void load_row(Row<N>& r, const float* p) {
    const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
    for (int i = 0; i < N / 4; ++i) r.v[i] = __ldg(q + i);
}

template <int N>
__device__ __forceinline__ float at(const Row<N>& r, int n) {
    const float4& f = r.v[n >> 2];
    switch (n & 3) {
        case 0: return f.x;
        case 1: return f.y;
        case 2: return f.z;
        default: return f.w;
    }
}

template <int N>
__global__ void __launch_bounds__(64)
sscan_kernel(const float* __restrict__ a, const float* __restrict__ b,
             const float* __restrict__ c, const float* __restrict__ h0,
             float* __restrict__ y, float* __restrict__ h_last, int S, int D) {
    const int d = blockIdx.x * blockDim.x + threadIdx.x;
    if (d >= D) return;
    const long long bi = blockIdx.y;
    const long long chan = bi * D + d;              // (b, d) state row
    float h[N];
#pragma unroll
    for (int n = 0; n < N; ++n) h[n] = h0 ? h0[chan * N + n] : 0.f;

    const long long tstride = (long long)D * N;     // floats per time step
    const float* ap = a + (bi * S * D + d) * N;
    const float* bp = b + (bi * S * D + d) * N;
    const float* cp = c + bi * S * N;
    float* yp = y + bi * S * D + d;

    Row<N> an, bn, cn;
    if (S > 0) {
        load_row<N>(an, ap);
        load_row<N>(bn, bp);
        load_row<N>(cn, cp);
    }
    for (int t = 0; t < S; ++t) {
        const Row<N> ac = an, bc = bn, cc = cn;
        if (t + 1 < S) {                            // prefetch step t+1
            load_row<N>(an, ap + (t + 1) * tstride);
            load_row<N>(bn, bp + (t + 1) * tstride);
            load_row<N>(cn, cp + (long long)(t + 1) * N);
        }
        double acc = 0.0;
#pragma unroll
        for (int n = 0; n < N; ++n) {
            h[n] = __fadd_rn(__fmul_rn(at<N>(ac, n), h[n]), at<N>(bc, n));
            const double p = __dmul_rn((double)h[n], (double)at<N>(cc, n));
            acc = n == 0 ? p : __dadd_rn(acc, p);
        }
        yp[(long long)t * D] = (float)acc;
    }
#pragma unroll
    for (int n = 0; n < N; ++n) h_last[chan * N + n] = h[n];
}

template <int N>
static void launch(const float* a, const float* b, const float* c,
                   const float* h0, float* y, float* h_last, int B, int S,
                   int D, cudaStream_t stream) {
    const dim3 grid((D + 63) / 64, B);
    sscan_kernel<N><<<grid, 64, 0, stream>>>(a, b, c, h0, y, h_last, S, D);
}

// a, b (B, S, D, N), c (B, S, N), h0 (B, D, N) or null, y (B, S, D),
// h_last (B, D, N); all fp32, contiguous, 16-byte aligned.  N is 4 or 16.
extern "C" int sscan_launch(const float* a, const float* b, const float* c,
                            const float* h0, float* y, float* h_last, int B,
                            int S, int D, int N, cudaStream_t stream) {
    if (B <= 0 || D <= 0 || S < 0 || B > 65535) return (int)cudaErrorInvalidValue;
    switch (N) {
        case 4: launch<4>(a, b, c, h0, y, h_last, B, S, D, stream); break;
        case 16: launch<16>(a, b, c, h0, y, h_last, B, S, D, stream); break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
