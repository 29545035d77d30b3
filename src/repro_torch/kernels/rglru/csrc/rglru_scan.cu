// The RG-LRU linear recurrence h_t = a_t * h_{t-1} + b_t for Hopper (sm_90a),
// written by hand.
//
// Replaces the reference's Pallas TPU kernel src/repro/kernels/rglru/kernel.py
// (_rglru_kernel, launched by rglru_scan_bsd, wrapped by ops.py::rglru_scan):
// (B, S, D) inputs, the state carried in float32 from h0 (zeros when absent),
// y_t = h_t in the inputs' dtype.
//
// Design: one thread per (b, d) channel walks S with the state in a register.
// Neighbouring threads own neighbouring d, so each time step's loads and
// stores are coalesced.  The loads of U steps are issued before their U
// dependent updates, so a thread keeps 2 U loads in flight.  Each update is
// a multiply then an add, each rounded (__fmul_rn, __fadd_rn: no FMA
// contraction), so the kernel gives the bits of the plain sequential version;
// a == 0 gives y == b exactly.
//
// Bound on an H100: bytes.  a and b read once, y written once:
// 3 * B * S * D * itemsize over 3.35 TB/s; 2 flops per element.  With B * D
// channels only (10,240 at RecurrentGemma-2B's width and batch 4) the card
// is under-filled; splitting S into chunks with a second pass is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 64;  // threads per block
constexpr int U = 16;   // time steps loaded ahead

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <typename T>
__global__ void __launch_bounds__(NT) rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                                                        const float* __restrict__ h0, T* __restrict__ y,
                                                        int nb, int s, int d) {
    const long long ch = (long long)blockIdx.x * NT + threadIdx.x;
    if (ch >= (long long)nb * d) return;
    const long long bi = ch / d, di = ch - bi * d;
    const long long base = bi * s * d + di;
    float h = h0 ? h0[ch] : 0.f;
    int t = 0;
    for (; t + U <= s; t += U) {
        float av[U], bv[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const long long off = base + (long long)(t + u) * d;
            av[u] = load_f(a + off);
            bv[u] = load_f(b + off);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
            h = __fadd_rn(__fmul_rn(av[u], h), bv[u]);
            store_f(y + base + (long long)(t + u) * d, h);
        }
    }
    for (; t < s; ++t) {
        const long long off = base + (long long)t * d;
        h = __fadd_rn(__fmul_rn(load_f(a + off), h), load_f(b + off));
        store_f(y + off, h);
    }
}

template <typename T>
cudaError_t run(const void* a, const void* b, const void* h0, void* y, int nb, int s, int d,
                cudaStream_t stream) {
    const long long channels = (long long)nb * d;
    const dim3 grid((unsigned)((channels + NT - 1) / NT));
    rglru_scan_kernel<T><<<grid, NT, 0, stream>>>(static_cast<const T*>(a), static_cast<const T*>(b),
                                                  static_cast<const float*>(h0), static_cast<T*>(y), nb, s, d);
    return cudaGetLastError();
}

}  // namespace

// a, b, y: contiguous (B, S, D); h0: contiguous float32 (B, D) or null.
// dtype: 0 float32, 1 bfloat16.  Returns a cudaError_t.
extern "C" int rglru_scan(int dtype, const void* a, const void* b, const void* h0, void* y,
                          int nb, int s, int d, void* stream) {
    if (nb <= 0 || s <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return (int)run<float>(a, b, h0, y, nb, s, d, st);
    if (dtype == 1) return (int)run<__nv_bfloat16>(a, b, h0, y, nb, s, d, st);
    return (int)cudaErrorInvalidValue;
}
