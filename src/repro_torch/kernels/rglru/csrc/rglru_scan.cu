// The RG-LRU linear recurrence h_t = a_t * h_{t-1} + b_t for Hopper (sm_90a),
// written by hand.
//
// Replaces the reference's Pallas TPU kernel src/repro/kernels/rglru/kernel.py
// (_rglru_kernel, launched by rglru_scan_bsd, wrapped by ops.py::rglru_scan):
// (B, S, D) inputs, the state carried in float32 from h0 (zeros when absent),
// y_t = h_t in the inputs' dtype.
//
// Bound on an H100: bytes.  a and b read once, y written once:
// 3 * B * S * D * itemsize over 3.35 TB/s; 2 flops per element.  At
// RecurrentGemma-2B's width and batch 4 there are only B * D = 10,240
// channels, so the card is bound by the bytes it can keep in flight, not by
// its bandwidth: Little's law at 3.35 TB/s and ~1 us asks for some 25 KB in
// flight on every SM.
//
// Design.  Each channel's recurrence stays sequential in one thread, each
// update a multiply then an add, each rounded (__fmul_rn, __fadd_rn: no FMA
// contraction), so the kernel gives the bits of the plain sequential
// version; a == 0 gives y == b exactly.  The parallelism comes from the
// layout and the pipeline, not from splitting time:
// * channels (b, d), flattened, are cut into one contiguous strip a block,
//   of equal widths in whole 16-byte chunks, as many strips as SMs (more
//   only past 256 channels a strip), so that no SM does twice another's work;
// * each block keeps a ring of NSTAGE stages of U time steps of its strip of
//   a and b in shared memory, filled by cp.async in 16-byte chunks: NSTAGE -
//   1 stages (50 KB for a strip of 80 float32 channels) are in flight while
//   the threads run the recurrence on the stage that has arrived;
// * each copying thread owns one chunk column of the strip and computes its
//   source offset once: a stage costs it a few cp.async and no division;
// * a step's stores of the strip are neighbouring addresses (coalesced).
// Where a row of D channels is not a whole number of 16-byte chunks (or a
// pointer is not 16-byte aligned) the ring is filled element by element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NSTAGE = 6;      // ring stages
constexpr int MAX_STRIP = 256;  // channels a block at most

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

// U time steps a stage: 16 float32 or 32 bfloat16 steps, the same bytes
template <typename T>
struct Ring {
    static constexpr int U = 64 / sizeof(T);
};

// Block x owns channels [x * w, min((x + 1) * w, nb * d)) of the flattened
// (b, d); its threads, one a channel, run the recurrence.  The ring holds,
// per stage, a (U, w) then b (U, w).
template <typename T>
__global__ void rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                                  const float* __restrict__ h0, T* __restrict__ y,
                                  int nb, int s, int d, int w, int vec) {
    constexpr int U = Ring<T>::U;
    constexpr int E = 16 / sizeof(T);  // elements of a 16-byte chunk
    extern __shared__ __align__(16) unsigned char smem[];
    T* ring = reinterpret_cast<T*>(smem);  // NSTAGE x {a, b} x (U, w)

    const long long nch = (long long)nb * d;
    const long long c0 = (long long)blockIdx.x * w;
    const int width = (int)min((long long)w, nch - c0);  // channels of this strip
    const int tid = threadIdx.x, nt = blockDim.x;
    const int nstages = (s + U - 1) / U;

    // Each copying thread owns one copy unit of the strip's step row (a
    // 16-byte chunk, or one element where rows are not whole chunks) and
    // every ustep-th step of a stage, from u0: its offsets are computed once.
    const int unit = vec ? E : 1, cw = width / unit;  // w and d are whole chunks where vec
    const int ustep = nt / cw, u0 = tid / cw, cc = (tid - u0 * cw) * unit;
    const bool copier = u0 < ustep;
    const long long src = [&] {
        const long long ch = c0 + cc, bi = ch / d;  // a chunk never straddles two batch rows
        return bi * s * d + (ch - bi * d);
    }();
    // fill stage st (time steps st * U ..) of the ring slot st % NSTAGE
    auto load = [&](int st) {
        T* sa = ring + (st % NSTAGE) * 2 * U * w + cc;
        T* sb = sa + U * w;
        const int t0 = st * U;
        if (copier) {
            for (int u = u0; u < U; u += ustep) {
                const bool ok = t0 + u < s;
                const long long off = ok ? src + (long long)(t0 + u) * d : 0;
                if (vec) {
                    cp_async16(sa + u * w, a + off, ok);
                    cp_async16(sb + u * w, b + off, ok);
                } else if (ok) {
                    sa[u * w] = a[off];
                    sb[u * w] = b[off];
                }
            }
        }
        cp_async_commit();  // an empty group where nothing was copied keeps the count
    };

#pragma unroll 1
    for (int st = 0; st < NSTAGE - 1; ++st)
        if (st < nstages) load(st); else cp_async_commit();

    const bool mine = tid < width;
    const long long ch = c0 + tid, bi = mine ? ch / d : 0;
    float h = (mine && h0) ? h0[ch] : 0.f;
    T* yp = y + bi * s * d + (mine ? ch - bi * d : 0);
#pragma unroll 1
    for (int st = 0; st < nstages; ++st) {
        cp_async_wait<NSTAGE - 2>();
        __syncthreads();  // stage st has landed; every thread is done with the slot loaded next
        if (st + NSTAGE - 1 < nstages) load(st + NSTAGE - 1); else cp_async_commit();
        if (mine) {
            const T* sa = ring + (st % NSTAGE) * 2 * U * w + tid;
            const T* sb = sa + U * w;
            const int t0 = st * U, n = min(U, s - t0);
            if (n == U) {
#pragma unroll
                for (int u = 0; u < U; ++u) {
                    h = __fadd_rn(__fmul_rn(to_f(sa[u * w]), h), to_f(sb[u * w]));
                    store_f(yp + (long long)(t0 + u) * d, h);
                }
            } else {
                for (int u = 0; u < n; ++u) {
                    h = __fadd_rn(__fmul_rn(to_f(sa[u * w]), h), to_f(sb[u * w]));
                    store_f(yp + (long long)(t0 + u) * d, h);
                }
            }
        }
    }
}

// the current device's SM count, cached for the first 64 devices
cudaError_t sm_count(int* count) {
    static int n[64] = {0};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev < 64 && n[dev] > 0) {
        *count = n[dev];
        return cudaSuccess;
    }
    e = cudaDeviceGetAttribute(count, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess && dev < 64) n[dev] = *count;
    return e;
}

template <typename T>
cudaError_t run(const void* a, const void* b, const void* h0, void* y, int nb, int s, int d,
                cudaStream_t stream) {
    constexpr int E = 16 / sizeof(T);
    const long long nch = (long long)nb * d;
    const bool vec = d % E == 0 && (reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) % 16 == 0;
    const int gran = vec ? E : 1;
    // as many equal strips as SMs, in whole chunks; more strips (waves) past MAX_STRIP channels
    int sms = 0;
    cudaError_t e = sm_count(&sms);
    if (e != cudaSuccess) return e;
    const long long nsm = sms;
    const long long waves = (nch + nsm * MAX_STRIP - 1) / (nsm * MAX_STRIP);
    long long w = (nch + nsm * waves - 1) / (nsm * waves);
    w = (w + gran - 1) / gran * gran;
    const long long blocks = (nch + w - 1) / w;
    const int threads = (int)((w + 31) / 32 * 32);
    const int smem = NSTAGE * 2 * Ring<T>::U * (int)w * (int)sizeof(T);
    e = cudaFuncSetAttribute(rglru_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    rglru_scan_kernel<T><<<(unsigned)blocks, threads, smem, stream>>>(
        static_cast<const T*>(a), static_cast<const T*>(b), static_cast<const float*>(h0), static_cast<T*>(y),
        nb, s, d, (int)w, int(vec));
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
