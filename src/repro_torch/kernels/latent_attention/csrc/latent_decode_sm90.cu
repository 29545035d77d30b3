// One decode step of latent attention (MLA, in the absorbed form) for Hopper
// (sm_90a) in bfloat16 on the tensor cores, written by hand.
//
// Replaces no kernel of the reference package, which has no latent attention.
// It replaces the port's plain absorbed decode (models/attention.py,
// attend_latent; its formula is ../ref.py): three library products over the
// latent cache and the float32 passes over the scores between them, which read
// every allocated row of the cache, the latent twice.  Same function: for each
// sequence b and head h, the softmax over rows j = 0 .. pos of
// (q_lat[b, h] . ckv[b, j] + q_pe[b, h] . kpe[b, j]) * scale, and the
// softmax-weighted sum of ckv[b, j]: o (B, H, latent), bfloat16.  pos is a 0-d
// int32 device tensor read here, so a launch captured in a CUDA graph stays
// right as pos moves from one replay to the next; rows past pos are never
// read.  The scores are summed in float32 on the tensor cores and the softmax
// runs in float32 (the plain path rounds each product's scores to bfloat16
// first); P is rounded to bfloat16 before the P.V product, as the plain path
// rounds it.
//
// Bound on an H100: bytes.  Each cache row (latent + rope bfloat16 values,
// 1152 bytes at latent 512 and rope 64) is read once and feeds 16 heads x 2 x
// (latent + rope + latent) flops, about 30 flops a byte: under the tensor
// cores' ridge (about 295 flops a byte), above the CUDA cores'.  At 64
// sequences of 7176 rows that is 529 MB a layer, 158 us at 3.35 TB/s.
//
// Design: one warpgroup (128 threads) a block, one block an SM (its shared
// memory); the grid is (split, group of 16 heads, sequence).  A sequence's
// rows 0 .. pos, in tiles of 64, are cut into `splits` runs of whole tiles,
// one a block (flash-decoding), so that few sequences still fill the card.
// The heads are the N of both products, so no row of the tensor cores is
// padding: S^T (64 rows x 16 heads) = K Q^T with the cache tile as wgmma's A
// and Q as B, both K-major from shared memory; then O^T (latent x 16 heads)
// += V^T P^T with the tile's first `latent` columns as A (MN-major, the
// transposed A of wgmma) and P^T as B.  One tile in shared memory feeds both
// products: the cache is read from device memory once.  Tiles come through a
// ring of two slots filled by cp.async: the copy of tile t + 1 runs beside
// tile t's products, and the copy of tile t + 2 starts as soon as tile t's
// slot is free, so that two copies run while a block waits.  The softmax is
// online, in log2 units: each warp's row maxima go across its lanes by
// shuffles and across the four warps through shared memory; every thread
// keeps partial sums of its own rows and heads, summed once at the end.  A thread holds the same four heads in both
// accumulators, so rescaling O needs nothing from other threads.  Shared
// memory holds tiles in wgmma's 128-byte swizzled layout: column blocks of 64
// values, rows of 128 bytes, the 16-byte chunks of a row XORed with the row's
// place among 8.  With one split a block writes o itself; with several, each
// writes its unnormalised O, max and sum in float32, and a second kernel
// merges them.  TMA, a producer warp and a persistent schedule are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// a named namespace, so that a profiler's trace names the kernels
namespace latent_decode {

constexpr int NT = 128;               // one warpgroup
constexpr int BN = 64;                // cache rows a tile
constexpr int HG = 16;                // heads a block
constexpr int Q_BLOCK = HG * 128;     // bytes of a column block of Q (and of P^T)
constexpr int T_BLOCK = BN * 128;     // bytes of a column block of a tile
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

struct Args {
    const __nv_bfloat16* q_lat;  // (B, H, latent), rows through strides
    const __nv_bfloat16* q_pe;   // (B, H, rope), rows through strides
    const __nv_bfloat16* ckv;    // (B, S, latent), contiguous
    const __nv_bfloat16* kpe;    // (B, S, rope), contiguous
    const int* pos;              // 0-d: rows 0 .. pos are valid
    __nv_bfloat16* o;            // (B, H, latent)
    float* o_part;               // (B, splits, H, latent) when splits > 1
    float* ml_part;              // (B, splits, H, 2): max (log2 units) and sum
    long long ql_sb, ql_sh, qp_sb, qp_sh;
    int h, s_alloc, rope, splits;
    float scale_log2;
};

// ---- wgmma (PTX ISA, "Asynchronous Warpgroup Level Matrix Multiply-Accumulate")

// D (64 x 16, float32) (+)= A (64 x 16, shared, K-major) * B (16 x 16, shared, K-major)
__device__ __forceinline__ void wgmma_kk(float (&d)[8], uint64_t da, uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 16, float32) += A (64 x 16, shared, MN-major) * B (16 x 16, shared, K-major)
__device__ __forceinline__ void wgmma_mk(float (&d)[8], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait0() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// keep the compiler from moving accesses of the accumulators across the
// asynchronous products
__device__ __forceinline__ void fence_regs(float (&d)[8]) {
#pragma unroll
    for (int i = 0; i < 8; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// A shared-memory matrix descriptor: start address, leading and stride byte
// offsets (all >> 4), 128-byte swizzle.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16)
           | ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

// byte offset, in a column block of 128-byte rows on a 1024-byte aligned base,
// of 16-byte chunk c of row r (the hardware's 128-byte swizzle)
__device__ __forceinline__ uint32_t swz(int r, int c) { return (uint32_t)(r * 128 + ((c ^ (r & 7)) << 4)); }

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
    // 16 bytes, or 16 zero bytes when !valid (nothing is read)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait0() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n" ::: "memory"); }
// make this thread's shared-memory writes visible to wgmma (the async proxy)
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// 2^x by the special function unit (0 for the -1e30 of masked scores)
__device__ __forceinline__ float fast_exp2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// rows k0 .. k0 + 63 of one sequence's cache into a tile slot: NM column
// blocks of the latent, then one of the rope key (its chunks past rope zero);
// rows at or past n are zero-filled, not read.  A warp copies 512 contiguous
// bytes of a latent row at a time.
template <int NM>
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* ckv, const __nv_bfloat16* kpe,
                                          int rope, int k0, int n, int tid) {
    constexpr int CPR = NM * 8;       // 16-byte chunks of a latent row
    constexpr int RSTEP = NT / CPR;   // rows a pass (the last NT % CPR threads idle)
    const int c = tid % CPR, r = tid / CPR;
    if (r < RSTEP) {
        const uint32_t col = (uint32_t)((c / 8) * T_BLOCK);
#pragma unroll
        for (int p = 0; p < (BN + RSTEP - 1) / RSTEP; ++p) {
            const int row = r + p * RSTEP;
            if (row < BN) {
                const bool ok = k0 + row < n;
                cp_async16(dst + col + swz(row, c % 8), ok ? ckv + (long long)(k0 + row) * CPR * 8 + 8 * c : ckv, ok);
            }
        }
    }
    const int cr = tid % 8, rr = tid / 8;
#pragma unroll
    for (int p = 0; p < BN / 16; ++p) {
        const int row = rr + 16 * p;
        const bool ok = k0 + row < n && 8 * cr < rope;
        cp_async16(dst + NM * T_BLOCK + swz(row, cr), ok ? kpe + (long long)(k0 + row) * rope + 8 * cr : kpe, ok);
    }
}

// The accumulators' layout (wgmma's m64nNk16 D fragment): element i of a
// thread (lane = 4 g + qd, warp w) sits at row 16 w + g + 8 ((i % 4) / 2)
// and column 8 (i / 4) + 2 qd + i % 2.  The columns are heads in both
// products, so a thread holds four heads, slot hs = 2 (i / 4) + i % 2.
__device__ __forceinline__ int head_of(int hs, int qd) { return 8 * (hs / 2) + 2 * qd + (hs % 2); }

template <int NM>
__global__ void __launch_bounds__(NT, 1) latent_decode_kernel(const Args a) {
    constexpr int NCB = NM + 1;  // column blocks: the latent, then the rope key
    constexpr int LAT = NM * 64;
    constexpr uint32_t SLOT = NCB * T_BLOCK;
    extern __shared__ __align__(1024) unsigned char smem_raw[];
    __shared__ float s_red[4 * HG];  // the warps' maxima (then sums) by head
    const uint32_t s_q = (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023u) & ~1023u;
    const uint32_t s_p = s_q + NCB * Q_BLOCK;
    const uint32_t s_t0 = s_p + Q_BLOCK;

    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, qd = lane % 4;
    const int split = blockIdx.x, h0 = blockIdx.y * HG, bb = blockIdx.z;
    const int n = min(*a.pos + 1, a.s_alloc);
    const int ntiles = (n + BN - 1) / BN;
    const int t_begin = (int)((long long)ntiles * split / a.splits);
    const int t_end = (int)((long long)ntiles * (split + 1) / a.splits);
    const __nv_bfloat16* ckv = a.ckv + (long long)bb * a.s_alloc * LAT;
    const __nv_bfloat16* kpe = a.kpe + (long long)bb * a.s_alloc * a.rope;

    if (t_begin < t_end) {
        // Q: 16 heads (those past h zero) of latent | rope (zero past rope)
        for (int i = tid; i < HG * NCB * 8; i += NT) {
            const int hd = i / (NCB * 8), c = i % (NCB * 8), cb = c / 8;
            const bool real = h0 + hd < a.h;
            const __nv_bfloat16* src;
            bool ok;
            if (cb < NM) {
                ok = real;
                src = a.q_lat + bb * a.ql_sb + (long long)(h0 + hd) * a.ql_sh + 8 * c;
            } else {
                ok = real && 8 * (c % 8) < a.rope;
                src = a.q_pe + bb * a.qp_sb + (long long)(h0 + hd) * a.qp_sh + 8 * (c % 8);
            }
            cp_async16(s_q + cb * Q_BLOCK + swz(hd, c % 8), ok ? src : a.q_lat, ok);
        }
        load_tile<NM>(s_t0, ckv, kpe, a.rope, t_begin * BN, n, tid);
        cp_async_commit();
        if (t_begin + 1 < t_end) {
            load_tile<NM>(s_t0 + SLOT, ckv, kpe, a.rope, (t_begin + 1) * BN, n, tid);
            cp_async_commit();
        }
    }

    float o[NM][8];
#pragma unroll
    for (int mi = 0; mi < NM; ++mi)
#pragma unroll
        for (int i = 0; i < 8; ++i) o[mi][i] = 0.f;
    float m[4], l[4];
#pragma unroll
    for (int hs = 0; hs < 4; ++hs) {
        m[hs] = NEG_INF;
        l[hs] = 0.f;
    }
    const int r0 = 16 * warp + g;  // this thread's tile rows: r0 and r0 + 8

    for (int t = t_begin; t < t_end; ++t) {
        const int it = t - t_begin, k0 = t * BN;
        if (t + 1 < t_end) cp_async_wait1();  // the next tile's copy may still run
        else cp_async_wait0();
        fence_proxy_async();
        // tile t is in shared memory for every thread, and every thread is
        // done with tile t - 1's P^T and maxima
        __syncthreads();
        const uint32_t s_t = s_t0 + (it & 1) * SLOT;

        // S^T = K Q^T over the latent and the rope key, K-major operands
        float s[8];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < NCB * 4; ++kk) {
            const uint32_t col = (kk / 4) * 1u, off = (kk % 4) * 32u;
            wgmma_kk(s, smem_desc(s_t + col * T_BLOCK + off, 16, 1024), smem_desc(s_q + col * Q_BLOCK + off, 16, 1024),
                     kk > 0);
        }
        wgmma_commit();
        wgmma_wait0();
        fence_regs(s);

        // scores in log2 units; rows past pos masked (only in the last tile)
#pragma unroll
        for (int i = 0; i < 8; ++i) s[i] *= a.scale_log2;
        if (k0 + BN > n) {
#pragma unroll
            for (int i = 0; i < 8; ++i)
                if (k0 + r0 + 8 * ((i % 4) / 2) >= n) s[i] = NEG_INF;
        }
        // the tile's maximum of each head: over this thread's two rows, the
        // warp's 8 row groups (lanes 4 apart), then the four warps
        float mx[4];
#pragma unroll
        for (int hs = 0; hs < 4; ++hs) {
            const int i = 4 * (hs / 2) + hs % 2;
            mx[hs] = fmaxf(s[i], s[i + 2]);
#pragma unroll
            for (int x = 4; x < 32; x <<= 1) mx[hs] = fmaxf(mx[hs], __shfl_xor_sync(0xffffffffu, mx[hs], x));
        }
        if (g == 0) {
#pragma unroll
            for (int hs = 0; hs < 4; ++hs) s_red[warp * HG + head_of(hs, qd)] = mx[hs];
        }
        __syncthreads();
        float al[4];
#pragma unroll
        for (int hs = 0; hs < 4; ++hs) {
            const int hd = head_of(hs, qd);
            const float tm = fmaxf(fmaxf(s_red[hd], s_red[HG + hd]), fmaxf(s_red[2 * HG + hd], s_red[3 * HG + hd]));
            const float mn = fmaxf(m[hs], tm);
            al[hs] = fast_exp2(m[hs] - mn);
            m[hs] = mn;
        }
        // P = 2^(s - m), its partial sums, and P^T in bfloat16 to shared
        // memory as wgmma's B (a 128-byte row of 64 tile rows per head)
        float ls[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const int hs = 2 * (i / 4) + i % 2;
            s[i] = fast_exp2(s[i] - m[hs]);
            ls[hs] += s[i];
            const int row = r0 + 8 * ((i % 4) / 2), hd = head_of(hs, qd);
            const __nv_bfloat16 pv = __float2bfloat16_rn(s[i]);
            const uint32_t addr = s_p + swz(hd, row / 8) + (row % 8) * 2;
            asm volatile("st.shared.b16 [%0], %1;\n" ::"r"(addr), "h"(*reinterpret_cast<const unsigned short*>(&pv))
                         : "memory");
        }
#pragma unroll
        for (int hs = 0; hs < 4; ++hs) l[hs] = l[hs] * al[hs] + ls[hs];
        fence_proxy_async();
        __syncthreads();  // P^T is whole

        // O^T = O^T * alpha + V^T P^T: V^T MN-major from the tile's latent
        // column blocks, P^T K-major
#pragma unroll
        for (int mi = 0; mi < NM; ++mi)
#pragma unroll
            for (int i = 0; i < 8; ++i) o[mi][i] *= al[2 * (i / 4) + i % 2];
        wgmma_fence();
#pragma unroll
        for (int mi = 0; mi < NM; ++mi) {
#pragma unroll
            for (int j = 0; j < BN / 16; ++j)
                wgmma_mk(o[mi], smem_desc(s_t + mi * T_BLOCK + j * 16 * 128, T_BLOCK, 1024),
                         smem_desc(s_p + j * 32, 16, 1024));
        }
        wgmma_commit();
        wgmma_wait0();
#pragma unroll
        for (int mi = 0; mi < NM; ++mi) fence_regs(o[mi]);
        if (t + 2 < t_end) {  // tile t's slot is free: the copy two tiles on runs beside the next tile's wait
            __syncthreads();
            load_tile<NM>(s_t, ckv, kpe, a.rope, k0 + 2 * BN, n, tid);
            cp_async_commit();
        }
    }

    // the sums of each head over the block's threads
#pragma unroll
    for (int hs = 0; hs < 4; ++hs) {
#pragma unroll
        for (int x = 4; x < 32; x <<= 1) l[hs] += __shfl_xor_sync(0xffffffffu, l[hs], x);
    }
    __syncthreads();  // every thread is done reading the last tile's maxima
    if (g == 0) {
#pragma unroll
        for (int hs = 0; hs < 4; ++hs) s_red[warp * HG + head_of(hs, qd)] = l[hs];
    }
    __syncthreads();
#pragma unroll
    for (int hs = 0; hs < 4; ++hs) {
        const int hd = head_of(hs, qd);
        l[hs] = (s_red[hd] + s_red[HG + hd]) + (s_red[2 * HG + hd] + s_red[3 * HG + hd]);
    }

    if (a.splits == 1) {
        float inv[4];
#pragma unroll
        for (int hs = 0; hs < 4; ++hs) inv[hs] = 1.f / fmaxf(l[hs], 1e-37f);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const int hs = 2 * (i / 4) + i % 2, hh = h0 + head_of(hs, qd);
            if (hh >= a.h) continue;
            __nv_bfloat16* orow = a.o + ((long long)bb * a.h + hh) * LAT + r0 + 8 * ((i % 4) / 2);
#pragma unroll
            for (int mi = 0; mi < NM; ++mi) orow[64 * mi] = __float2bfloat16_rn(o[mi][i] * inv[hs]);
        }
        return;
    }
    const long long part = (long long)bb * a.splits + split;  // this block's (b, split)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int hs = 2 * (i / 4) + i % 2, hh = h0 + head_of(hs, qd);
        if (hh >= a.h) continue;
        float* orow = a.o_part + (part * a.h + hh) * LAT + r0 + 8 * ((i % 4) / 2);
#pragma unroll
        for (int mi = 0; mi < NM; ++mi) orow[64 * mi] = o[mi][i];
    }
    if (warp == 0 && g == 0) {
#pragma unroll
        for (int hs = 0; hs < 4; ++hs) {
            const int hh = h0 + head_of(hs, qd);
            if (hh < a.h) {
                a.ml_part[(part * a.h + hh) * 2] = m[hs];
                a.ml_part[(part * a.h + hh) * 2 + 1] = l[hs];
            }
        }
    }
}

// o[b, h] from the splits' partials: each split's O, max and sum, weighted by
// 2^(max - the largest max).  One block a (head, sequence).
__global__ void __launch_bounds__(NT) latent_combine_kernel(const float* o_part, const float* ml_part,
                                                            __nv_bfloat16* o, int h, int splits, int lat) {
    const int hh = blockIdx.x, bb = blockIdx.y;
    const float* ml = ml_part + ((long long)bb * splits * h + hh) * 2;  // split s at ml + 2 h s
    const long long step = 2LL * h;
    float mx = NEG_INF;
    for (int s = 0; s < splits; ++s) mx = fmaxf(mx, ml[s * step]);
    float sum = 0.f;
    for (int s = 0; s < splits; ++s) sum += fast_exp2(ml[s * step] - mx) * ml[s * step + 1];
    const float inv = 1.f / fmaxf(sum, 1e-37f);
    const float* op = o_part + ((long long)bb * splits * h + hh) * lat;  // split s at op + h lat s
    for (int c = threadIdx.x; c < lat; c += NT) {
        float acc = 0.f;
        for (int s = 0; s < splits; ++s) acc += fast_exp2(ml[s * step] - mx) * op[(long long)s * h * lat + c];
        o[((long long)bb * h + hh) * lat + c] = __float2bfloat16_rn(acc * inv);
    }
}

template <int NM>
cudaError_t run(const Args& a, int b, cudaStream_t stream) {
    constexpr int smem = (NM + 1) * (Q_BLOCK + 2 * T_BLOCK) + Q_BLOCK + 1024;  // Q, P^T, two slots, alignment
    // the attribute is set once a device, before any graph capture that follows
    static bool ready[64] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev >= 64 || !ready[dev]) {
        e = cudaFuncSetAttribute(latent_decode_kernel<NM>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return e;
        if (dev < 64) ready[dev] = true;
    }
    const dim3 grid(a.splits, (a.h + HG - 1) / HG, b);
    latent_decode_kernel<NM><<<grid, NT, smem, stream>>>(a);
    e = cudaGetLastError();
    if (e != cudaSuccess || a.splits == 1) return e;
    latent_combine_kernel<<<dim3(a.h, b), NT, 0, stream>>>(a.o_part, a.ml_part, a.o, a.h, a.splits, NM * 64);
    return cudaGetLastError();
}

}  // namespace latent_decode

using namespace latent_decode;

// q_lat (B, H, latent) and q_pe (B, H, rope): rows 16-byte aligned, strides in
// elements; ckv (B, S, latent) and kpe (B, S, rope) contiguous; pos a 0-d
// int32; o (B, H, latent) contiguous; o_part (B, splits, H, latent) and
// ml_part (B, splits, H, 2) float32 scratch, unused with one split.  latent a
// multiple of 64 up to 512, rope a multiple of 16 up to 64.  Returns a
// cudaError_t.
extern "C" int latent_decode_sm90(const void* q_lat, const void* q_pe, const void* ckv, const void* kpe,
                                  const void* pos, void* o, void* o_part, void* ml_part,
                                  long long ql_sb, long long ql_sh, long long qp_sb, long long qp_sh,
                                  int b, int h, int s_alloc, int latent, int rope, int splits, float scale,
                                  void* stream) {
    Args a{static_cast<const __nv_bfloat16*>(q_lat), static_cast<const __nv_bfloat16*>(q_pe),
           static_cast<const __nv_bfloat16*>(ckv), static_cast<const __nv_bfloat16*>(kpe),
           static_cast<const int*>(pos), static_cast<__nv_bfloat16*>(o), static_cast<float*>(o_part),
           static_cast<float*>(ml_part), ql_sb, ql_sh, qp_sb, qp_sh, h, s_alloc, rope, splits, scale * LOG2E};
    if (b <= 0 || h <= 0 || s_alloc <= 0 || splits <= 0 || rope <= 0 || rope > 64 || rope % 16 != 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (latent) {
        case 64: return (int)run<1>(a, b, s);
        case 128: return (int)run<2>(a, b, s);
        case 192: return (int)run<3>(a, b, s);
        case 256: return (int)run<4>(a, b, s);
        case 320: return (int)run<5>(a, b, s);
        case 384: return (int)run<6>(a, b, s);
        case 448: return (int)run<7>(a, b, s);
        case 512: return (int)run<8>(a, b, s);
        default: return (int)cudaErrorInvalidValue;
    }
}
