// Forward flash attention for Hopper (sm_90a), written by hand.
//
// Replaces the reference's Pallas TPU kernel
// src/repro/kernels/flash_attention/kernel.py (_flash_kernel, launched by
// flash_attention_bhsd, wrapped by ops.py::flash_attention).  Same function:
// softmax(q k^T * Dh^-1/2, soft-capped, masked) v with a float32 online
// softmax (acc, m, l); GQA/MQA (kv head = h / (H / Kh)); causal, a sliding
// window, a tanh soft-cap and q_offset / kv_len (decode rows); kv tiles that
// are wholly masked are never loaded; a row left with no valid key is 0.
// Masked scores are the finite -1e30 of the reference, so exp(s - m) never
// forms inf - inf.
//
// Layout: the model's (B, S, H, Dh), read through strides (Dh contiguous);
// ragged q and kv edges are masked here, not padded by the wrapper.
//
// Design (a first, simple kernel): one block of 256 threads per
// (b, h, tile of 256 / TPR query rows); TPR threads per row (4, or 8 for
// Dh >= 128, to bound registers), each holding a 1/TPR share of the row's q
// and of its accumulator in registers, interleaved by float4 chunks so that
// the TPR threads of a row read neighbouring 16-byte chunks of shared memory
// (no bank conflicts; the rows of a warp read the same chunks, a broadcast).
// K and V tiles of BK keys are staged in shared memory.  Scores: each
// thread's partial dot product, summed over the row's threads by warp
// shuffles.  It serves float32 inputs; bfloat16 inputs go to the tensor-core
// kernel of flash_fwd_sm90.cu.  All products are FMAs on the CUDA cores (no
// TF32, which cannot meet the tolerance below), and the score dot products
// are summed in float64: a float32 sum of Dh products
// carries a rounding error of some 1e-6 in the scores, which moves outputs
// near zero by more than the reference's float32 tolerance of 2e-6 at long
// sequences.  Each tile's p and p.v are summed apart and then added to
// (l, acc), as the reference's online softmax does.
//
// Bound on an H100: operations.  4 * B * H * Sq * Skv * Dh / 2 flops for a
// causal prefill against bytes of q, k, v and o read or written once; at
// B 4, S 2048, H 32, Dh 96 that is 1.5 ms at the 67 TFLOP/s float32 peak
// of the CUDA cores, whose FMA issue rate limits this kernel.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NT = 256;  // threads per block
constexpr float NEG_INF = -1e30f;


struct Args {
    const float* q;
    const float* k;
    const float* v;
    float* o;
    long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh;
    int sq, skv, h, kh;
    const int* qoff_ptr;  // a 0-d device tensor, or null: then qoff
    int qoff;
    const int* kvlen_ptr;  // likewise for kv_len
    int kvlen;
    int causal, has_window, window, has_cap;
    float cap, scale;
};

template <int DH, int BK, int TPR>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(const Args a) {
    constexpr int BQ = NT / TPR;        // query rows per block
    constexpr int NC = DH / (4 * TPR);  // float4 chunks of a row held by one thread
    extern __shared__ __align__(16) float smem[];
    float* sk = smem;            // (BK, DH) keys of the tile
    float* sv = smem + BK * DH;  // (BK, DH) values of the tile

    const int tid = threadIdx.x, row = tid / TPR, part = tid % TPR;
    const int q0 = blockIdx.x * BQ, hh = blockIdx.y, bb = blockIdx.z;
    const int kvh = hh / (a.h / a.kh);
    const int qoff = a.qoff_ptr ? *a.qoff_ptr : a.qoff;
    const int kv_len = min(a.kvlen_ptr ? *a.kvlen_ptr : a.kvlen, a.skv);
    const int qi = q0 + row;
    const bool row_ok = qi < a.sq;
    const int qpos = qoff + qi;

    const float* qp = a.q + bb * a.q_sb + (long long)qi * a.q_ss + hh * a.q_sh;
    float q[4 * NC], acc[4 * NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            q[4 * c + e] = row_ok ? qp[4 * (part + TPR * c) + e] : 0.f;
            acc[4 * c + e] = 0.f;
        }
    }
    float m = NEG_INF, l = 0.f;

    // the keys this tile of rows can see: tiles wholly masked by kv_len,
    // causality or the window are skipped
    const int last_qpos = qoff + min(q0 + BQ, a.sq) - 1;
    int k_end = kv_len;
    if (a.causal) k_end = min(k_end, last_qpos + 1);
    int k_begin = a.has_window ? max(0, qoff + q0 - a.window + 1) : 0;
    k_begin -= k_begin % BK;

    const float* kb = a.k + bb * a.k_sb + kvh * a.k_sh;
    const float* vb = a.v + bb * a.v_sb + kvh * a.v_sh;

    for (int k0 = k_begin; k0 < k_end; k0 += BK) {
        __syncthreads();  // every thread is done with the previous tile
        for (int e = tid; e < BK * DH; e += NT) {
            const int j = e / DH, d = e - j * DH, kp = k0 + j;
            float kx = 0.f, vx = 0.f;
            if (kp < kv_len) {
                kx = kb[(long long)kp * a.k_ss + d];
                vx = vb[(long long)kp * a.v_ss + d];
            }
            sk[e] = kx;
            sv[e] = vx;
        }
        __syncthreads();

        float s[BK];
        float m_tile = NEG_INF;
#pragma unroll
        for (int j = 0; j < BK; ++j) {
            const float4* kr = reinterpret_cast<const float4*>(sk + j * DH);
            double dot = 0;  // float64 sums: see the head of this file
#pragma unroll
            for (int c = 0; c < NC; ++c) {
                const float4 kk = kr[part + TPR * c];
                dot = fma(double(q[4 * c + 0]), double(kk.x), dot);
                dot = fma(double(q[4 * c + 1]), double(kk.y), dot);
                dot = fma(double(q[4 * c + 2]), double(kk.z), dot);
                dot = fma(double(q[4 * c + 3]), double(kk.w), dot);
            }
#pragma unroll
            for (int o = 1; o < TPR; o <<= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
            float x = float(dot) * a.scale;
            if (a.has_cap) x = a.cap * tanhf(x / a.cap);
            const int kp = k0 + j;
            bool ok = kp < kv_len;
            if (a.causal) ok = ok && kp <= qpos;
            if (a.has_window) ok = ok && kp > qpos - a.window;
            s[j] = ok ? x : NEG_INF;
            m_tile = fmaxf(m_tile, s[j]);
        }
        const float m_new = fmaxf(m, m_tile);
        const float alpha = expf(m - m_new);
        float l_tile = 0.f, pv[4 * NC];
#pragma unroll
        for (int i = 0; i < 4 * NC; ++i) pv[i] = 0.f;
#pragma unroll
        for (int j = 0; j < BK; ++j) {
            const float p = expf(s[j] - m_new);
            l_tile += p;
            const float4* vr = reinterpret_cast<const float4*>(sv + j * DH);
#pragma unroll
            for (int c = 0; c < NC; ++c) {
                const float4 vv = vr[part + TPR * c];
                pv[4 * c + 0] = fmaf(p, vv.x, pv[4 * c + 0]);
                pv[4 * c + 1] = fmaf(p, vv.y, pv[4 * c + 1]);
                pv[4 * c + 2] = fmaf(p, vv.z, pv[4 * c + 2]);
                pv[4 * c + 3] = fmaf(p, vv.w, pv[4 * c + 3]);
            }
        }
        l = fmaf(l, alpha, l_tile);
#pragma unroll
        for (int i = 0; i < 4 * NC; ++i) acc[i] = fmaf(acc[i], alpha, pv[i]);
        m = m_new;
    }

    if (row_ok) {
        float* op = a.o + bb * a.o_sb + (long long)qi * a.o_ss + hh * a.o_sh;
        const float den = fmaxf(l, 1e-37f);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
#pragma unroll
            for (int e = 0; e < 4; ++e) op[4 * (part + TPR * c) + e] = acc[4 * c + e] / den;
        }
    }
}

template <int DH, int BK, int TPR>
cudaError_t run(const Args& a, int b, cudaStream_t stream) {
    constexpr int smem = 2 * BK * DH * (int)sizeof(float);
    constexpr int BQ = NT / TPR;
    cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<DH, BK, TPR>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    const dim3 grid((a.sq + BQ - 1) / BQ, a.h, b);
    flash_fwd_kernel<DH, BK, TPR><<<grid, NT, smem, stream>>>(a);
    return cudaGetLastError();
}

// BK keys per tile: 64, and 32 at Dh 256 (at most 80 KB of float32 K and V);
// TPR threads per row: 4, and 8 from Dh 128 on (at most 40 floats each of q,
// acc and p.v per thread)
cudaError_t dispatch(int dh, const Args& a, int b, cudaStream_t stream) {
    switch (dh) {
        case 16: return run<16, 64, 4>(a, b, stream);
        case 32: return run<32, 64, 4>(a, b, stream);
        case 64: return run<64, 64, 4>(a, b, stream);
        case 96: return run<96, 64, 4>(a, b, stream);
        case 128: return run<128, 64, 8>(a, b, stream);
        case 160: return run<160, 64, 8>(a, b, stream);
        case 256: return run<256, 32, 8>(a, b, stream);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

// float32 tensors.  Strides in elements.  Returns a cudaError_t.
extern "C" int flash_fwd(int dh, const void* q, const void* k, const void* v, void* o,
                         long long q_sb, long long q_ss, long long q_sh,
                         long long k_sb, long long k_ss, long long k_sh,
                         long long v_sb, long long v_ss, long long v_sh,
                         long long o_sb, long long o_ss, long long o_sh,
                         int b, int sq, int skv, int h, int kh,
                         const void* qoff_ptr, int qoff, const void* kvlen_ptr, int kvlen,
                         int causal, int has_window, int window, int has_cap, float cap, float scale,
                         void* stream) {
    Args a{static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
           static_cast<float*>(o),
           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,
           sq, skv, h, kh,
           static_cast<const int*>(qoff_ptr), qoff, static_cast<const int*>(kvlen_ptr), kvlen,
           causal, has_window, window, has_cap, cap, scale};
    if (b <= 0 || sq <= 0 || h <= 0 || kh <= 0 || h % kh != 0) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return (int)dispatch(dh, a, b, s);
}
