// Forward flash attention for float32 inputs on Hopper (sm_90a), written by hand.
//
// Replaces the reference's Pallas TPU kernel
// src/repro/kernels/flash_attention/kernel.py (_flash_kernel, launched by
// flash_attention_bhsd, wrapped by ops.py::flash_attention).  Same function:
// softmax(q k^T * Dh^-1/2, soft-capped, masked) v with a float32 online
// softmax (acc, m, l); GQA/MQA (kv head = h / (H / Kh)); causal, a sliding
// window, a tanh soft-cap and q_offset / kv_len (decode rows); kv tiles that
// are wholly masked are never loaded; a row left with no valid key is 0.
// Masked scores are the finite -1e30 of the reference, so exp(s - m) never
// forms inf - inf.  bfloat16 inputs go to flash_fwd_sm90.cu.
//
// Layout: the model's (B, S, H, Dh), read through strides (Dh contiguous);
// ragged q and kv edges are masked here, not padded by the wrapper.
//
// Accuracy.  A float32 sum of Dh products carries a rounding error of some
// 1e-6 in the scores, which moves outputs near zero by more than the
// reference's float32 tolerance of 2e-6 at long sequences, and TF32 keeps
// three decimal digits.  So the scores are summed in float64: the product of
// two float32 values is exact in float64.  Each kv tile's p and p.v are
// summed apart and then added to (l, acc), as the reference's online softmax
// does; the softmax runs in float32, in log2 units (ex2.approx).
//
// Bound on an H100: operations.  4 * Dh flops per (query, key) pair seen, in
// all 103 GFLOP at B 4, S 2048, H 32, Dh 96 causal: 1.5 ms at the 67
// TFLOP/s of the float64 tensor cores (DMMA), the rate of the float32 CUDA
// cores as well.
//
// Design.  What capped the first version was not the float64 sums but the
// conversion of every k (and q) element to float64 at every use: float <->
// double conversions issue at 16 a clock on an SM.  Here
// * the block's Q tile and each K tile are staged in shared memory as
//   float64, each element converted once where it is staged, and warps form
//   S = Q K^T with mma.sync f64 fragments on the tensor cores (m16n8k8 for
//   16 rows a warp, m8n8k4 for 8), with no shuffles for the dot products;
//   rows of the float64 tiles are padded so that the fragments' loads hit
//   distinct banks;
// * up to Dh 96, P.V runs on the float64 tensor cores too: each p is
//   converted once and is already the A fragment (the score fragment's
//   layout is the operand's, up to an order of the keys, which a sum over
//   keys does not see), V is staged as float64 once, and the tile's p.v
//   sums in float64 before it is added to the float32 acc.  From Dh 128 on
//   its float64 accumulators do not fit the registers, and P.V runs in
//   float32 on the CUDA cores with register tiling: the thread that holds a
//   row's scores owns that row's output at Dh / 4 columns, so each v loaded
//   serves all its rows and each p (shared within the quad by shuffles)
//   Dh / 4 columns (at Dh 96 this took 3.98 ms against DMMA's 2.90, see
//   PERF.md);
// * K and V tiles load by cp.async (16-byte chunks where rows are 16-byte
//   aligned, else 4-byte) into a float32 buffer while the previous tile is
//   computed, and are converted from there (two buffers where P.V reads V
//   in float32); Q loads the same way with the first tile;
// * blocks of the longest causal rows are scheduled first; a warp skips a
//   kv tile that none of its rows can see, and masks only tiles that cross
//   an edge of its rows' visible keys.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

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
    int vec;  // Q, K and V rows start on 16-byte boundaries: 16-byte copies
};

// d += a * b on an 8 x 8 x 4 float64 tile.  Lane (g = lane / 4, t = lane % 4)
// holds a = A[g][t], b = B[t][g] and d = D[g][2t], D[g][2t + 1].
__device__ __forceinline__ void dmma(double& d0, double& d1, double a, double b) {
    asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%4, %5};\n"
                 : "=d"(d0), "=d"(d1)
                 : "d"(a), "d"(b), "d"(d0), "d"(d1));
}

// d += a * b on a 16 x 8 x 8 float64 tile.  Lane (g, t) holds a = A[g][t],
// A[g + 8][t], A[g][t + 4], A[g + 8][t + 4]; b = B[t][g], B[t + 4][g]; d =
// D[g][2t], D[g][2t + 1], D[g + 8][2t], D[g + 8][2t + 1].
__device__ __forceinline__ void dmma16(double (&d)[4], double a0, double a1, double a2, double a3, double b0,
                                       double b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%10, %11, %12, %13};\n"
        : "=d"(d[0]), "=d"(d[1]), "=d"(d[2]), "=d"(d[3])
        : "d"(a0), "d"(a1), "d"(a2), "d"(a3), "d"(b0), "d"(b1), "d"(d[0]), "d"(d[1]), "d"(d[2]), "d"(d[3]));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
    const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(valid ? 4 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// 2^x on the special-function unit (relative error some 2^-22; results
// below 2^-126 flush to 0)
__device__ __forceinline__ float exp2_approx(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// Row pitches of the float64 tiles, in doubles, padded so that the
// fragments' loads hit distinct banks (16 banks of 8 bytes): the lanes of an
// A or B fragment of Q or K read rows g, columns t, at 4 g + t mod 16; those
// of a P.V B fragment of V rows 2 t + h, columns g, at 4 t + 2 h + g mod 16.
template <int DH>
struct Pitch {
    static constexpr int QK = DH + 4, V = DH + 2;
};

// The block's kv range: tiles wholly masked by kv_len, causality or the
// window are skipped.
struct KeyRange {
    int qoff, kv_len, k_begin, k_end;
};

template <int BQ, int BK>
__device__ __forceinline__ KeyRange key_range(const Args& a, int q0) {
    KeyRange r;
    r.qoff = a.qoff_ptr ? *a.qoff_ptr : a.qoff;
    r.kv_len = min(a.kvlen_ptr ? *a.kvlen_ptr : a.kvlen, a.skv);
    const int last_qpos = r.qoff + min(q0 + BQ, a.sq) - 1;
    r.k_end = r.kv_len;
    if (a.causal) r.k_end = min(r.k_end, last_qpos + 1);
    r.k_begin = a.has_window ? max(0, r.qoff + q0 - a.window + 1) : 0;
    r.k_begin -= r.k_begin % BK;
    return r;
}

// Q (BQ, DH) as float32 by cp.async into dst (row pitch DH), zeros past the
// end; one commit group
template <int DH, int BQ, int NT>
__device__ __forceinline__ void load_q(const Args& a, float* dst, int q0, int hh, int bb, int tid) {
    const float* qb = a.q + bb * a.q_sb + hh * a.q_sh;
    if (a.vec) {
        for (int e = tid; e < BQ * DH / 4; e += NT) {
            const int r = e / (DH / 4), c = 4 * (e - r * (DH / 4)), qi = q0 + r;
            const bool ok = qi < a.sq;
            cp_async16(dst + 4 * e, qb + (long long)(ok ? qi : 0) * a.q_ss + c, ok);
        }
    } else {
        for (int e = tid; e < BQ * DH; e += NT) {
            const int r = e / DH, c = e - r * DH, qi = q0 + r;
            const bool ok = qi < a.sq;
            cp_async4(dst + e, qb + (long long)(ok ? qi : 0) * a.q_ss + c, ok);
        }
    }
    cp_async_commit();
}

// Q from where load_q left it to float64 in its padded tile, once
template <int DH, int BQ, int NT>
__device__ __forceinline__ void convert_q(const float* src, double* sq, int tid) {
    const float2* rq = reinterpret_cast<const float2*>(src);
    for (int e = tid; e < BQ * DH / 2; e += NT) {
        const int r = e / (DH / 2), c = 2 * (e - r * (DH / 2));
        const float2 x = rq[e];
        *reinterpret_cast<double2*>(sq + r * Pitch<DH>::QK + c) = make_double2(x.x, x.y);
    }
}

// cp.async of K and V rows k0 .. k0 + BK (zeros past kv_len) into dk, dv
// (BK, DH) float32, by threads tid of nt; one commit group
template <int DH, int BK>
__device__ __forceinline__ void load_kv(const Args& a, const float* kb, const float* vb, float* dk, float* dv,
                                        int k0, int kv_len, int tid, int nt) {
    if (a.vec) {
        for (int e = tid; e < BK * DH / 4; e += nt) {
            const int j = e / (DH / 4), c = 4 * (e - j * (DH / 4)), kp = k0 + j;
            const bool ok = kp < kv_len;
            const long long r = ok ? kp : 0;
            cp_async16(dk + 4 * e, kb + r * a.k_ss + c, ok);
            cp_async16(dv + 4 * e, vb + r * a.v_ss + c, ok);
        }
    } else {
        for (int e = tid; e < BK * DH; e += nt) {
            const int j = e / DH, c = e - j * DH, kp = k0 + j;
            const bool ok = kp < kv_len;
            const long long r = ok ? kp : 0;
            cp_async4(dk + e, kb + r * a.k_ss + c, ok);
            cp_async4(dv + e, vb + r * a.v_ss + c, ok);
        }
    }
    cp_async_commit();
}

// c[mt][j][hf] = the float64 score of row r0 + 8 mt + g and key 8 j + 2 tg + hf
// of the tile, on the tensor cores: m16n8k8 for 16 rows a warp, m8n8k4 for 8
template <int DH, int MT, int NJ>
__device__ __forceinline__ void scores(double (&c)[MT][NJ][2], const double* sq, const double* sk, int r0, int g,
                                       int tg) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < NJ; ++j) c[mt][j][0] = c[mt][j][1] = 0.0;
    constexpr int P = Pitch<DH>::QK;
    const double* qa = sq + (r0 + g) * P + tg;
    const double* kf = sk + g * P + tg;
    if constexpr (MT == 2) {
#pragma unroll
        for (int kk = 0; kk < DH; kk += 8) {
            const double a0 = qa[kk], a1 = qa[8 * P + kk], a2 = qa[kk + 4], a3 = qa[8 * P + kk + 4];
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
                double d[4] = {c[0][j][0], c[0][j][1], c[1][j][0], c[1][j][1]};
                dmma16(d, a0, a1, a2, a3, kf[j * 8 * P + kk], kf[j * 8 * P + kk + 4]);
                c[0][j][0] = d[0];
                c[0][j][1] = d[1];
                c[1][j][0] = d[2];
                c[1][j][1] = d[3];
            }
        }
    } else {
#pragma unroll
        for (int kk = 0; kk < DH; kk += 4) {
            const double af = qa[kk];
#pragma unroll
            for (int j = 0; j < NJ; ++j) dmma(c[0][j][0], c[0][j][1], af, kf[j * 8 * P + kk]);
        }
    }
}

// The tile's scores in log2 units, its p (in place of the scores) and the
// online softmax (m, l, alpha) of the lane's rows; a row's four lanes (one
// quad) share its max and sum by shuffles.  mask: the tile crosses an edge of
// the visible keys of the warp's rows.
template <int MT, int NJ>
__device__ __forceinline__ void softmax_tile(const double (&c)[MT][NJ][2], float (&p)[MT][NJ][2], float (&m)[MT],
                                             float (&l)[MT], float (&alpha)[MT], const Args& a, bool mask,
                                             int qpos0, int k0, int kv_len, int tg) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
        const int qpos = qpos0 + mt * 8;
        float mx = NEG_INF;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
                float x = float(c[mt][j][hf]);
                if (a.has_cap) x = a.cap * tanhf(x * a.scale / a.cap) * LOG2E;
                else x *= a.scale * LOG2E;
                if (mask) {
                    const int kp = k0 + 8 * j + 2 * tg + hf;
                    bool ok = kp < kv_len;
                    if (a.causal) ok = ok && kp <= qpos;
                    if (a.has_window) ok = ok && kp > qpos - a.window;
                    x = ok ? x : NEG_INF;
                }
                p[mt][j][hf] = x;
                mx = fmaxf(mx, x);
            }
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[mt], mx);
        alpha[mt] = exp2_approx(m[mt] - m_new);
        float lt = 0.f;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
                p[mt][j][hf] = exp2_approx(p[mt][j][hf] - m_new);
                lt += p[mt][j][hf];
            }
        }
        lt += __shfl_xor_sync(0xffffffffu, lt, 1);
        lt += __shfl_xor_sync(0xffffffffu, lt, 2);
        l[mt] = fmaf(l[mt], alpha[mt], lt);
        m[mt] = m_new;
    }
}

// Whether the warp's rows (positions w_first .. w_last) see any key of the
// tile at k0, and whether they see all of them
struct TileView {
    bool live, mask;
};

template <int BK>
__device__ __forceinline__ TileView tile_view(const Args& a, int k0, int kv_len, int w_first, int w_last) {
    TileView v;
    v.live = w_first <= w_last;
    if (a.causal) v.live = v.live && k0 <= w_last;
    if (a.has_window) v.live = v.live && k0 + BK - 1 > w_first - a.window;
    v.mask = k0 + BK > kv_len;
    if (a.causal) v.mask = v.mask || k0 + BK - 1 > w_first;
    if (a.has_window) v.mask = v.mask || k0 <= w_last - a.window;
    return v;
}

// ---------------------------------------------------------------------------
// Dh <= 96: both products on the float64 tensor cores.  Eight warps own 16
// query rows each.  K and V of the next tile load by cp.async into a float32
// buffer while this tile is computed; at the top of a tile the block
// converts them once into the float64 tiles.
// ---------------------------------------------------------------------------

template <int DH, int BK>
struct DmmaSmem {
    static constexpr int BQ = 128, NT = 256;
    static constexpr int Q = 0;                                 // (BQ, DH) float64
    static constexpr int KD = Q + BQ * Pitch<DH>::QK * 8;       // (BK, DH) float64
    static constexpr int VD = KD + BK * Pitch<DH>::QK * 8;      // (BK, DH) float64
    static constexpr int RAW = VD + BK * Pitch<DH>::V * 8;      // K then V (BK, DH) float32
    static constexpr int BYTES = RAW + 2 * BK * DH * 4;
    static_assert(RAW - KD >= BQ * DH * 4, "Q lands as float32 where K and V go");
};

template <int DH, int BK>
__global__ void __launch_bounds__(256, 1) flash_fwd_dmma_kernel(const Args a) {
    using L = DmmaSmem<DH, BK>;
    constexpr int BQ = L::BQ, NT = L::NT;
    constexpr int NJ = BK / 8;  // 8-key column tiles of a score tile
    constexpr int NN = DH / 8;  // 8-column tiles of the output
    constexpr int NH = NN / 2;  // of them a P.V pass
    extern __shared__ __align__(16) unsigned char smem[];
    double* sq = reinterpret_cast<double*>(smem + L::Q);
    double* skd = reinterpret_cast<double*>(smem + L::KD);
    double* svd = reinterpret_cast<double*>(smem + L::VD);
    float* sraw = reinterpret_cast<float*>(smem + L::RAW);

    const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, tg = lane & 3;
    const int r0 = (tid >> 5) * 16;  // the warp's first row in the block
    const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ, hh = blockIdx.y, bb = blockIdx.z;
    const KeyRange kr = key_range<BQ, BK>(a, q0);
    const int w_first = kr.qoff + q0 + r0, w_last = kr.qoff + min(q0 + r0 + 16, a.sq) - 1;
    const int kvh = hh / (a.h / a.kh);
    const float* kb = a.k + bb * a.k_sb + kvh * a.k_sh;
    const float* vb = a.v + bb * a.v_sb + kvh * a.v_sh;

    // Q lands as float32 where the float64 K and V go, together with the
    // first tile's K and V, and is converted from there
    load_q<DH, BQ, NT>(a, reinterpret_cast<float*>(skd), q0, hh, bb, tid);
    if (kr.k_begin < kr.k_end) load_kv<DH, BK>(a, kb, vb, sraw, sraw + BK * DH, kr.k_begin, kr.kv_len, tid, NT);
    cp_async_wait_all();
    __syncthreads();
    convert_q<DH, BQ, NT>(reinterpret_cast<const float*>(skd), sq, tid);
    // the first tile's barrier orders these reads before K and V are converted over them
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
    float acc[NN][4];  // rows g, g + 8 (the m16n8 layout), columns 8 n + 2 tg + hf
#pragma unroll
    for (int n = 0; n < NN; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

    for (int k0 = kr.k_begin; k0 < kr.k_end; k0 += BK) {
        cp_async_wait_all();
        __syncthreads();  // tile k0 has landed; every warp is done with the previous tile
        const float2* rk = reinterpret_cast<const float2*>(sraw);
        const float2* rv = reinterpret_cast<const float2*>(sraw + BK * DH);
        for (int e = tid; e < BK * DH / 2; e += NT) {  // to float64, once; neighbouring threads, neighbouring pairs
            const int j = e / (DH / 2), c = 2 * (e - j * (DH / 2));
            const float2 x = rk[e], y = rv[e];
            *reinterpret_cast<double2*>(skd + j * Pitch<DH>::QK + c) = make_double2(x.x, x.y);
            *reinterpret_cast<double2*>(svd + j * Pitch<DH>::V + c) = make_double2(y.x, y.y);
        }
        __syncthreads();
        if (k0 + BK < kr.k_end)  // the next tile loads while this one is computed
            load_kv<DH, BK>(a, kb, vb, sraw, sraw + BK * DH, k0 + BK, kr.kv_len, tid, NT);
        const TileView tv = tile_view<BK>(a, k0, kr.kv_len, w_first, w_last);
        if (!tv.live) continue;  // warp-uniform: mma.sync and the shuffles need the whole warp

        double c[2][NJ][2];
        scores<DH, 2, NJ>(c, sq, skd, r0, g, tg);
        float p[2][NJ][2], alpha[2];
        softmax_tile<2, NJ>(c, p, m, l, alpha, a, tv.mask, w_first + g, k0, kr.kv_len, tg);
        // P.V: the A fragment of the 8-key step j holds key 8 j + 2 tg + hf at
        // k = tg + 4 hf, which is where the score fragment left its p (a sum
        // over keys does not see their order).  The tile's p.v sums in
        // float64 on its own, in two passes over the columns (for the
        // registers), and is then added to the float32 acc.
        double pa[NJ][4];
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
            pa[j][0] = p[0][j][0];
            pa[j][1] = p[1][j][0];
            pa[j][2] = p[0][j][1];
            pa[j][3] = p[1][j][1];
        }
#pragma unroll
        for (int n0 = 0; n0 < NN; n0 += NH) {
            double pv[NH][4];
#pragma unroll
            for (int n = 0; n < NH; ++n) pv[n][0] = pv[n][1] = pv[n][2] = pv[n][3] = 0.0;
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
                const double* vr = svd + (8 * j + 2 * tg) * Pitch<DH>::V + 8 * n0 + g;
#pragma unroll
                for (int n = 0; n < NH; ++n)
                    dmma16(pv[n], pa[j][0], pa[j][1], pa[j][2], pa[j][3], vr[8 * n], vr[Pitch<DH>::V + 8 * n]);
            }
#pragma unroll
            for (int n = 0; n < NH; ++n) {
                acc[n0 + n][0] = fmaf(acc[n0 + n][0], alpha[0], float(pv[n][0]));
                acc[n0 + n][1] = fmaf(acc[n0 + n][1], alpha[0], float(pv[n][1]));
                acc[n0 + n][2] = fmaf(acc[n0 + n][2], alpha[1], float(pv[n][2]));
                acc[n0 + n][3] = fmaf(acc[n0 + n][3], alpha[1], float(pv[n][3]));
            }
        }
    }

#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
        const int qi = q0 + r0 + mt * 8 + g;
        if (qi >= a.sq) continue;
        float* op = a.o + bb * a.o_sb + (long long)qi * a.o_ss + hh * a.o_sh;
        const float den = fmaxf(l[mt], 1e-37f);
#pragma unroll
        for (int n = 0; n < NN; ++n)
            reinterpret_cast<float2*>(op)[4 * n + tg] =
                make_float2(acc[n][2 * mt] / den, acc[n][2 * mt + 1] / den);
    }
}

// ---------------------------------------------------------------------------
// Dh >= 128: scores on the float64 tensor cores, P.V in float32 on the CUDA
// cores (the float64 accumulators of a DMMA P.V do not fit the registers).
// Every warp owns 8 MT query rows; the thread that holds a row's scores in
// the mma fragment owns that row's output at Dh / 4 columns, so each v
// loaded serves its MT rows and each p (shared in the quad by shuffles) Dh /
// 4 columns.  K and V load by cp.async into two float32 buffers (P.V reads
// V there); K is converted to float64 once a tile by the whole block.
// ---------------------------------------------------------------------------

template <int DH, int BQ, int BK>
struct CcSmem {
    static constexpr int Q = 0;                               // (BQ, DH) float64
    static constexpr int RAW0 = Q + BQ * Pitch<DH>::QK * 8;   // K then V (BK, DH) float32
    static constexpr int KD = RAW0 + 2 * BK * DH * 4;         // (BK, DH) float64
    static constexpr int RAW1 = KD + BK * Pitch<DH>::QK * 8;  // the other K then V buffer
    static constexpr int BYTES = RAW1 + 2 * BK * DH * 4;
    static_assert(BYTES - KD >= BQ * DH * 4, "Q lands as float32 where K and the second buffer go");
};

template <int DH, int BQ, int BK, int MT>
__global__ void __launch_bounds__(32 * BQ / (8 * MT), 1) flash_fwd_cc_kernel(const Args a) {
    constexpr int NT = 32 * BQ / (8 * MT);
    constexpr int NJ = BK / 8;
    constexpr int NC = DH / 16;  // float4 chunks of a row's output one thread owns
    using L = CcSmem<DH, BQ, BK>;
    extern __shared__ __align__(16) unsigned char smem[];
    double* sq = reinterpret_cast<double*>(smem + L::Q);
    double* skd = reinterpret_cast<double*>(smem + L::KD);
    float* const raw0 = reinterpret_cast<float*>(smem + L::RAW0);
    float* const raw1 = reinterpret_cast<float*>(smem + L::RAW1);

    const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, tg = lane & 3;
    const int r0 = (tid >> 5) * 8 * MT;  // the warp's first row in the block
    const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ, hh = blockIdx.y, bb = blockIdx.z;
    const KeyRange kr = key_range<BQ, BK>(a, q0);
    const int w_first = kr.qoff + q0 + r0, w_last = kr.qoff + min(q0 + r0 + 8 * MT, a.sq) - 1;
    const int kvh = hh / (a.h / a.kh);
    const float* kb = a.k + bb * a.k_sb + kvh * a.k_sh;
    const float* vb = a.v + bb * a.v_sb + kvh * a.v_sh;

    // Q lands as float32 where K and the second buffer go, together with the
    // first tile's K and V, and is converted from there
    load_q<DH, BQ, NT>(a, reinterpret_cast<float*>(skd), q0, hh, bb, tid);
    if (kr.k_begin < kr.k_end) load_kv<DH, BK>(a, kb, vb, raw0, raw0 + BK * DH, kr.k_begin, kr.kv_len, tid, NT);
    cp_async_wait_all();
    __syncthreads();
    convert_q<DH, BQ, NT>(reinterpret_cast<const float*>(skd), sq, tid);
    // the first tile's barriers order these reads before K is converted and
    // the second buffer loads over them
    float m[MT], l[MT], acc[MT][4 * NC];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
        m[mt] = NEG_INF;
        l[mt] = 0.f;
#pragma unroll
        for (int i = 0; i < 4 * NC; ++i) acc[mt][i] = 0.f;
    }

    int buf = 0;
    for (int k0 = kr.k_begin; k0 < kr.k_end; k0 += BK, buf ^= 1) {
        cp_async_wait_all();
        __syncthreads();  // tile k0 has landed; every warp is done with the previous tile
        float* const cur = buf ? raw1 : raw0;
        float* const nxt = buf ? raw0 : raw1;
        const float2* rk = reinterpret_cast<const float2*>(cur);
        for (int e = tid; e < BK * DH / 2; e += NT) {  // K to float64, once
            const int j = e / (DH / 2), c = 2 * (e - j * (DH / 2));
            const float2 x = rk[e];
            *reinterpret_cast<double2*>(skd + j * Pitch<DH>::QK + c) = make_double2(x.x, x.y);
        }
        __syncthreads();
        if (k0 + BK < kr.k_end)  // the next tile loads while this one is computed
            load_kv<DH, BK>(a, kb, vb, nxt, nxt + BK * DH, k0 + BK, kr.kv_len, tid, NT);
        const TileView tv = tile_view<BK>(a, k0, kr.kv_len, w_first, w_last);
        if (!tv.live) continue;  // warp-uniform

        double c[MT][NJ][2];
        scores<DH, MT, NJ>(c, sq, skd, r0, g, tg);
        float p[MT][NJ][2], alpha[MT];
        softmax_tile<MT, NJ>(c, p, m, l, alpha, a, tv.mask, w_first + g, k0, kr.kv_len, tg);

        // P.V, keys in order: the thread owns columns 4 (tg + 4 cc) + e of
        // its rows; p of key 8 j + 2 src + hf comes from the quad's lane src
        const float* rv = cur + BK * DH;
        float pv[MT][4 * NC];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int i = 0; i < 4 * NC; ++i) pv[mt][i] = 0.f;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
#pragma unroll
            for (int src = 0; src < 4; ++src) {
#pragma unroll
                for (int hf = 0; hf < 2; ++hf) {
                    float pk[MT];
#pragma unroll
                    for (int mt = 0; mt < MT; ++mt) pk[mt] = __shfl_sync(0xffffffffu, p[mt][j][hf], (lane & ~3) | src);
                    const float4* vr = reinterpret_cast<const float4*>(rv + (8 * j + 2 * src + hf) * DH);
#pragma unroll
                    for (int cc = 0; cc < NC; ++cc) {
                        const float4 vv = vr[tg + 4 * cc];
#pragma unroll
                        for (int mt = 0; mt < MT; ++mt) {
                            pv[mt][4 * cc + 0] = fmaf(pk[mt], vv.x, pv[mt][4 * cc + 0]);
                            pv[mt][4 * cc + 1] = fmaf(pk[mt], vv.y, pv[mt][4 * cc + 1]);
                            pv[mt][4 * cc + 2] = fmaf(pk[mt], vv.z, pv[mt][4 * cc + 2]);
                            pv[mt][4 * cc + 3] = fmaf(pk[mt], vv.w, pv[mt][4 * cc + 3]);
                        }
                    }
                }
            }
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int i = 0; i < 4 * NC; ++i) acc[mt][i] = fmaf(acc[mt][i], alpha[mt], pv[mt][i]);
    }

#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
        const int qi = q0 + r0 + mt * 8 + g;
        if (qi >= a.sq) continue;
        float* op = a.o + bb * a.o_sb + (long long)qi * a.o_ss + hh * a.o_sh;
        const float den = fmaxf(l[mt], 1e-37f);
#pragma unroll
        for (int cc = 0; cc < NC; ++cc)
            reinterpret_cast<float4*>(op)[tg + 4 * cc] = make_float4(
                acc[mt][4 * cc] / den, acc[mt][4 * cc + 1] / den, acc[mt][4 * cc + 2] / den, acc[mt][4 * cc + 3] / den);
    }
}

template <typename K>
cudaError_t launch(K kernel, int bq, int threads, int smem, const Args& a, int b, cudaStream_t stream) {
    if (smem > 232448) return cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    const dim3 grid((a.sq + bq - 1) / bq, a.h, b);
    kernel<<<grid, threads, smem, stream>>>(a);
    return cudaGetLastError();
}

// P.V on the float64 tensor cores: BQ 128 rows, BK keys a tile
template <int DH, int BK>
cudaError_t run_dmma(const Args& a, int b, cudaStream_t stream) {
    static_assert(DmmaSmem<DH, BK>::BYTES <= 232448 && DH % 16 == 0 && BK % 8 == 0, "tile shapes");
    return launch(flash_fwd_dmma_kernel<DH, BK>, DmmaSmem<DH, BK>::BQ, DmmaSmem<DH, BK>::NT, DmmaSmem<DH, BK>::BYTES,
                  a, b, stream);
}

// P.V on the CUDA cores: BQ rows, BK keys a tile, MT 8-row tiles a warp
template <int DH, int BQ, int BK, int MT>
cudaError_t run_cc(const Args& a, int b, cudaStream_t stream) {
    static_assert(CcSmem<DH, BQ, BK>::BYTES <= 232448 && DH % 16 == 0 && BK % 8 == 0 && BQ % (8 * MT) == 0,
                  "tile shapes");
    return launch(flash_fwd_cc_kernel<DH, BQ, BK, MT>, BQ, 32 * BQ / (8 * MT), CcSmem<DH, BQ, BK>::BYTES, a, b,
                  stream);
}

// The tiles a head dim takes: at most 227 KB of shared memory and 255
// registers a thread.  The same table is ref.py's F32_TILES.
cudaError_t dispatch(int dh, const Args& a, int b, cudaStream_t stream) {
    switch (dh) {
        case 16: return run_dmma<16, 32>(a, b, stream);
        case 32: return run_dmma<32, 32>(a, b, stream);
        case 64: return run_dmma<64, 32>(a, b, stream);
        case 96: return run_dmma<96, 32>(a, b, stream);
        case 128: return run_cc<128, 64, 32, 1>(a, b, stream);
        case 160: return run_cc<160, 64, 32, 1>(a, b, stream);
        case 256: return run_cc<256, 32, 16, 1>(a, b, stream);
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
    const bool vec =
        (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16 == 0 &&
        (q_sb | q_ss | q_sh | k_sb | k_ss | k_sh | v_sb | v_ss | v_sh) % 4 == 0;
    Args a{static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
           static_cast<float*>(o),
           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,
           sq, skv, h, kh,
           static_cast<const int*>(qoff_ptr), qoff, static_cast<const int*>(kvlen_ptr), kvlen,
           causal, has_window, window, has_cap, cap, scale, int(vec)};
    if (b <= 0 || sq <= 0 || h <= 0 || kh <= 0 || h % kh != 0) return (int)cudaErrorInvalidValue;
    if ((reinterpret_cast<uintptr_t>(o) % 16) || (o_sb | o_ss | o_sh) % 4) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return (int)dispatch(dh, a, b, s);
}
