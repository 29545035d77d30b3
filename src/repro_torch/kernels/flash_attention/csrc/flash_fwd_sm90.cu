// Forward flash attention for Hopper (sm_90a) in bfloat16 on the tensor cores,
// written by hand.
//
// Replaces the reference's Pallas TPU kernel
// src/repro/kernels/flash_attention/kernel.py (_flash_kernel, launched by
// flash_attention_bhsd) for bfloat16 inputs; float32 inputs keep flash_fwd.cu.
// Same function: softmax(q k^T * Dh^-1/2, soft-capped, masked) v with a
// float32 online softmax (acc, m, l); GQA/MQA (kv head = h / (H / Kh)); causal,
// a sliding window, a tanh soft-cap and q_offset / kv_len (decode rows), each
// an int or a 0-d device tensor read here; kv tiles that are wholly masked are
// never loaded; masked scores are the finite -1e30 of the reference; a row
// left with no valid key is 0.  One difference: P is rounded to bfloat16
// before the P.V product (the tensor cores' operand type), where the reference
// keeps it in float32; the reference's bfloat16 tolerance (2e-2) covers it.
//
// Layout: the model's (B, S, H, Dh), read through strides (Dh contiguous,
// 16-byte aligned rows); ragged q and kv edges are masked here.
//
// Bound on an H100: operations.  4 * B * H * Sq * Skv * Dh / 2 flops for a
// causal prefill (0.10 ms at B 4, S 2048, H 32, Dh 96 at the 989 TFLOP/s
// bfloat16 peak) against 2 bytes of q, k, v and o read or written once.
//
// Design: one block of two warpgroups (256 threads) per (b, h, tile of 128
// query rows), 64 rows per warpgroup; late (causally heavier) q tiles first.
// Both products run on the tensor cores with wgmma.mma_async and float32
// accumulators in registers: S = Q K^T with Q and the K tile read from shared
// memory (K-major), then O += P V with P taken from the S accumulators,
// rounded to bfloat16 in registers, as the register A operand, and V read
// from shared memory (MN-major, the transposed B of wgmma).  No score tile
// goes to shared or device memory.  K and V tiles of BK keys (128, or 64 for
// Dh 160 and 256) come through rings filled with cp.async (two K tiles,
// three V tiles), so that the next tile's copy overlaps this tile's work,
// with one barrier per tile.  Each warpgroup issues tile t's Q K^T and then
// tile t - 1's P V, and runs tile t's softmax on the CUDA cores while that
// P V runs on the tensor cores (P of tile t - 1 waits in registers as
// bfloat16; O is rescaled once the product is in).  Q, K and V sit
// in shared memory in wgmma's swizzled layout: rows of SW bytes (128, 64 or
// 32: the widest that divides Dh), 8 rows to a swizzle atom, the 16-byte
// chunks of a row XORed with the row's place in the atom, and Dh split into
// column blocks of SW / 2 elements.  The online softmax runs on the
// accumulator fragments in log2 units (ex2.approx); the row max goes across the
// four threads that share a row by warp shuffles, each thread keeps a partial
// row sum, summed once at the end; masks are computed only on tiles that
// straddle the causal diagonal, the window's edge or kv_len.  Producer warp
// specialisation, TMA and a persistent schedule are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;  // two warpgroups
constexpr int BQ = 128;  // query rows per block
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

struct Args {
    const void* q;
    const void* k;
    const void* v;
    void* o;
    long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh;
    int sq, skv, h, kh;
    const int* qoff_ptr;  // a 0-d device tensor, or null: then qoff
    int qoff;
    const int* kvlen_ptr;  // likewise for kv_len
    int kvlen;
    int causal, has_window, window, has_cap;
    float cap, scale;
};

// ---- wgmma (PTX ISA, "Asynchronous Warpgroup Level Matrix Multiply-Accumulate")

template <int N>
__device__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int accumulate);
template <int N>
__device__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db);

// D (64 x 64, float32) (+)= A (64 x 16, shared) * B (64 x 16, shared, K-major)^T
template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 128, float32) (+)= A (64 x 16, shared) * B (128 x 16, shared, K-major)^T
template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 16, float32) += A (64 x 16, registers) * B (16 x 16, shared, MN-major)
template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 32, float32) += A (64 x 16, registers) * B (16 x 32, shared, MN-major)
template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 64, float32) += A (64 x 16, registers) * B (16 x 64, shared, MN-major)
template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 96, float32) += A (64 x 16, registers) * B (16 x 96, shared, MN-major)
template <>
__device__ __forceinline__ void wgmma_rs<96>(float (&d)[48], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 128, float32) += A (64 x 16, registers) * B (16 x 128, shared, MN-major)
template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 160, float32) += A (64 x 16, registers) * B (16 x 160, shared, MN-major)
template <>
__device__ __forceinline__ void wgmma_rs<160>(float (&d)[80], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %85, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79}, {%80, %81, %82, %83}, %84, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 256, float32) += A (64 x 16, registers) * B (16 x 256, shared, MN-major)
template <>
__device__ __forceinline__ void wgmma_rs<256>(float (&d)[128], const uint32_t (&a)[4], uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
// wait until at most N committed groups of this warpgroup are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() { asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory"); }

// keep the compiler from moving accesses of the accumulators across the
// asynchronous products
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
    for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// A shared-memory matrix descriptor: start address, leading and stride
// byte offsets (all >> 4) and the swizzle mode (1: 128 B, 2: 64 B, 3: 32 B).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo, uint64_t mode) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16)
           | ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (mode << 62);
}

// A tile of ROWS rows of Dh bfloat16 values in shared memory: Dh in column
// blocks of SW / 2 elements, each block ROWS rows of SW bytes, the 16-byte
// chunks of a row XORed with bits 7.. of the offset (the hardware's swizzle,
// on a 1024-byte aligned base).
template <int SW>
struct Swizzled {
    static constexpr int CHUNKS = SW / 16;  // 16-byte chunks in a row of a block
    static constexpr int COLS = SW / 2;     // elements in a row of a block
    static constexpr uint64_t MODE = SW == 128 ? 1 : (SW == 64 ? 2 : 3);
    // byte offset of the 16-byte chunk c (elements 8c .. 8c + 7) of row r
    template <int ROWS>
    __device__ static __forceinline__ uint32_t chunk(int r, int c) {
        const uint32_t off = (uint32_t)((c / CHUNKS) * ROWS * SW + r * SW + (c % CHUNKS) * 16);
        return off ^ (((off >> 7) & (CHUNKS - 1)) << 4);
    }
};

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
    // 16 bytes, or 16 zero bytes when !valid (nothing is read)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }
// make this thread's shared-memory writes visible to wgmma (the async proxy)
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// 2^x by the special function unit (ex2.approx, relative error ~2^-22; 0 for
// the -1e30 of masked scores)
__device__ __forceinline__ float fast_exp2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even, as torch
    return *reinterpret_cast<const uint32_t*>(&v);
}

// rows row0 .. row0 + ROWS - 1 of (rows, Dh) at base (row stride ld) into a
// swizzled tile; rows at or past nvalid are zero-filled, not read.  Thread t
// copies chunk t % CPR of rows t / CPR, t / CPR + RSTEP, ... (the last
// NT % CPR threads idle), so its addresses only step by constants.
template <int DH, int SW, int ROWS>
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* base, long long ld, int row0, int nvalid,
                                          int tid) {
    constexpr int CPR = DH / 8;       // 16-byte chunks per row
    constexpr int RSTEP = NT / CPR;   // rows per pass of the block's threads
    constexpr int CHUNKS = SW / 16;   // chunks per row of a column block
    const int c = tid % CPR, r = tid / CPR;
    if (r >= RSTEP) return;
    const uint32_t off0 = (c / CHUNKS) * ROWS * SW + r * SW + (c % CHUNKS) * 16;
    const __nv_bfloat16* src = base + (long long)(row0 + r) * ld + 8 * c;
#pragma unroll
    for (int n = 0; n < (ROWS + RSTEP - 1) / RSTEP; ++n) {
        if (r + n * RSTEP < ROWS) {
            const uint32_t off = off0 + n * RSTEP * SW;
            const bool ok = row0 + r + n * RSTEP < nvalid;
            cp_async16(dst + (off ^ (((off >> 7) & (CHUNKS - 1)) << 4)), ok ? src : base, ok);
        }
        src += RSTEP * ld;
    }
}

// O += P V (64 x Dh per warpgroup) with V's tile at s_v, MN-major; issued
// and committed, not waited
template <int DH, int BK, int SW>
__device__ __forceinline__ void issue_pv(float (&o)[DH / 2], const uint32_t (&p)[BK / 16][4], uint32_t s_v) {
#pragma unroll
    for (int j = 0; j < BK / 16; ++j)
        wgmma_rs<DH>(o, p[j], smem_desc(s_v + 16 * j * SW, BK * SW, 8 * SW, Swizzled<SW>::MODE));
    wgmma_commit();
}

template <int DH, int BK>
__global__ void __launch_bounds__(NT, 1) flash_fwd_sm90_kernel(const Args a) {
    constexpr int SW = DH % 64 == 0 ? 128 : (DH % 32 == 0 ? 64 : 32);
    using L = Swizzled<SW>;
    constexpr uint32_t Q_BYTES = BQ * DH * 2, KV_BYTES = BK * DH * 2;
    extern __shared__ __align__(1024) unsigned char smem_raw[];
    // Q, then a ring of two K tiles and one of three V tiles: tile t's V is
    // read by the P V product issued while tile t + 1 computes
    const uint32_t s_q = (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023u) & ~1023u;
    const uint32_t s_k0 = s_q + Q_BYTES, s_v0 = s_k0 + 2 * KV_BYTES;

    const int tid = threadIdx.x, wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
    const int g = lane / 4, qd = lane % 4;  // a thread's rows: g and g + 8 of its warp's 16
    const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
    const int hh = blockIdx.y, bb = blockIdx.z, kvh = hh / (a.h / a.kh);
    const int qoff = a.qoff_ptr ? *a.qoff_ptr : a.qoff;
    const int kv_len = min(a.kvlen_ptr ? *a.kvlen_ptr : a.kvlen, a.skv);
    const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(a.q) + bb * a.q_sb + hh * a.q_sh;
    const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(a.k) + bb * a.k_sb + kvh * a.k_sh;
    const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(a.v) + bb * a.v_sb + kvh * a.v_sh;

    // the keys the block's rows can see: tiles wholly masked by kv_len,
    // causality or the window are skipped
    const int last_qpos = qoff + min(q0 + BQ, a.sq) - 1;
    int k_end = kv_len;
    if (a.causal) k_end = min(k_end, last_qpos + 1);
    int k_begin = a.has_window ? max(0, qoff + q0 - a.window + 1) : 0;
    k_begin -= k_begin % BK;
    const int ntiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

    // this warpgroup's 64 rows, and this thread's two
    const int wq0 = q0 + 64 * wg;
    const bool wg_rows = wq0 < a.sq;
    const int wg_first = qoff + wq0, wg_last = qoff + min(wq0 + 64, a.sq) - 1;
    const int r0 = 16 * warp + g;
    const int qpos0 = wg_first + r0, qpos1 = qpos0 + 8;

    const float scale_log2 = a.scale * LOG2E, scale_over_cap = a.scale / a.cap, cap_log2 = a.cap * LOG2E;
    float o[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
    float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
    float s[BK / 2];
    uint32_t p[BK / 16][4];  // P of the last tile, as the A fragments of P V
    bool pending = false;    // that tile's P V product is still to issue

    if (ntiles > 0) {
        load_tile<DH, SW, BQ>(s_q, qb, a.q_ss, q0, a.sq, tid);
        load_tile<DH, SW, BK>(s_k0, kb, a.k_ss, k_begin, kv_len, tid);
        load_tile<DH, SW, BK>(s_v0, vb, a.v_ss, k_begin, kv_len, tid);
        cp_async_commit();
    }
    for (int it = 0; it < ntiles; ++it) {
        const int k0 = k_begin + it * BK;
        cp_async_wait<0>();
        fence_proxy_async();
        // tile it is in shared memory for every thread, and every thread is
        // done with the slots the next copy fills (K of tile it - 1, V of it - 2)
        __syncthreads();
        if (it + 1 < ntiles) {  // the next tile's copy overlaps this tile's products
            load_tile<DH, SW, BK>(s_k0 + ((it + 1) & 1) * KV_BYTES, kb, a.k_ss, k0 + BK, kv_len, tid);
            load_tile<DH, SW, BK>(s_v0 + ((it + 1) % 3) * KV_BYTES, vb, a.v_ss, k0 + BK, kv_len, tid);
            cp_async_commit();
        }

        const bool live = wg_rows && (!a.causal || k0 <= wg_last) && (!a.has_window || k0 + BK - 1 > wg_first - a.window);
        if (!live) {
            if (pending) {  // the last live tile's P V
                wgmma_fence();
                issue_pv<DH, BK, SW>(o, p, s_v0 + ((it - 1) % 3) * KV_BYTES);
                wgmma_wait<0>();
                fence_regs(o);
                pending = false;
            }
            continue;
        }
        // S = Q K^T (64 x BK per warpgroup), K-major operands; then the
        // previous tile's P V, which runs on the tensor cores while this
        // tile's softmax runs on the CUDA cores
        const uint32_t s_k = s_k0 + (it & 1) * KV_BYTES;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk) {
            const int c = 16 * kk;
            const uint32_t qa = s_q + (c / L::COLS) * (BQ * SW) + 64 * wg * SW + (c % L::COLS) * 2;
            const uint32_t ka = s_k + (c / L::COLS) * (BK * SW) + (c % L::COLS) * 2;
            wgmma_ss<BK>(s, smem_desc(qa, 16, 8 * SW, L::MODE), smem_desc(ka, 16, 8 * SW, L::MODE), kk > 0);
        }
        wgmma_commit();
        if (pending) {
            issue_pv<DH, BK, SW>(o, p, s_v0 + ((it - 1) % 3) * KV_BYTES);
            wgmma_wait<1>();  // S is done; P V may still run
        } else {
            wgmma_wait<0>();
        }
        fence_regs(s);

        // scores in log2 units; element i sits at row r0 (i % 4 < 2) or
        // r0 + 8, key k0 + 8 (i / 4) + 2 qd + i % 2.  (Each branch holds
        // a whole loop, so that the compiler predicates neither.)
        if (a.has_cap) {
#pragma unroll
            for (int i = 0; i < BK / 2; ++i) s[i] = cap_log2 * tanhf(s[i] * scale_over_cap);
        } else {
#pragma unroll
            for (int i = 0; i < BK / 2; ++i) s[i] *= scale_log2;
        }
        const bool edge = k0 + BK > kv_len || (a.causal && k0 + BK - 1 > wg_first)
                          || (a.has_window && k0 <= wg_last - a.window);
        if (edge) {
            // key k0 + 2 qd + c (c = 8 (i / 4) + i % 2) is visible to a row
            // when lo < c <= hi: kv_len and causality bound hi, the window lo
            int hi0 = kv_len - 1 - k0 - 2 * qd, hi1 = hi0, lo0 = -BK, lo1 = -BK;
            if (a.causal) {
                hi0 = min(hi0, qpos0 - k0 - 2 * qd);
                hi1 = min(hi1, qpos1 - k0 - 2 * qd);
            }
            if (a.has_window) {
                lo0 = qpos0 - a.window - k0 - 2 * qd;
                lo1 = qpos1 - a.window - k0 - 2 * qd;
            }
#pragma unroll
            for (int i = 0; i < BK / 2; ++i) {
                const int c = 8 * (i / 4) + (i % 2);
                const bool ok = (i % 4) < 2 ? (c <= hi0 && c > lo0) : (c <= hi1 && c > lo1);
                if (!ok) s[i] = NEG_INF;
            }
        }
        float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
            if ((i % 4) < 2) mx0 = fmaxf(mx0, s[i]);
            else mx1 = fmaxf(mx1, s[i]);
        }
#pragma unroll
        for (int x = 1; x < 4; x <<= 1) {
            mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
            mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
        }
        const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
        const float al0 = fast_exp2(m0 - mn0), al1 = fast_exp2(m1 - mn1);
        m0 = mn0;
        m1 = mn1;
        float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
            s[i] = fast_exp2(s[i] - ((i % 4) < 2 ? mn0 : mn1));
            if ((i % 4) < 2) ls0 += s[i];
            else ls1 += s[i];
        }
        l0 = l0 * al0 + ls0;
        l1 = l1 * al1 + ls1;

        wgmma_wait<0>();  // the previous tile's P V is in O: O and P are free
        fence_regs(o);
#pragma unroll
        for (int i = 0; i < DH / 2; ++i) o[i] *= (i % 4) < 2 ? al0 : al1;
        // P, rounded to bfloat16: the score accumulator's layout is the A
        // operand's (keys 16 j .. 16 j + 15 in elements 8 j .. 8 j + 7)
#pragma unroll
        for (int j = 0; j < BK / 16; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) p[j][e] = pack_bf16(s[8 * j + 2 * e], s[8 * j + 2 * e + 1]);
        }
        pending = true;
    }
    if (pending) {
        wgmma_fence();
        issue_pv<DH, BK, SW>(o, p, s_v0 + ((ntiles - 1) % 3) * KV_BYTES);
        wgmma_wait<0>();
        fence_regs(o);
    }

    // the row sums over the four threads of a row
#pragma unroll
    for (int x = 1; x < 4; x <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, x);
        l1 += __shfl_xor_sync(0xffffffffu, l1, x);
    }
    if (wg_rows) {
        __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(a.o) + bb * a.o_sb + hh * a.o_sh;
        const int qi0 = wq0 + r0, qi1 = qi0 + 8;
        const float d0 = fmaxf(l0, 1e-37f), d1 = fmaxf(l1, 1e-37f);
#pragma unroll
        for (int n = 0; n < DH / 8; ++n) {
            const int col = 8 * n + 2 * qd;
            if (qi0 < a.sq)
                *reinterpret_cast<uint32_t*>(ob + qi0 * a.o_ss + col) = pack_bf16(o[4 * n] / d0, o[4 * n + 1] / d0);
            if (qi1 < a.sq)
                *reinterpret_cast<uint32_t*>(ob + qi1 * a.o_ss + col) =
                    pack_bf16(o[4 * n + 2] / d1, o[4 * n + 3] / d1);
        }
    }
}

template <int DH, int BK>
cudaError_t run(const Args& a, int b, cudaStream_t stream) {
    constexpr int smem = BQ * DH * 2 + 5 * BK * DH * 2 + 1024;  // Q, two K and three V slots, alignment
    cudaError_t e = cudaFuncSetAttribute(flash_fwd_sm90_kernel<DH, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
    if (e != cudaSuccess) return e;
    const dim3 grid((a.sq + BQ - 1) / BQ, a.h, b);
    flash_fwd_sm90_kernel<DH, BK><<<grid, NT, smem, stream>>>(a);
    return cudaGetLastError();
}

}  // namespace

// Strides in elements; q, k, v and o 16-byte aligned, strides multiples of 8.
// Returns a cudaError_t.
extern "C" int flash_fwd_sm90(int dh, const void* q, const void* k, const void* v, void* o,
                              long long q_sb, long long q_ss, long long q_sh,
                              long long k_sb, long long k_ss, long long k_sh,
                              long long v_sb, long long v_ss, long long v_sh,
                              long long o_sb, long long o_ss, long long o_sh,
                              int b, int sq, int skv, int h, int kh,
                              const void* qoff_ptr, int qoff, const void* kvlen_ptr, int kvlen,
                              int causal, int has_window, int window, int has_cap, float cap, float scale,
                              void* stream) {
    Args a{q, k, v, o,
           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,
           sq, skv, h, kh,
           static_cast<const int*>(qoff_ptr), qoff, static_cast<const int*>(kvlen_ptr), kvlen,
           causal, has_window, window, has_cap, cap, scale};
    if (b <= 0 || sq <= 0 || h <= 0 || kh <= 0 || h % kh != 0) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    // BK keys per tile: 128, and 64 at Dh 160 and 256 (at most 225 KB of shared memory)
    switch (dh) {
        case 16: return (int)run<16, 128>(a, b, s);
        case 32: return (int)run<32, 128>(a, b, s);
        case 64: return (int)run<64, 128>(a, b, s);
        case 96: return (int)run<96, 128>(a, b, s);
        case 128: return (int)run<128, 128>(a, b, s);
        case 160: return (int)run<160, 64>(a, b, s);
        case 256: return (int)run<256, 64>(a, b, s);
        default: return (int)cudaErrorInvalidValue;
    }
}
