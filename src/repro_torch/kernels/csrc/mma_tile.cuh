// A squared-L2 tile whose inner product runs on the tensor cores, for
// l2dist.cu (pairwise_sq_dist) and fused_scan.cu (filtered_topk).
//
// A block of 256 threads (8 warps, 2 x 4) computes the (128, 128) tile
//     d[r][c] = max((|q_r|^2 + |x_c|^2) - 2 * <q_r, x_c>, 0)
// in two parts:
//
// * The inner products on the tensor cores with mma.sync, a 64 x 32
//   register block of f32 accumulators a warp.  f32 rows use 3xTF32:
//   each fragment element a is split in registers into big = tf32(a) and
//   small = tf32(a - big) (cvt.rna), and m16n8k8 .tf32 products
//   small*big, big*small and big*big are accumulated in f32, in that
//   order: the product keeps about 2^-21 relative accuracy, fp32's, at a
//   third of the tensor cores' TF32 rate.  bf16 rows take one m16n8k16
//   .bf16 product, exact in f32.  Only the order of the sum over d differs
//   from the plain version's fold; on integer-valued data with small
//   magnitudes (|v| <= 8, d <= 256) every product and partial sum is an
//   integer below 2^24, the small parts are 0, and the tile is bitwise the
//   fold's.
// * The norms on the SIMT cores, folded from the staged slices in the
//   plain version's order (k = 0 upwards from +0, each multiply and add
//   rounded on its own), so they are bitwise the plain version's: threads
//   0..127 fold the query rows, 128..255 the corpus rows.
//
// Operands are staged in K-slices of 128 bytes a row (32 f32 or 64 bf16)
// through two shared-memory stages, by cp.async 16-byte copies (zero-filled
// past the matrix) where a row's bytes are a multiple of 16, and by plain
// loads otherwise.  A staged row is 36 words (32 + 4 of pad), so the
// fragment loads (8 rows x 4 words a warp) and the norms' 16-byte loads
// meet no bank conflict.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>

#include "common.cuh"

namespace mmatile {

constexpr int BM = 128, BN = 128;               // tile rows (queries) and columns (corpus)
constexpr int THREADS = 256;
constexpr int ROW_WORDS = 36;                   // a staged row: 32 words of data, 4 of pad
constexpr int OPERAND_WORDS = BM * ROW_WORDS;   // BM == BN
constexpr int STAGE_WORDS = 2 * OPERAND_WORDS;
constexpr int STAGES = 2;
// Dynamic shared memory of one block: the stages and the 256 norms.
constexpr int SMEM_BYTES = (STAGES * STAGE_WORDS + BM + BN) * 4;

template <typename T>
struct Elem;
template <>
struct Elem<float> { using Raw = uint32_t; };
template <>
struct Elem<__nv_bfloat16> { using Raw = uint16_t; };

template <typename T>
__device__ __forceinline__ float widen_lo(uint32_t w);
template <>
__device__ __forceinline__ float widen_lo<float>(uint32_t w) { return __uint_as_float(w); }
template <>
__device__ __forceinline__ float widen_lo<__nv_bfloat16>(uint32_t w) {
    return __uint_as_float(w << 16);            // bf16 -> f32 is a shift: exact
}
__device__ __forceinline__ float widen_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory"); }

// Stage rows [row0, row0 + 128) and the 128-byte K-slice starting at
// element k0 of the row-major (nrows, d) matrix a into s (row r at word
// r * ROW_WORDS), zero outside the matrix.
template <typename T>
__device__ __forceinline__ void stage(uint32_t* s, const T* __restrict__ a, long long nrows,
                                      int d, long long row0, int k0, bool vec) {
    using Raw = typename Elem<T>::Raw;
    constexpr int PER_CHUNK = 16 / static_cast<int>(sizeof(T));   // elements in 16 bytes
    constexpr int BK = 8 * PER_CHUNK;                              // elements a slice
    if (vec) {   // d * sizeof(T) is a multiple of 16: a chunk is wholly in or out
        const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(s));
#pragma unroll
        for (int i = 0; i < BM * 8 / THREADS; ++i) {
            const int e = threadIdx.x + i * THREADS;
            const int r = e >> 3, ch = e & 7;
            const long long gr = row0 + r;
            const int gk = k0 + ch * PER_CHUNK;
            const bool in = gr < nrows && gk < d;
            cp_async16(base + (r * ROW_WORDS + ch * 4) * 4, in ? a + gr * d + gk : a, in ? 16 : 0);
        }
    } else {
        for (int e = threadIdx.x; e < BM * BK; e += THREADS) {
            const int r = e / BK, kk = e % BK;
            const long long gr = row0 + r;
            const int gk = k0 + kk;
            Raw v = 0;
            if (gr < nrows && gk < d) v = reinterpret_cast<const Raw*>(a)[gr * d + gk];
            reinterpret_cast<Raw*>(s + r * ROW_WORDS)[kk] = v;
        }
    }
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
    return r;
}

__device__ __forceinline__ void split(uint32_t w, uint32_t& big, uint32_t& small) {
    const float x = __uint_as_float(w);
    big = to_tf32(x);
    small = to_tf32(__fsub_rn(x, __uint_as_float(big)));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One staged K-slice into the warp's accumulators.  Word ks * 8 + tig of a
// row holds element ks * 8 + tig (f32) or elements 2 (ks * 8 + tig) and the
// next (bf16): the fragments of m16n8k8 .tf32 and m16n8k16 .bf16 then have
// the same word layout (a: rows g, g + 8 x words tig, tig + 4; b: row g x
// words tig, tig + 4).
template <typename T>
__device__ __forceinline__ void mma_slice(float (&acc)[4][4][4], const uint32_t* __restrict__ sa,
                                          const uint32_t* __restrict__ sb, int wm, int wn,
                                          int g, int tig) {
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
        uint32_t bw[4][2];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
            const uint32_t* row = sb + (wn * 32 + nt * 8 + g) * ROW_WORDS + ks * 8 + tig;
            bw[nt][0] = row[0];
            bw[nt][1] = row[4];
        }
        if constexpr (sizeof(T) == 4) {
            uint32_t bbig[4][2], bsmall[4][2];
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
#pragma unroll
                for (int i = 0; i < 2; ++i) split(bw[nt][i], bbig[nt][i], bsmall[nt][i]);
#pragma unroll
            for (int mt = 0; mt < 4; ++mt) {
                const uint32_t* r0 = sa + (wm * 64 + mt * 16 + g) * ROW_WORDS + ks * 8 + tig;
                const uint32_t* r8 = r0 + 8 * ROW_WORDS;
                const uint32_t aw[4] = {r0[0], r8[0], r0[4], r8[4]};
                uint32_t abig[4], asmall[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) split(aw[i], abig[i], asmall[i]);
                // four accumulators between two products into one
#pragma unroll
                for (int nt = 0; nt < 4; ++nt) mma_tf32(acc[mt][nt], asmall, bbig[nt]);
#pragma unroll
                for (int nt = 0; nt < 4; ++nt) mma_tf32(acc[mt][nt], abig, bsmall[nt]);
#pragma unroll
                for (int nt = 0; nt < 4; ++nt) mma_tf32(acc[mt][nt], abig, bbig[nt]);
            }
        } else {
#pragma unroll
            for (int mt = 0; mt < 4; ++mt) {
                const uint32_t* r0 = sa + (wm * 64 + mt * 16 + g) * ROW_WORDS + ks * 8 + tig;
                const uint32_t* r8 = r0 + 8 * ROW_WORDS;
                const uint32_t aw[4] = {r0[0], r8[0], r0[4], r8[4]};
#pragma unroll
                for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], aw, bw[nt]);
            }
        }
    }
}

// Fold the squares of one staged row's slice into norm, k upwards.
template <typename T>
__device__ __forceinline__ float fold_row(float norm, const uint32_t* __restrict__ row) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        const uint4 v = reinterpret_cast<const uint4*>(row)[j];
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float lo = widen_lo<T>(w[i]);
            norm = __fadd_rn(norm, __fmul_rn(lo, lo));
            if constexpr (sizeof(T) == 2) {
                const float hi = widen_hi(w[i]);
                norm = __fadd_rn(norm, __fmul_rn(hi, hi));
            }
        }
    }
    return norm;
}

// The (128, 128) tile at query rows q0.. and corpus rows x0..: on return
// acc[mt][nt][i] is the inner product of query row
// wm * 64 + mt * 16 + g + 8 * (i / 2) and corpus row wn * 32 + nt * 8 +
// 2 * tig + i % 2 of the tile (warp = 4 wm + wn, lane = 4 g + tig), and
// norms[0..127] / norms[128..255] hold the query / corpus rows' norms; with
// fold_q false the query rows' norms are not folded and norms[0..127] keep
// what an earlier call with the same query rows left there.  smem is
// SMEM_BYTES of dynamic shared memory; every thread of the block must call
// it; it ends with a barrier.
template <typename T>
__device__ __forceinline__ void tile(float (&acc)[4][4][4], const T* __restrict__ q, long long nq,
                                     long long q0, const T* __restrict__ x, long long nx,
                                     long long x0, int d, uint32_t* smem, bool fold_q = true) {
    constexpr int BK = 128 / static_cast<int>(sizeof(T));
    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int wm = warp >> 2, wn = warp & 3;
    const int g = lane >> 2, tig = lane & 3;
    float* norms = reinterpret_cast<float*>(smem + STAGES * STAGE_WORDS);
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;
    const bool vec = (static_cast<long long>(d) * sizeof(T)) % 16 == 0
                     && (reinterpret_cast<uintptr_t>(q) & 15) == 0
                     && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
    const int nk = (d + BK - 1) / BK;
    float norm = 0.0f;
    const bool fold = tid >= BM || fold_q;   // warp-uniform
    if (nk > 0) {
        stage(smem, q, nq, d, q0, 0, vec);
        stage(smem + OPERAND_WORDS, x, nx, d, x0, 0, vec);
        cp_commit();
    }
    for (int s = 0; s < nk; ++s) {
        uint32_t* cur = smem + (s & 1) * STAGE_WORDS;
        if (s + 1 < nk) {
            uint32_t* nxt = smem + ((s + 1) & 1) * STAGE_WORDS;
            stage(nxt, q, nq, d, q0, (s + 1) * BK, vec);
            stage(nxt + OPERAND_WORDS, x, nx, d, x0, (s + 1) * BK, vec);
            cp_commit();
            cp_wait<1>();
        } else {
            cp_wait<0>();
        }
        __syncthreads();
        if (fold) norm = fold_row<T>(norm, cur + tid * ROW_WORDS);   // q row tid, or x row tid - 128
        mma_slice<T>(acc, cur, cur + OPERAND_WORDS, wm, wn, g, tig);
        __syncthreads();
    }
    if (fold) norms[tid] = norm;
    __syncthreads();
}

}  // namespace mmatile
