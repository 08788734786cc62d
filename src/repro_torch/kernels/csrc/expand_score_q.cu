// expand_score_q: squared L2 between query q[b] and the int8 corpus row
// x[idx[b, c]] dequantized as x * scale + zero, +inf where idx[b, c] < 0.
//
// Replaces the Pallas kernel src/repro/kernels/expand_score.py::expand_score_q
// (the scalar-prefetch row gather of expand_score on an int8 plane, the row
// dequantized in-register before the square-difference sum).
//
// Bound on the H100: bytes.  Each candidate reads one d-byte int8 row at a
// random address and does 5d flops on it; the gather of the live rows, the
// ids, the outputs and the queries over 3.35 TB/s is the floor (about
// 0.086 ms at n = 1M, d = 128, B = 10,000, C = 256, 20 % masked).
//
// Design: one thread per candidate, the THREADS candidates of a block all
// of one query.  The block stages q[b], scale and zero in shared memory
// once, PIECE elements at a time, and every thread reads them there as
// broadcasts.  A thread loads the codes of its row's piece up front, all
// in one round trip: 16-byte loads where the row starts on a 16-byte
// boundary and d % 16 == 0, else the aligned words that cover it, joined
// with a funnel shift.  It keeps the 32 lane sums of common.cuh's fixed
// order in registers (lane l: elements l, l+32, ... in sequence) and then
// evaluates the xor butterfly (offsets 16, 8, 4, 2, 1) as a tree, which is
// lane 0's order, and every lane's, since each add is commutative.  So the
// sum is bitwise the plain version's.  A code c becomes an f32 through its
// bits, 0x4B000000 | (c ^ 0x80) being 2^23 + c + 128, exactly: two
// full-rate instructions in place of a quarter-rate conversion.  It is
// dequantized with two roundings, __fadd_rn(__fmul_rn(x, scale), zero), so
// nvcc cannot contract it into an FMA.  Masked candidates fetch nothing.
#include <climits>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int THREADS = 128;       // candidates a block
constexpr int PIECE = 128;         // elements of d a step: four lane chunks
constexpr int WORDS = PIECE / 4;   // code words of a piece
constexpr float CODE_BIAS = 8388736.0f;   // 2^23 + 128

// The codes of the row bytes [p, p + len) as WORDS words, in order; bytes
// past len are left unspecified (the caller never reads them).  vec: p is
// 16-byte aligned and len a multiple of 16.
__device__ __forceinline__ void load_piece(uint32_t (&w)[WORDS + 1], const int8_t* p, int len,
                                           bool vec) {
    if (vec) {
        const uint4* p4 = reinterpret_cast<const uint4*>(p);
#pragma unroll
        for (int i = 0; i < WORDS / 4; ++i) {
            const uint4 v = 16 * i < len ? __ldg(p4 + i) : make_uint4(0, 0, 0, 0);
            w[4 * i] = v.x;
            w[4 * i + 1] = v.y;
            w[4 * i + 2] = v.z;
            w[4 * i + 3] = v.w;
        }
    } else {
        // the aligned words that hold a byte of the piece (never a word
        // outside the row's allocation), shifted down by p's misalignment
        const uintptr_t a = reinterpret_cast<uintptr_t>(p);
        const uint32_t* base = reinterpret_cast<const uint32_t*>(a & ~static_cast<uintptr_t>(3));
        const int mis = static_cast<int>(a & 3);
        const int nw = (mis + len + 3) >> 2;
#pragma unroll
        for (int i = 0; i <= WORDS; ++i) w[i] = i < nw ? __ldg(base + i) : 0u;
#pragma unroll
        for (int i = 0; i < WORDS; ++i) w[i] = __funnelshift_r(w[i], w[i + 1], 8 * mis);
    }
}

// Fold the piece's square differences into the 32 lane sums, element e of
// the piece into acc[e % 32]; FULL: the piece holds PIECE elements, so no
// element needs a bound check.
template <bool FULL>
__device__ __forceinline__ void accumulate(float (&acc)[32], const uint32_t (&w)[WORDS + 1],
                                           const float4* sq, const float4* ss, const float4* sz,
                                           int len) {
#pragma unroll
    for (int j4 = 0; j4 < WORDS; ++j4) {      // elements 4 j4 .. 4 j4 + 3
        const float4 qv = sq[j4], sv = ss[j4], zv = sz[j4];
        const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
        const float sa[4] = {sv.x, sv.y, sv.z, sv.w};
        const float za[4] = {zv.x, zv.y, zv.z, zv.w};
        const uint32_t biased = w[j4] ^ 0x80808080u;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
            if (FULL || 4 * j4 + t < len) {
                const float xv = __fsub_rn(
                    __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7440u + t)), CODE_BIAS);
                const float df = __fsub_rn(qa[t], __fadd_rn(__fmul_rn(xv, sa[t]), za[t]));
                const int lane = (4 * j4 + t) & 31;
                acc[lane] = __fadd_rn(acc[lane], __fmul_rn(df, df));
            }
        }
    }
}

__global__ void __launch_bounds__(THREADS)
expand_score_q_kernel(const int8_t* __restrict__ x, const float* __restrict__ scale,
                      const float* __restrict__ zero, const int* __restrict__ idx,
                      const float* __restrict__ q, float* __restrict__ out,
                      long long n, int d, int C, int blocks_per_query, bool vec) {
    __shared__ float4 sq[PIECE / 4], ss[PIECE / 4], sz[PIECE / 4];
    const long long b = blockIdx.x / blocks_per_query;
    const int c = (blockIdx.x % blocks_per_query) * THREADS + threadIdx.x;
    const long long o = b * C + c;
    const int id = c < C ? idx[o] : -1;
    const int8_t* xr = id >= 0 ? x + (id < n ? id : n - 1) * static_cast<long long>(d) : nullptr;
    const float* qb = q + b * d;
    float acc[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[j] = 0.0f;   // +0 + t == t: the first chunk's sums
    for (int p0 = 0; p0 < d; p0 += PIECE) {       // block-uniform
        const int len = min(PIECE, d - p0);
        uint32_t w[WORDS + 1];
        if (xr) load_piece(w, xr + p0, len, vec);
        for (int e = threadIdx.x; e < PIECE; e += THREADS) {
            const bool in = e < len;
            reinterpret_cast<float*>(sq)[e] = in ? qb[p0 + e] : 0.0f;
            reinterpret_cast<float*>(ss)[e] = in ? scale[p0 + e] : 0.0f;
            reinterpret_cast<float*>(sz)[e] = in ? zero[p0 + e] : 0.0f;
        }
        __syncthreads();
        if (xr) {
            if (len == PIECE)
                accumulate<true>(acc, w, sq, ss, sz, len);
            else
                accumulate<false>(acc, w, sq, ss, sz, len);
        }
        __syncthreads();
    }
    if (c >= C) return;
    if (!xr) {
        out[o] = __int_as_float(0x7f800000);  // +inf
        return;
    }
    // the butterfly's tree, a level at a time (constant bounds, so that acc
    // stays in registers)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[j] = __fadd_rn(acc[j], acc[j + 16]);
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = __fadd_rn(acc[j], acc[j + 8]);
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[j] = __fadd_rn(acc[j], acc[j + 4]);
    acc[0] = __fadd_rn(acc[0], acc[2]);
    acc[1] = __fadd_rn(acc[1], acc[3]);
    out[o] = __fadd_rn(acc[0], acc[1]);
}

}  // namespace

extern "C" int repro_expand_score_q(const int8_t* x, const float* scale, const float* zero,
                                    const int* idx, const float* q, float* out,
                                    long long n, int d, int B, int C, cudaStream_t stream) {
    const int blocks_per_query = (C + THREADS - 1) / THREADS;
    const long long blocks = static_cast<long long>(B) * blocks_per_query;
    if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
    const bool vec = d % 16 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
    expand_score_q_kernel<<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
        x, scale, zero, idx, q, out, n, d, C, blocks_per_query, vec);
    return static_cast<int>(cudaGetLastError());
}
