// expand_score: squared L2 between query q[b] and corpus row x[idx[b, c]],
// +inf where idx[b, c] < 0.  Two entry points: an f32 corpus (the f32 plane
// and the f32 rerank plane) and a bf16 corpus (the bf16 plane), whose
// elements are widened to f32 in registers (exactly).
//
// Replaces the Pallas kernel src/repro/kernels/expand_score.py::expand_score
// (scalar-prefetch row gather, one (1, d) row DMA per candidate; the bf16
// plane takes the same Pallas kernel, which casts the row in-register).
//
// Bound on the H100: bytes.  Each candidate reads one 4d-byte (bf16: 2d)
// corpus row at a random address and does 3d flops on it, far below the
// card's ~20 flops per byte, so the gather of B*C rows over 3.35 TB/s is the
// floor.
//
// Design: one thread per candidate, the THREADS candidates of a block all
// of one query.  A thread takes its row in pieces of 128 bytes (64 bf16 or
// 32 f32 elements), each loaded in one round trip: eight 16-byte loads
// where the row starts on a 16-byte boundary and holds a whole number of
// them, else the aligned words that cover the piece, joined with a funnel
// shift.  Two pieces are in registers at a time, and the next piece's loads
// are issued before the current piece's arithmetic, so a row's gather is
// always in flight behind the sums (at d = 128 bf16 all sixteen loads are
// issued up front).  The block stages q[b] in shared memory two pieces at a
// time and every thread reads it there as broadcasts.  A bf16 element
// becomes an f32 through its bits (w << 16 or w & 0xffff0000, exact, one
// full-rate op).  The sum keeps the 32 lane sums of common.cuh's fixed order
// in registers (element e into sum e % 32, in order of e) and then
// evaluates the xor butterfly as a tree, a level at a time, which is every
// lane's order since each add is commutative; every add and multiply is an
// explicitly rounded intrinsic.  So the result is bitwise the plain
// version's (kernels/expand_score.py::sq_dist_fixed_order).  Masked
// candidates fetch nothing.
#include <climits>
#include <cstdint>

#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 128;      // candidates a block
constexpr int WORDS = 32;         // 32-bit words of a piece: 128 bytes

// Per element type: elements of a piece and the f32 value of element e of
// a piece held as WORDS words.
template <typename T>
struct Plane;

template <>
struct Plane<float> {
    static constexpr int PIECE = WORDS;
    static __device__ __forceinline__ float at(const uint32_t (&w)[WORDS + 1], int e) {
        return __uint_as_float(w[e]);
    }
};

template <>
struct Plane<__nv_bfloat16> {
    static constexpr int PIECE = 2 * WORDS;
    static __device__ __forceinline__ float at(const uint32_t (&w)[WORDS + 1], int e) {
        const uint32_t v = w[e >> 1];
        return __uint_as_float((e & 1) ? (v & 0xffff0000u) : (v << 16));
    }
};

// The row bytes [p, p + len) as WORDS words, in order; bytes past len are
// left unspecified (the caller never reads them).  vec: p is 16-byte
// aligned and the row a whole number of 16-byte loads.
__device__ __forceinline__ void load_piece(uint32_t (&w)[WORDS + 1], const char* p, int len,
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
// the piece into acc[e % 32] (a piece starts at a multiple of 32); FULL:
// the piece holds PIECE elements, so no element needs a bound check.
template <typename T, bool FULL>
__device__ __forceinline__ void accumulate(float (&acc)[32], const uint32_t (&w)[WORDS + 1],
                                           const float4* sq, int len) {
    constexpr int PIECE = Plane<T>::PIECE;
#pragma unroll
    for (int j4 = 0; j4 < PIECE / 4; ++j4) {      // elements 4 j4 .. 4 j4 + 3
        const float4 qv = sq[j4];
        const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
        for (int t = 0; t < 4; ++t) {
            const int e = 4 * j4 + t;
            if (FULL || e < len) {
                const float df = __fsub_rn(qa[t], Plane<T>::at(w, e));
                acc[e & 31] = __fadd_rn(acc[e & 31], __fmul_rn(df, df));
            }
        }
    }
}

template <typename T>
__device__ __forceinline__ void step(float (&acc)[32], const uint32_t (&w)[WORDS + 1],
                                     const float4* sq, int len) {
    if (len == Plane<T>::PIECE)
        accumulate<T, true>(acc, w, sq, len);
    else
        accumulate<T, false>(acc, w, sq, len);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
expand_score_kernel(const T* __restrict__ x, const int* __restrict__ idx,
                    const float* __restrict__ q, float* __restrict__ out,
                    long long n, int d, int C, int blocks_per_query, bool vec) {
    constexpr int PIECE = Plane<T>::PIECE;
    constexpr int SIZE = static_cast<int>(sizeof(T));
    __shared__ float4 sq[2 * PIECE / 4];
    const long long b = blockIdx.x / blocks_per_query;
    const int c = (blockIdx.x % blocks_per_query) * THREADS + threadIdx.x;
    const long long o = b * C + c;
    const int id = c < C ? idx[o] : -1;
    const char* xr = id >= 0
        ? reinterpret_cast<const char*>(x + (id < n ? id : n - 1) * static_cast<long long>(d))
        : nullptr;
    const float* qb = q + b * d;
    float acc[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[j] = 0.0f;   // +0 + t == t: the first chunk's sums
    uint32_t wa[WORDS + 1], wb[WORDS + 1];
    if (xr) {
        load_piece(wa, xr, min(PIECE, d) * SIZE, vec);
        if (PIECE < d) load_piece(wb, xr + PIECE * SIZE, min(PIECE, d - PIECE) * SIZE, vec);
    }
    // two pieces a step, a (in wa) then b (in wb); each register set is
    // reloaded with the piece after next as soon as its sums are done
    for (int p0 = 0; p0 < d; p0 += 2 * PIECE) {   // block-uniform
        const int span = min(2 * PIECE, d - p0);
        for (int e = threadIdx.x; e < 2 * PIECE; e += THREADS)
            reinterpret_cast<float*>(sq)[e] = e < span ? qb[p0 + e] : 0.0f;
        __syncthreads();
        if (xr) {
            step<T>(acc, wa, sq, min(PIECE, span));
            const int pa = p0 + 2 * PIECE, pb = p0 + 3 * PIECE;
            if (pa < d) load_piece(wa, xr + pa * SIZE, min(PIECE, d - pa) * SIZE, vec);
            if (span > PIECE) {
                step<T>(acc, wb, sq + PIECE / 4, span - PIECE);
                if (pb < d) load_piece(wb, xr + pb * SIZE, min(PIECE, d - pb) * SIZE, vec);
            }
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

template <typename T>
int launch(const T* x, const int* idx, const float* q, float* out, long long n, int d, int B,
           int C, cudaStream_t stream) {
    const int blocks_per_query = (C + THREADS - 1) / THREADS;
    const long long blocks = static_cast<long long>(B) * blocks_per_query;
    if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
    const bool vec = (static_cast<long long>(d) * sizeof(T)) % 16 == 0 &&
                     (reinterpret_cast<uintptr_t>(x) & 15) == 0;
    expand_score_kernel<T><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
        x, idx, q, out, n, d, C, blocks_per_query, vec);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_expand_score(const float* x, const int* idx, const float* q,
                                  float* out, long long n, int d, int B, int C,
                                  cudaStream_t stream) {
    return launch(x, idx, q, out, n, d, B, C, stream);
}

extern "C" int repro_expand_score_bf16(const __nv_bfloat16* x, const int* idx, const float* q,
                                       float* out, long long n, int d, int B, int C,
                                       cudaStream_t stream) {
    return launch(x, idx, q, out, n, d, B, C, stream);
}
