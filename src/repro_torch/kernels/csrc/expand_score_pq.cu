// expand_score_pq: asymmetric distance (ADC) between query q[b] and the
// product-quantized corpus row idx[b, c]: the sum over subspaces j of
// lut[b, j, codes[idx[b, c], j]], folded strictly left to right over j,
// +inf where idx[b, c] < 0.  The (B, m, 256) tables come from the plain
// pq_lut (kernels/expand_score.py), built once per batch.
//
// Replaces the Pallas kernel src/repro/kernels/expand_score.py::expand_score_pq
// (one (1, m) uint8 code-row DMA per candidate, m in-register table lookups
// summed by _fold_sum_m).
//
// Bound on the H100: bytes.  Each query's table is m * 256 * 4 bytes (16 KB
// at m = 16), read once; each live candidate adds an m-byte code row and
// m adds.  At B = 10,000, C = 256 the tables alone are 164 MB, so reading
// them dominates the floor.
//
// Design: persistent blocks, each walking the queries b = blockIdx.x,
// blockIdx.x + gridDim.x, ...; a thread per candidate.  A block keeps a
// ring of three tables in dynamic shared memory, so the next two queries'
// tables arrive (cp.async, 16 bytes a copy) while this query's lookups run;
// where three do not fit the 232,448 bytes a block may have, it keeps two
// (m <= 113), else one.  Three beat two (4 blocks an SM against 7) and
// four (3 blocks an SM) at m = 16.  A thread loads its next candidate's id
// and first CHUNK code bytes into registers before it waits for the
// current table, so the code gather and the table copies are in flight
// together.  A code row comes in one round
// trip: 16-byte loads where the row starts on a 16-byte boundary and
// m % 16 == 0, else the aligned words that cover it, joined with a funnel
// shift.  The m lookups fold left to right with __fadd_rn from -0.0f (the
// additive identity, so the first add returns the first entry exactly):
// the order of the plain version's fold_sum_m, so the two are bitwise
// equal.  Masked candidates fetch no code row.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int K = 256;            // centroids a subspace: one uint8 code each
constexpr int MAX_THREADS = 256;
constexpr int MAX_TABLES = 3;     // table buffers a block
constexpr int CHUNK = 32;         // code bytes a thread holds in registers
constexpr int CW = CHUNK / 4;     // their words

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// Start the copy of one query's (m, 256) table into dst, block-wide.
// vec: the tables start on 16-byte boundaries.
__device__ __forceinline__ void stage_table(float* dst, const float* src, int entries,
                                            bool vec) {
    if (vec) {
        for (int i = 4 * threadIdx.x; i < entries; i += 4 * blockDim.x) cp_async16(dst + i, src + i);
    } else {
        for (int i = threadIdx.x; i < entries; i += blockDim.x) cp_async4(dst + i, src + i);
    }
}

// The code bytes [p, p + len) as CW words, in order; bytes past len are
// left unspecified (the caller never reads them).  vec: p is 16-byte
// aligned and len a multiple of 16.
__device__ __forceinline__ void load_codes(uint32_t (&w)[CW + 1], const uint8_t* p, int len,
                                           bool vec) {
    if (vec) {
        const uint4* p4 = reinterpret_cast<const uint4*>(p);
#pragma unroll
        for (int i = 0; i < CW / 4; ++i) {
            const uint4 v = 16 * i < len ? __ldg(p4 + i) : make_uint4(0, 0, 0, 0);
            w[4 * i] = v.x;
            w[4 * i + 1] = v.y;
            w[4 * i + 2] = v.z;
            w[4 * i + 3] = v.w;
        }
    } else {
        // the aligned words that hold a byte of [p, p + len), shifted down
        // by p's misalignment
        const uintptr_t a = reinterpret_cast<uintptr_t>(p);
        const uint32_t* base = reinterpret_cast<const uint32_t*>(a & ~static_cast<uintptr_t>(3));
        const int mis = static_cast<int>(a & 3);
        const int nw = (mis + len + 3) >> 2;
#pragma unroll
        for (int i = 0; i <= CW; ++i) w[i] = i < nw ? __ldg(base + i) : 0u;
#pragma unroll
        for (int i = 0; i < CW; ++i) w[i] = __funnelshift_r(w[i], w[i + 1], 8 * mis);
    }
}

// Candidate c of query b: its code row (nullptr where masked) and, in w,
// its first min(CHUNK, m) code bytes.
__device__ __forceinline__ const uint8_t* load_candidate(
    uint32_t (&w)[CW + 1], const uint8_t* __restrict__ codes, const int* __restrict__ idx,
    long long n, int m, int C, long long b, int c, bool vec) {
    const int id = idx[b * C + c];
    if (id < 0) return nullptr;
    const uint8_t* row = codes + (id < n ? id : n - 1) * static_cast<long long>(m);
    load_codes(w, row, min(CHUNK, m), vec);
    return row;
}

// The fold of candidate c's m lookups in table lt, its first chunk in w.
__device__ __forceinline__ void score(float* __restrict__ out, long long o, const uint8_t* row,
                                      uint32_t (&w)[CW + 1], const float* lt, int m, bool vec) {
    if (!row) {
        out[o] = __int_as_float(0x7f800000);  // +inf
        return;
    }
    float acc = -0.0f;                        // -0 + v == v for every v
    for (int j0 = 0; j0 < m; j0 += CHUNK) {
        const int len = min(CHUNK, m - j0);
        if (j0 > 0) load_codes(w, row + j0, len, vec);
#pragma unroll
        for (int t = 0; t < CHUNK; ++t) {
            if (t < len) {
                const uint32_t code = (w[t >> 2] >> (8 * (t & 3))) & 0xffu;
                acc = __fadd_rn(acc, lt[(j0 + t) * K + code]);
            }
        }
    }
    out[o] = acc;
}

__global__ void __launch_bounds__(MAX_THREADS)
expand_score_pq_kernel(const uint8_t* __restrict__ codes, const float* __restrict__ lut,
                       const int* __restrict__ idx, float* __restrict__ out, long long n,
                       int m, int B, int C, int nbuf, bool vec_codes, bool vec_lut) {
    extern __shared__ float4 tables4[];
    float* tables = reinterpret_cast<float*>(tables4);
    const int entries = m * K;
    const long long G = gridDim.x;
    long long b = blockIdx.x;                 // gridDim.x <= B
    for (int k = 0; k < nbuf; ++k) {          // the first nbuf tables; a group each
        const long long bk = b + k * G;
        if (bk < B) stage_table(tables + k * entries, lut + bk * entries, entries, vec_lut);
        cp_async_commit();
    }
    const int c0 = threadIdx.x;               // this thread's first candidate
    uint32_t w[CW + 1];
    const uint8_t* row = c0 < C ? load_candidate(w, codes, idx, n, m, C, b, c0, vec_codes)
                                : nullptr;
    for (int it = 0; b < B; ++it, b += G) {
        // the next query's first candidate, in flight with the table copies
        uint32_t wn[CW + 1];
        const uint8_t* rown = c0 < C && b + G < B
            ? load_candidate(wn, codes, idx, n, m, C, b + G, c0, vec_codes) : nullptr;
        switch (nbuf) {                       // the table of b has landed, later ones may not
            case 3: cp_async_wait<2>(); break;
            case 2: cp_async_wait<1>(); break;
            default: cp_async_wait<0>();
        }
        __syncthreads();
        float* lt = tables + (it % nbuf) * entries;
        if (c0 < C) score(out, b * C + c0, row, w, lt, m, vec_codes);
        for (int c = c0 + blockDim.x; c < C; c += blockDim.x) {
            uint32_t wc[CW + 1];
            const uint8_t* rc = load_candidate(wc, codes, idx, n, m, C, b, c, vec_codes);
            score(out, b * C + c, rc, wc, lt, m, vec_codes);
        }
        __syncthreads();                      // every lookup in lt is done
        const long long bn = b + nbuf * G;
        if (bn < B) stage_table(lt, lut + bn * entries, entries, vec_lut);
        cp_async_commit();
        row = rown;
#pragma unroll
        for (int i = 0; i <= CW; ++i) w[i] = wn[i];
    }
}

}  // namespace

extern "C" int repro_expand_score_pq(const uint8_t* codes, const float* lut, const int* idx,
                                     float* out, long long n, int m, int B, int C,
                                     cudaStream_t stream) {
    const size_t table = static_cast<size_t>(m) * K * sizeof(float);
    const int max_smem = 232448;              // dynamic shared memory a block may use
    if (table > static_cast<size_t>(max_smem)) return static_cast<int>(cudaErrorInvalidValue);
    const int fit = static_cast<int>(max_smem / table);
    const int nbuf = fit < MAX_TABLES ? fit : MAX_TABLES;
    const size_t smem = nbuf * table;
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            expand_score_pq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    const int threads = C >= MAX_THREADS ? MAX_THREADS : ((C + 31) / 32) * 32;
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, expand_score_pq_kernel,
                                                            threads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long resident = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
    const int blocks = static_cast<int>(B < resident ? B : resident);
    const bool vec_codes = m % 16 == 0 && (reinterpret_cast<uintptr_t>(codes) & 15) == 0;
    const bool vec_lut = (reinterpret_cast<uintptr_t>(lut) & 15) == 0;
    expand_score_pq_kernel<<<blocks, threads, smem, stream>>>(
        codes, lut, idx, out, n, m, B, C, nbuf, vec_codes, vec_lut);
    return static_cast<int>(cudaGetLastError());
}
