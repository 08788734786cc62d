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
// Design: one block per query row b.  The block first stages its query's
// table in dynamic shared memory (coalesced), then its threads stride over
// the C candidates; each reads its m code bytes and does m shared-memory
// lookups, folding them left to right with __fadd_rn, the order of the plain
// version's fold_sum_m, so the two are bitwise equal.  m * 1 KB above 48 KB
// (m > 48) needs the opt-in of cudaFuncSetAttribute; above the card's
// 232,448 bytes a block the wrapper refuses.  Masked candidates fetch no
// code row.
#include <cstdint>

#include "common.cuh"

#define REPRO_PQ_K 256

__global__ void expand_score_pq_kernel(const uint8_t* __restrict__ codes,
                                       const float* __restrict__ lut,
                                       const int* __restrict__ idx,
                                       float* __restrict__ out,
                                       long long n, int m, int C) {
    extern __shared__ float lut_s[];
    const long long b = blockIdx.x;
    const int entries = m * REPRO_PQ_K;
    const float* lb = lut + b * entries;
    for (int i = threadIdx.x; i < entries; i += blockDim.x) lut_s[i] = lb[i];
    __syncthreads();
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
        const long long o = b * C + c;
        const int id = idx[o];
        if (id < 0) {
            out[o] = __int_as_float(0x7f800000);  // +inf
            continue;
        }
        const long long row = id < n ? id : n - 1;
        const uint8_t* cr = codes + row * m;
        float acc = lut_s[cr[0]];
        for (int j = 1; j < m; ++j)
            acc = __fadd_rn(acc, lut_s[j * REPRO_PQ_K + cr[j]]);
        out[o] = acc;
    }
}

extern "C" int repro_expand_score_pq(const uint8_t* codes, const float* lut, const int* idx,
                                     float* out, long long n, int m, int B, int C,
                                     cudaStream_t stream) {
    const size_t smem = static_cast<size_t>(m) * REPRO_PQ_K * sizeof(float);
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            expand_score_pq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    const int threads = C >= 256 ? 256 : ((C + 31) / 32) * 32;
    expand_score_pq_kernel<<<static_cast<unsigned>(B), threads, smem, stream>>>(
        codes, lut, idx, out, n, m, C);
    return static_cast<int>(cudaGetLastError());
}
