// beam_merge: the E smallest of (sorted beam) union (candidates) under the
// total order (dist, payload), ascending.
//
// Replaces the Pallas kernel src/repro/kernels/beam_merge.py::beam_merge
// (bitonic sort of the L candidates, reversed min against the beam, log E
// merge stages, all vectorised over the lane axis).
//
// Bound on the H100: bytes.  The network does O(L log^2 L) compares per row
// on data that it reads and writes once, (2E + 2L) * 4 bytes in and 2E * 4
// out; the compares are cheap integer/float ops.  What limits a simple
// kernel in practice is the barrier after every network stage.
//
// Design: one block per row, max(L, E)/2 threads, the network in shared
// memory.  Thread t owns the compare-exchange pair (lo, lo | j) of a stage.
// The compare-exchange is the reference's per-element rule, verbatim: the
// low element takes its partner when le(self, partner) != asc, the high one
// when ge(self, partner) != asc.  It has only compares and selects, so the
// result is bitwise the plain network's and the reference's on any input,
// NaN included.  Candidate slots past the input width L_in are the
// (+inf, PAD_PAYLOAD) pads of the power-of-two padding.
#include "common.cuh"

#define REPRO_PAD_PAYLOAD (-2)

__device__ __forceinline__ bool key_le(float d, int p, float pd, int pp) {
    return (d < pd) || (d == pd && p <= pp);
}

__device__ __forceinline__ bool key_ge(float d, int p, float pd, int pp) {
    return (d > pd) || (d == pd && p >= pp);
}

__device__ __forceinline__ void cmp_swap(float* sd, int* sp, int lo, int hi, bool asc) {
    const float dl = sd[lo], dh = sd[hi];
    const int pl = sp[lo], ph = sp[hi];
    const bool take_lo = key_le(dl, pl, dh, ph) != asc;
    const bool take_hi = key_ge(dh, ph, dl, pl) != asc;
    sd[lo] = take_lo ? dh : dl;
    sp[lo] = take_lo ? ph : pl;
    sd[hi] = take_hi ? dl : dh;
    sp[hi] = take_hi ? pl : ph;
}

// The index of the low element of pair t in a stage of stride j.
__device__ __forceinline__ int pair_lo(int t, int j) {
    return ((t & ~(j - 1)) << 1) | (t & (j - 1));
}

__global__ void beam_merge_kernel(const float* __restrict__ beam_d,
                                  const int* __restrict__ beam_p,
                                  const float* __restrict__ cand_d,
                                  const int* __restrict__ cand_p,
                                  float* __restrict__ out_d,
                                  int* __restrict__ out_p,
                                  int E, int L_in, int L) {
    extern __shared__ unsigned char smem_raw[];
    float* cd = reinterpret_cast<float*>(smem_raw);
    int* cp = reinterpret_cast<int*>(cd + L);
    float* md = reinterpret_cast<float*>(cp + L);
    int* mp = reinterpret_cast<int*>(md + E);

    const long long b = blockIdx.x;
    const int tid = threadIdx.x;
    const int nt = blockDim.x;
    const float inf = __int_as_float(0x7f800000);

    for (int i = tid; i < L; i += nt) {
        if (i < L_in) {
            cd[i] = cand_d[b * L_in + i];
            cp[i] = cand_p[b * L_in + i];
        } else {
            cd[i] = inf;
            cp[i] = REPRO_PAD_PAYLOAD;
        }
    }
    __syncthreads();

    // 1. bitonic sort of the L candidates, ascending
    for (int k = 2; k <= L; k <<= 1) {
        for (int j = k >> 1; j >= 1; j >>= 1) {
            for (int t = tid; t < L / 2; t += nt) {
                const int lo = pair_lo(t, j);
                cmp_swap(cd, cp, lo, lo | j, (lo & k) == 0);
            }
            __syncthreads();
        }
    }

    // 2. the best E candidates, reversed, against the sorted beam
    for (int i = tid; i < E; i += nt) {
        const int r = E - 1 - i;
        const float rd = r < L ? cd[r] : inf;
        const int rp = r < L ? cp[r] : REPRO_PAD_PAYLOAD;
        const float bd = beam_d[b * E + i];
        const int bp = beam_p[b * E + i];
        const bool le = key_le(bd, bp, rd, rp);
        md[i] = le ? bd : rd;
        mp[i] = le ? bp : rp;
    }
    __syncthreads();

    // 3. log E merge stages re-sort the bitonic sequence
    for (int j = E >> 1; j >= 1; j >>= 1) {
        for (int t = tid; t < E / 2; t += nt) {
            const int lo = pair_lo(t, j);
            cmp_swap(md, mp, lo, lo | j, true);
        }
        __syncthreads();
    }

    for (int i = tid; i < E; i += nt) {
        out_d[b * E + i] = md[i];
        out_p[b * E + i] = mp[i];
    }
}

extern "C" int repro_beam_merge(const float* beam_d, const int* beam_p,
                                const float* cand_d, const int* cand_p,
                                float* out_d, int* out_p,
                                int B, int E, int L_in, int L, int threads,
                                cudaStream_t stream) {
    const size_t smem = static_cast<size_t>(2 * L + 2 * E) * 4;
    beam_merge_kernel<<<B, threads, smem, stream>>>(
        beam_d, beam_p, cand_d, cand_p, out_d, out_p, E, L_in, L);
    return static_cast<int>(cudaGetLastError());
}
