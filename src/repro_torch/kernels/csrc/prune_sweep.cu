// prune_sweep: the Alg. 3 unified-prune scan over the distance-sorted
// candidates of B nodes.  For each candidate t in order, t is pruned for IF
// (IS) when an earlier retained candidate w witnesses it: geometrically,
// alpha^2 * dist(t, w) < dist(u, t), and semantically, Phi_IF (Phi_IS).
// Survivors are kept under the degree budgets m_if / m_is; a pruned t
// records its first witness slot.
//
// Replaces the Pallas kernel src/repro/kernels/prune_sweep.py::prune_sweep
// (body sweep_block: a fori_loop over t recomputing the (B, C) distance and
// Phi rows, vectorised over a bb-row tile).
//
// Bound on the H100: bytes, narrowly.  Counting only the pairs the answer
// needs (valid t against retained w < t, 3d flops each), the main path's
// shape (B = 1024, C = 96, d = 128) needs ~15 us of fp32 operations and
// ~16 us to move its B*C*d*4 input bytes once: the two bounds are about
// equal.  This kernel sits ~33x above either, held by the two barriers of
// each of its C sequential steps, not by bytes or operations.
//
// Design: one block per row b; the scan over t is a loop inside the block,
// as the TPU grid's sequential dimension was.  The per-row state (the
// act_if / act_is bits, the counters) lives in shared memory and registers.
// Only the pairs the answer depends on are computed: rows t that are not
// valid skip the distances, and a distance dist(t, w) is computed only for
// w < t that is retained for IF or IS, since no other w can witness.  A warp
// computes one pair in the fixed order of common.cuh.  Then warp 0 finds
// the first witness with two ballots per 32 slots, which is argmax of the
// witness row, and thread 0 applies the budget and writes the outputs.
#include "common.cuh"

__global__ void prune_sweep_kernel(const float* __restrict__ i_u,
                                   const float* __restrict__ xs,
                                   const float* __restrict__ i_c,
                                   const float* __restrict__ d_uc,
                                   const int* __restrict__ valid,
                                   const int* __restrict__ overlap,
                                   int* __restrict__ status,
                                   int* __restrict__ rep_if,
                                   int* __restrict__ rep_is,
                                   int C, int d, int m_if, int m_is,
                                   float alpha2, int unified) {
    extern __shared__ unsigned char smem_raw[];
    float* drow = reinterpret_cast<float*>(smem_raw);  // dist(t, w), w < t
    int* act = reinterpret_cast<int*>(drow + C);        // bit 0 IF, bit 1 IS

    const long long b = blockIdx.x;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int nwarps = blockDim.x >> 5;
    const float* X = xs + b * C * d;
    const float* IC = i_c + b * C * 2;
    const float u0 = i_u[2 * b], u1 = i_u[2 * b + 1];
    const long long row0 = b * C;

    for (int i = tid; i < C; i += blockDim.x) act[i] = 0;
    int cnt_if = 0, cnt_is = 0;  // used by thread 0 only
    __syncthreads();

    for (int t = 0; t < C; ++t) {
        const bool v_ok = valid[row0 + t] != 0;
        if (v_ok) {
            const float* xt = X + static_cast<long long>(t) * d;
            for (int w = warp; w < t; w += nwarps) {
                if (act[w] == 0) continue;  // warp-uniform
                const float acc = warp_sq_dist(X + static_cast<long long>(w) * d, xt, d, lane);
                if (lane == 0) drow[w] = acc;
            }
        }
        __syncthreads();
        if (warp == 0) {
            int j_if = -1, j_is = -1;
            if (v_ok) {
                const float dt = d_uc[row0 + t];
                const float t0 = IC[2 * t], t1 = IC[2 * t + 1];
                const float hull_l = fminf(u0, t0), hull_r = fmaxf(u1, t1);
                const float int_l = fmaxf(u0, t0), int_r = fminf(u1, t1);
                const bool nonempty = int_l <= int_r;
                for (int base = 0; base < t && (j_if < 0 || j_is < 0); base += 32) {
                    const int w = base + lane;
                    bool wit_if = false, wit_is = false;
                    if (w < t && act[w] != 0) {
                        const int a = act[w];
                        const bool geo = __fmul_rn(alpha2, drow[w]) < dt;
                        const float c0 = IC[2 * w], c1 = IC[2 * w + 1];
                        const bool phi_if = !unified || (hull_l <= c0 && c1 <= hull_r);
                        const bool phi_is = !unified || (nonempty && c0 <= int_l && c1 >= int_r);
                        wit_if = geo && (a & 1) && phi_if;
                        wit_is = geo && (a & 2) && phi_is;
                    }
                    const unsigned bal_if = __ballot_sync(REPRO_FULL_MASK, wit_if);
                    const unsigned bal_is = __ballot_sync(REPRO_FULL_MASK, wit_is);
                    if (j_if < 0 && bal_if) j_if = base + __ffs(bal_if) - 1;
                    if (j_is < 0 && bal_is) j_is = base + __ffs(bal_is) - 1;
                }
            }
            if (lane == 0) {
                const bool s_if = v_ok;
                const bool s_is = v_ok && overlap[row0 + t] != 0;
                const bool keep_if = s_if && j_if < 0 && cnt_if < m_if;
                const bool keep_is = s_is && j_is < 0 && cnt_is < m_is;
                cnt_if += keep_if;
                cnt_is += keep_is;
                act[t] = (keep_if ? 1 : 0) | (keep_is ? 2 : 0);
                rep_if[row0 + t] = (s_if && j_if >= 0) ? j_if : -1;
                rep_is[row0 + t] = (s_is && j_is >= 0) ? j_is : -1;
            }
        }
        __syncthreads();
    }
    for (int i = tid; i < C; i += blockDim.x)
        status[row0 + i] = (act[i] & 1) + (act[i] & 2);
}

extern "C" int repro_prune_sweep(const float* i_u, const float* xs, const float* i_c,
                                 const float* d_uc, const int* valid, const int* overlap,
                                 int* status, int* rep_if, int* rep_is,
                                 int B, int C, int d, int m_if, int m_is,
                                 float alpha2, int unified, cudaStream_t stream) {
    const int threads = 256;
    const size_t smem = static_cast<size_t>(C) * 8;
    if (smem > 48 * 1024) {  // beyond the default: opt in (the wrapper refuses past the card's limit)
        const cudaError_t err = cudaFuncSetAttribute(
            prune_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    prune_sweep_kernel<<<B, threads, smem, stream>>>(
        i_u, xs, i_c, d_uc, valid, overlap, status, rep_if, rep_is,
        C, d, m_if, m_is, alpha2, unified);
    return static_cast<int>(cudaGetLastError());
}
