// filtered_topk: the interval-filtered exact top-k of every query in one
// pass over the corpus (the pre-filter scan and the ground truth).  For
// query i it returns the k smallest squared distances max(|q|^2 + |x|^2 -
// 2 q.x, 0) over the objects j whose interval passes the predicate (IF/RF:
// obj within the query window, IS/RS: obj covers it), ascending under the
// total order (distance, id), padded with (+inf, -1).
//
// Replaces the Pallas kernel src/repro/kernels/fused_scan.py::filtered_topk
// (the corpus axis a sequential grid dimension, the running top-k carried in
// the revisited output block, k rounds of min-extract and sorted insert).
//
// Bound on the H100: operations, 2 nq nx d multiply-adds against
// (nq + nx) d input bytes: at nq = 10,000 and d = 128 about 4,800 flops per
// corpus byte.  The TPU kernel runs its product on the matrix unit; this
// one runs it on the tensor cores (mma_tile.cuh): f32 rows as 3xTF32, three
// TF32 products a multiply-add (15.5 ms at 10,000 x 1M x 128 at
// 495 TFLOP/s, against 38.2 ms for fp32 on the SIMT cores), bf16 rows as
// one bf16 product (2.6 ms at 989 TFLOP/s).
//
// Design: the TPU grid's sequential corpus axis becomes a loop inside a
// block, and the corpus is cut into `splits` contiguous ranges so that
// enough blocks are in flight: block (i, s) scans query tile i (128 rows)
// against range s in 128-row tiles, two blocks an SM (the wrapper picks
// `splits` so that the blocks fill the card's slots).  Each tile's inner
// products come from mma_tile.cuh's tile, which folds the norms in the
// plain version's order; the query rows' norms are folded once, at the
// block's first tile.  The epilogue stores the raw (128, 128) products
// into the idle staging buffers and keeps nothing else live beside the
// accumulators.  Then each warp owns 16 query rows, and lane l columns l,
// l + 32, l + 64, l + 96 of each, whose intervals and norms it holds in
// registers for the tile.  For every row it forms the four distances,
// (|q|^2 + |x|^2) - 2 q.x clamped at 0 in the plain version's grouping,
// +inf where the predicate fails, and the warp votes once on whether any
// lies below the row's k-th distance (a register of one lane): past the
// first tiles, almost never.  Only rows with such a candidate go on: 32
// candidates at a time, lowest column first, each still below the k-th
// distance is inserted behind the entries of equal distance (those all
// have lower ids).  The sorted lists live in the partial-result buffer in
// device memory, so that they take no shared memory for any k (128 rows x
// 256 entries x 8 bytes would be 262 KB, above a block's 227 KB): lane l
// owns entries l, l + 32, ... of each of its warp's lists, loads a row's
// list into registers at the row's first insert in a tile, shifts it there
// with shuffles and stores it back, so no thread ever reads an entry that
// another wrote.  A second kernel merges each query's `splits` sorted lists
// under (distance, id), one warp a query.  The answer is the k smallest
// under a total order, so it does not depend on `splits` or on the tile
// sizes.  Its distances are the tensor-core tile's: within
// (d + 4) 2^-23 (|q|^2 + |x|^2) of the plain version's, and bitwise equal
// on small integers (mma_tile.cuh).
#include <climits>

#include "mma_tile.cuh"

namespace {

using mmatile::BM;
using mmatile::BN;
constexpr int DS = BN + 8;       // floats a row of the distance tile in shared memory
constexpr int MAX_K = 256;
constexpr int KPL = MAX_K / 32;  // list entries a lane owns at most
constexpr int ROWS_PER_WARP = BM / (mmatile::THREADS / 32);
static_assert(BM * DS <= mmatile::STAGES * mmatile::STAGE_WORDS,
              "the distance tile reuses the staging buffers");
static_assert(ROWS_PER_WARP <= 32, "a lane holds one row's k-th distance");
// Dynamic shared memory: the tile's, then the query windows and the
// tile's object intervals.
constexpr int SMEM_BYTES = mmatile::SMEM_BYTES + (2 * BM + 2 * BN) * 4;

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

// Insert (dv, iv) into the ascending list held in registers (entry
// lane + 32 t in cd[t], ci[t]) of k entries, behind every entry whose
// distance is <= dv; the last entry drops out.  Called by a whole warp with
// the same arguments; returns the list's new k-th distance.
__device__ __forceinline__ float insert(float (&cd)[KPL], int (&ci)[KPL], int k, float dv,
                                        int iv, int lane) {
    int cnt = 0;
#pragma unroll
    for (int t = 0; t < KPL; ++t)
        if (32 * t < k) cnt += lane + 32 * t < k && cd[t] <= dv;
    const int pos = __reduce_add_sync(REPRO_FULL_MASK, cnt);
    // entry j > pos takes entry j - 1: lane - 1's slot t, or lane 31's slot
    // t - 1 for lane 0; downwards in t, so that both are still the old ones
#pragma unroll
    for (int t = KPL - 1; t >= 0; --t) {
        if (32 * t >= k) continue;   // warp-uniform
        const float up_d = __shfl_sync(REPRO_FULL_MASK, cd[t], (lane + 31) & 31);
        const int up_i = __shfl_sync(REPRO_FULL_MASK, ci[t], (lane + 31) & 31);
        const int tp = t > 0 ? t - 1 : 0;   // (lane 0's entry 0 never shifts)
        const float wrap_d = __shfl_sync(REPRO_FULL_MASK, cd[tp], 31);
        const int wrap_i = __shfl_sync(REPRO_FULL_MASK, ci[tp], 31);
        const int j = lane + 32 * t;
        if (j > pos) {
            cd[t] = lane == 0 ? wrap_d : up_d;
            ci[t] = lane == 0 ? wrap_i : up_i;
        } else if (j == pos) {
            cd[t] = dv;
            ci[t] = iv;
        }
    }
    const int tk = (k - 1) >> 5;
    float last = inf();
#pragma unroll
    for (int t = 0; t < KPL; ++t)
        if (t == tk) last = cd[t];
    return __shfl_sync(REPRO_FULL_MASK, last, (k - 1) & 31);
}

// Lane l's candidates of one row of the tile: columns l + 32 j, their
// distances where their intervals pass the predicate (+inf where not), and
// the least of them.  d_row: the row's inner products in shared memory.
__device__ __forceinline__ float row_dists(float (&dc)[BN / 32], const float* d_row, float qn,
                                           float q_lo, float q_hi, const float (&xn)[BN / 32],
                                           const float (&o_lo)[BN / 32],
                                           const float (&o_hi)[BN / 32], int is_filter,
                                           int lane) {
    float low = inf();
#pragma unroll
    for (int j = 0; j < BN / 32; ++j) {
        const bool pass = is_filter ? (o_lo[j] >= q_lo && o_hi[j] <= q_hi)
                                    : (o_lo[j] <= q_lo && o_hi[j] >= q_hi);
        const float dv = __fsub_rn(__fadd_rn(qn, xn[j]), __fmul_rn(2.0f, d_row[32 * j + lane]));
        // NaN passes the clamp, as torch.clamp_min lets it, and is never taken
        dc[j] = !pass ? inf() : dv < 0.0f ? 0.0f : dv;
        low = fminf(low, dc[j]);
    }
    return low;
}

template <typename T>
__global__ void __launch_bounds__(mmatile::THREADS, 2)   // two blocks an SM: <= 128 registers
scan_kernel(const T* __restrict__ q, const T* __restrict__ x,
            const float* __restrict__ oi, const float* __restrict__ qi,
            float* __restrict__ part_d, int* __restrict__ part_i,
            int nq, int nx, int d, int k, int is_filter, int tiles_per_split) {
    extern __shared__ float4 smem4[];
    uint32_t* smem = reinterpret_cast<uint32_t*>(smem4);
    const float* norms = reinterpret_cast<const float*>(smem + mmatile::STAGES * mmatile::STAGE_WORDS);
    float* sqi = reinterpret_cast<float*>(smem + mmatile::STAGES * mmatile::STAGE_WORDS) + BM + BN;
    float* soi = sqi + 2 * BM;
    float* D = reinterpret_cast<float*>(smem);   // the tile's inner products, over the stages

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int wm = warp >> 2, wn = warp & 3;
    const int g = lane >> 2, tig = lane & 3;
    const long long q0 = static_cast<long long>(blockIdx.x) * BM;
    const int split = blockIdx.y;
    // the list of row r (of this warp: r = warp + 8 rr) in the partial results
#define LIST(r) ((static_cast<long long>(split) * nq + q0 + (r)) * k)
    for (int r = warp; r < BM && q0 + r < nq; r += 8)
        for (int j = lane; j < k; j += 32) {
            part_d[LIST(r) + j] = inf();
            part_i[LIST(r) + j] = -1;
        }
    float thr = inf();   // lane rr: the k-th distance of row warp + 8 rr
    for (int e = tid; e < BM; e += mmatile::THREADS) {
        const long long r = q0 + e;
        sqi[2 * e] = r < nq ? qi[2 * r] : 0.0f;
        sqi[2 * e + 1] = r < nq ? qi[2 * r + 1] : 0.0f;
    }
    const int ntiles = (nx + BN - 1) / BN;
    const int t_begin = split * tiles_per_split;
    const int t_end = min(t_begin + tiles_per_split, ntiles);
    for (int t = t_begin; t < t_end; ++t) {
        const long long x0 = static_cast<long long>(t) * BN;
        for (int e = tid; e < BN; e += mmatile::THREADS) {   // NaN past nx: passes no window
            const long long c = x0 + e;
            soi[2 * e] = c < nx ? oi[2 * c] : __int_as_float(0x7fffffff);
            soi[2 * e + 1] = c < nx ? oi[2 * c + 1] : __int_as_float(0x7fffffff);
        }
        float acc[4][4][4];
        // the query rows' norms are folded at the first tile and kept
        mmatile::tile<T>(acc, q, nq, q0, x, nx, x0, d, smem, t == t_begin);   // ends with a barrier
        // the inner products into the (now idle) stages: the epilogue keeps
        // no more than the accumulators live
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int lr = wm * 64 + mt * 16 + g + 8 * h;
#pragma unroll
                for (int nt = 0; nt < 4; ++nt)
                    *reinterpret_cast<float2*>(D + lr * DS + wn * 32 + nt * 8 + 2 * tig) =
                        make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
            }
        __syncthreads();
        // each warp folds its rows' candidates into their lists (see above)
        float xn[BN / 32], o_lo[BN / 32], o_hi[BN / 32];
#pragma unroll
        for (int j = 0; j < BN / 32; ++j) {
            xn[j] = norms[BM + 32 * j + lane];
            o_lo[j] = soi[2 * (32 * j + lane)];
            o_hi[j] = soi[2 * (32 * j + lane) + 1];
        }
        // first the vote of every row (the rows are independent, so their
        // loads overlap), then the rows with a candidate below the k-th
        unsigned rows_hit = 0;
#pragma unroll
        for (int rr = 0; rr < ROWS_PER_WARP; ++rr) {
            const int r = warp + 8 * rr;
            float dc[BN / 32];
            const float low = row_dists(dc, D + r * DS, norms[r], sqi[2 * r], sqi[2 * r + 1], xn,
                                        o_lo, o_hi, is_filter, lane);
            const float kth = __shfl_sync(REPRO_FULL_MASK, thr, rr);
            if (__any_sync(REPRO_FULL_MASK, low < kth) && q0 + r < nq) rows_hit |= 1u << rr;
        }
        while (rows_hit) {
            const int rr = __ffs(rows_hit) - 1;
            rows_hit &= rows_hit - 1;
            const int r = warp + 8 * rr;
            float dc[BN / 32];
            row_dists(dc, D + r * DS, norms[r], sqi[2 * r], sqi[2 * r + 1], xn, o_lo, o_hi,
                      is_filter, lane);
            float kth = __shfl_sync(REPRO_FULL_MASK, thr, rr);
            bool loaded = false;
            float cd[KPL];
            int ci[KPL];
#pragma unroll
            for (int j = 0; j < BN / 32; ++j) {
                const bool hit = dc[j] < kth;
                unsigned bal = __ballot_sync(REPRO_FULL_MASK, hit);
                while (bal) {
                    const int src = __ffs(bal) - 1;
                    bal &= bal - 1;
                    const float dv = __shfl_sync(REPRO_FULL_MASK, dc[j], src);
                    if (!(dv < kth)) continue;   // warp-uniform
                    if (!loaded) {
#pragma unroll
                        for (int s = 0; s < KPL; ++s) {
                            const int e = lane + 32 * s;
                            cd[s] = e < k ? part_d[LIST(r) + e] : inf();
                            ci[s] = e < k ? part_i[LIST(r) + e] : -1;
                        }
                        loaded = true;
                    }
                    kth = insert(cd, ci, k, dv, static_cast<int>(x0) + 32 * j + src, lane);
                }
            }
            if (loaded) {
#pragma unroll
                for (int s = 0; s < KPL; ++s) {
                    const int j = lane + 32 * s;
                    if (j < k) {
                        part_d[LIST(r) + j] = cd[s];
                        part_i[LIST(r) + j] = ci[s];
                    }
                }
                if (lane == rr) thr = kth;
            }
        }
        __syncthreads();   // the next tile's staging overwrites D and soi
    }
#undef LIST
}

// One warp per query: the k smallest of its `splits` sorted lists under
// (distance, id); ids of +inf entries come out as -1.
__global__ void merge_kernel(const float* __restrict__ part_d, const int* __restrict__ part_i,
                             float* __restrict__ out_d, int* __restrict__ out_i,
                             int nq, int k, int splits) {
    const long long qid = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (qid >= nq) return;  // warp-uniform
    int h = 0;
    float hd = inf();
    int hi = INT_MAX;
    const long long base = (static_cast<long long>(lane) * nq + qid) * k;
    if (lane < splits) {
        hd = part_d[base];
        hi = part_i[base];
    }
    for (int j = 0; j < k; ++j) {
        float bd = hd;
        int bi = hi, bl = lane;
        for (int off = 16; off >= 1; off >>= 1) {
            const float od = __shfl_xor_sync(REPRO_FULL_MASK, bd, off);
            const int oid = __shfl_xor_sync(REPRO_FULL_MASK, bi, off);
            const int ol = __shfl_xor_sync(REPRO_FULL_MASK, bl, off);
            if (od < bd || (od == bd && (oid < bi || (oid == bi && ol < bl)))) {
                bd = od;
                bi = oid;
                bl = ol;
            }
        }
        if (lane == 0) {
            out_d[qid * k + j] = bd;
            out_i[qid * k + j] = isfinite(bd) ? bi : -1;
        }
        if (lane == bl) {
            ++h;
            if (h < k && lane < splits) {
                hd = part_d[base + h];
                hi = part_i[base + h];
            } else {
                hd = inf();
                hi = INT_MAX;
            }
        }
    }
}

template <typename T>
int launch(const T* q, const T* x, const float* oi, const float* qi, float* part_d,
           int* part_i, float* out_d, int* out_i, int nq, int nx, int d, int k,
           int is_filter, int splits, cudaStream_t stream) {
    if (k < 1 || k > MAX_K || splits < 1 || splits > 32) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaFuncSetAttribute(scan_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int ntiles = (nx + BN - 1) / BN;
    const int tiles_per_split = (ntiles + splits - 1) / splits;
    const dim3 grid((nq + BM - 1) / BM, splits);
    scan_kernel<T><<<grid, mmatile::THREADS, SMEM_BYTES, stream>>>(
        q, x, oi, qi, part_d, part_i, nq, nx, d, k, is_filter, tiles_per_split);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const int threads = 256;
    const long long blocks = (static_cast<long long>(nq) * 32 + threads - 1) / threads;
    merge_kernel<<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
        part_d, part_i, out_d, out_i, nq, k, splits);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_filtered_topk(const float* q, const float* x, const float* oi,
                                   const float* qi, float* part_d, int* part_i,
                                   float* out_d, int* out_i, int nq, int nx, int d, int k,
                                   int is_filter, int splits, cudaStream_t stream) {
    return launch(q, x, oi, qi, part_d, part_i, out_d, out_i, nq, nx, d, k, is_filter,
                  splits, stream);
}

extern "C" int repro_filtered_topk_bf16(const __nv_bfloat16* q, const __nv_bfloat16* x,
                                        const float* oi, const float* qi, float* part_d,
                                        int* part_i, float* out_d, int* out_i, int nq, int nx,
                                        int d, int k, int is_filter, int splits,
                                        cudaStream_t stream) {
    return launch(q, x, oi, qi, part_d, part_i, out_d, out_i, nq, nx, d, k, is_filter,
                  splits, stream);
}
