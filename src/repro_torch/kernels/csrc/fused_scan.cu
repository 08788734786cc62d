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
// corpus byte.  As in l2dist.cu the products run on the SIMT cores with
// every multiply and add rounded on its own, bitwise equal to the plain
// version and at half the SIMT ceiling.
//
// Design: the TPU grid's sequential corpus axis becomes a loop inside a
// block, and the corpus is cut into `splits` contiguous ranges so that
// enough blocks are in flight: block (i, s) scans query tile i (64 rows)
// against range s in 128-row tiles.  Each tile's (64, 128) distances come
// from sq_dist_tile.cuh; the predicate is applied in registers and the
// tile lands in shared memory.  Then each warp owns 8 query rows and keeps
// each row's running top-k sorted in shared memory: 32 candidates at a time
// are compared with the row's k-th distance, and the few that beat it are
// inserted one after another, lowest column first, behind the entries of
// equal distance (those all have lower ids).  A second kernel merges each
// query's `splits` sorted lists under (distance, id), one warp a query.
// The answer is the k smallest under a total order, so it does not depend
// on `splits` or on the tile sizes.
#include <climits>

#include "sq_dist_tile.cuh"

namespace {

constexpr int BM = 64, BN = 128;
constexpr int DS = BN + 16;      // row stride of the distance tile (no bank conflicts)
constexpr int MAX_K = 256;
constexpr int KPL = MAX_K / 32;  // list entries a lane handles at most

size_t smem_bytes(int k) {
    const size_t floats = sqtile::staged_floats<BM>() + sqtile::staged_floats<BN>() + BM + BN
                          + 2 * BM + 2 * BN + static_cast<size_t>(BM) * DS;
    return floats * sizeof(float) + static_cast<size_t>(BM) * k * (sizeof(float) + sizeof(int));
}

// Insert (dv, iv) into the ascending list (ld, li) of k entries, behind
// every entry whose distance is <= dv; the last entry drops out.  Called by
// a whole warp with the same arguments.
__device__ __forceinline__ void insert(float* __restrict__ ld, int* __restrict__ li, int k,
                                       float dv, int iv, int lane) {
    int cnt = 0;
    for (int j = lane; j < k; j += 32) cnt += ld[j] <= dv;
    const int pos = __reduce_add_sync(REPRO_FULL_MASK, cnt);
    float nd[KPL];
    int ni[KPL];
#pragma unroll
    for (int t = 0; t < KPL; ++t) {
        const int j = lane + 32 * t;
        if (j < k && j >= pos) {
            nd[t] = j == pos ? dv : ld[j - 1];
            ni[t] = j == pos ? iv : li[j - 1];
        }
    }
    __syncwarp();
#pragma unroll
    for (int t = 0; t < KPL; ++t) {
        const int j = lane + 32 * t;
        if (j < k && j >= pos) {
            ld[j] = nd[t];
            li[j] = ni[t];
        }
    }
    __syncwarp();
}

template <typename T>
__global__ void __launch_bounds__(sqtile::THREADS)
scan_kernel(const T* __restrict__ q, const T* __restrict__ x,
            const float* __restrict__ oi, const float* __restrict__ qi,
            float* __restrict__ part_d, int* __restrict__ part_i,
            int nq, int nx, int d, int k, int is_filter, int tiles_per_split) {
    extern __shared__ float smem[];
    float* sq = smem;
    float* sx = sq + sqtile::staged_floats<BM>();
    float* sqn = sx + sqtile::staged_floats<BN>();
    float* sxn = sqn + BM;
    float* sqi = sxn + BN;
    float* soi = sqi + 2 * BM;
    float* D = soi + 2 * BN;
    float* Ld = D + BM * DS;
    int* Li = reinterpret_cast<int*>(Ld + BM * k);

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int ty = tid / 16, tx = tid % 16;
    const long long q0 = static_cast<long long>(blockIdx.x) * BM;
    const int split = blockIdx.y;
    for (int e = tid; e < BM * k; e += sqtile::THREADS) {
        Ld[e] = __int_as_float(0x7f800000);  // +inf
        Li[e] = -1;
    }
    for (int e = tid; e < BM; e += sqtile::THREADS) {
        const long long r = q0 + e;
        sqi[2 * e] = r < nq ? qi[2 * r] : 0.0f;
        sqi[2 * e + 1] = r < nq ? qi[2 * r + 1] : 0.0f;
    }
    const int ntiles = (nx + BN - 1) / BN;
    const int t_begin = split * tiles_per_split;
    const int t_end = min(t_begin + tiles_per_split, ntiles);
    for (int t = t_begin; t < t_end; ++t) {
        const long long x0 = static_cast<long long>(t) * BN;
        for (int e = tid; e < BN; e += sqtile::THREADS) {
            const long long c = x0 + e;
            soi[2 * e] = c < nx ? oi[2 * c] : 0.0f;
            soi[2 * e + 1] = c < nx ? oi[2 * c + 1] : 0.0f;
        }
        float dist[BM / 16][BN / 16];
        sqtile::tile<T, BM, BN>(dist, q, nq, q0, x, nx, x0, d, sq, sx, sqn, sxn);
#pragma unroll
        for (int i = 0; i < BM / 16; ++i) {
            const int r = ty + 16 * i;
            const float q_lo = sqi[2 * r], q_hi = sqi[2 * r + 1];
#pragma unroll
            for (int j = 0; j < BN / 16; ++j) {
                const int c = tx + 16 * j;
                const float o_lo = soi[2 * c], o_hi = soi[2 * c + 1];
                const bool pass = is_filter ? (o_lo >= q_lo && o_hi <= q_hi)
                                            : (o_lo <= q_lo && o_hi >= q_hi);
                const bool ok = pass && x0 + c < nx && q0 + r < nq;
                D[r * DS + c] = ok ? dist[i][j] : __int_as_float(0x7f800000);
            }
        }
        __syncthreads();
        for (int r = warp; r < BM; r += sqtile::THREADS / 32) {
            float* ld = Ld + r * k;
            int* li = Li + r * k;
            for (int base = 0; base < BN; base += 32) {
                const float dc = D[r * DS + base + lane];
                const int idc = static_cast<int>(x0) + base + lane;
                unsigned bal = __ballot_sync(REPRO_FULL_MASK, dc < ld[k - 1]);
                while (bal) {
                    const int src = __ffs(bal) - 1;
                    bal &= bal - 1;
                    const float dv = __shfl_sync(REPRO_FULL_MASK, dc, src);
                    const int iv = __shfl_sync(REPRO_FULL_MASK, idc, src);
                    if (dv < ld[k - 1]) insert(ld, li, k, dv, iv, lane);  // warp-uniform
                }
            }
        }
        __syncthreads();
    }
    for (int e = tid; e < BM * k; e += sqtile::THREADS) {
        const long long r = q0 + e / k;
        if (r < nq) {
            const long long o = (static_cast<long long>(split) * nq + r) * k + e % k;
            part_d[o] = Ld[e];
            part_i[o] = Li[e];
        }
    }
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
    float hd = __int_as_float(0x7f800000);
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
                hd = __int_as_float(0x7f800000);
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
    const size_t smem = smem_bytes(k);
    cudaError_t err = cudaFuncSetAttribute(scan_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const int ntiles = (nx + BN - 1) / BN;
    const int tiles_per_split = (ntiles + splits - 1) / splits;
    const dim3 grid((nq + BM - 1) / BM, splits);
    scan_kernel<T><<<grid, sqtile::THREADS, smem, stream>>>(
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
