// beam_merge: the E smallest of (sorted beam) union (candidates) under the
// total order (dist, payload), ascending.
//
// Replaces the Pallas kernel src/repro/kernels/beam_merge.py::beam_merge
// (bitonic sort of the L candidates, reversed min against the beam, log E
// merge stages, all vectorised over the lane axis).
//
// Bound on the H100: bytes.  A row reads (2E + 2L_in) * 4 bytes and writes
// 2E * 4 once; the network's O(L log^2 L) compares are cheap integer and
// float ops.  What holds a simple kernel back is where the network runs: in
// shared memory, each compare-exchange is four loads and four stores and
// every stage ends in a block barrier.
//
// Design: the network runs in registers.  The row's N = max(L, E) slots
// (candidates past L_in, and slots past L, hold the (+inf, PAD_PAYLOAD)
// pads, written in registers) are laid out as element i at warp i / (32 P),
// lane (i / P) % 32, register i % P, with P = min(max(N / 32, 1), 8) keys a
// lane and N / (32 P) warps a row.  A stage of stride j pairs i with i ^ j:
//   j < P        inside the thread, register r against r ^ j;
//   P <= j < 32P __shfl_xor_sync over lane mask j / P, the same register;
//   j >= 32P     through shared memory (two buffers used in turn, so one
//                block barrier a stage).
// The stage sequence is the reference's: the full sort of the L slots
// (block sizes k = 2 .. L; slots at L and beyond are never paired with one
// below L), then element i < E takes the smaller of beam[i] and candidate
// E - 1 - i = i ^ (E - 1) (register r ^ (EP - 1), EP = min(E, P), of lane
// lane ^ ((E - 1) / P) % 32, of warp w ^ (E - 1) / (32 P)), then the log E
// merge stages.  The beam is read into the same layout, so the merge's
// first E slots sit in the first E / P lanes.  Every register index is a
// compile-time constant (P and EP are template parameters; stage loops over
// register strides are fully unrolled, loops over lane and warp strides only
// change shuffle masks and shared-memory offsets), so no array lands in
// local memory.
//
// Which shapes take which path (N = max(L, E)):
//   N <= 32:          one warp a row, P = 1, lanes >= N idle;
//   32 < N <= 256:    one warp a row, P = N / 32; no barrier at all;
//   256 < N <= 4096:  N / 256 warps a row (2, 4, 8, 16), P = 8; only the
//                     strides >= 256 go through shared memory: at L = 2048,
//                     E = 64 that is 6 barriers, where a barrier a stage
//                     makes 66.
// One-warp rows go 8 to a 256-thread block (B = 10,000 rows: 1,250
// blocks), compiled apart from the multi-warp kernel (no shared-memory
// code, no barrier) under launch bounds of 5 blocks an SM: 47 registers at
// the search's main shape (E = 64, L = 256), so the 132 SMs hold 660
// blocks, 5,280 rows, at a time, and 10,000 rows are 1.89 waves, the
// second 89 % full.  Multi-warp rows take 256-thread blocks too (4, 2 or 1
// rows a block at 2, 4 or 8 warps a row), 512 threads at 16; N = 4096 uses
// 64 KiB of shared memory, above the 48 KiB default.
//
// The compare-exchange is the reference's per-element rule, verbatim: the
// low element takes its partner when le(self, partner) != asc, the high one
// when ge(self, partner) != asc, each decided on its own (the two coincide,
// since ge(b, a) reads the same comparisons as le(a, b), NaN included).  It
// has only compares and selects, so the result is bitwise the plain
// network's and the reference's on any input, NaN and -0.0 included.
//
// Rows whose candidates are all pads skip the sort.  Proof that this gives
// the network's bits on any input: if every slot holds the bits of
// (+inf, PAD_PAYLOAD), every compare-exchange of the sort pairs two
// bitwise-equal elements, and each element leaves it holding itself or its
// partner, the same bits; so the sorted slots are the loaded slots, and the
// sort is the identity on them.  The beam is not looked at: the reversed
// minimum and the merge stages then run as always, so a NaN in the beam or
// an unsorted beam comes out as the network puts it.  The test is on the
// bits (+inf as 0x7f800000, the payload -2), decided for the whole warp
// (__all_sync) or, with several warps a row, the whole block
// (__syncthreads_and), so every thread takes the same path.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int PAD_PAYLOAD = -2;
constexpr unsigned INF_BITS = 0x7f800000u;
constexpr int MAX_P = 8;            // keys a lane
constexpr int BLOCK = 256;          // threads a block where a row needs fewer
constexpr int MIN_BLOCKS = 5;       // one-warp rows: blocks an SM (at most 51 registers)
constexpr int MAX_WARPS = 16;       // warps a row: N <= 32 * MAX_P * MAX_WARPS = 4096
constexpr int MAX_THREADS = 32 * MAX_WARPS;

__host__ __device__ constexpr int ilog2(int v) { return v <= 1 ? 0 : 1 + ilog2(v / 2); }

__device__ __forceinline__ bool key_le(float d, int p, float pd, int pp) {
    return (d < pd) || (d == pd && p <= pp);
}

__device__ __forceinline__ bool key_ge(float d, int p, float pd, int pp) {
    return (d > pd) || (d == pd && p >= pp);
}

// One element's side of a compare-exchange against its partner's value.
__device__ __forceinline__ void take(float& d, int& p, float pd, int pp, bool is_lo, bool asc) {
    const bool in_order = is_lo ? key_le(d, p, pd, pp) : key_ge(d, p, pd, pp);
    if (in_order != asc) {
        d = pd;
        p = pp;
    }
}

// Registers lo < hi of one thread: both sides of the pair.
template <int P>
__device__ __forceinline__ void cmp_swap(float (&d)[P], int (&p)[P], int lo, int hi, bool asc) {
    const float dl = d[lo], dh = d[hi];
    const int pl = p[lo], ph = p[hi];
    const bool take_lo = key_le(dl, pl, dh, ph) != asc;
    const bool take_hi = key_ge(dh, ph, dl, pl) != asc;
    d[lo] = take_lo ? dh : dl;
    p[lo] = take_lo ? ph : pl;
    d[hi] = take_hi ? dl : dh;
    p[hi] = take_hi ? pl : ph;
}

// The stages j = jtop / 2, ..., 1 inside the thread (jtop <= P).  A pair's
// direction is bit k of its register index where the sort block k lies
// inside the thread (k < P), else asc_lane.  Called with compile-time jtop
// and k (or inside a fully unrolled loop), so every index is a constant.
template <int P>
__device__ __forceinline__ void stages_in_thread(float (&d)[P], int (&p)[P], int jtop, int k,
                                                 bool asc_lane) {
#pragma unroll
    for (int lj = ilog2(P) - 1; lj >= 0; --lj) {
        const int j = 1 << lj;
        if (j >= jtop) continue;
#pragma unroll
        for (int r = 0; r < P; ++r) {
            if (r & j) continue;
            cmp_swap(d, p, r, r | j, k < P ? (r & k) == 0 : asc_lane);
        }
    }
}

// A stage of stride j = m * P (m < 32): every register against the same
// register of lane ^ m.
template <int P>
__device__ __forceinline__ void stage_shfl(float (&d)[P], int (&p)[P], int m, bool asc) {
    const bool is_lo = ((threadIdx.x & 31) & m) == 0;
#pragma unroll
    for (int r = 0; r < P; ++r) {
        const float pd = __shfl_xor_sync(REPRO_FULL_MASK, d[r], m);
        const int pp = __shfl_xor_sync(REPRO_FULL_MASK, p[r], m);
        take(d[r], p[r], pd, pp, is_lo, asc);
    }
}

// The row's slots in shared memory, two buffers used in turn: a thread
// stores its P slots into one, waits at the barrier, and reads another
// thread's P slots; by the next store into the same buffer every thread has
// passed a later barrier, so all reads of it are done.
struct Exchange {
    float* d;
    int* p;
    int half;       // elements from buffer 0 to buffer 1
    int buf;

    template <int P>
    __device__ __forceinline__ void swap_with(const float (&v)[P], const int (&q)[P], int i0,
                                              float (&pv)[P], int (&pq)[P], int q0) {
        float* bd = d + buf * half;
        int* bp = p + buf * half;
        if constexpr (P % 4 == 0) {
#pragma unroll
            for (int c = 0; c < P; c += 4) {
                *reinterpret_cast<float4*>(bd + i0 + c) = make_float4(v[c], v[c + 1], v[c + 2],
                                                                      v[c + 3]);
                *reinterpret_cast<int4*>(bp + i0 + c) = make_int4(q[c], q[c + 1], q[c + 2],
                                                                  q[c + 3]);
            }
        } else {
#pragma unroll
            for (int r = 0; r < P; ++r) {
                bd[i0 + r] = v[r];
                bp[i0 + r] = q[r];
            }
        }
        __syncthreads();
        if constexpr (P % 4 == 0) {
#pragma unroll
            for (int c = 0; c < P; c += 4) {
                const float4 a = *reinterpret_cast<const float4*>(bd + q0 + c);
                const int4 b = *reinterpret_cast<const int4*>(bp + q0 + c);
                pv[c] = a.x; pv[c + 1] = a.y; pv[c + 2] = a.z; pv[c + 3] = a.w;
                pq[c] = b.x; pq[c + 1] = b.y; pq[c + 2] = b.z; pq[c + 3] = b.w;
            }
        } else {
#pragma unroll
            for (int r = 0; r < P; ++r) {
                pv[r] = bd[q0 + r];
                pq[r] = bp[q0 + r];
            }
        }
        buf ^= 1;
    }
};

// A stage of stride j >= 32 P: every slot against slot i ^ j of another warp.
template <int P>
__device__ __forceinline__ void stage_smem(float (&d)[P], int (&p)[P], Exchange& x, int i0,
                                           int j, bool asc) {
    float pd[P];
    int pp[P];
    x.swap_with(d, p, i0, pd, pp, i0 ^ j);
    const bool is_lo = (i0 & j) == 0;
#pragma unroll
    for (int r = 0; r < P; ++r) take(d[r], p[r], pd[r], pp[r], is_lo, asc);
}

// Load P slots starting at slot i0 of a row of n: 16-byte loads where vec
// (n a multiple of 4, the row 16-byte aligned), slots at n and beyond left
// as they are.
template <int P>
__device__ __forceinline__ void load_slots(float (&d)[P], int (&p)[P], const float* rd,
                                           const int* rp, int i0, int n, bool vec) {
    if constexpr (P % 4 == 0) {
        if (vec) {
#pragma unroll
            for (int c = 0; c < P; c += 4) {
                if (i0 + c < n) {
                    const float4 a = __ldg(reinterpret_cast<const float4*>(rd + i0 + c));
                    const int4 b = __ldg(reinterpret_cast<const int4*>(rp + i0 + c));
                    d[c] = a.x; d[c + 1] = a.y; d[c + 2] = a.z; d[c + 3] = a.w;
                    p[c] = b.x; p[c + 1] = b.y; p[c + 2] = b.z; p[c + 3] = b.w;
                }
            }
            return;
        }
    }
#pragma unroll
    for (int r = 0; r < P; ++r) {
        if (i0 + r < n) {
            d[r] = __ldg(rd + i0 + r);
            p[r] = __ldg(rp + i0 + r);
        }
    }
}

// MULTI: several warps a row (nw > 1, P == MAX_P); else one, and the
// shared-memory stages compile away.
template <int P, int EP, bool MULTI>
__global__ void __launch_bounds__(MULTI ? MAX_THREADS : BLOCK, MULTI ? 1 : MIN_BLOCKS)
beam_merge_kernel(const float* __restrict__ beam_d, const int* __restrict__ beam_p,
                  const float* __restrict__ cand_d, const int* __restrict__ cand_p,
                  float* __restrict__ out_d, int* __restrict__ out_p,
                  int B, int E, int L_in, int L, int nw_arg, bool vec_c, bool vec_b) {
    constexpr int LOG_P = ilog2(P);
    const int nw = MULTI ? nw_arg : 1;
    extern __shared__ __align__(16) unsigned char smem_raw[];

    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int rows = (blockDim.x >> 5) / nw;
    const int slot = warp / nw;
    const int w = warp - slot * nw;
    const long long row = static_cast<long long>(blockIdx.x) * rows + slot;
    const bool live = row < B;
    const int i0 = (w * 32 + lane) * P;         // this thread's first slot
    const int N = 32 * P * nw;
    const float inf = __uint_as_float(INF_BITS);

    Exchange ex;
    ex.d = reinterpret_cast<float*>(smem_raw) + slot * N;
    ex.p = reinterpret_cast<int*>(smem_raw) + 2 * rows * N + slot * N;
    ex.half = rows * N;
    ex.buf = 0;

    float d[P];
    int p[P];
#pragma unroll
    for (int r = 0; r < P; ++r) {
        d[r] = inf;
        p[r] = PAD_PAYLOAD;
    }
    if (live) load_slots(d, p, cand_d + row * L_in, cand_p + row * L_in, i0, L_in, vec_c);

    bool pads = true;
#pragma unroll
    for (int r = 0; r < P; ++r)
        pads = pads && __float_as_uint(d[r]) == INF_BITS && p[r] == PAD_PAYLOAD;
    const bool all_pads = MULTI ? __syncthreads_and(pads) : __all_sync(REPRO_FULL_MASK, pads);

    // 1. bitonic sort of the L slots, ascending
    if (!all_pads) {
#pragma unroll
        for (int lk = 1; lk <= LOG_P; ++lk) {       // sort blocks inside the thread
            const int k = 1 << lk;
            if (k <= L) stages_in_thread(d, p, k, k, (i0 & k) == 0);
        }
        for (int k = 2 * P; k <= L; k <<= 1) {
            const bool asc = (i0 & k) == 0;
            if (MULTI)
                for (int j = k >> 1; j >= 32 * P; j >>= 1) stage_smem(d, p, ex, i0, j, asc);
            for (int j = min(k >> 1, 16 * P); j >= P; j >>= 1) stage_shfl(d, p, j / P, asc);
            stages_in_thread(d, p, P, P, asc);
        }
    }

    // 2. the best E candidates, reversed, against the sorted beam: slot
    // i < E meets candidate i ^ (E - 1)
    float fd[P];
    int fp[P];
    const int x = E - 1;
    if (MULTI && x >= 32 * P) {                 // across warps (E > 32 P, so EP == P)
        float sd[P];
        int sp[P];
        ex.swap_with(d, p, i0, sd, sp, i0 ^ (x & ~(P - 1)));
#pragma unroll
        for (int r = 0; r < P; ++r) {
            fd[r] = sd[r ^ (EP - 1)];
            fp[r] = sp[r ^ (EP - 1)];
        }
    } else {
#pragma unroll
        for (int r = 0; r < P; ++r) {
            fd[r] = __shfl_xor_sync(REPRO_FULL_MASK, d[r ^ (EP - 1)], x / P);
            fp[r] = __shfl_xor_sync(REPRO_FULL_MASK, p[r ^ (EP - 1)], x / P);
        }
    }
    float bd[P];
    int bp[P];
#pragma unroll
    for (int r = 0; r < P; ++r) {
        bd[r] = inf;
        bp[r] = PAD_PAYLOAD;
    }
    if (live && i0 < E) load_slots(bd, bp, beam_d + row * E, beam_p + row * E, i0, E, vec_b);
#pragma unroll
    for (int r = 0; r < EP; ++r) {
        const bool le = key_le(bd[r], bp[r], fd[r], fp[r]);
        d[r] = le ? bd[r] : fd[r];
        p[r] = le ? bp[r] : fp[r];
    }

    // 3. log E merge stages re-sort the bitonic sequence
    if (MULTI)
        for (int j = E >> 1; j >= 32 * P; j >>= 1) stage_smem(d, p, ex, i0, j, true);
    for (int j = min(E >> 1, 16 * P); j >= P; j >>= 1) stage_shfl(d, p, j / P, true);
    stages_in_thread(d, p, EP, P, true);

    if (!live || i0 >= E) return;
    float* od = out_d + row * E + i0;
    int* op = out_p + row * E + i0;
    if constexpr (EP % 4 == 0) {
        if (vec_b) {
#pragma unroll
            for (int c = 0; c < EP; c += 4) {
                *reinterpret_cast<float4*>(od + c) = make_float4(d[c], d[c + 1], d[c + 2],
                                                                 d[c + 3]);
                *reinterpret_cast<int4*>(op + c) = make_int4(p[c], p[c + 1], p[c + 2], p[c + 3]);
            }
            return;
        }
    }
#pragma unroll
    for (int r = 0; r < EP; ++r) {
        od[r] = d[r];
        op[r] = p[r];
    }
}

struct Launch {
    const float* beam_d;
    const int* beam_p;
    const float* cand_d;
    const int* cand_p;
    float* out_d;
    int* out_p;
    int B, E, L_in, L, nw, rows;
    bool vec_c, vec_b;
    size_t smem;
    cudaStream_t stream;
};

template <int P, int EP, bool MULTI>
int launch(const Launch& a) {
    auto kernel = beam_merge_kernel<P, EP, MULTI>;
    if (a.smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(a.smem));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    const unsigned blocks = static_cast<unsigned>((a.B + a.rows - 1) / a.rows);
    kernel<<<blocks, a.rows * 32 * a.nw, a.smem, a.stream>>>(
        a.beam_d, a.beam_p, a.cand_d, a.cand_p, a.out_d, a.out_p, a.B, a.E, a.L_in, a.L, a.nw,
        a.vec_c, a.vec_b);
    return static_cast<int>(cudaGetLastError());
}

// The instantiation for keys-a-lane p and E's keys a lane ep (ep <= p).
template <int P, int EP = 1>
int dispatch(int p, int ep, const Launch& a) {
    if constexpr (P > MAX_P) {
        return static_cast<int>(cudaErrorInvalidValue);
    } else if constexpr (EP > P) {
        return dispatch<2 * P, 1>(p, ep, a);
    } else {
        if (p == P && ep == EP) {
            if constexpr (P == MAX_P)
                if (a.nw > 1) return launch<P, EP, true>(a);
            return launch<P, EP, false>(a);
        }
        return dispatch<P, 2 * EP>(p, ep, a);
    }
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0; }

}  // namespace

// E and L are powers of two, L >= L_in, max(L, E) <= 4096.  threads is not
// read: the kernel sizes its own launch (the argument keeps the entry
// point's signature, which tools that load older builds of this library
// share).
extern "C" int repro_beam_merge(const float* beam_d, const int* beam_p,
                                const float* cand_d, const int* cand_p,
                                float* out_d, int* out_p,
                                int B, int E, int L_in, int L, int threads,
                                cudaStream_t stream) {
    (void)threads;
    const int N = L > E ? L : E;
    const int P = N / 32 < 1 ? 1 : (N / 32 > MAX_P ? MAX_P : N / 32);
    const int nw = N / (32 * P) < 1 ? 1 : N / (32 * P);
    if (nw > MAX_WARPS) return static_cast<int>(cudaErrorInvalidValue);
    const int rows = BLOCK / (32 * nw) < 1 ? 1 : BLOCK / (32 * nw);
    Launch a{beam_d, beam_p, cand_d, cand_p, out_d, out_p, B, E, L_in, L, nw, rows,
             L_in % 4 == 0 && aligned16(cand_d) && aligned16(cand_p),
             E % 4 == 0 && aligned16(beam_d) && aligned16(beam_p) && aligned16(out_d) &&
                 aligned16(out_p),
             nw > 1 ? static_cast<size_t>(2 * 2 * rows * N) * 4 : 0, stream};
    return dispatch<1, 1>(P, E < P ? E : P, a);
}
