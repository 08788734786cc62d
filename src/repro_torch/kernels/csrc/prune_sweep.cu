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
// equal.  A scan that walks t one at a time with a block barrier on each
// side of every step is held by those barriers instead (2 C of them a row,
// each behind a chain of loads).
//
// Design: one block per row b.  Everything about a pair (t, w) except
// "is w retained" depends on t, w and u alone: the distance, the geometric
// test and Phi_IF / Phi_IS.  So the candidates are scanned in chunks of
// T = 32 (one word of bits), and for each chunk the block first computes
// the pairs in parallel, a thread a pair:
//   (a) each valid t of the chunk against each w < t0 retained for IF or
//       IS (their state is final; the block keeps a list of them): the
//       first witness per t and per semantics, reduced with a shared
//       atomicMin (a min has no order); pairs above a known witness are
//       skipped;
//   (b) each valid t of the chunk against each valid w in [t0, t): a 32-bit
//       mask per t and semantics of the w that witness t if retained; only
//       for t that (a) left unwitnessed and semantics whose budget is open.
// Then warp 0 walks the chunk's t in order with no block barrier, lane ti
// deciding t = t0 + ti in its step and the warp taking its bits by ballot
// (only the t that no earlier chunk witnesses take a step):
// the first witness is (a)'s if there is one, else the lowest bit of (b)'s
// mask that is retained in this chunk so far; the budgets apply; then each
// lane writes its rep_if / rep_is and the retained t join the list.  Three
// barriers a chunk: 9 a row at C = 96, where a scan by candidate takes 192.
// What is left to bound it: the distances, whose fixed order rounds every
// subtract, multiply and add on its own and whose two loads an element
// (one a broadcast, which costs the shared-memory pipe a full access) make
// ~8 shared-memory cycles a 128-wide pair; and a row's fixed costs
// (staging, ballots, the scans, the barriers).
//
// A thread computes its pair's distance alone, in the fixed order of
// common.cuh (the 32 lane sums in 32 registers, then the butterfly's
// tree), which is the warp's result bit for bit without its shuffles.
// In (a) the threads of a warp share w (a broadcast) and differ in t, in
// (b) they share t and differ in w; staged rows are padded to a stride of
// 1 mod 32 words, so the rows of a chunk meet in no bank.
//
// Shared memory: the act / valid / overlap bits, the list of retained
// candidates and the chunk's scratch always (4.5 bytes a candidate, so
// C <= 51,536); the row's candidate vectors, intervals and d(u, .) too
// where they fit (C = 96, d = 128: 51,648 bytes, four blocks an SM), so
// that each vector is read from device memory once.  Otherwise
// (build_exact's C = n) they are read through L1 and L2.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int T = 32;          // candidates per chunk: one word of bits
constexpr int THREADS = 128;   // four warps: four blocks an SM at the main shape
constexpr int NONE = 0x7fffffff;

struct Scratch {               // one chunk's witnesses, reset by the scan
    int first_if[T];           // (a): first witness below the chunk
    int first_is[T];
    unsigned mask_if[T];       // (b): witnesses inside the chunk, bit w - t0
    unsigned mask_is[T];
    int cnt_if, cnt_is;        // budgets spent before the chunk
    int nret;                  // length of the retained list
    int pad;                   // keeps what follows 16-byte aligned
};

// A staged row's stride in floats: at least d, and 1 mod 32, so that 32
// neighbouring rows meet in no bank.
__host__ __device__ inline int row_stride(int d) { return d + ((33 - d % 32) % 32); }

__host__ __device__ inline size_t state_bytes(int C) {
    const size_t words = (C + 31) / 32;       // act_if, act_is, valid, overlap
    const size_t list = (C + 3) / 4 * 4;      // retained candidates
    return sizeof(Scratch) + words * 16 + list * 4;
}

__host__ __device__ inline size_t staged_bytes(int C, int d) {
    return (static_cast<size_t>(C) * row_stride(d) + 3 * static_cast<size_t>(C)) * 4;
}

// A fresh read of a shared value other threads may lower meanwhile.
__device__ __forceinline__ int peek(const int* p) { return *reinterpret_cast<const volatile int*>(p); }

// Position of the k-th (from 0) set bit of m; m has more than k set bits.
__device__ __forceinline__ int select_bit(unsigned m, int k) {
    int pos = 0;
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
        const int c = __popc(m & ((1u << s) - 1u));
        if (k >= c) {
            k -= c;
            m >>= s;
            pos += s;
        }
    }
    return pos;
}

// common.cuh's fixed order by one thread: lane sum l in s[l], then the
// butterfly as a tree (s[l] + s[l + 16], ...), which is lane 0's order and,
// by commutativity, every lane's.
__device__ __forceinline__ float thread_sq_dist(const float* __restrict__ a,
                                                const float* __restrict__ b, int d) {
    float s[32];
    const int full = d / 32;
#pragma unroll
    for (int l = 0; l < 32; ++l) s[l] = 0.0f;
    for (int i = 0; i < full; ++i) {
#pragma unroll
        for (int l = 0; l < 32; ++l) {
            const float df = __fsub_rn(a[32 * i + l], b[32 * i + l]);
            const float term = __fmul_rn(df, df);
            s[l] = (i == 0) ? term : __fadd_rn(s[l], term);
        }
    }
    if (d % 32) {
#pragma unroll
        for (int l = 0; l < 32; ++l) {
            const int k = 32 * full + l;
            float term = 0.0f;
            if (k < d) {
                const float df = __fsub_rn(a[k], b[k]);
                term = __fmul_rn(df, df);
            }
            s[l] = (full == 0) ? term : __fadd_rn(s[l], term);
        }
    }
#pragma unroll
    for (int l = 0; l < 16; ++l) s[l] = __fadd_rn(s[l], s[l + 16]);
#pragma unroll
    for (int l = 0; l < 8; ++l) s[l] = __fadd_rn(s[l], s[l + 8]);
#pragma unroll
    for (int l = 0; l < 4; ++l) s[l] = __fadd_rn(s[l], s[l + 4]);
    s[0] = __fadd_rn(s[0], s[2]);
    s[1] = __fadd_rn(s[1], s[3]);
    return __fadd_rn(s[0], s[1]);
}

template <bool STAGED>
__global__ void __launch_bounds__(THREADS)
prune_sweep_kernel(const float* __restrict__ i_u, const float* __restrict__ xs,
                   const float* __restrict__ i_c, const float* __restrict__ d_uc,
                   const int* __restrict__ valid, const int* __restrict__ overlap,
                   int* __restrict__ status, int* __restrict__ rep_if,
                   int* __restrict__ rep_is, int C, int d, int m_if, int m_is,
                   float alpha2, int unified) {
    extern __shared__ float4 smem4[];
    unsigned char* base = reinterpret_cast<unsigned char*>(smem4);
    Scratch& sc = *reinterpret_cast<Scratch*>(base);
    const int words = (C + 31) / 32;
    unsigned* act_if = reinterpret_cast<unsigned*>(base + sizeof(Scratch));
    unsigned* act_is = act_if + words;
    unsigned* vbits = act_is + words;
    unsigned* obits = vbits + words;
    int* rlist = reinterpret_cast<int*>(obits + words);

    const long long b = blockIdx.x;
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const long long row0 = b * C;
    const float* X = xs + row0 * d;
    const float* IC = i_c + row0 * 2;
    const float* DU = d_uc + row0;
    int stride = d;
    const float u0 = i_u[2 * b], u1 = i_u[2 * b + 1];

    if constexpr (STAGED) {
        float* sx = reinterpret_cast<float*>(base + state_bytes(C));
        stride = row_stride(d);
        float* sic = sx + static_cast<size_t>(C) * stride;
        float* sdu = sic + 2 * C;
        // a warp a row, 4-byte asynchronous copies: all of the row's loads
        // in flight at once, none through registers
        const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(sx));
        for (int w = tid >> 5; w < C; w += THREADS / 32)
            for (int k = lane; k < d; k += 32)
                asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                             :: "r"(sbase + 4u * static_cast<uint32_t>(w * stride + k)),
                                "l"(X + static_cast<long long>(w) * d + k) : "memory");
        asm volatile("cp.async.wait_all;\n" ::: "memory");
        for (int e = tid; e < 2 * C; e += THREADS) sic[e] = IC[e];
        for (int e = tid; e < C; e += THREADS) sdu[e] = DU[e];
        X = sx;
        IC = sic;
        DU = sdu;
    }
    const auto dist = [&](int w, int t) {
        return thread_sq_dist(X + static_cast<long long>(w) * stride,
                              X + static_cast<long long>(t) * stride, d);
    };
    for (int j = tid >> 5; j < words; j += THREADS / 32) {
        const int k = j * 32 + lane;
        const unsigned v = __ballot_sync(REPRO_FULL_MASK, k < C && valid[row0 + k] != 0);
        const unsigned o = __ballot_sync(REPRO_FULL_MASK, k < C && overlap[row0 + k] != 0);
        if (lane == 0) {
            vbits[j] = v;
            obits[j] = o;
            act_if[j] = 0u;
            act_is[j] = 0u;
        }
    }
    if (tid < T) {
        sc.first_if[tid] = NONE;
        sc.first_is[tid] = NONE;
        sc.mask_if[tid] = 0u;
        sc.mask_is[tid] = 0u;
    }
    if (tid == 0) sc.cnt_if = sc.cnt_is = sc.nret = 0;
    __syncthreads();

    for (int t0 = 0; t0 < C; t0 += T) {
        const int nt = min(T, C - t0);
        const int cw = t0 / 32;
        const unsigned vchunk = vbits[cw];
        const unsigned ochunk = vchunk & obits[cw];   // t valid and overlapping: IS applies
        const int nv = __popc(vchunk);
        const int R = sc.nret;

        // (a) valid t of the chunk against retained w < t0, in rounds of
        // ascending w (the list is in scan order), so that a pair whose t
        // has a lower witness already is skipped
        for (int p = tid; p < nv * R; p += THREADS) {
            const int ti = select_bit(vchunk, p % nv);
            const int w = rlist[p / nv];
            const unsigned wb = 1u << (w & 31);
            const bool r_if = (act_if[w >> 5] & wb) != 0u && peek(&sc.first_if[ti]) > w;
            const bool r_is = ((ochunk >> ti) & 1u) && (act_is[w >> 5] & wb) != 0u
                              && peek(&sc.first_is[ti]) > w;
            if (!(r_if || r_is)) continue;
            const int t = t0 + ti;
            const float acc = dist(w, t);
            const bool geo = __fmul_rn(alpha2, acc) < DU[t];
            const float c0t = IC[2 * t], c1t = IC[2 * t + 1];
            const float c0 = IC[2 * w], c1 = IC[2 * w + 1];
            const float int_l = fmaxf(u0, c0t), int_r = fminf(u1, c1t);
            const bool phi_if = !unified || (fminf(u0, c0t) <= c0 && c1 <= fmaxf(u1, c1t));
            const bool phi_is = !unified || (int_l <= int_r && c0 <= int_l && c1 >= int_r);
            if (r_if && geo && phi_if) atomicMin(&sc.first_if[ti], w);
            if (r_is && geo && phi_is) atomicMin(&sc.first_is[ti], w);
        }
        __syncthreads();

        // (b) valid t of the chunk against valid w in [t0, t): the pairs
        // (ia, ib), ib < ia, of the chunk's valid candidates
        const bool open_if = sc.cnt_if < m_if, open_is = sc.cnt_is < m_is;
        for (int p = tid; p < nv * (nv - 1) / 2; p += THREADS) {
            int ia = static_cast<int>((1.0f + sqrtf(8.0f * p + 1.0f)) * 0.5f);
            while (ia * (ia - 1) / 2 > p) --ia;
            while ((ia + 1) * ia / 2 <= p) ++ia;
            const int ti = select_bit(vchunk, ia);
            const int wi = select_bit(vchunk, p - ia * (ia - 1) / 2);
            const bool want_if = open_if && sc.first_if[ti] == NONE;
            const bool want_is = open_is && ((ochunk >> ti) & 1u) && ((ochunk >> wi) & 1u)
                                 && sc.first_is[ti] == NONE;
            if (!(want_if || want_is)) continue;
            const int t = t0 + ti, w = t0 + wi;
            const float acc = dist(w, t);
            const bool geo = __fmul_rn(alpha2, acc) < DU[t];
            const float c0t = IC[2 * t], c1t = IC[2 * t + 1];
            const float c0 = IC[2 * w], c1 = IC[2 * w + 1];
            const float int_l = fmaxf(u0, c0t), int_r = fminf(u1, c1t);
            const bool phi_if = !unified || (fminf(u0, c0t) <= c0 && c1 <= fmaxf(u1, c1t));
            const bool phi_is = !unified || (int_l <= int_r && c0 <= int_l && c1 >= int_r);
            if (want_if && geo && phi_if) atomicOr(&sc.mask_if[ti], 1u << wi);
            if (want_is && geo && phi_is) atomicOr(&sc.mask_is[ti], 1u << wi);
        }
        __syncthreads();

        // the scan: warp 0 walks the chunk's t in order, lane ti deciding t
        // = t0 + ti in its step and the warp taking its bits by ballot
        if (tid < 32) {
            const int ti = lane;
            const bool in = ti < nt;
            const int f_if = in ? sc.first_if[ti] : NONE, f_is = in ? sc.first_is[ti] : NONE;
            const unsigned w_if = in ? sc.mask_if[ti] : 0u, w_is = in ? sc.mask_is[ti] : 0u;
            const bool s_if = (vchunk >> ti) & 1u, s_is = (ochunk >> ti) & 1u;
            int cnt_if = sc.cnt_if, cnt_is = sc.cnt_is;
            unsigned a_if = 0u, a_is = 0u;   // retained in this chunk so far (bits < step)
            // only the t that no earlier chunk witnesses can be kept: step
            // through those, while a budget is open
            unsigned pend = __ballot_sync(REPRO_FULL_MASK, (s_if && f_if == NONE)
                                                           || (s_is && f_is == NONE));
            while (pend != 0u && (cnt_if < m_if || cnt_is < m_is)) {
                const int step = __ffs(pend) - 1;
                pend &= pend - 1u;
                bool keep_if = false, keep_is = false;
                if (ti == step) {
                    keep_if = s_if && f_if == NONE && (w_if & a_if) == 0u && cnt_if < m_if;
                    keep_is = s_is && f_is == NONE && (w_is & a_is) == 0u && cnt_is < m_is;
                }
                const unsigned k_if = __ballot_sync(REPRO_FULL_MASK, keep_if);
                const unsigned k_is = __ballot_sync(REPRO_FULL_MASK, keep_is);
                a_if |= k_if;
                a_is |= k_is;
                cnt_if += k_if != 0u;
                cnt_is += k_is != 0u;
            }
            if (in) {
                // w_if holds only bits below ti, so the final a_if gives t's witness
                const int j_if = f_if != NONE ? f_if
                                 : (w_if & a_if) ? t0 + __ffs(w_if & a_if) - 1 : -1;
                const int j_is = f_is != NONE ? f_is
                                 : (w_is & a_is) ? t0 + __ffs(w_is & a_is) - 1 : -1;
                rep_if[row0 + t0 + ti] = (s_if && j_if >= 0) ? j_if : -1;
                rep_is[row0 + t0 + ti] = (s_is && j_is >= 0) ? j_is : -1;
                sc.first_if[ti] = sc.first_is[ti] = NONE;
                sc.mask_if[ti] = sc.mask_is[ti] = 0u;
            }
            const unsigned kept = a_if | a_is;
            const int nret = sc.nret;
            if ((kept >> ti) & 1u) rlist[nret + __popc(kept & ((1u << ti) - 1u))] = t0 + ti;
            __syncwarp();
            if (ti == 0) {
                act_if[cw] = a_if;
                act_is[cw] = a_is;
                sc.cnt_if = cnt_if;
                sc.cnt_is = cnt_is;
                sc.nret = nret + __popc(kept);
            }
        }
        __syncthreads();
    }
    for (int i = tid; i < C; i += THREADS)
        status[row0 + i] = static_cast<int>((act_if[i / 32] >> (i % 32)) & 1u)
                           + 2 * static_cast<int>((act_is[i / 32] >> (i % 32)) & 1u);
}

template <bool STAGED>
int launch(const float* i_u, const float* xs, const float* i_c, const float* d_uc,
           const int* valid, const int* overlap, int* status, int* rep_if, int* rep_is,
           int B, int C, int d, int m_if, int m_is, float alpha2, int unified, size_t smem,
           cudaStream_t stream) {
    if (smem > 48 * 1024) {  // beyond the default: opt in (the wrapper refuses past the card's limit)
        const cudaError_t err = cudaFuncSetAttribute(
            prune_sweep_kernel<STAGED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    prune_sweep_kernel<STAGED><<<B, THREADS, smem, stream>>>(
        i_u, xs, i_c, d_uc, valid, overlap, status, rep_if, rep_is,
        C, d, m_if, m_is, alpha2, unified);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory a block takes: the state, plus the staged row when
// stage != 0.  The wrapper stages where that fits and refuses where even
// the state does not.
extern "C" long long repro_prune_sweep_smem(int C, int d, int stage) {
    return static_cast<long long>(state_bytes(C) + (stage ? staged_bytes(C, d) : 0));
}

extern "C" int repro_prune_sweep(const float* i_u, const float* xs, const float* i_c,
                                 const float* d_uc, const int* valid, const int* overlap,
                                 int* status, int* rep_if, int* rep_is,
                                 int B, int C, int d, int m_if, int m_is,
                                 float alpha2, int unified, int stage, cudaStream_t stream) {
    const size_t smem = static_cast<size_t>(repro_prune_sweep_smem(C, d, stage));
    return stage ? launch<true>(i_u, xs, i_c, d_uc, valid, overlap, status, rep_if, rep_is,
                                B, C, d, m_if, m_is, alpha2, unified, smem, stream)
                 : launch<false>(i_u, xs, i_c, d_uc, valid, overlap, status, rep_if, rep_is,
                                 B, C, d, m_if, m_is, alpha2, unified, smem, stream);
}
