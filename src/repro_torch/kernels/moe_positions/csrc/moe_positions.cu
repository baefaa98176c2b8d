// Position in expert for the MoE dispatch, for Hopper (sm_90a): for each flat
// (token, k) assignment i with expert id flat_e[i], the number of earlier
// assignments j < i with the same expert. These are the integers of the
// reference's token-major one-hot construction
//   onehot = flat_e[:, None] == arange(E);  pos = ((cumsum(onehot, 0) - 1) * onehot).sum(-1)
// (src/repro/models/moe.py:63-67, moe_apply, a jnp.cumsum outside any Pallas
// kernel), and of the port's plain version (kernels/moe_positions/ref.py),
// id for id; an id outside [0, E) has an all-zero one-hot row there, so it
// gets 0 here and counts for no expert. It replaces no TPU kernel: on the
// card PyTorch's cumsum of the (N, E) one-hot scans its outer axis with one
// thread a column, N dependent steps each, and took 57 % of the MoE prefill's
// device time.
//
// What bounds it on this card. It needs the N int64 ids read once and the N
// int64 positions written once: 16 N bytes, 0.16 us at N = 32,768 over
// 3.35 TB/s, so each call is bound by its two launches (about 2-3 us each)
// and by the dependent steps inside a block, never by bytes.
//
// Design: tiles of TILE = 1,024 assignments, one block of 32 warps a tile,
// one id a thread, two launches whatever N (a decode call of N = B k <= TILE
// takes both too: its add_earlier adds nothing).
//   - rank_tile: each warp ranks its 32 ids among its lanes of the same
//     expert (__match_any_sync, then the peers on lower lanes), and the
//     lowest lane of each group writes the group's size into shared
//     cnt[warp][expert] (int32, 32 E of them: 16 KB at E = 128, 128 KB at
//     the limit E = 1,024). One thread an expert turns its column into an
//     exclusive scan over the warps, so cnt[warp][id] + the rank in the warp
//     is the id's rank in the tile, and its total is the tile's count of
//     that expert. The launch writes the rank (int32 scratch) and the tile's
//     E counts.
//   - add_earlier: each block sums, an expert at a time, the counts of the
//     tiles before its own (TILE / E thread groups a column, then the groups'
//     partial sums in group order) and adds them to its ranks. At N = 32,768
//     that is 32 tiles of 128 counts, read from L2.
// Limit: every block reads all the counts before its own, so add_earlier
// reads tiles^2 E / 2 int32 in all: 256 KB at N = 32,768 and E = 128 (the
// MoE prefill and train step), but 2 GB at N = 2^20 and E = 1,024, where it
// and not the bytes bound the call (chip_smoke.py's moe_positions phase
// times that size). An input that large wants a scan of the tile counts in
// a pass of its own.
// Integer sums only and no global atomics, so the result is the same on
// every run whatever the blocks' order. No host synchronisation; the
// wrapper allocates the output and the scratch.
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int TILE = 1024;           // assignments a block ranks, one a thread
constexpr int WARPS = TILE / 32;
constexpr int MAX_EXPERTS = 1024;    // cnt[WARPS][E] int32: 128 KB of shared memory
constexpr size_t STATIC_SMEM = 48 * 1024;  // dynamic shared memory a block gets without opting in

// flat_e[i] as an expert in [0, e), or -1 past the input or outside the range
__device__ __forceinline__ int load_id(const long long* __restrict__ flat_e, long long i, long long n, int e) {
    if (i >= n) return -1;
    const long long v = flat_e[i];
    return v >= 0 && v < e ? (int)v : -1;
}

__global__ void __launch_bounds__(TILE) rank_tile(const long long* __restrict__ flat_e, long long n, int e,
                                                  int* __restrict__ rank, int* __restrict__ tile_counts) {
    extern __shared__ int cnt[];  // [WARPS][e]
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const long long i = (long long)blockIdx.x * TILE + tid;
    const int id = load_id(flat_e, i, n, e);
    for (int j = tid; j < WARPS * e; j += TILE) cnt[j] = 0;
    const unsigned peers = __match_any_sync(0xffffffffu, id);
    const int in_warp = __popc(peers & ((1u << lane) - 1u));
    __syncthreads();
    if (id >= 0 && in_warp == 0) cnt[warp * e + id] = __popc(peers);
    __syncthreads();
    for (int x = tid; x < e; x += TILE) {
        int run = 0;
#pragma unroll 8
        for (int w = 0; w < WARPS; ++w) {
            const int c = cnt[w * e + x];
            cnt[w * e + x] = run;
            run += c;
        }
        tile_counts[(size_t)blockIdx.x * e + x] = run;
    }
    __syncthreads();
    if (i < n) rank[i] = id >= 0 ? cnt[warp * e + id] + in_warp : 0;
}

__global__ void __launch_bounds__(TILE) add_earlier(const long long* __restrict__ flat_e, long long n, int e,
                                                    const int* __restrict__ rank,
                                                    const int* __restrict__ tile_counts,
                                                    long long* __restrict__ out) {
    __shared__ int part[TILE];
    __shared__ int before[MAX_EXPERTS];
    const int tid = threadIdx.x, tile = blockIdx.x;
    const int groups = TILE / e;  // e <= MAX_EXPERTS == TILE, so at least one
    if (tid < groups * e) {
        const int g = tid / e, x = tid - g * e;
        int s = 0;
#pragma unroll 4
        for (int t = g; t < tile; t += groups) s += tile_counts[(size_t)t * e + x];
        part[tid] = s;
    }
    __syncthreads();
    for (int x = tid; x < e; x += TILE) {
        int s = 0;
        for (int g = 0; g < groups; ++g) s += part[g * e + x];
        before[x] = s;
    }
    __syncthreads();
    const long long i = (long long)tile * TILE + tid;
    if (i < n) {
        const int id = load_id(flat_e, i, n, e);
        out[i] = id >= 0 ? (long long)(rank[i] + before[id]) : 0LL;
    }
}

int opt_in(size_t smem) {
    if (smem <= STATIC_SMEM) return 0;
    return (int)cudaFuncSetAttribute(rank_tile, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace

extern "C" {

// flat_e: n int64 ids; out: n int64 positions; scratch: n + tiles * e
// int32 (the ranks, then each tile's counts). Returns cudaGetLastError() of
// the launches (0 on success), or cudaErrorInvalidValue for e outside
// [1, MAX_EXPERTS] or n past 2^31 - 1; never synchronises.
int moe_positions_launch(const void* flat_e, long long n, int e, void* scratch, void* out, void* stream) {
    if (e < 1 || e > MAX_EXPERTS || n < 0 || n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const long long tiles = (n + TILE - 1) / TILE;
    const size_t smem = (size_t)WARPS * e * sizeof(int);
    const long long* ids = static_cast<const long long*>(flat_e);
    int* rank = static_cast<int*>(scratch);
    int* counts = rank + n;
    int err;
    if ((err = opt_in(smem))) return err;
    rank_tile<<<(unsigned)tiles, TILE, smem, st>>>(ids, n, e, rank, counts);
    if ((err = (int)cudaGetLastError())) return err;
    add_earlier<<<(unsigned)tiles, TILE, 0, st>>>(ids, n, e, rank, counts, static_cast<long long*>(out));
    return (int)cudaGetLastError();
}

const char* moe_positions_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
