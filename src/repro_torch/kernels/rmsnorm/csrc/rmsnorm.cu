// Row RMSNorm for Hopper (sm_90a): out = x * (1 / sqrt(mean(x^2) + eps)) * (1 + w),
// the statistics in f32, the output in x's dtype.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/rmsnorm/kernel.py::_rmsnorm_kernel
// and computes what it computes: x cast to f32, var = sum(x^2) / d, the
// reciprocal square root of var + eps, a scale by (1 + w) with w cast to f32,
// the product rounded once to x's dtype. The reciprocal square root is
// 1.0f / sqrtf(var + eps): IEEE square root and division (no fast math), so
// it is within one f32 ulp of the exact value (rsqrtf is an approximation of
// up to 2 ulp, and the f32 bar is 1e-5).
//
// What bounds it on this card. Per row it reads d elements of x, writes d
// of the output and reads w (shared by all rows): at Mamba2-370m's prefill
// shapes (2048 rows of 1024 or 2048 bf16) 8.4 MB or 16.8 MB, 2.5 us or 5.0 us
// at 3.35 TB/s; the 4 operations an element are nothing beside that. So the
// kernel is bound by bytes: it reads x once, writes the output once, and
// keeps as many loads in flight as it can. Its decode calls (4 rows) are
// bound by the launch.
//
// Design:
//   - d <= 4096 (every width of the port but Mistral's) and at least 256
//     rows (the prefill's): one warp per row, 8 rows a block. The row is
//     loaded into registers once, in 16-byte vectors where d and the
//     pointers allow (else element by element), and stays there between
//     the sum of squares and the scale, so x crosses from memory once. The
//     block stages (1 + w) in f32 in shared memory once, while the rows'
//     loads are in flight.
//   - d > 4096, or fewer rows (decode's 4): one block per row, as many
//     threads (up to 512) as the row has vectors up to 16 a thread, the row
//     again in registers, w read once by the block. A 4-row call so runs
//     on 4 SMs with one vector a thread, the shortest chain of loads.
//   - the sum of squares is a per-thread sum in index order, a warp-shuffle
//     tree, and (wide rows) the warps' partials summed in warp order: the
//     same order on every run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int ROW_WARPS = 8;       // rows per block on the warp-per-row path
constexpr int WIDE_THREADS = 512;  // threads per row on the block-per-row path
constexpr int WARP_MAX_D = 4096;
// fewer rows than this (decode's 4, qk-norm's B*H) take a block each, sized
// to the row, so a short call spreads over as many SMs as it has rows
constexpr int FEW_ROWS = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
    return __float2bfloat16_rn(x);
}

// Elements [c V, c V + V) of a row (V = one 16-byte vector) into f, zeros
// past d: one vector load when VEC (d a multiple of V and the row 16-byte
// aligned), else element loads.
template <typename T, bool VEC>
__device__ __forceinline__ void load_chunk(const T* __restrict__ p, int c, int d, float* f) {
    constexpr int V = 16 / (int)sizeof(T);
    const int e0 = c * V;
    if (VEC) {
        if (e0 < d) {
            const uint4 u = *reinterpret_cast<const uint4*>(p + e0);
            const T* t = reinterpret_cast<const T*>(&u);
#pragma unroll
            for (int i = 0; i < V; ++i) f[i] = to_f32(t[i]);
        } else {
#pragma unroll
            for (int i = 0; i < V; ++i) f[i] = 0.0f;
        }
    } else {
#pragma unroll
        for (int i = 0; i < V; ++i) f[i] = e0 + i < d ? to_f32(p[e0 + i]) : 0.0f;
    }
}

// (1 + w[e]) for the N elements from e0, zeros past d: 16-byte (or, for
// 8-byte runs, 8-byte) vector loads when VEC, else element loads
template <typename T, int N, bool VEC>
__device__ __forceinline__ void load_w1(const T* __restrict__ w, int e0, int d, float* f) {
    constexpr int BYTES = N * (int)sizeof(T);
    static_assert(BYTES % 8 == 0, "a chunk of w is whole 8-byte words");
    if (VEC && e0 < d) {
        constexpr int PER = BYTES % 16 == 0 ? 16 : 8;  // bytes per load
        constexpr int E = PER / (int)sizeof(T);        // elements per load
#pragma unroll
        for (int j = 0; j < N / E; ++j) {
            uint4 u;
            if constexpr (PER == 16) {
                u = reinterpret_cast<const uint4*>(w + e0)[j];
            } else {
                const uint2 h = reinterpret_cast<const uint2*>(w + e0)[j];
                u = make_uint4(h.x, h.y, 0u, 0u);
            }
            const T* t = reinterpret_cast<const T*>(&u);
#pragma unroll
            for (int i = 0; i < E; ++i) f[j * E + i] = 1.0f + to_f32(t[i]);
        }
    } else {
#pragma unroll
        for (int i = 0; i < N; ++i) f[i] = e0 + i < d ? 1.0f + to_f32(w[e0 + i]) : 0.0f;
    }
}

// out[c V + i] = v[i] * r * w1[i] for the chunk's elements below d
template <typename T, bool VEC>
__device__ __forceinline__ void store_chunk(T* __restrict__ p, int c, int d, const float* v, float r,
                                            const float* w1) {
    constexpr int V = 16 / (int)sizeof(T);
    const int e0 = c * V;
    if (VEC) {
        if (e0 < d) {
            uint4 u;
            T* t = reinterpret_cast<T*>(&u);
#pragma unroll
            for (int i = 0; i < V; ++i) t[i] = from_f32<T>(v[i] * r * w1[i]);
            *reinterpret_cast<uint4*>(p + e0) = u;
        }
    } else {
#pragma unroll
        for (int i = 0; i < V; ++i)
            if (e0 + i < d) p[e0 + i] = from_f32<T>(v[i] * r * w1[i]);
    }
}

// One warp per row; lane l holds chunks l + 32 k (k < K) of its row.
// Dynamic shared memory: (1 + w) in f32, d rounded up to a whole chunk.
template <typename TX, typename TW, int K, bool VEC>
__global__ void __launch_bounds__(32 * ROW_WARPS) rms_warp_rows(const TX* __restrict__ x,
                                                                const TW* __restrict__ w,
                                                                TX* __restrict__ out, int rows, int d,
                                                                float eps) {
    constexpr int V = 16 / (int)sizeof(TX);
    extern __shared__ float4 w1_raw[];
    float* w1 = reinterpret_cast<float*>(w1_raw);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int row = blockIdx.x * (blockDim.x >> 5) + warp;
    const bool live = row < rows;
    const TX* xr = x + (size_t)row * d;

    float v[K][V];
    float sq = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
        if (live) load_chunk<TX, VEC>(xr, lane + 32 * k, d, v[k]);
        else
#pragma unroll
            for (int i = 0; i < V; ++i) v[k][i] = 0.0f;
    }
    // (1 + w) into shared memory, V entries a thread at a time, while the
    // row's loads are in flight
    for (int c = threadIdx.x; c * V < d; c += blockDim.x) {
        float f[V];
        load_w1<TW, V, VEC>(w, c * V, d, f);
#pragma unroll
        for (int i = 0; i < V; i += 4)
            reinterpret_cast<float4*>(w1 + c * V)[i / 4] = make_float4(f[i], f[i + 1], f[i + 2], f[i + 3]);
    }
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
        for (int i = 0; i < V; ++i) sq = fmaf(v[k][i], v[k][i], sq);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, off);
    __syncthreads();
    if (!live) return;

    const float r = 1.0f / sqrtf(sq / (float)d + eps);
    TX* orow = out + (size_t)row * d;
#pragma unroll
    for (int k = 0; k < K; ++k) {
        const int c = lane + 32 * k;
        if (c * V >= d) break;
        float wv[V];
#pragma unroll
        for (int i = 0; i < V; i += 4) {
            const float4 t = reinterpret_cast<const float4*>(w1 + c * V)[i / 4];
            wv[i] = t.x;
            wv[i + 1] = t.y;
            wv[i + 2] = t.z;
            wv[i + 3] = t.w;
        }
        store_chunk<TX, VEC>(orow, c, d, v[k], r, wv);
    }
}

// One block per row; thread t holds chunks t + blockDim k (k < K), the
// block a multiple of 32 threads, at most WIDE_THREADS.
template <typename TX, typename TW, int K, bool VEC>
__global__ void __launch_bounds__(WIDE_THREADS) rms_block_row(const TX* __restrict__ x,
                                                              const TW* __restrict__ w,
                                                              TX* __restrict__ out, int d, float eps) {
    constexpr int V = 16 / (int)sizeof(TX);
    __shared__ float partial[WIDE_THREADS / 32];
    const int nt = blockDim.x;
    const TX* xr = x + (size_t)blockIdx.x * d;

    float v[K][V];
    float sq = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) load_chunk<TX, VEC>(xr, threadIdx.x + nt * k, d, v[k]);
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
        for (int i = 0; i < V; ++i) sq = fmaf(v[k][i], v[k][i], sq);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, off);
    if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = sq;
    __syncthreads();
    float total = 0.0f;
    for (int i = 0; i < (nt >> 5); ++i) total += partial[i];  // warp order, in every thread

    const float r = 1.0f / sqrtf(total / (float)d + eps);
    TX* orow = out + (size_t)blockIdx.x * d;
#pragma unroll
    for (int k = 0; k < K; ++k) {
        const int c = threadIdx.x + nt * k;
        if (c * V >= d) break;
        float wv[V];
        load_w1<TW, V, VEC>(w, c * V, d, wv);
        store_chunk<TX, VEC>(orow, c, d, v[k], r, wv);
    }
}

template <typename TX, typename TW, int K, bool VEC>
int launch_warp(const void* x, const void* w, void* out, int rows, int d, float eps, cudaStream_t stream) {
    constexpr int V = 16 / (int)sizeof(TX);
    const int per_block = rows < ROW_WARPS ? rows : ROW_WARPS;
    const int blocks = (rows + per_block - 1) / per_block;
    const size_t smem = (size_t)((d + V - 1) / V * V) * sizeof(float);
    rms_warp_rows<TX, TW, K, VEC><<<blocks, 32 * per_block, smem, stream>>>(
        static_cast<const TX*>(x), static_cast<const TW*>(w), static_cast<TX*>(out), rows, d, eps);
    return (int)cudaGetLastError();
}

template <typename TX, typename TW, int K, bool VEC>
int launch_wide(const void* x, const void* w, void* out, int rows, int d, float eps, cudaStream_t stream) {
    constexpr int V = 16 / (int)sizeof(TX);
    const int per_thread = K * V;  // elements a thread holds
    const int threads = ((d + per_thread - 1) / per_thread + 31) / 32 * 32;
    rms_block_row<TX, TW, K, VEC><<<rows, threads, 0, stream>>>(
        static_cast<const TX*>(x), static_cast<const TW*>(w), static_cast<TX*>(out), d, eps);
    return (int)cudaGetLastError();
}

// the smallest power of two k with k * per >= chunks
inline int pow2_chunks(int chunks, int per) {
    int k = 1;
    while (k * per < chunks) k *= 2;
    return k;
}

template <typename TX, typename TW, bool VEC>
int launch_vec(const void* x, const void* w, void* out, int rows, int d, float eps, cudaStream_t s) {
    constexpr int V = 16 / (int)sizeof(TX);
    const int chunks = (d + V - 1) / V;
    if (d <= WARP_MAX_D && rows >= FEW_ROWS) {
        switch (pow2_chunks(chunks, 32)) {
            case 1: return launch_warp<TX, TW, 1, VEC>(x, w, out, rows, d, eps, s);
            case 2: return launch_warp<TX, TW, 2, VEC>(x, w, out, rows, d, eps, s);
            case 4: return launch_warp<TX, TW, 4, VEC>(x, w, out, rows, d, eps, s);
            case 8: return launch_warp<TX, TW, 8, VEC>(x, w, out, rows, d, eps, s);
            case 16: return launch_warp<TX, TW, 16, VEC>(x, w, out, rows, d, eps, s);
            case 32: return launch_warp<TX, TW, 32, VEC>(x, w, out, rows, d, eps, s);
            default: return (int)cudaErrorInvalidValue;
        }
    }
    switch (pow2_chunks(chunks, WIDE_THREADS)) {
        case 1: return launch_wide<TX, TW, 1, VEC>(x, w, out, rows, d, eps, s);
        case 2: return launch_wide<TX, TW, 2, VEC>(x, w, out, rows, d, eps, s);
        case 4: return launch_wide<TX, TW, 4, VEC>(x, w, out, rows, d, eps, s);
        case 8: return launch_wide<TX, TW, 8, VEC>(x, w, out, rows, d, eps, s);
        case 16: return launch_wide<TX, TW, 16, VEC>(x, w, out, rows, d, eps, s);
        default: return (int)cudaErrorInvalidValue;  // d past the registers of a block
    }
}

template <typename TX, typename TW>
int launch_typed(const void* x, const void* w, void* out, int rows, int d, float eps, cudaStream_t s) {
    const bool vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(w) % 16 == 0 && ((size_t)d * sizeof(TX)) % 16 == 0 &&
                     ((size_t)d * sizeof(TW)) % 16 == 0;
    return vec ? launch_vec<TX, TW, true>(x, w, out, rows, d, eps, s)
               : launch_vec<TX, TW, false>(x, w, out, rows, d, eps, s);
}

}  // namespace

// x_dtype, w_dtype: 0 float32, 1 bfloat16. x and out (rows, d) contiguous,
// w (d,). Returns cudaGetLastError() of the launch (0 on success), or
// cudaErrorInvalidValue for d past 16 vectors a thread of a 512-thread
// block; never synchronises.
extern "C" int rmsnorm_launch(const void* x, const void* w, void* out, int x_dtype, int w_dtype,
                              int rows, int d, float eps, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (x_dtype == 0 && w_dtype == 0) return launch_typed<float, float>(x, w, out, rows, d, eps, st);
    if (x_dtype == 0 && w_dtype == 1)
        return launch_typed<float, __nv_bfloat16>(x, w, out, rows, d, eps, st);
    if (x_dtype == 1 && w_dtype == 0)
        return launch_typed<__nv_bfloat16, float>(x, w, out, rows, d, eps, st);
    if (x_dtype == 1 && w_dtype == 1)
        return launch_typed<__nv_bfloat16, __nv_bfloat16>(x, w, out, rows, d, eps, st);
    return (int)cudaErrorInvalidValue;
}

extern "C" const char* rmsnorm_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
