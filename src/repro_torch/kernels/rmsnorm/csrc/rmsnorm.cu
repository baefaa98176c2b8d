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
// kernel is bound by bytes, and its job is to read x once from device
// memory and write the output once.
//
// Design: one block per row (any row count: the TPU kernel's row_block
// divisibility does not apply). Each thread walks the row at a stride of
// the block width, so a warp reads consecutive elements; the sum of squares
// is reduced by warp shuffles and then across warps through shared memory.
// The second pass reads the row again, from L1/L2 (a row is at most a few
// tens of KB), and writes the output. Loads are plain element loads, not
// 16-byte vectors: a later PR's work, with several rows per block for the
// 4-row decode shapes, which fill 4 of 132 SMs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int MAX_THREADS = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
    return __float2bfloat16_rn(x);
}

template <typename TX, typename TW>
__global__ void __launch_bounds__(MAX_THREADS) rmsnorm_rows(const TX* __restrict__ x,
                                                            const TW* __restrict__ w,
                                                            TX* __restrict__ out, int d, float eps) {
    __shared__ float partial[MAX_THREADS / 32];
    const TX* xr = x + (size_t)blockIdx.x * d;
    TX* orow = out + (size_t)blockIdx.x * d;

    float sq = 0.0f;
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
        const float v = to_f32(xr[i]);
        sq = fmaf(v, v, sq);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, off);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    if (lane == 0) partial[warp] = sq;
    __syncthreads();
    float total = 0.0f;
    const int n_warps = blockDim.x >> 5;
    for (int k = 0; k < n_warps; ++k) total += partial[k];  // the same order in every thread

    const float r = 1.0f / sqrtf(total / (float)d + eps);
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
        const float y = to_f32(xr[i]) * r;
        orow[i] = from_f32<TX>(y * (1.0f + to_f32(w[i])));
    }
}

template <typename TX, typename TW>
int launch_typed(const void* x, const void* w, void* out, int rows, int d, float eps,
                 cudaStream_t stream) {
    // a multiple of 32 threads, about 4 elements each, at most MAX_THREADS
    int threads = ((d + 3) / 4 + 31) / 32 * 32;
    threads = threads < 32 ? 32 : (threads > MAX_THREADS ? MAX_THREADS : threads);
    rmsnorm_rows<TX, TW><<<rows, threads, 0, stream>>>(static_cast<const TX*>(x),
                                                         static_cast<const TW*>(w),
                                                         static_cast<TX*>(out), d, eps);
    return (int)cudaGetLastError();
}

}  // namespace

// x_dtype, w_dtype: 0 float32, 1 bfloat16. x and out (rows, d) contiguous,
// w (d,). Returns cudaGetLastError() of the launch (0 on success); never
// synchronises.
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
