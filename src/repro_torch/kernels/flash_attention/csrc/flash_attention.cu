// Flash-attention forward for Hopper (sm_90a): causal or full GQA attention
// with an online softmax over KV tiles, all arithmetic in f32.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py::_flash_kernel
// and computes what it computes: q, k, v cast to f32, S = q kT * scale,
// causal mask on absolute row/col indices with NEG_INF = -1e30, running
// (m, l, acc) over KV tiles, finalised with l = max(l, 1e-30), output in q's
// dtype. Query head h reads KV head h * KH / H.
//
// What bounds it on this card. At the Qwen3-1.7B prefill shape (B=4, S=512,
// H=16, KH=8, Dh=128, bf16) the function must move Q + O (16.8 MB) and K + V
// (8.4 MB): about 25 MB, 7.5 us at 3.35 TB/s. It does 4*B*H*Dh*S(S+1)/2 =
// 4.3 GFLOP of causal products: 4.4 us at the 989 TFLOP/s bf16 dense peak.
// So the function is bound by bytes, and a tensor-core kernel reaches that
// bound. This first design does not aim at it:
//   - it does both products with f32 FMAs on the CUDA cores (no tensor
//     cores: 67 TFLOP/s is its ceiling, about 64 us at this shape), so one
//     code path serves bf16 and f32 inputs at the reference's own bars;
//   - it keeps every tile in shared memory in the input dtype and converts
//     on read; loads are plain 16-byte vector loads (no TMA, no cp.async
//     pipeline), so a tile's load does not overlap the previous tile's math;
//   - grouped query heads each read their KV tiles (from L2 after the
//     first), so K and V cross from HBM about once and from L2 H/KH times.
// What it does do: no masked tile is loaded (the KV loop stops at the
// diagonal), the S x S scores never reach device memory, and the output is
// written once. Tensor cores (wgmma on bf16, P rounded to bf16), TMA and
// warp specialisation are the redesign's work.
//
// Layout: q, o (B, H, Sq, Dh); k, v (B, KH, Skv, Dh); contiguous, 16-byte
// aligned (the wrapper checks); Dh one of 16, 32, 64, 128, 256 (one template
// instance each); f32 or bf16. One block of 256 threads per (q tile, head,
// batch row); thread (ty, tx) = (tid / 16, tid % 16) owns query rows
// ty + 16 i (i < 4), score columns tx + 16 j (j < 4) of each KV tile, and
// output columns tx + 16 d (d < Dh / 16). The 16 threads of a row are one
// half-warp, so row max and row sum are shuffles.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int BQ = 64;         // query rows per block
constexpr int BK = 64;         // key rows per KV tile
constexpr int NT = 256;        // threads per block
constexpr int RPT = BQ / 16;   // query rows per thread
constexpr int CPT = BK / 16;   // score columns per thread
constexpr int PS_LD = BK + 16; // row stride of the P tile: rows ty, ty+1 land 16 banks apart
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
    return __float2bfloat16_rn(x);
}

// Row stride (elements) of the Q and K tiles: Dh plus 4 bytes, so the 16
// key rows a half-warp reads at one d fall in 16 different banks.
template <typename T, int DH> struct Tile {
    static constexpr int LD = DH + 4 / (int)sizeof(T);
    static constexpr size_t smem_bytes() {
        return (size_t)(BQ * LD + BK * LD + BK * DH) * sizeof(T) + (size_t)BQ * PS_LD * sizeof(float);
    }
};

// rows [row0, row0 + ROWS) of a (rows, DH) matrix into shared memory with
// row stride LDS; rows at or past n_rows are zero
template <typename T, int DH, int ROWS, int LDS>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src, int row0, int n_rows) {
    constexpr int VEC = 16 / (int)sizeof(T);
    constexpr int CHUNKS = ROWS * DH / VEC;
    for (int ch = threadIdx.x; ch < CHUNKS; ch += NT) {
        const int e = ch * VEC;
        const int r = e / DH, c = e % DH;
        uint4 u = make_uint4(0u, 0u, 0u, 0u);
        if (row0 + r < n_rows) u = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * DH + c);
        const T* t = reinterpret_cast<const T*>(&u);
#pragma unroll
        for (int i = 0; i < VEC; ++i) dst[r * LDS + c + i] = t[i];
    }
}

template <typename T, int DH>
__global__ void __launch_bounds__(NT) flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
                                                const T* __restrict__ v, T* __restrict__ o, int h,
                                                int kh, int sq, int skv, int causal, float scale) {
    constexpr int LD = Tile<T, DH>::LD;
    constexpr int DPT = DH / 16;  // output columns per thread
    extern __shared__ __align__(16) unsigned char smem[];
    T* qs = reinterpret_cast<T*>(smem);
    T* ks = qs + BQ * LD;
    T* vs = ks + BK * LD;
    float* ps = reinterpret_cast<float*>(vs + BK * DH);

    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
    const int q0 = blockIdx.x * BQ;
    const int head = blockIdx.y, b = blockIdx.z;
    const int kv_head = head * kh / h;
    const T* qp = q + (size_t)(b * h + head) * sq * DH;
    const T* kp = k + (size_t)(b * kh + kv_head) * skv * DH;
    const T* vp = v + (size_t)(b * kh + kv_head) * skv * DH;
    T* op = o + (size_t)(b * h + head) * sq * DH;

    load_tile<T, DH, BQ, LD>(qs, qp, q0, sq);

    float m[RPT], l[RPT], acc[RPT][DPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
        m[i] = NEG_INF;
        l[i] = 0.0f;
#pragma unroll
        for (int d = 0; d < DPT; ++d) acc[i][d] = 0.0f;
    }

    // causal skip: KV tiles past the block's last real row are fully masked
    int n_kv = (skv + BK - 1) / BK;
    if (causal) {
        const int last_row = min(q0 + BQ, sq) - 1;
        n_kv = min(n_kv, last_row / BK + 1);
    }

    for (int j = 0; j < n_kv; ++j) {
        const int k0 = j * BK;
        __syncthreads();  // the previous tile's K, V and P are consumed
        load_tile<T, DH, BK, LD>(ks, kp, k0, skv);
        load_tile<T, DH, BK, DH>(vs, vp, k0, skv);
        __syncthreads();

        float s[RPT][CPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
            for (int c = 0; c < CPT; ++c) s[i][c] = 0.0f;
#pragma unroll 8
        for (int d = 0; d < DH; ++d) {
            float a[RPT], bk[CPT];
#pragma unroll
            for (int i = 0; i < RPT; ++i) a[i] = to_f32(qs[(ty + 16 * i) * LD + d]);
#pragma unroll
            for (int c = 0; c < CPT; ++c) bk[c] = to_f32(ks[(tx + 16 * c) * LD + d]);
#pragma unroll
            for (int i = 0; i < RPT; ++i)
#pragma unroll
                for (int c = 0; c < CPT; ++c) s[i][c] = fmaf(a[i], bk[c], s[i][c]);
        }

#pragma unroll
        for (int i = 0; i < RPT; ++i) {
            const int row = q0 + ty + 16 * i;
            float mx = NEG_INF;
#pragma unroll
            for (int c = 0; c < CPT; ++c) {
                const int col = k0 + tx + 16 * c;
                float x = s[i][c] * scale;
                if (col >= skv || (causal && row < col)) x = NEG_INF;
                s[i][c] = x;
                mx = fmaxf(mx, x);
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            const float m_new = fmaxf(m[i], mx);
            float sum = 0.0f;
#pragma unroll
            for (int c = 0; c < CPT; ++c) {
                const float p = expf(s[i][c] - m_new);
                ps[(ty + 16 * i) * PS_LD + tx + 16 * c] = p;
                sum += p;
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
            const float alpha = expf(m[i] - m_new);
            l[i] = l[i] * alpha + sum;
#pragma unroll
            for (int d = 0; d < DPT; ++d) acc[i][d] *= alpha;
            m[i] = m_new;
        }
        __syncthreads();

#pragma unroll 4
        for (int c = 0; c < BK; ++c) {
            float p[RPT];
#pragma unroll
            for (int i = 0; i < RPT; ++i) p[i] = ps[(ty + 16 * i) * PS_LD + c];
#pragma unroll
            for (int d = 0; d < DPT; ++d) {
                const float vv = to_f32(vs[c * DH + tx + 16 * d]);
#pragma unroll
                for (int i = 0; i < RPT; ++i) acc[i][d] = fmaf(p[i], vv, acc[i][d]);
            }
        }
    }

#pragma unroll
    for (int i = 0; i < RPT; ++i) {
        const int row = q0 + ty + 16 * i;
        if (row >= sq) continue;
        const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
        for (int d = 0; d < DPT; ++d) op[(size_t)row * DH + tx + 16 * d] = from_f32<T>(acc[i][d] / den);
    }
}

template <typename T, int DH>
int launch_typed(const void* q, const void* k, const void* v, void* o, int b, int h, int kh, int sq,
                 int skv, int causal, float scale, cudaStream_t stream) {
    const size_t smem = Tile<T, DH>::smem_bytes();
    cudaError_t err = cudaFuncSetAttribute(flash_fwd<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((sq + BQ - 1) / BQ, h, b);
    flash_fwd<T, DH><<<grid, NT, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                                  static_cast<const T*>(v), static_cast<T*>(o), h, kh,
                                                  sq, skv, causal, scale);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_dh(const void* q, const void* k, const void* v, void* o, int b, int h, int kh, int sq,
              int skv, int dh, int causal, float scale, cudaStream_t stream) {
    switch (dh) {
        case 16: return launch_typed<T, 16>(q, k, v, o, b, h, kh, sq, skv, causal, scale, stream);
        case 32: return launch_typed<T, 32>(q, k, v, o, b, h, kh, sq, skv, causal, scale, stream);
        case 64: return launch_typed<T, 64>(q, k, v, o, b, h, kh, sq, skv, causal, scale, stream);
        case 128: return launch_typed<T, 128>(q, k, v, o, b, h, kh, sq, skv, causal, scale, stream);
        case 256: return launch_typed<T, 256>(q, k, v, o, b, h, kh, sq, skv, causal, scale, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. Returns cudaGetLastError() of the
// launch (0 on success); never synchronises.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o, int dtype,
                                      int b, int h, int kh, int sq, int skv, int dh, int causal,
                                      float scale, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case 0: return launch_dh<float>(q, k, v, o, b, h, kh, sq, skv, dh, causal, scale, st);
        case 1: return launch_dh<__nv_bfloat16>(q, k, v, o, b, h, kh, sq, skv, dh, causal, scale, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

extern "C" const char* flash_attention_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
