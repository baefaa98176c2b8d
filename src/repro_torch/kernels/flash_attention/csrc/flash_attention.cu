// Flash-attention forward for Hopper (sm_90a): causal or full GQA attention
// with an online softmax over KV tiles. Two routes in one source, picked by
// the wrapper (kernel.py ``route``) from the dtype and the head dim alone:
//
//   tensor cores   bf16 at Dh 64, 128, 256 (every full-size config):
//                  wgmma products, TMA loads, a warp-specialised pipeline
//                  (flash_attention_tc_launch);
//   CUDA cores     f32 at every Dh, bf16 at Dh 16 and 32 (reduced test
//                  configs): f32 FMAs (flash_attention_launch).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py::_flash_kernel
// and computes what it computes: S = q kT * scale, causal mask on absolute
// row/col indices with NEG_INF = -1e30, running (m, l, acc) over KV tiles,
// finalised with l = max(l, 1e-30), output in q's dtype. Query head h reads
// KV head h * KH / H. The tensor-core route rounds P to bf16 before P.V (as
// the reference's own attention_full does with probs.astype(v.dtype)); the
// bf16 x bf16 products are exact in f32, so that is its one new rounding.
//
// Layout, both routes: q (B, Sq, H, Dh) and k, v (B, Skv, KH, Dh) read in
// place through element strides (batch, row, head), the head dim
// contiguous, every other stride a multiple of 16 bytes and every base
// 16-byte aligned (the wrapper checks); the output is written through its
// own strides. So the model's (B, S, H, Dh) activations, or slices of one
// fused projection, need no transposed copies.
//
// What bounds it on this card. At the Qwen3-1.7B prefill shape (B=4, S=512,
// H=16, KH=8, Dh=128, bf16) the function must move Q + O (16.8 MB) and K + V
// (8.4 MB): about 25 MB, 7.5 us at 3.35 TB/s, against 4.3 GFLOP of causal
// products, 4.4 us at the 989 TFLOP/s bf16 dense peak: bound by bytes. At
// S=2048 the products (69 GFLOP, 70 us) bound it. The tensor-core route is
// built for both:
//   - one block covers 64 query rows of the two query heads that share a
//     KV head (or, when the group is odd, 128 rows of one head), one
//     consumer warpgroup each: each K/V tile crosses from L2 to shared
//     memory once for both. A group of 2g heads takes g blocks;
//   - K and V tiles arrive by TMA (cp.async.bulk.tensor, 128-byte swizzle)
//     into a ring of two stages with full and empty mbarriers, issued by one
//     thread of a producer warpgroup that gives its registers to the
//     consumers (setmaxnreg 24 / 240); Q is loaded once per block;
//   - S = Q.KT is wgmma m64n64k16 with both operands in shared memory (K
//     K-major as stored); the softmax runs in registers on the accumulator
//     fragment, with log2(e) * scale folded into the scores and IEEE exp2f;
//     P becomes bf16 in registers and is wgmma's A operand for O += P.V,
//     with V's (kv, Dh) tile as stored read as B through the transpose bit;
//   - the KV loop stops at the causal diagonal, only the diagonal and
//     ragged tiles compute the mask, TMA zero-fills rows past the sequence
//     (columns >= Skv are masked, rows >= Sq not stored), and the blocks of
//     the latest (longest) query tiles are launched first.
// The CUDA-core route is the first design of this kernel, kept for f32,
// whose 2e-5 bar no bf16 or TF32 tensor-core product meets: one block of 256
// threads per (64 query rows, head, batch row), tiles loaded by 16-byte
// vector loads into shared memory and converted on read, both products as
// f32 FMAs (67 TFLOP/s ceiling).
#include <cuda.h>  // CUtensorMap and its enums; the encoder is reached through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr float NEG_INF = -1e30f;

// element strides (batch, row, head) of q, k, v and the output
struct Strides {
    long long q[3], k[3], v[3], o[3];
};

// error codes beyond cudaError_t's range
constexpr int ERR_NO_ENCODER = 1001;  // cuTensorMapEncodeTiled not found
constexpr int ERR_TENSOR_MAP = 1002;  // cuTensorMapEncodeTiled refused a map
constexpr int ERR_REGISTERS = 1003;   // too few registers for the setmaxnreg split

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
    return __float2bfloat16_rn(x);
}

// ============================================================================
// CUDA-core route
// ============================================================================
namespace cc {

constexpr int BQ = 64;         // query rows per block
constexpr int BK = 64;         // key rows per KV tile
constexpr int NT = 256;        // threads per block
constexpr int RPT = BQ / 16;   // query rows per thread
constexpr int CPT = BK / 16;   // score columns per thread
constexpr int PS_LD = BK + 16; // row stride of the P tile: rows ty, ty+1 land 16 banks apart

// Row stride (elements) of the Q and K tiles: Dh plus 4 bytes, so the 16
// key rows a half-warp reads at one d fall in 16 different banks.
template <typename T, int DH> struct Tile {
    static constexpr int LD = DH + 4 / (int)sizeof(T);
    static constexpr size_t smem_bytes() {
        return (size_t)(BQ * LD + BK * LD + BK * DH) * sizeof(T) + (size_t)BQ * PS_LD * sizeof(float);
    }
};

// rows [row0, row0 + ROWS) of a matrix with row stride ld (elements) into
// shared memory with row stride LDS; rows at or past n_rows are zero
template <typename T, int DH, int ROWS, int LDS>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src, long long ld, int row0,
                                          int n_rows) {
    constexpr int VEC = 16 / (int)sizeof(T);
    constexpr int CHUNKS = ROWS * DH / VEC;
    for (int ch = threadIdx.x; ch < CHUNKS; ch += NT) {
        const int e = ch * VEC;
        const int r = e / DH, c = e % DH;
        uint4 u = make_uint4(0u, 0u, 0u, 0u);
        if (row0 + r < n_rows) u = *reinterpret_cast<const uint4*>(src + (row0 + r) * ld + c);
        const T* t = reinterpret_cast<const T*>(&u);
#pragma unroll
        for (int i = 0; i < VEC; ++i) dst[r * LDS + c + i] = t[i];
    }
}

// One block of 256 threads per (q tile, head, batch row); thread (ty, tx) =
// (tid / 16, tid % 16) owns query rows ty + 16 i (i < 4), score columns
// tx + 16 j (j < 4) of each KV tile, and output columns tx + 16 d
// (d < Dh / 16). The 16 threads of a row are one half-warp, so row max and
// row sum are shuffles.
template <typename T, int DH>
__global__ void __launch_bounds__(NT) flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
                                                const T* __restrict__ v, T* __restrict__ o, Strides st,
                                                int h, int kh, int sq, int skv, int causal, float scale) {
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
    const T* qp = q + b * st.q[0] + head * st.q[2];
    const T* kp = k + b * st.k[0] + kv_head * st.k[2];
    const T* vp = v + b * st.v[0] + kv_head * st.v[2];
    T* op = o + b * st.o[0] + head * st.o[2];

    load_tile<T, DH, BQ, LD>(qs, qp, st.q[1], q0, sq);

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
        load_tile<T, DH, BK, LD>(ks, kp, st.k[1], k0, skv);
        load_tile<T, DH, BK, DH>(vs, vp, st.v[1], k0, skv);
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
        for (int d = 0; d < DPT; ++d) op[row * st.o[1] + tx + 16 * d] = from_f32<T>(acc[i][d] / den);
    }
}

template <typename T, int DH>
int launch_typed(const void* q, const void* k, const void* v, void* o, const Strides& st, int b, int h,
                 int kh, int sq, int skv, int causal, float scale, cudaStream_t stream) {
    const size_t smem = Tile<T, DH>::smem_bytes();
    cudaError_t err = cudaFuncSetAttribute(flash_fwd<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((sq + BQ - 1) / BQ, h, b);
    flash_fwd<T, DH><<<grid, NT, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                                  static_cast<const T*>(v), static_cast<T*>(o), st, h,
                                                  kh, sq, skv, causal, scale);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_dh(const void* q, const void* k, const void* v, void* o, const Strides& st, int b, int h,
              int kh, int sq, int skv, int dh, int causal, float scale, cudaStream_t stream) {
    switch (dh) {
        case 16: return launch_typed<T, 16>(q, k, v, o, st, b, h, kh, sq, skv, causal, scale, stream);
        case 32: return launch_typed<T, 32>(q, k, v, o, st, b, h, kh, sq, skv, causal, scale, stream);
        case 64: return launch_typed<T, 64>(q, k, v, o, st, b, h, kh, sq, skv, causal, scale, stream);
        case 128: return launch_typed<T, 128>(q, k, v, o, st, b, h, kh, sq, skv, causal, scale, stream);
        case 256: return launch_typed<T, 256>(q, k, v, o, st, b, h, kh, sq, skv, causal, scale, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace cc

// ============================================================================
// Tensor-core route: PTX wrappers
// ============================================================================
namespace tc {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// one arrival that also announces the bytes a TMA copy will deliver
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
                 : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// wait for the completion of the barrier's phase of this parity
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    uint32_t done = 0;
    do {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done)
            : "r"(bar), "r"(parity)
            : "memory");
    } while (!done);
}

// one box of a 4-D tensor map into shared memory, completing on bar
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                            int c1, int c2, int c3) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
        : "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma that owns them
template <int N> __device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma shared-memory descriptor for a 128-byte-swizzled tile: start address,
// leading and stride byte offsets (16-byte units), layout type 1 (128B)
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
    uint64_t d = (uint64_t)((addr & 0x3FFFFu) >> 4);
    d |= (uint64_t)((lbo >> 4) & 0x3FFFu) << 16;
    d |= (uint64_t)((sbo >> 4) & 0x3FFFu) << 32;
    d |= 1ull << 62;
    return d;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
    return *reinterpret_cast<uint32_t*>(&t);
}

// D(64x64, f32) += A(64x16, smem, K-major) * B(16x64, smem, K-major)
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da, uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(accumulate)
        : "memory");
}

// D(64x64, f32) += A(64x16, registers) * B(16x64, smem, MN-major: transposed)
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a, uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate)
        : "memory");
}

// D(64x128, f32) += A(64x16, registers) * B(16x128, smem, MN-major: transposed)
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a, uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate)
        : "memory");
}

// D(64x256, f32) += A(64x16, registers) * B(16x256, smem, MN-major: transposed)
__device__ __forceinline__ void wgmma_rs_n256(float* d, const uint32_t* a, uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate)
        : "memory");
}


template <int N> __device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t db) {
    if constexpr (N == 64) wgmma_rs_n64(d, a, db, 1);
    else if constexpr (N == 128) wgmma_rs_n128(d, a, db, 1);
    else wgmma_rs_n256(d, a, db, 1);
}

// ============================================================================
// Tensor-core route: the kernel
// ============================================================================
constexpr int BM = 64;                 // query rows per consumer warpgroup (wgmma's M)
constexpr int BK = 64;                 // key rows per KV tile (S's N)
constexpr int CH = 64;                 // Dh elements per 128-byte swizzled box row
constexpr int SLOTS = 2;               // consumer warpgroups per block
constexpr int STAGES = 2;              // K/V ring depth
constexpr int NT = 128 * (SLOTS + 1);  // consumers, then the producer warpgroup
constexpr int BOX = 64 * 128;          // one (64 rows x 64 bf16) box: 8 KB
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;

// Shared memory, every box 1024-byte aligned (the swizzle's period):
// Q[SLOTS][Dh/64][64][64], K[STAGES][Dh/64][64][64], V likewise, then the
// barriers q_full, k_full[STAGES], v_full[STAGES], empty[STAGES].
template <int DH> struct Smem {
    static constexpr int NCH = DH / CH;
    static constexpr int TILE = NCH * BOX;  // one 64 x Dh tile
    static constexpr int K_OFF = SLOTS * TILE;
    static constexpr int V_OFF = K_OFF + STAGES * TILE;
    static constexpr int BAR_OFF = V_OFF + STAGES * TILE;
    static constexpr int ALLOC = BAR_OFF + 8 * (1 + 3 * STAGES) + 1024;  // + slack to align the base
};

// Slot s of a block (consumer warpgroup s) owns 64 query rows starting at
// q0 + s * row_step of query head head0 + s * head_step: (row_step,
// head_step) is (0, 1) when a KV group has an even number of heads (two
// heads share each K/V tile) and (64, 0) otherwise (128 rows of one head).
template <int DH>
__global__ void __launch_bounds__(NT, 1)
    flash_fwd_tc(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v, __nv_bfloat16* __restrict__ o,
                 long long o_sb, long long o_ss, long long o_sh, int h, int kh, int sq, int skv,
                 int causal, float scale_log2, int head_step, int row_step, int head_chunks) {
    using L = Smem<DH>;
    constexpr int NCH = L::NCH;
    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem =
        reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    const uint32_t base = smem_u32(smem);
    const uint32_t q_full = base + L::BAR_OFF;
    auto k_full = [&](int s) { return q_full + 8u * (1 + s); };
    auto v_full = [&](int s) { return q_full + 8u * (1 + STAGES + s); };
    auto empty = [&](int s) { return q_full + 8u * (1 + 2 * STAGES + s); };

    const int group = h / kh;
    const int kvh = blockIdx.x / head_chunks;
    const int head0 = kvh * group + (blockIdx.x % head_chunks) * (head_step ? SLOTS : 1);
    const int b = blockIdx.y;
    const int q0 = (gridDim.z - 1 - blockIdx.z) * (BM + row_step);  // latest query tiles first

    // KV tiles a slot needs: up to its causal diagonal (at least one)
    const int n_kv_all = (skv + BK - 1) / BK;
    auto slot_tiles = [&](int row0) {
        if (!causal) return n_kv_all;
        const int last = min(row0 + BM, sq) - 1;
        return max(1, min(n_kv_all, last / BK + 1));
    };
    const int n_kv = max(slot_tiles(q0), slot_tiles(q0 + row_step));

    if (threadIdx.x == 0) {
        mbar_init(q_full, 1);
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(k_full(s), 1);
            mbar_init(v_full(s), 1);
            mbar_init(empty(s), SLOTS * 128);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    const int wg = threadIdx.x / 128;
    if (wg == SLOTS) {
        // ---- producer: one thread issues every TMA copy -------------------------
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
        if (threadIdx.x == SLOTS * 128) {
            mbar_expect_tx(q_full, SLOTS * L::TILE);
            for (int s = 0; s < SLOTS; ++s)
                for (int c = 0; c < NCH; ++c)
                    tma_load_4d(base + s * L::TILE + c * BOX, &map_q, q_full, c * CH, head0 + s * head_step,
                                q0 + s * row_step, b);
            for (int j = 0; j < n_kv; ++j) {
                const int st = j % STAGES;
                if (j >= STAGES) mbar_wait(empty(st), ((j / STAGES) - 1) & 1);
                mbar_expect_tx(k_full(st), L::TILE);
                for (int c = 0; c < NCH; ++c)
                    tma_load_4d(base + L::K_OFF + st * L::TILE + c * BOX, &map_k, k_full(st), c * CH, kvh,
                                j * BK, b);
                mbar_expect_tx(v_full(st), L::TILE);
                for (int c = 0; c < NCH; ++c)
                    tma_load_4d(base + L::V_OFF + st * L::TILE + c * BOX, &map_v, v_full(st), c * CH, kvh,
                                j * BK, b);
            }
        }
    } else {
        // ---- consumer warpgroup `wg`: 64 query rows of one head -----------------
        asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
        const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
        const int head = head0 + wg * head_step;
        const int row0 = q0 + wg * row_step;
        const int my_kv = slot_tiles(row0);
        // accumulator fragment: element i sits at row 16 warp + lane / 4 + 8 ((i / 2) % 2),
        // column 8 (i / 4) + 2 (lane % 4) + i % 2
        const int r_lo = row0 + 16 * warp + lane / 4, r_hi = r_lo + 8;
        const int c_lane = 2 * (lane % 4);
        const uint32_t q_base = base + wg * L::TILE;

        float acc[DH / 2];
#pragma unroll
        for (int i = 0; i < DH / 2; ++i) acc[i] = 0.0f;
        float m_lo = NEG_INF, m_hi = NEG_INF, l_lo = 0.0f, l_hi = 0.0f;

        mbar_wait(q_full, 0);
        for (int j = 0; j < n_kv; ++j) {
            const int st = j % STAGES;
            const uint32_t parity = (j / STAGES) & 1;
            const uint32_t k_base = base + L::K_OFF + st * L::TILE;
            const uint32_t v_base = base + L::V_OFF + st * L::TILE;
            mbar_wait(k_full(st), parity);
            if (j < my_kv) {
                // S = Q K^T: Dh / 16 steps of k16, both operands K-major in shared memory
                float s[BK / 2];
#pragma unroll
                for (int i = 0; i < BK / 2; ++i) s[i] = 0.0f;
                wgmma_fence();
                fence_regs<BK / 2>(s);
#pragma unroll
                for (int kk = 0; kk < DH / 16; ++kk) {
                    const uint32_t off = (kk / 4) * BOX + (kk % 4) * 32;
                    wgmma_ss_n64(s, gmma_desc(q_base + off, 16, 1024), gmma_desc(k_base + off, 16, 1024),
                                 kk > 0);
                }
                wgmma_commit();
                wgmma_wait_all();
                fence_regs<BK / 2>(s);

                // scores in log2 units; the mask only on diagonal or ragged tiles
                const int k0 = j * BK;
                const bool edge = (k0 + BK > skv) || (causal && k0 + BK - 1 > row0);
                float mx_lo = NEG_INF, mx_hi = NEG_INF;
#pragma unroll
                for (int i = 0; i < BK / 2; ++i) {
                    float x = s[i] * scale_log2;
                    if (edge) {
                        const int col = k0 + 8 * (i / 4) + c_lane + (i % 2);
                        const int row = ((i / 2) % 2) ? r_hi : r_lo;
                        if (col >= skv || (causal && col > row)) x = NEG_INF;
                    }
                    s[i] = x;
                    if ((i / 2) % 2) mx_hi = fmaxf(mx_hi, x);
                    else mx_lo = fmaxf(mx_lo, x);
                }
#pragma unroll
                for (int off = 1; off <= 2; off <<= 1) {
                    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
                    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
                }
                const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
                const float a_lo = exp2f(m_lo - mn_lo), a_hi = exp2f(m_hi - mn_hi);
                m_lo = mn_lo;
                m_hi = mn_hi;
                float sum_lo = 0.0f, sum_hi = 0.0f;
#pragma unroll
                for (int i = 0; i < BK / 2; ++i) {
                    if ((i / 2) % 2) {
                        s[i] = exp2f(s[i] - mn_hi);
                        sum_hi += s[i];
                    } else {
                        s[i] = exp2f(s[i] - mn_lo);
                        sum_lo += s[i];
                    }
                }
                l_lo = l_lo * a_lo + sum_lo;  // this thread's columns; the quad sums at the end
                l_hi = l_hi * a_hi + sum_hi;
#pragma unroll
                for (int i = 0; i < DH / 2; ++i) acc[i] *= ((i / 2) % 2) ? a_hi : a_lo;

                // P in bf16 as wgmma's A fragments: k16 step kk holds columns 16 kk .. 16 kk + 15
                uint32_t pa[BK / 4];
#pragma unroll
                for (int kk = 0; kk < BK / 16; ++kk) {
                    pa[4 * kk + 0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
                    pa[4 * kk + 1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
                    pa[4 * kk + 2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
                    pa[4 * kk + 3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
                }

                // O += P V: V's (kv, Dh) tile as stored is B, MN-major (transpose bit);
                // 16 kv rows per step (2 KB), the Dh/64 boxes one leading offset apart
                mbar_wait(v_full(st), parity);
                wgmma_fence();
                fence_regs<DH / 2>(acc);
#pragma unroll
                for (int kk = 0; kk < BK / 16; ++kk)
                    wgmma_rs<DH>(acc, pa + 4 * kk, gmma_desc(v_base + kk * 2048, BOX, 1024));
                wgmma_commit();
                wgmma_wait_all();
                fence_regs<DH / 2>(acc);
            } else {
                mbar_wait(v_full(st), parity);  // past this slot's diagonal: release the stage only
            }
            mbar_arrive(empty(st));
        }

        // finalise: the quad's partial sums, l clamped to 1e-30, rows past Sq not stored
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
            l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
            l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
        }
        const float den_lo = fmaxf(l_lo, 1e-30f), den_hi = fmaxf(l_hi, 1e-30f);
        __nv_bfloat16* op = o + b * o_sb + head * o_sh;
#pragma unroll
        for (int i = 0; i < DH / 2; i += 2) {
            const bool hi = (i / 2) % 2;
            const int row = hi ? r_hi : r_lo;
            if (row >= sq) continue;
            const float den = hi ? den_hi : den_lo;
            const int col = 8 * (i / 4) + c_lane;
            *reinterpret_cast<__nv_bfloat162*>(op + row * o_ss + col) =
                __floats2bfloat162_rn(acc[i] / den, acc[i + 1] / den);
        }
    }
}

// One 64 x 64 tile of each product, for checking the descriptors and the
// swizzle against a plain matrix product: S = Q K^T (f32, 64 x 64) and
// O = bf16(S) V (f32, 64 x Dh), for Q, K, V (64, Dh) bf16 row-major loaded by
// the same tensor maps (B = 1, one head). One warpgroup.
template <int DH>
__global__ void __launch_bounds__(128)
    wgmma_tile(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
               const __grid_constant__ CUtensorMap map_v, float* __restrict__ s_out,
               float* __restrict__ o_out) {
    using L = Smem<DH>;
    constexpr int NCH = L::NCH;
    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem =
        reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    const uint32_t base = smem_u32(smem);
    const uint32_t bar = base + L::BAR_OFF;
    if (threadIdx.x == 0) {
        mbar_init(bar, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        mbar_expect_tx(bar, 3 * L::TILE);
        for (int c = 0; c < NCH; ++c) {
            tma_load_4d(base + c * BOX, &map_q, bar, c * CH, 0, 0, 0);
            tma_load_4d(base + L::K_OFF + c * BOX, &map_k, bar, c * CH, 0, 0, 0);
            tma_load_4d(base + L::V_OFF + c * BOX, &map_v, bar, c * CH, 0, 0, 0);
        }
    }
    mbar_wait(bar, 0);
    const int t = threadIdx.x, warp = t / 32, lane = t % 32;
    const int r_lo = 16 * warp + lane / 4, c_lane = 2 * (lane % 4);

    float s[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.0f;
    wgmma_fence();
    fence_regs<BK / 2>(s);
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
        const uint32_t off = (kk / 4) * BOX + (kk % 4) * 32;
        wgmma_ss_n64(s, gmma_desc(base + off, 16, 1024), gmma_desc(base + L::K_OFF + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<BK / 2>(s);
#pragma unroll
    for (int i = 0; i < BK / 2; ++i)
        s_out[(r_lo + 8 * ((i / 2) % 2)) * BK + 8 * (i / 4) + c_lane + (i % 2)] = s[i];

    uint32_t pa[BK / 4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
        pa[4 * kk + 0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
        pa[4 * kk + 1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[4 * kk + 2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[4 * kk + 3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
    float acc[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) acc[i] = 0.0f;
    wgmma_fence();
    fence_regs<DH / 2>(acc);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs<DH>(acc, pa + 4 * kk, gmma_desc(base + L::V_OFF + kk * 2048, BOX, 1024));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<DH / 2>(acc);
#pragma unroll
    for (int i = 0; i < DH / 2; ++i)
        o_out[(r_lo + 8 * ((i / 2) % 2)) * DH + 8 * (i / 4) + c_lane + (i % 2)] = acc[i];
}

// ============================================================================
// Tensor-core route: host side
// ============================================================================
// cuTensorMapEncodeTiled lives in libcuda. It is reached through the
// runtime's cudaGetDriverEntryPoint(ByVersion), so the library links no
// libcuda and loads wherever the runtime does.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
        cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
        cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
        if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
    }
    return fn;
}

// A 4-D map over a (batch, rows, heads, Dh) bf16 view with element strides
// (sb, ss, sh), the head dim contiguous; one box is 64 Dh elements (128
// bytes, the swizzle's width) of one head, over 64 rows of one batch row.
// Rows past `rows` read as zeros.
int make_map(CUtensorMap* map, const void* ptr, int batch, int rows, int heads, int dh, long long sb,
             long long ss, long long sh) {
    EncodeTiled encode = encoder();
    if (encode == nullptr) return ERR_NO_ENCODER;
    const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)heads, (cuuint64_t)rows, (cuuint64_t)batch};
    const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2, (cuuint64_t)sb * 2};
    const cuuint32_t box[4] = {(cuuint32_t)CH, 1, 64, 1};
    const cuuint32_t elem[4] = {1, 1, 1, 1};
    CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
                        elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : ERR_TENSOR_MAP;
}

// Once per instance: opt in to the shared memory, and check that ptxas gave
// the kernel the registers its setmaxnreg split moves (a consumer's
// setmaxnreg.inc would otherwise wait forever).
template <int DH> int prepare() {
    static int state = -1;
    if (state < 0) {
        cudaError_t err = cudaFuncSetAttribute(flash_fwd_tc<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               Smem<DH>::ALLOC);
        if (err == cudaSuccess)
            err = cudaFuncSetAttribute(wgmma_tile<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       Smem<DH>::ALLOC);
        if (err != cudaSuccess) return (int)err;
        cudaFuncAttributes attr;
        err = cudaFuncGetAttributes(&attr, flash_fwd_tc<DH>);
        if (err != cudaSuccess) return (int)err;
        if (attr.numRegs * NT < 128 * PRODUCER_REGS + SLOTS * 128 * CONSUMER_REGS) return ERR_REGISTERS;
        state = 0;
    }
    return state;
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* o, const Strides& st, int b, int h, int kh,
           int sq, int skv, int causal, float scale, cudaStream_t stream) {
    int err = prepare<DH>();
    if (err) return err;
    CUtensorMap mq, mk, mv;
    if ((err = make_map(&mq, q, b, sq, h, DH, st.q[0], st.q[1], st.q[2]))) return err;
    if ((err = make_map(&mk, k, b, skv, kh, DH, st.k[0], st.k[1], st.k[2]))) return err;
    if ((err = make_map(&mv, v, b, skv, kh, DH, st.v[0], st.v[1], st.v[2]))) return err;
    const int group = h / kh;
    const bool pairs = group % 2 == 0;
    const int head_step = pairs ? 1 : 0, row_step = pairs ? 0 : BM;
    const int head_chunks = pairs ? group / 2 : group;
    const dim3 grid(kh * head_chunks, b, (sq + BM + row_step - 1) / (BM + row_step));
    const float log2e = 1.4426950408889634f;
    flash_fwd_tc<DH><<<grid, NT, Smem<DH>::ALLOC, stream>>>(
        mq, mk, mv, static_cast<__nv_bfloat16*>(o), st.o[0], st.o[1], st.o[2], h, kh, sq, skv, causal,
        scale * log2e, head_step, row_step, head_chunks);
    return (int)cudaGetLastError();
}

template <int DH>
int tile(const void* q, const void* k, const void* v, float* s_out, float* o_out, cudaStream_t stream) {
    int err = prepare<DH>();
    if (err) return err;
    CUtensorMap mq, mk, mv;
    if ((err = make_map(&mq, q, 1, 64, 1, DH, 64LL * DH, DH, DH))) return err;
    if ((err = make_map(&mk, k, 1, 64, 1, DH, 64LL * DH, DH, DH))) return err;
    if ((err = make_map(&mv, v, 1, 64, 1, DH, 64LL * DH, DH, DH))) return err;
    wgmma_tile<DH><<<1, 128, Smem<DH>::ALLOC, stream>>>(mq, mk, mv, s_out, o_out);
    return (int)cudaGetLastError();
}

}  // namespace tc

Strides strides_from(const long long* s) {
    Strides st;
    for (int i = 0; i < 3; ++i) {
        st.q[i] = s[i];
        st.k[i] = s[3 + i];
        st.v[i] = s[6 + i];
        st.o[i] = s[9 + i];
    }
    return st;
}

}  // namespace

// The CUDA-core route. dtype: 0 float32, 1 bfloat16; strides: 12 element
// strides, (batch, row, head) of q, k, v and the output. Returns
// cudaGetLastError() of the launch (0 on success); never synchronises.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o, int dtype,
                                      int b, int h, int kh, int sq, int skv, int dh,
                                      const long long* strides, int causal, float scale, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const Strides st = strides_from(strides);
    switch (dtype) {
        case 0: return cc::launch_dh<float>(q, k, v, o, st, b, h, kh, sq, skv, dh, causal, scale, s);
        case 1: return cc::launch_dh<__nv_bfloat16>(q, k, v, o, st, b, h, kh, sq, skv, dh, causal, scale, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

// The tensor-core route: bf16, Dh 64, 128 or 256; arguments as above.
extern "C" int flash_attention_tc_launch(const void* q, const void* k, const void* v, void* o, int b, int h,
                                         int kh, int sq, int skv, int dh, const long long* strides,
                                         int causal, float scale, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const Strides st = strides_from(strides);
    switch (dh) {
        case 64: return tc::launch<64>(q, k, v, o, st, b, h, kh, sq, skv, causal, scale, s);
        case 128: return tc::launch<128>(q, k, v, o, st, b, h, kh, sq, skv, causal, scale, s);
        case 256: return tc::launch<256>(q, k, v, o, st, b, h, kh, sq, skv, causal, scale, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

// One wgmma tile of each product (see tc::wgmma_tile): q, k, v (64, dh)
// contiguous bf16; s_out (64, 64) and o_out (64, dh) f32.
extern "C" int flash_attention_wgmma_tile(const void* q, const void* k, const void* v, void* s_out,
                                          void* o_out, int dh, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    float* so = static_cast<float*>(s_out);
    float* oo = static_cast<float*>(o_out);
    switch (dh) {
        case 64: return tc::tile<64>(q, k, v, so, oo, s);
        case 128: return tc::tile<128>(q, k, v, so, oo, s);
        case 256: return tc::tile<256>(q, k, v, so, oo, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

extern "C" const char* flash_attention_error_string(int err) {
    switch (err) {
        case ERR_NO_ENCODER: return "cuTensorMapEncodeTiled not found through cudaGetDriverEntryPoint";
        case ERR_TENSOR_MAP: return "cuTensorMapEncodeTiled refused a tensor map (strides or alignment)";
        case ERR_REGISTERS: return "the kernel has fewer registers than its setmaxnreg split moves";
        default: return cudaGetErrorString(static_cast<cudaError_t>(err));
    }
}
