// Mamba-2 SSD chunk scan for Hopper (sm_90a). Two routes in one source,
// picked by the wrapper (kernel.py ``route``) from the dtypes and the sizes
// alone:
//
//   tensor cores   x, B and C in bf16 with chunk, P and N each 64 or 128
//                  (the serving path): wgmma products, TMA loads into a
//                  chunk ring, the model's strided layout read in place
//                  (ssd_tc_launch);
//   CUDA cores     everything else, f32 included: f32 FMAs, contiguous
//                  inputs (ssd_launch).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/ssd/kernel.py::_ssd_kernel
// and computes what it computes, chunk by chunk of Q tokens, for one batch
// row and one head (a = A of the head; B and C those of the head's SSM
// group: with G groups, head h reads group h / (H / G), so G = 1 shares one
// B and one C among all heads, the reference's layout):
//   da = dt * a, cum = the inclusive prefix sum of da (in token order),
//   xdt = x * dt,
//   y_i = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) xdt_j     (intra-chunk)
//       + exp(cum_i) (C_i . h)                                 (carried state)
//   h  <- h exp(cum_{Q-1}) + sum_j exp(cum_{Q-1} - cum_j) xdt_j (x) B_j,
// y in x's dtype, the final h in f32. The masked differences (j > i) are
// zeroed before exp, as the reference does, so exp never sees a positive
// exponent (a < 0 and dt > 0 make every unmasked one <= 0).
//
// What bounds it on this card. At Mamba2-370m's serving prefill (B=4, S=512,
// H=32, P=64, N=128, bf16, chunk 64) the function must read x (8.39 MB), dt
// (0.26 MB), B and C (1.05 MB) and write y (8.39 MB) and h (4.19 MB): 22.3 MB,
// 6.7 us at 3.35 TB/s. Its products over the causal pairs come to about
// 3.0 GFLOP, 3.0 us at the 989 TFLOP/s bf16 peak: the function is bound by
// bytes. The tensor-core route is built for that:
//   - one block per (head, batch row) loops over the chunks and keeps h in
//     f32 registers for the whole sequence (the TPU kernel carries it in VMEM
//     across a sequential grid axis; blocks on the GPU carry nothing between
//     them). P / 64 consumer warpgroups each own 64 rows of h (64 x N) and
//     64 columns of y;
//   - a producer warp issues TMA loads (128-byte swizzle) of chunk c+1's x,
//     B and C tiles, reads its dt and makes the in-chunk prefix (one thread,
//     in token order, as the first design did), exp(cum) and
//     dt exp(cum_{Q-1} - cum) into a two-stage mbarrier ring while the
//     consumers compute chunk c (one stage when Q = P = N = 128, whose two
//     stages would not fit); x, B and C are read through their own strides,
//     so the model's slices of one projection need no copies;
//   - the four products run on wgmma with f32 accumulators, 64 rows a tile:
//       S = C B^T (bf16 operands, exact products; only the summation order
//         differs from an f32 dot),
//       Y_off = C h^T, then scaled by exp(cum_i),
//       Y_diag = (S o L o dt) x, accumulated onto it,
//       dS = (x dt exp(cum_{Q-1} - cum))^T B, accumulated onto h exp(cum_{Q-1});
//     the f32 operands (S o L o dt, h, and the decayed x dt) enter as a bf16
//     hi + lo split, two products each: their rounding is that of the split
//     (about 2^-17 relative), f32-class; x, B and C enter as stored. No
//     operand is rounded plainly to bf16;
//   - S o L o dt stays in registers (the S accumulator fragment is the
//     A operand's layout); h goes to shared memory as the hi/lo pair once a
//     chunk for C h^T; the decayed x dt is read from the x tile straight into
//     A fragments. Only Y_off and the h update depend on the previous chunk;
//     the h update's fragments are read while C h^T and S run, and its
//     wgmma is issued behind Y_diag's, so the two overlap.
//   - Two heads of one SSM group could share each B/C tile, but at the
//     serving shape that halves the grid to 64 blocks on 132 SMs, and a
//     block's 117,792 bytes of shared memory leave no room for a second one
//     on an SM (228 KB): one head a block. With G groups (B and C of shape
//     (B, S, G, N)) a block's TMA loads of B and C take its head's group
//     through the group coordinate of a 4-D tensor map; G = 1 is the same
//     map with a group axis of one, so every G is one launch a call.
// The CUDA-core route is the first design of this kernel, kept for f32, whose
// bars the bf16 split would meet but whose inputs would double the bytes, and
// for the sizes the tensor-core tiles do not take: one block of 256 threads
// per (head, batch row), every product an f32 FMA from shared memory.
#include <cuda.h>  // CUtensorMap and its enums; the encoder is reached through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

// error codes beyond cudaError_t's range
constexpr int ERR_NO_ENCODER = 1001;  // cuTensorMapEncodeTiled not found
constexpr int ERR_TENSOR_MAP = 1002;  // cuTensorMapEncodeTiled refused a map

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
// Layout: x, y (B, S, H, P); dt (B, S, H) f32; a (H,) f32; B, C (B, S, G, N);
// h (B, H, P, N) f32; all contiguous. x and y f32 or bf16, B and C f32 or
// bf16 (independently). Q <= 128, P <= 128, N <= 128, Q divides S. One
// block of 256 threads per (head, batch row); thread (ty, tx) =
// (tid / 16, tid % 16). Shared memory per block, in f32: B and C (Q rows of
// N + 1), xdt (Q x P), a tile of RT rows of the decay-masked C.B^T (RT x
// (Q + 1)), h (P rows of N + 1), and dt, cum, exp(cum), exp(cum_{Q-1} - cum)
// (Q each): 216 KB at Q=128, P=64, N=128, 125 KB at Q=64, so the block opts
// in to dynamic shared memory above 48 KB. Where a whole instance does not
// fit a block's 227 KB (Q = P = N = 128 asks for 276 KB), the head dim is
// split across blocks (grid z): each block takes pb columns of x and y and
// the pb rows of h they feed, and recomputes the chunk's C.B^T, cumsum and
// decays itself; every value is computed as in the whole instance. The odd
// row strides put the 16 rows a half-warp reads at one column in 16
// different banks.
namespace cc {

constexpr int NT = 256;       // threads per block
constexpr int RT = 32;        // rows of the C.B^T tile
constexpr int MAX_DIM = 128;  // the largest Q, P and N
constexpr int SPAN = MAX_DIM / 16;  // columns a thread owns at the largest width

__host__ __device__ constexpr size_t smem_floats(int q, int p, int n) {
    return (size_t)2 * q * (n + 1) + (size_t)q * p + (size_t)RT * (q + 1) + (size_t)p * (n + 1) +
           (size_t)4 * q;
}

template <typename TX, typename TBC>
__global__ void __launch_bounds__(NT) ssd_chunk_scan(const TX* __restrict__ x,
                                                     const float* __restrict__ dt,
                                                     const float* __restrict__ a,
                                                     const TBC* __restrict__ bm,
                                                     const TBC* __restrict__ cm,
                                                     TX* __restrict__ y, float* __restrict__ hout,
                                                     int s, int nh, int ng, int p_total, int pb, int n,
                                                     int q) {
    extern __shared__ __align__(16) float smem[];
    // this block's head-dim columns: [p_off, p_off + p) of x, y and the rows
    // of h (each depends on its own x column alone, so no sum changes order)
    const int p_off = blockIdx.z * pb;
    const int p = min(pb, p_total - p_off);
    const int ldn = n + 1, ldq = q + 1;
    float* bs = smem;               // (Q, N + 1)
    float* cs = bs + q * ldn;       // (Q, N + 1)
    float* xs = cs + q * ldn;       // (Q, P): x * dt
    float* ms = xs + q * p;         // (RT, Q + 1): decay-masked C.B^T rows
    float* hs = ms + RT * ldq;      // (P, N + 1): the carried state
    float* dts = hs + p * ldn;      // (Q): dt
    float* cum = dts + q;           // (Q): inclusive prefix of dt * a
    float* ecum = cum + q;          // (Q): exp(cum)
    float* dte = ecum + q;          // (Q): exp(cum_{Q-1} - cum)

    const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
    const int head = blockIdx.x, b = blockIdx.y;
    const int grp = head / (nh / ng);  // the head's SSM group
    const float ah = a[head];

    for (int e = tid; e < p * ldn; e += NT) hs[e] = 0.0f;

    for (int c0 = 0; c0 < s; c0 += q) {
        __syncthreads();  // the previous chunk's state update is done with bs, xs, dte
        const size_t tok0 = (size_t)b * s + c0;  // first token of the chunk, as a (B*S) row
        for (int t = tid; t < q; t += NT) dts[t] = dt[(tok0 + t) * nh + head];
        // unrolled so that several global loads are in flight at once
#pragma unroll 8
        for (int e = tid; e < q * n; e += NT) {
            const int t = e / n, k = e - t * n;
            const size_t at = ((tok0 + t) * ng + grp) * n + k;
            bs[t * ldn + k] = to_f32(bm[at]);
            cs[t * ldn + k] = to_f32(cm[at]);
        }
        __syncthreads();
        if (tid == 0) {  // an ordered prefix, as cumsum sums in token order
            float acc = 0.0f;
            for (int t = 0; t < q; ++t) {
                acc = __fadd_rn(acc, __fmul_rn(dts[t], ah));
                cum[t] = acc;
            }
        }
#pragma unroll 8
        for (int e = tid; e < q * p; e += NT) {
            const int t = e / p, k = e - t * p;
            xs[e] = to_f32(x[((tok0 + t) * nh + head) * p_total + p_off + k]) * dts[t];
        }
        __syncthreads();
        for (int t = tid; t < q; t += NT) {
            ecum[t] = expf(cum[t]);
            dte[t] = expf(cum[q - 1] - cum[t]);
        }
        __syncthreads();

        for (int r0 = 0; r0 < q; r0 += RT) {
            const int qe = min(r0 + RT, q);  // columns j <= the tile's last row
            // ---- the tile's rows of (C.B^T) * decay --------------------------
            {
                float acc[2][SPAN];
#pragma unroll
                for (int i = 0; i < 2; ++i)
#pragma unroll
                    for (int k = 0; k < SPAN; ++k) acc[i][k] = 0.0f;
                const int r_a = min(r0 + ty, q - 1), r_b = min(r0 + ty + 16, q - 1);
#pragma unroll 4
                for (int k = 0; k < n; ++k) {
                    const float c_a = cs[r_a * ldn + k], c_b = cs[r_b * ldn + k];
#pragma unroll
                    for (int jj = 0; jj < SPAN; ++jj) {
                        const int j = tx + 16 * jj;
                        if (j < qe) {
                            const float bv = bs[j * ldn + k];
                            acc[0][jj] = fmaf(c_a, bv, acc[0][jj]);
                            acc[1][jj] = fmaf(c_b, bv, acc[1][jj]);
                        }
                    }
                }
#pragma unroll
                for (int ii = 0; ii < 2; ++ii) {
                    const int row = ty + 16 * ii, i = r0 + row;
                    if (row >= RT || i >= q) continue;
#pragma unroll
                    for (int jj = 0; jj < SPAN; ++jj) {
                        const int j = tx + 16 * jj;
                        if (j >= qe) continue;
                        const bool keep = j <= i;
                        const float diff = keep ? cum[i] - cum[j] : 0.0f;
                        const float decay = keep ? expf(diff) : 0.0f;
                        ms[row * ldq + j] = acc[ii][jj] * decay;
                    }
                }
            }
            __syncthreads();
            // ---- y rows: the masked product with xdt, plus the carried state ---
            {
                float intra[2][SPAN], inter[2][SPAN];
#pragma unroll
                for (int i = 0; i < 2; ++i)
#pragma unroll
                    for (int k = 0; k < SPAN; ++k) intra[i][k] = inter[i][k] = 0.0f;
                const int row_a = ty, row_b = min(ty + 16, RT - 1);
#pragma unroll 4
                for (int j = 0; j < qe; ++j) {
                    const float m_a = ms[row_a * ldq + j], m_b = ms[row_b * ldq + j];
#pragma unroll
                    for (int dd = 0; dd < SPAN; ++dd) {
                        const int col = tx + 16 * dd;
                        if (col < p) {
                            const float xv = xs[j * p + col];
                            intra[0][dd] = fmaf(m_a, xv, intra[0][dd]);
                            intra[1][dd] = fmaf(m_b, xv, intra[1][dd]);
                        }
                    }
                }
                const int r_a = min(r0 + ty, q - 1), r_b = min(r0 + ty + 16, q - 1);
#pragma unroll 4
                for (int k = 0; k < n; ++k) {
                    const float c_a = cs[r_a * ldn + k], c_b = cs[r_b * ldn + k];
#pragma unroll
                    for (int dd = 0; dd < SPAN; ++dd) {
                        const int col = tx + 16 * dd;
                        if (col < p) {
                            const float hv = hs[col * ldn + k];
                            inter[0][dd] = fmaf(c_a, hv, inter[0][dd]);
                            inter[1][dd] = fmaf(c_b, hv, inter[1][dd]);
                        }
                    }
                }
#pragma unroll
                for (int ii = 0; ii < 2; ++ii) {
                    const int row = ty + 16 * ii, i = r0 + row;
                    if (row >= RT || i >= q) continue;
                    TX* yrow = y + ((tok0 + i) * nh + head) * p_total + p_off;
#pragma unroll
                    for (int dd = 0; dd < SPAN; ++dd) {
                        const int col = tx + 16 * dd;
                        if (col < p) yrow[col] = from_f32<TX>(intra[ii][dd] + inter[ii][dd] * ecum[i]);
                    }
                }
            }
            __syncthreads();  // the tile of C.B^T and h are consumed
        }

        // ---- state update: h <- h exp(cum_{Q-1}) + sum_j dte_j xdt_j (x) B_j --
        // thread (ty, tx) owns rows p0 + ty + 16 a (a < 4) and columns tx + 16 kk
        // of h: per token 13 shared loads feed 32 FMAs
        const float chunk_decay = ecum[q - 1];
        for (int p0 = 0; p0 < p; p0 += 64) {
            float acc[4][SPAN];
#pragma unroll
            for (int a = 0; a < 4; ++a)
#pragma unroll
                for (int k = 0; k < SPAN; ++k) acc[a][k] = 0.0f;
#pragma unroll 4
            for (int j = 0; j < q; ++j) {
                float wx[4];
#pragma unroll
                for (int a = 0; a < 4; ++a) wx[a] = dte[j] * xs[j * p + min(p0 + ty + 16 * a, p - 1)];
#pragma unroll
                for (int kk = 0; kk < SPAN; ++kk) {
                    const int k = tx + 16 * kk;
                    if (k < n) {
                        const float bv = bs[j * ldn + k];
#pragma unroll
                        for (int a = 0; a < 4; ++a) acc[a][kk] = fmaf(wx[a], bv, acc[a][kk]);
                    }
                }
            }
#pragma unroll
            for (int a = 0; a < 4; ++a) {
                const int pp = p0 + ty + 16 * a;
                if (pp >= p) continue;
#pragma unroll
                for (int kk = 0; kk < SPAN; ++kk) {
                    const int k = tx + 16 * kk;
                    if (k < n) hs[pp * ldn + k] = hs[pp * ldn + k] * chunk_decay + acc[a][kk];
                }
            }
        }
    }
    __syncthreads();
    float* hp = hout + (((size_t)b * nh + head) * p_total + p_off) * n;
    for (int e = tid; e < p * n; e += NT) {
        const int pp = e / n, k = e - pp * n;
        hp[e] = hs[pp * ldn + k];
    }
}
template <typename TX, typename TBC>
int launch_typed(const void* x, const void* dt, const void* a, const void* bm, const void* cm,
                 void* y, void* h, int bsz, int s, int nh, int ng, int p, int n, int q, int pb,
                 cudaStream_t stream) {
    const size_t smem = smem_floats(q, pb, n) * sizeof(float);
    static size_t granted = 48 * 1024;  // an instance keeps the largest opt-in it has had
    if (smem > granted) {
        cudaError_t err = cudaFuncSetAttribute(ssd_chunk_scan<TX, TBC>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return (int)err;
        granted = smem;
    }
    const dim3 grid(nh, bsz, (p + pb - 1) / pb);
    ssd_chunk_scan<TX, TBC><<<grid, NT, smem, stream>>>(
        static_cast<const TX*>(x), static_cast<const float*>(dt), static_cast<const float*>(a),
        static_cast<const TBC*>(bm), static_cast<const TBC*>(cm), static_cast<TX*>(y),
        static_cast<float*>(h), s, nh, ng, p, pb, n, q);
    return (int)cudaGetLastError();
}

template <typename TX>
int launch_bc(const void* x, const void* dt, const void* a, const void* bm, const void* cm,
              void* y, void* h, int bc_dtype, int bsz, int s, int nh, int ng, int p, int n, int q, int pb,
              cudaStream_t stream) {
    switch (bc_dtype) {
        case 0: return launch_typed<TX, float>(x, dt, a, bm, cm, y, h, bsz, s, nh, ng, p, n, q, pb, stream);
        case 1:
            return launch_typed<TX, __nv_bfloat16>(x, dt, a, bm, cm, y, h, bsz, s, nh, ng, p, n, q, pb,
                                                   stream);
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

// one arrival that also announces the bytes the TMA copies will deliver
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

// the warpgroup's 128 threads meet at named barrier `id` (0 is __syncthreads')
__device__ __forceinline__ void warpgroup_sync(int id) {
    asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// shared-memory writes of this thread become visible to the async proxy (wgmma)
__device__ __forceinline__ void fence_async_smem() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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

// a K-major operand: 16-element step kk of rows in boxes of 64 columns `box` bytes apart
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk, int box) {
    return gmma_desc(tile + (kk / 4) * box + (kk % 4) * 32, 16, 1024);
}

// an MN-major operand (transposed): 16-row step kk, column boxes `box` bytes apart
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk, int box) {
    return gmma_desc(tile + kk * 2048, box, 1024);
}

// Byte offset of element (row, col) in a box of 64-element (128-byte) rows
// under the 128-byte swizzle, as TMA lays it out: the 16-byte chunk index is
// XORed with the row within its 8-row (1024-byte) group.
__device__ __forceinline__ uint32_t swz(int row, int col) {
    return row * 128 + ((((col >> 3) ^ row) & 7) << 4) + (col & 7) * 2;
}

// two f32 as bf16 hi + lo pairs: hi = bf16(v), lo = bf16(v - hi); lower
// half of each word the first value
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi, uint32_t& lo) {
    const __nv_bfloat16 h0 = __float2bfloat16_rn(v0), h1 = __float2bfloat16_rn(v1);
    const __nv_bfloat162 h = __halves2bfloat162(h0, h1);
    const __nv_bfloat162 l = __floats2bfloat162_rn(v0 - __bfloat162float(h0), v1 - __bfloat162float(h1));
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = *reinterpret_cast<const uint32_t*>(&l);
}

// D(64x64, f32) (+)= A(64x16, smem, K-major) * B(16x64, smem, K-major)
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

// D(64x128, f32) (+)= A(64x16, smem, K-major) * B(16x128, smem, K-major)
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da, uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(accumulate)
        : "memory");
}

// D(64x64, f32) (+)= A(64x16, registers) * B(16x64, smem, MN-major: transposed)
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

// D(64x128, f32) (+)= A(64x16, registers) * B(16x128, smem, MN-major: transposed)
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

// ============================================================================
// Tensor-core route: the kernel
// ============================================================================
// Shared memory, every box 1024-byte aligned (the swizzle's period). A stage
// of the ring holds chunk c's x tile (P/64 boxes of Q rows x 64 columns), its
// B and C tiles (N/64 boxes each), then cum, exp(cum), dt exp(cum_{Q-1} - cum)
// and dt (Q floats each). After the stages: each consumer warpgroup's h rows
// as the hi and lo bf16 tiles C h^T reads (N/64 boxes of 64 rows), then the
// barriers full[STAGES] and empty[STAGES].
template <int Q, int P, int N> struct Layout {
    static constexpr int NWG = P / 64;         // consumer warpgroups: 64 rows of h each
    static constexpr int NT = 128 * NWG + 32;  // then one producer warp
    static constexpr int XB = Q * 128;         // one box: Q rows of 64 bf16
    static constexpr int X_OFF = 0;
    static constexpr int B_OFF = (P / 64) * XB;
    static constexpr int C_OFF = B_OFF + (N / 64) * XB;
    static constexpr int F_OFF = C_OFF + (N / 64) * XB;
    static constexpr int TX = F_OFF;  // bytes the TMA copies of one chunk deliver
    static constexpr int STAGE = (F_OFF + 16 * Q + 1023) / 1024 * 1024;
    static constexpr int HB = (N / 64) * 8192;  // one warpgroup's h, hi or lo
    static constexpr int H_BYTES = NWG * 2 * HB;
    static constexpr int STAGES = 2 * STAGE + H_BYTES + 32 + 1024 <= 232448 ? 2 : 1;
    static constexpr int H_OFF = STAGES * STAGE;
    static constexpr int BAR_OFF = H_OFF + H_BYTES;
    static constexpr int ALLOC = BAR_OFF + 16 * STAGES + 1024;  // + slack to align the base
};

// Fragments: thread t of a warpgroup (warp w = t / 32, lane l) holds element e
// of a 64-row accumulator at row r0 + 8 ((e / 2) % 2), column 8 (e / 4) + c0 +
// e % 2, with r0 = 16 w + l / 4 and c0 = 2 (l % 4); word q of a k16 A
// fragment holds elements 2q and 2q + 1 of the same layout.

// S (64 x NJ) = C_rows B^T over K = N
template <int NJ, int N>
__device__ __forceinline__ void issue_s(float* s, uint32_t c_rows, uint32_t b_tile, int box) {
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
        if constexpr (NJ == 64) wgmma_ss_n64(s, desc_k(c_rows, kk, box), desc_k(b_tile, kk, box), kk > 0);
        else wgmma_ss_n128(s, desc_k(c_rows, kk, box), desc_k(b_tile, kk, box), kk > 0);
    }
}

// Y_off (64 x 64) = C_rows (h_hi + h_lo)^T over K = N
template <int N>
__device__ __forceinline__ void issue_yoff(float* acc, uint32_t c_rows, int box, uint32_t hhi, uint32_t hlo) {
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) wgmma_ss_n64(acc, desc_k(c_rows, kk, box), desc_k(hhi, kk, 8192), kk > 0);
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) wgmma_ss_n64(acc, desc_k(c_rows, kk, box), desc_k(hlo, kk, 8192), 1);
}

// acc (64 x 64) += (A_hi + A_lo) (64 x NJ, registers) x_tile (NJ x 64, as stored)
template <int NJ>
__device__ __forceinline__ void issue_ydiag(float* acc, const uint32_t* ahi, const uint32_t* alo, uint32_t x_tile,
                                            int box) {
#pragma unroll
    for (int kk = 0; kk < NJ / 16; ++kk) wgmma_rs_n64(acc, ahi + 4 * kk, desc_mn(x_tile, kk, box), 1);
#pragma unroll
    for (int kk = 0; kk < NJ / 16; ++kk) wgmma_rs_n64(acc, alo + 4 * kk, desc_mn(x_tile, kk, box), 1);
}

// h (64 x N) += (W_hi + W_lo) (64 x Q, registers) B_tile (Q x N, as stored)
template <int Q, int N>
__device__ __forceinline__ void issue_state(float* h, const uint32_t* whi, const uint32_t* wlo, uint32_t b_tile,
                                            int box) {
#pragma unroll
    for (int kk = 0; kk < Q / 16; ++kk) {
        if constexpr (N == 64) wgmma_rs_n64(h, whi + 4 * kk, desc_mn(b_tile, kk, box), 1);
        else wgmma_rs_n128(h, whi + 4 * kk, desc_mn(b_tile, kk, box), 1);
    }
#pragma unroll
    for (int kk = 0; kk < Q / 16; ++kk) {
        if constexpr (N == 64) wgmma_rs_n64(h, wlo + 4 * kk, desc_mn(b_tile, kk, box), 1);
        else wgmma_rs_n128(h, wlo + 4 * kk, desc_mn(b_tile, kk, box), 1);
    }
}

// A fragments of W (64 x Q): W[p, j] = x[j, p] w[j], read from this
// warpgroup's box of the x tile, as a hi / lo pair
template <int Q>
__device__ __forceinline__ void load_w(uint32_t* whi, uint32_t* wlo, const unsigned char* x_box, const float* w,
                                       int r0, int c0) {
#pragma unroll
    for (int q = 0; q < Q / 4; ++q) {  // k16 step q / 4, word q % 4
        const int p = r0 + 8 * (q & 1);
        const int j = 16 * (q / 4) + c0 + 8 * ((q / 2) & 1);
        const float x0 = __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(x_box + swz(j, p)));
        const float x1 = __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(x_box + swz(j + 1, p)));
        split2(x0 * w[j], x1 * w[j + 1], whi[q], wlo[q]);
    }
}

// h (64 x N accumulator) into the hi / lo tiles C h^T reads (K-major, swizzled)
template <int N>
__device__ __forceinline__ void store_h(const float* h, unsigned char* hhi, unsigned char* hlo, int r0, int c0) {
#pragma unroll
    for (int e = 0; e < N / 2; e += 2) {
        const int p = r0 + 8 * ((e / 2) & 1);
        const int n = 8 * (e / 4) + c0;
        const uint32_t off = (n / 64) * 8192 + swz(p, n & 63);
        uint32_t hi, lo;
        split2(h[e], h[e + 1], hi, lo);
        *reinterpret_cast<uint32_t*>(hhi + off) = hi;
        *reinterpret_cast<uint32_t*>(hlo + off) = lo;
    }
}

// Rows 64R .. 64R + 63 of a chunk's y, this warpgroup's 64 columns:
// C h^T scaled by exp(cum_i), plus (S o L o dt) x over the NJ causal columns.
// `mid` runs while C h^T and S are in flight, `late` while Y_diag is: work
// of the caller that needs neither (the state update's operands, its wgmma).
template <int Q, int P, int N, int R, typename Mid, typename Late>
__device__ __forceinline__ void y_tile(uint32_t sb, const float* f, uint32_t hhi, uint32_t hlo, bool carry, int wg,
                                       int r0, int c0, __nv_bfloat16* y_chunk, long long y_ss, Mid mid, Late late) {
    using L = Layout<Q, P, N>;
    constexpr int NJ = 64 * (R + 1);
    const float *cum = f, *ecum = f + Q, *dts = f + 3 * Q;
    const uint32_t c_rows = sb + L::C_OFF + R * 8192;
    float acc[32], s[NJ / 2];
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] = 0.0f;
    wgmma_fence();
    fence_regs<32>(acc);
    fence_regs<NJ / 2>(s);
    if (carry) issue_yoff<N>(acc, c_rows, L::XB, hhi, hlo);
    issue_s<NJ, N>(s, c_rows, sb + L::B_OFF, L::XB);
    wgmma_commit();
    mid();
    wgmma_wait_all();
    fence_regs<NJ / 2>(s);
    fence_regs<32>(acc);

    const int i_lo = 64 * R + r0, i_hi = i_lo + 8;
    const float e_lo = ecum[i_lo], e_hi = ecum[i_hi], cum_lo = cum[i_lo], cum_hi = cum[i_hi];
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] *= ((e / 2) & 1) ? e_hi : e_lo;
    // S o L o dt as A fragments: L_ij = exp(cum_i - cum_j) for j <= i, else 0
    uint32_t ahi[NJ / 4], alo[NJ / 4];
#pragma unroll
    for (int q = 0; q < NJ / 4; ++q) {
        const bool hi_row = q & 1;
        const int i = hi_row ? i_hi : i_lo;
        const float ci = hi_row ? cum_hi : cum_lo;
        const int j = 8 * (q / 2) + c0;
        const float v0 = j <= i ? s[2 * q] * expf(ci - cum[j]) * dts[j] : 0.0f;
        const float v1 = j + 1 <= i ? s[2 * q + 1] * expf(ci - cum[j + 1]) * dts[j + 1] : 0.0f;
        split2(v0, v1, ahi[q], alo[q]);
    }
    wgmma_fence();
    fence_regs<32>(acc);
    issue_ydiag<NJ>(acc, ahi, alo, sb + L::X_OFF + wg * L::XB, L::XB);
    wgmma_commit();
    late();
    wgmma_wait_all();
    fence_regs<32>(acc);
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
        const int row = 64 * R + r0 + 8 * ((e / 2) & 1);
        const int col = 64 * wg + 8 * (e / 4) + c0;
        *reinterpret_cast<__nv_bfloat162*>(y_chunk + row * y_ss + col) = __floats2bfloat162_rn(acc[e], acc[e + 1]);
    }
}

// One block per (head, batch row): P/64 consumer warpgroups, then the
// producer warp. y is (B, S, H, P) contiguous, h_out (B, H, P, N) f32; dt is
// read through its element strides; B and C are 4-D maps (N, G, S, B), the
// block reading its head's group of ng.
template <int Q, int P, int N>
__global__ void __launch_bounds__(Layout<Q, P, N>::NT, 1)
    ssd_tc(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_b,
           const __grid_constant__ CUtensorMap map_c, const float* __restrict__ dt, long long dt_sb,
           long long dt_ss, long long dt_sh, const float* __restrict__ a, __nv_bfloat16* __restrict__ y,
           float* __restrict__ h_out, int s, int nh, int ng) {
    using L = Layout<Q, P, N>;
    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem =
        reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    const uint32_t base = smem_u32(smem);
    const uint32_t bar = base + L::BAR_OFF;
    auto full = [&](int st) { return bar + 8u * st; };
    auto empty = [&](int st) { return bar + 8u * (L::STAGES + st); };
    const int head = blockIdx.x, b = blockIdx.y;
    const int nc = s / Q;

    if (threadIdx.x == 0) {
        for (int st = 0; st < L::STAGES; ++st) {
            mbar_init(full(st), 33);  // the expect_tx arrival, then the producer's 32 lanes
            mbar_init(empty(st), 128 * L::NWG);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    const int wg = threadIdx.x / 128;
    if (wg == L::NWG) {
        // ---- producer warp: TMA of x, B, C; dt and the in-chunk prefix ---------
        const int lane = threadIdx.x % 32;
        const int grp = head / (nh / ng);  // the head's SSM group
        const float ah = a[head];
        const float* dtp = dt + b * dt_sb + head * dt_sh;
        for (int c = 0; c < nc; ++c) {
            const int st = c % L::STAGES;
            if (c >= L::STAGES) mbar_wait(empty(st), ((c / L::STAGES) - 1) & 1);
            const uint32_t sb = base + st * L::STAGE;
            const int c0 = c * Q;
            if (lane == 0) {
                mbar_expect_tx(full(st), L::TX);
                for (int bx = 0; bx < P / 64; ++bx)
                    tma_load_4d(sb + L::X_OFF + bx * L::XB, &map_x, full(st), 64 * bx, head, c0, b);
                for (int bx = 0; bx < N / 64; ++bx) {
                    tma_load_4d(sb + L::B_OFF + bx * L::XB, &map_b, full(st), 64 * bx, grp, c0, b);
                    tma_load_4d(sb + L::C_OFF + bx * L::XB, &map_c, full(st), 64 * bx, grp, c0, b);
                }
            }
            float* f = reinterpret_cast<float*>(smem + st * L::STAGE + L::F_OFF);
            float *cum = f, *ecum = f + Q, *dtd = f + 2 * Q, *dts = f + 3 * Q;
            for (int t = lane; t < Q; t += 32) dts[t] = dtp[(long long)(c0 + t) * dt_ss];
            __syncwarp();
            if (lane == 0) {  // an ordered prefix, as cumsum sums in token order
                float acc = 0.0f;
                for (int t = 0; t < Q; ++t) {
                    acc = __fadd_rn(acc, __fmul_rn(dts[t], ah));
                    cum[t] = acc;
                }
            }
            __syncwarp();
            const float cend = cum[Q - 1];
            for (int t = lane; t < Q; t += 32) {
                ecum[t] = expf(cum[t]);
                dtd[t] = dts[t] * expf(cend - cum[t]);
            }
            mbar_arrive(full(st));
        }
    } else {
        // ---- consumer warpgroup wg: rows 64 wg .. 64 wg + 63 of h, columns of y ---
        const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
        const int r0 = 16 * warp + lane / 4, c0 = 2 * (lane % 4);
        unsigned char* hhi_p = smem + L::H_OFF + wg * 2 * L::HB;
        unsigned char* hlo_p = hhi_p + L::HB;
        const uint32_t hhi = smem_u32(hhi_p), hlo = hhi + L::HB;
        float h[N / 2];
#pragma unroll
        for (int e = 0; e < N / 2; ++e) h[e] = 0.0f;
        const long long y_ss = (long long)nh * P;
        __nv_bfloat16* yb = y + (long long)b * s * y_ss + (long long)head * P;

        for (int c = 0; c < nc; ++c) {
            const int st = c % L::STAGES;
            mbar_wait(full(st), (c / L::STAGES) & 1);
            const uint32_t sb = base + st * L::STAGE;
            const unsigned char* sp = smem + st * L::STAGE;
            const float* f = reinterpret_cast<const float*>(sp + L::F_OFF);
            __nv_bfloat16* y_chunk = yb + (long long)c * Q * y_ss;
            // h <- h exp(cum_{Q-1}) + (x dt exp(cum_{Q-1} - cum))^T B, its
            // operands built and its wgmma issued under the last y tile's
            uint32_t whi[Q / 4], wlo[Q / 4];
            auto build_w = [&] { load_w<Q>(whi, wlo, sp + L::X_OFF + wg * L::XB, f + 2 * Q, r0, c0); };
            auto update_h = [&] {
                const float decay = f[2 * Q - 1];  // exp(cum_{Q-1})
#pragma unroll
                for (int e = 0; e < N / 2; ++e) h[e] *= decay;
                wgmma_fence();
                fence_regs<N / 2>(h);
                issue_state<Q, N>(h, whi, wlo, sb + L::B_OFF, L::XB);
                wgmma_commit();
            };
            auto none = [] {};
            if constexpr (Q == 128) {
                y_tile<Q, P, N, 0>(sb, f, hhi, hlo, c > 0, wg, r0, c0, y_chunk, y_ss, none, none);
                y_tile<Q, P, N, 1>(sb, f, hhi, hlo, c > 0, wg, r0, c0, y_chunk, y_ss, build_w, update_h);
            } else {
                y_tile<Q, P, N, 0>(sb, f, hhi, hlo, c > 0, wg, r0, c0, y_chunk, y_ss, build_w, update_h);
            }
            fence_regs<N / 2>(h);
            mbar_arrive(empty(st));  // the stage is consumed
            if (c + 1 < nc) {
                warpgroup_sync(1 + wg);  // every warp is past this chunk's reads of the h tiles
                store_h<N>(h, hhi_p, hlo_p, r0, c0);
                fence_async_smem();
                warpgroup_sync(1 + wg);
            }
        }
        float* hp = h_out + (((long long)b * nh + head) * P + 64 * wg) * N;
#pragma unroll
        for (int e = 0; e < N / 2; e += 2) {
            const int p = r0 + 8 * ((e / 2) & 1);
            const int n = 8 * (e / 4) + c0;
            *reinterpret_cast<float2*>(hp + p * N + n) = make_float2(h[e], h[e + 1]);
        }
    }
}

// One tile of each product at the serving sizes (Q = P = 64, N = 128), for
// checking the descriptors, the swizzle and the fragments against a plain
// matrix product: for C, B (64, 128) and x (64, 64) bf16 and h (64, 128) f32,
// all contiguous: S = C B^T, Yo = C (h_hi + h_lo)^T, Yd = split(S) x (64 x 64)
// and dS = split(x)^T B (64 x 128), all f32. One warpgroup.
__global__ void __launch_bounds__(128)
    ssd_wgmma_tile(const __grid_constant__ CUtensorMap map_x, const __grid_constant__ CUtensorMap map_b,
                   const __grid_constant__ CUtensorMap map_c, const float* __restrict__ h_in,
                   float* __restrict__ s_out, float* __restrict__ yo_out, float* __restrict__ yd_out,
                   float* __restrict__ ds_out) {
    using L = Layout<64, 64, 128>;
    extern __shared__ unsigned char smem_raw[];
    unsigned char* smem =
        reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
    const uint32_t base = smem_u32(smem);
    const uint32_t bar = base + L::BAR_OFF;
    const int t = threadIdx.x, warp = t / 32, lane = t % 32;
    const int r0 = 16 * warp + lane / 4, c0 = 2 * (lane % 4);
    if (t == 0) {
        mbar_init(bar, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (t == 0) {
        mbar_expect_tx(bar, L::TX);
        tma_load_4d(base + L::X_OFF, &map_x, bar, 0, 0, 0, 0);
        for (int bx = 0; bx < 2; ++bx) {
            tma_load_4d(base + L::B_OFF + bx * L::XB, &map_b, bar, 64 * bx, 0, 0, 0);
            tma_load_4d(base + L::C_OFF + bx * L::XB, &map_c, bar, 64 * bx, 0, 0, 0);
        }
    }
    float* ones = reinterpret_cast<float*>(smem + L::F_OFF);
    if (t < 64) ones[t] = 1.0f;
    unsigned char* hhi_p = smem + L::H_OFF;
    float h[64];
#pragma unroll
    for (int e = 0; e < 64; ++e) h[e] = h_in[(r0 + 8 * ((e / 2) & 1)) * 128 + 8 * (e / 4) + c0 + (e % 2)];
    store_h<128>(h, hhi_p, hhi_p + L::HB, r0, c0);
    fence_async_smem();
    __syncthreads();
    mbar_wait(bar, 0);

    auto store = [&](float* out, const float* d, int width, int count) {
        for (int e = 0; e < count; ++e)
            out[(r0 + 8 * ((e / 2) & 1)) * width + 8 * (e / 4) + c0 + (e % 2)] = d[e];
    };
    float s[32], yo[32];
    wgmma_fence();
    fence_regs<32>(s);
    fence_regs<32>(yo);
    issue_s<64, 128>(s, base + L::C_OFF, base + L::B_OFF, L::XB);
    issue_yoff<128>(yo, base + L::C_OFF, L::XB, base + L::H_OFF, base + L::H_OFF + L::HB);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<32>(s);
    fence_regs<32>(yo);
    store(s_out, s, 64, 32);
    store(yo_out, yo, 64, 32);

    uint32_t ahi[16], alo[16];
#pragma unroll
    for (int q = 0; q < 16; ++q) split2(s[2 * q], s[2 * q + 1], ahi[q], alo[q]);
    float yd[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) yd[e] = 0.0f;
    wgmma_fence();
    fence_regs<32>(yd);
    issue_ydiag<64>(yd, ahi, alo, base + L::X_OFF, L::XB);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<32>(yd);
    store(yd_out, yd, 64, 32);

    uint32_t whi[16], wlo[16];
    load_w<64>(whi, wlo, smem + L::X_OFF, ones, r0, c0);
    float ds[64];
#pragma unroll
    for (int e = 0; e < 64; ++e) ds[e] = 0.0f;
    wgmma_fence();
    fence_regs<64>(ds);
    issue_state<64, 128>(ds, whi, wlo, base + L::B_OFF, L::XB);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<64>(ds);
    store(ds_out, ds, 128, 64);
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

// A bf16 tensor map of `rank` dims (innermost first) with byte strides of the
// outer dims; one box is 64 innermost elements (128 bytes, the swizzle's
// width) by `box` of the others.
int make_map(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims, const cuuint64_t* strides,
             const cuuint32_t* box) {
    EncodeTiled encode = encoder();
    if (encode == nullptr) return ERR_NO_ENCODER;
    const cuuint32_t elem[4] = {1, 1, 1, 1};
    CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), dims, strides, box,
                        elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : ERR_TENSOR_MAP;
}

// x (B, S, H, P) through element strides (batch, row, head); Q rows of 64
// columns of one head a box
int map_x(CUtensorMap* m, const void* x, int bsz, int s, int nh, int p, int q, const long long* st) {
    const cuuint64_t dims[4] = {(cuuint64_t)p, (cuuint64_t)nh, (cuuint64_t)s, (cuuint64_t)bsz};
    const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2, (cuuint64_t)st[0] * 2};
    const cuuint32_t box[4] = {64, 1, (cuuint32_t)q, 1};
    return make_map(m, x, 4, dims, strides, box);
}

// B or C (B, S, G, N) through element strides (batch, row, group); Q rows of
// 64 columns of one group a box
int map_bc(CUtensorMap* m, const void* bc, int bsz, int s, int ng, int n, int q, const long long* st) {
    const cuuint64_t dims[4] = {(cuuint64_t)n, (cuuint64_t)ng, (cuuint64_t)s, (cuuint64_t)bsz};
    const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2, (cuuint64_t)st[0] * 2};
    const cuuint32_t box[4] = {64, 1, (cuuint32_t)q, 1};
    return make_map(m, bc, 4, dims, strides, box);
}

// Once per instance: opt in to the shared memory.
template <int Q, int P, int N> int prepare() {
    static int state = -1;
    if (state < 0) {
        const cudaError_t err =
            cudaFuncSetAttribute(ssd_tc<Q, P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<Q, P, N>::ALLOC);
        if (err != cudaSuccess) return (int)err;
        state = 0;
    }
    return state;
}

// strides: x (batch, row, head), B (batch, row, group), C (batch, row, group),
// dt (batch, row, head)
template <int Q, int P, int N>
int launch(const void* x, const void* dt, const void* a, const void* bm, const void* cm, void* y, void* h,
           const long long* st, int bsz, int s, int nh, int ng, cudaStream_t stream) {
    int err = prepare<Q, P, N>();
    if (err) return err;
    CUtensorMap mx, mb, mc;
    if ((err = map_x(&mx, x, bsz, s, nh, P, Q, st))) return err;
    if ((err = map_bc(&mb, bm, bsz, s, ng, N, Q, st + 3))) return err;
    if ((err = map_bc(&mc, cm, bsz, s, ng, N, Q, st + 6))) return err;
    const dim3 grid(nh, bsz);
    ssd_tc<Q, P, N><<<grid, Layout<Q, P, N>::NT, Layout<Q, P, N>::ALLOC, stream>>>(
        mx, mb, mc, static_cast<const float*>(dt), st[9], st[10], st[11], static_cast<const float*>(a),
        static_cast<__nv_bfloat16*>(y), static_cast<float*>(h), s, nh, ng);
    return (int)cudaGetLastError();
}

template <int Q, int P>
int launch_n(int n, const void* x, const void* dt, const void* a, const void* bm, const void* cm, void* y, void* h,
             const long long* st, int bsz, int s, int nh, int ng, cudaStream_t stream) {
    switch (n) {
        case 64: return launch<Q, P, 64>(x, dt, a, bm, cm, y, h, st, bsz, s, nh, ng, stream);
        case 128: return launch<Q, P, 128>(x, dt, a, bm, cm, y, h, st, bsz, s, nh, ng, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

template <int Q>
int launch_pn(int p, int n, const void* x, const void* dt, const void* a, const void* bm, const void* cm, void* y,
              void* h, const long long* st, int bsz, int s, int nh, int ng, cudaStream_t stream) {
    switch (p) {
        case 64: return launch_n<Q, 64>(n, x, dt, a, bm, cm, y, h, st, bsz, s, nh, ng, stream);
        case 128: return launch_n<Q, 128>(n, x, dt, a, bm, cm, y, h, st, bsz, s, nh, ng, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

int tile(const void* c, const void* bm, const void* x, const void* h, float* s_out, float* yo_out, float* yd_out,
         float* ds_out, cudaStream_t stream) {
    using L = Layout<64, 64, 128>;
    static int state = -1;
    if (state < 0) {
        const cudaError_t err =
            cudaFuncSetAttribute(ssd_wgmma_tile, cudaFuncAttributeMaxDynamicSharedMemorySize, L::ALLOC);
        if (err != cudaSuccess) return (int)err;
        state = 0;
    }
    const long long st_x[3] = {64 * 64, 64, 64}, st_bc[3] = {64 * 128, 128, 128};
    CUtensorMap mx, mb, mc;
    int err;
    if ((err = map_x(&mx, x, 1, 64, 1, 64, 64, st_x))) return err;
    if ((err = map_bc(&mb, bm, 1, 64, 1, 128, 64, st_bc))) return err;
    if ((err = map_bc(&mc, c, 1, 64, 1, 128, 64, st_bc))) return err;
    ssd_wgmma_tile<<<1, 128, L::ALLOC, stream>>>(mx, mb, mc, static_cast<const float*>(h), s_out, yo_out, yd_out,
                                                 ds_out);
    return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// Shared memory (bytes) the CUDA-core route asks for at chunk q, head dim p, state n.
extern "C" size_t ssd_smem_bytes(int q, int p, int n) { return cc::smem_floats(q, p, n) * sizeof(float); }

// The CUDA-core route. x_dtype, bc_dtype: 0 float32, 1 bfloat16; every
// tensor contiguous, B and C (B, S, ng, N) with ng dividing nh. pb: the
// head-dim columns one block takes (1 <= pb <= p; ceil(p / pb) blocks per
// (head, batch row), each sized for pb). Returns cudaGetLastError() of the
// launch (0 on success); never synchronises.
extern "C" int ssd_launch(const void* x, const void* dt, const void* a, const void* bm,
                          const void* cm, void* y, void* h, int x_dtype, int bc_dtype, int bsz,
                          int s, int nh, int ng, int p, int n, int q, int pb, void* stream) {
    if (q <= 0 || q > cc::MAX_DIM || p <= 0 || p > cc::MAX_DIM || n <= 0 || n > cc::MAX_DIM || s % q ||
        pb <= 0 || pb > p || ng <= 0 || nh % ng)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (x_dtype) {
        case 0: return cc::launch_bc<float>(x, dt, a, bm, cm, y, h, bc_dtype, bsz, s, nh, ng, p, n, q, pb, st);
        case 1:
            return cc::launch_bc<__nv_bfloat16>(x, dt, a, bm, cm, y, h, bc_dtype, bsz, s, nh, ng, p, n, q, pb,
                                                st);
        default: return (int)cudaErrorInvalidValue;
    }
}

// The tensor-core route: x, B, C bf16 and q, p, n each 64 or 128, read
// through element strides (12: x batch, row, head; B batch, row, group; C
// batch, row, group; dt batch, row, head), the last dim of x, B and C
// contiguous, B and C (B, S, ng, N) with ng dividing nh; y (B, S, H, P)
// bf16 and h (B, H, P, N) f32 contiguous. Returns as above.
extern "C" int ssd_tc_launch(const void* x, const void* dt, const void* a, const void* bm, const void* cm, void* y,
                             void* h, const long long* strides, int bsz, int s, int nh, int ng, int p, int n, int q,
                             void* stream) {
    if (s % q || ng <= 0 || nh % ng) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (q) {
        case 64: return tc::launch_pn<64>(p, n, x, dt, a, bm, cm, y, h, strides, bsz, s, nh, ng, st);
        case 128: return tc::launch_pn<128>(p, n, x, dt, a, bm, cm, y, h, strides, bsz, s, nh, ng, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

// One wgmma tile of each product of the tensor-core route (see
// tc::ssd_wgmma_tile): c, b (64, 128) and x (64, 64) contiguous bf16, h
// (64, 128) f32; s_out, yo_out, yd_out (64, 64) and ds_out (64, 128) f32.
extern "C" int ssd_wgmma_tile(const void* c, const void* b, const void* x, const void* h, void* s_out,
                              void* yo_out, void* yd_out, void* ds_out, void* stream) {
    return tc::tile(c, b, x, h, static_cast<float*>(s_out), static_cast<float*>(yo_out),
                    static_cast<float*>(yd_out), static_cast<float*>(ds_out), static_cast<cudaStream_t>(stream));
}

extern "C" const char* ssd_error_string(int err) {
    switch (err) {
        case ERR_NO_ENCODER: return "cuTensorMapEncodeTiled not found through cudaGetDriverEntryPoint";
        case ERR_TENSOR_MAP: return "cuTensorMapEncodeTiled refused a tensor map (strides or alignment)";
        default: return cudaGetErrorString(static_cast<cudaError_t>(err));
    }
}
