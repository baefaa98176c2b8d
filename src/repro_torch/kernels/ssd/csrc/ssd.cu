// Mamba-2 SSD chunk scan for Hopper (sm_90a), all arithmetic in f32.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/ssd/kernel.py::_ssd_kernel
// and computes what it computes, chunk by chunk of Q tokens, for one batch
// row and one head (a = A of the head, one SSM group shared by all heads):
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
// 3.0 GFLOP, 3.0 us at the 989 TFLOP/s bf16 peak, so the function is bound
// by bytes, and a tensor-core kernel could come near that bound. This first
// design does not aim at it:
//   - the TPU kernel carries h in VMEM across a sequential grid axis of
//     chunks; blocks on the GPU carry nothing between them, so one block per
//     (head, batch row) loops over the chunks itself, with h in shared
//     memory: 128 blocks at the serving shape, about one wave on 132 SMs,
//     each serial over S / Q chunks;
//   - every product is f32 FMAs on the CUDA cores (67 TFLOP/s at best), read
//     from shared memory, so one code path serves bf16 and f32 inputs at the
//     reference's bars; no wgmma, no TMA;
//   - B and C are shared by all heads but each block loads them again (from
//     L2 after the first); chunks are not processed in parallel.
// What it does do: x, dt, B, C are read once per block, y is written once,
// the Q x Q decay-masked C.B^T never leaves shared memory, and h reaches
// device memory once, at the end.
//
// Layout: x, y (B, S, H, P); dt (B, S, H) f32; a (H,) f32; B, C (B, S, N);
// h (B, H, P, N) f32; all contiguous. x and y f32 or bf16, B and C f32 or
// bf16 (independently). Q <= 128, P <= 128, N <= 128, Q divides S. One
// block of 256 threads per (head, batch row); thread (ty, tx) =
// (tid / 16, tid % 16). Shared memory per block, in f32: B and C (Q rows of
// N + 1), xdt (Q x P), a tile of RT rows of the decay-masked C.B^T (RT x
// (Q + 1)), h (P rows of N + 1), and dt, cum, exp(cum), exp(cum_{Q-1} - cum)
// (Q each): 216 KB at Q=128, P=64, N=128, 125 KB at Q=64, so the block opts
// in to dynamic shared memory above 48 KB. The odd row strides put the 16
// rows a half-warp reads at one column in 16 different banks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int NT = 256;       // threads per block
constexpr int RT = 32;        // rows of the C.B^T tile
constexpr int MAX_DIM = 128;  // the largest Q, P and N
constexpr int SPAN = MAX_DIM / 16;  // columns a thread owns at the largest width

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
    return __float2bfloat16_rn(x);
}

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
                                                     int s, int nh, int p, int n, int q) {
    extern __shared__ __align__(16) float smem[];
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
            bs[t * ldn + k] = to_f32(bm[(tok0 + t) * n + k]);
            cs[t * ldn + k] = to_f32(cm[(tok0 + t) * n + k]);
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
            xs[e] = to_f32(x[((tok0 + t) * nh + head) * p + k]) * dts[t];
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
                    TX* yrow = y + ((tok0 + i) * nh + head) * p;
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
    float* hp = hout + ((size_t)b * nh + head) * p * n;
    for (int e = tid; e < p * n; e += NT) {
        const int pp = e / n, k = e - pp * n;
        hp[e] = hs[pp * ldn + k];
    }
}

template <typename TX, typename TBC>
int launch_typed(const void* x, const void* dt, const void* a, const void* bm, const void* cm,
                 void* y, void* h, int bsz, int s, int nh, int p, int n, int q,
                 cudaStream_t stream) {
    const size_t smem = smem_floats(q, p, n) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(ssd_chunk_scan<TX, TBC>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(nh, bsz);
    ssd_chunk_scan<TX, TBC><<<grid, NT, smem, stream>>>(
        static_cast<const TX*>(x), static_cast<const float*>(dt), static_cast<const float*>(a),
        static_cast<const TBC*>(bm), static_cast<const TBC*>(cm), static_cast<TX*>(y),
        static_cast<float*>(h), s, nh, p, n, q);
    return (int)cudaGetLastError();
}

template <typename TX>
int launch_bc(const void* x, const void* dt, const void* a, const void* bm, const void* cm,
              void* y, void* h, int bc_dtype, int bsz, int s, int nh, int p, int n, int q,
              cudaStream_t stream) {
    switch (bc_dtype) {
        case 0: return launch_typed<TX, float>(x, dt, a, bm, cm, y, h, bsz, s, nh, p, n, q, stream);
        case 1:
            return launch_typed<TX, __nv_bfloat16>(x, dt, a, bm, cm, y, h, bsz, s, nh, p, n, q, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// Shared memory (bytes) the kernel asks for at chunk q, head dim p, state n.
extern "C" size_t ssd_smem_bytes(int q, int p, int n) { return smem_floats(q, p, n) * sizeof(float); }

// x_dtype, bc_dtype: 0 float32, 1 bfloat16. Returns cudaGetLastError() of
// the launch (0 on success); never synchronises.
extern "C" int ssd_launch(const void* x, const void* dt, const void* a, const void* bm,
                          const void* cm, void* y, void* h, int x_dtype, int bc_dtype, int bsz,
                          int s, int nh, int p, int n, int q, void* stream) {
    if (q <= 0 || q > MAX_DIM || p <= 0 || p > MAX_DIM || n <= 0 || n > MAX_DIM || s % q)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    switch (x_dtype) {
        case 0: return launch_bc<float>(x, dt, a, bm, cm, y, h, bc_dtype, bsz, s, nh, p, n, q, st);
        case 1:
            return launch_bc<__nv_bfloat16>(x, dt, a, bm, cm, y, h, bc_dtype, bsz, s, nh, p, n, q, st);
        default: return (int)cudaErrorInvalidValue;
    }
}

extern "C" const char* ssd_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
