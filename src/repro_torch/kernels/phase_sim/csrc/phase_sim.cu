// FARSI phase-driven simulator: one candidate design per thread block.
//
// Replaces the Pallas TPU kernel `_phase_sim_kernel`
// (src/repro/kernels/phase_sim/kernel.py), launched there by
// `phase_sim_batch`. It computes the same function: per candidate, at most
// T phases of ready-set scheduling, PE / MEM co-residency shares (Eq. 1/2/4),
// per-NoC rank-residue link striping (Eq. 3), the Eq.-6 phase length and the
// per-task bottleneck codes, then the per-slot bottleneck seconds and the
// Eq.-7 energy / power / area / fitness rollup.
//
// What bounds it on an H100: neither bytes nor operations. A candidate's rows
// are a few hundred bytes and its arithmetic is O(phases * T^2) f32 ops, both
// far below the card's rates; the time is the latency of a serial phase loop
// (each phase depends on the last) with a handful of block barriers and
// O(T) shared-memory sweeps per phase. The design answers with parallelism
// across candidates, not inside one: one block per candidate (grid = B),
// one thread per task (T padded up to a multiple of 32, so the AR workloads
// are one warp), so a B = 4096 population is ~4096 independent blocks in
// flight at once on 132 SMs. Per-candidate state (task maps, running set,
// ranks, per-task terms) lives in shared memory; the workload arrays, shared
// by every block, are read from global memory and stay in L2. The phase loop
// stops at the first phase in which no task runs: every later phase of the
// reference is a zero-length no-op.
//
// Numerics follow the plain PyTorch version (ref.py) operation by operation:
// every constant is a float literal, the file is built without fast math and
// with -fmad=false so products and sums round separately, contention and
// link-load sums run in task-index order in the thread that owns the result,
// ranks are integers, and argmax keeps the first index on ties.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float BIG = 1e30f;
constexpr float TINY = 1e-30f;
constexpr int N_SCAL = 14;      // core/scal_layout.py SCAL_COLS
constexpr int N_NOCS = 4;       // noc_pj, power_budget, area_budget, alpha
constexpr int MAX_NOC = 8;      // core/phase_sim_torch.py MAX_NOC
constexpr int LINK_ONEHOT = 8;  // link ladder tops out at 8 channels
constexpr unsigned FULL = 0xffffffffu;

// owner threads of the per-candidate accumulators (blockDim >= 32 > 5 + 8)
constexpr int OWN_ALP = 0;
constexpr int OWN_TRAFFIC = 1;
constexpr int OWN_KIND = 2;  // 2, 3, 4: kind_s[pe, mem, noc]
constexpr int OWN_NOC = 5;   // 5 .. 5 + N - 1: noc_bt[k]
constexpr int N_ACC = OWN_NOC + MAX_NOC;

struct Params {
  // workload (shared by every block), T entries / T x T
  const float* work;
  const float* rd;
  const float* wr;
  const float* burst;
  const uint8_t* pmask;  // [i * T + j] = 1 iff j is a parent of i
  const int* wl_id;
  // per candidate rows, row-major with the given widths
  const int* task_pe;    // (B, T)
  const int* task_mem;   // (B, T)
  const float* accel;    // (B, T)
  const float* pe_peak;  // (B, S_pe)
  const float* pe_pj;
  const float* pe_leak;
  const float* pe_area;
  const int* pe_noc;
  const float* pe_active;
  const float* mem_bw;   // (B, S_mem)
  const float* mem_pj;
  const float* mem_leak;
  const float* mem_af;
  const float* mem_amb;
  const int* mem_noc;
  const float* mem_active;
  const float* noc_bw;   // (B, N)
  const int* noc_links;
  const float* noc_leak;
  const float* noc_area;
  const float* noc_active;
  const float* nocs;     // (B, N_NOCS)
  const float* wlbud;    // (B, NW)
  // one packed output row per candidate (see kernel.py out_layout):
  // scal(14) | pe_b(S_pe) | mem_b(S_mem) | noc_b(N) | wl_lat(NW) |
  // finish(T) | bneck code(T, int32 bits)
  float* out;
  int out_stride;
  int B, T, S_pe, S_mem, N, NW;
};

__device__ __forceinline__ float block_min(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(FULL, v, o));
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  if (lane == 0) red[wid] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < nw; ++w) r = fminf(r, red[w]);
  __syncthreads();
  return r;
}

// inclusive prefix sum of a 0/1 flag over the block (the running-order rank)
__device__ __forceinline__ int block_rank(int v, int* red) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(FULL, v, o);
    if (lane >= o) v += n;
  }
  if (lane == 31) red[wid] = v;
  __syncthreads();
  int off = 0;
  for (int w = 0; w < wid; ++w) off += red[w];
  __syncthreads();
  return v + off;
}

__global__ void __launch_bounds__(1024) phase_sim_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tp = blockDim.x;
  const int i = threadIdx.x;
  const int b = blockIdx.x;
  const int T = p.T;
  const int N = p.N;
  const int s_max = max(max(p.S_pe, p.S_mem), tp);

  int* s_pe = reinterpret_cast<int*>(smem_raw);  // task -> PE slot
  int* s_mem = s_pe + tp;                         // task -> MEM slot
  int* s_run = s_mem + tp;                        // running this phase
  int* s_done = s_run + tp;                       // completed
  int* s_link = s_done + tp;                      // rank / link of a user
  int* s_code = s_link + tp;                      // bottleneck code, -1 idle
  int* s_arg = s_code + tp;                       // binding NoC index
  int* s_redi = s_arg + tp;                       // 32
  float* s_brun = reinterpret_cast<float*>(s_redi + 32);  // burst if running
  float* s_f0 = s_brun + tp;   // 1/load, later pe_bt
  float* s_f1 = s_f0 + tp;     // traffic term, later mem_bt
  float* s_f2 = s_f1 + tp;     // dynamic pJ term
  float* s_fin = s_f2 + tp;    // finish times
  float* s_slot0 = s_fin + tp;     // pe_b per slot
  float* s_slot1 = s_slot0 + s_max;  // mem_b per slot
  float* s_slot2 = s_slot1 + s_max;  // mem area term per slot
  float* s_redf = s_slot2 + s_max;   // 32
  float* s_acc = s_redf + 32;        // N_ACC

  const bool live = i < T;
  const size_t rt = (size_t)b * T;
  const int pe_i = live ? p.task_pe[rt + i] : 0;
  const int mem_i = live ? p.task_mem[rt + i] : 0;
  s_pe[i] = pe_i;
  s_mem[i] = mem_i;

  const float* pe_peak = p.pe_peak + (size_t)b * p.S_pe;
  const float* mem_bw = p.mem_bw + (size_t)b * p.S_mem;
  const float* noc_bw = p.noc_bw + (size_t)b * N;
  const int* noc_links = p.noc_links + (size_t)b * N;

  const float work_i = live ? p.work[i] : 0.0f;
  const float rd_i = live ? p.rd[i] : 0.0f;
  const float wr_i = live ? p.wr[i] : 0.0f;
  const float burst_i = live ? p.burst[i] : 0.0f;
  const float accel_i = live ? p.accel[rt + i] : 1.0f;
  const float peak_eff = pe_peak[pe_i] * accel_i;
  const float mem_peak = mem_bw[mem_i];
  // chain routing: the route is the chain-index interval between the
  // task's PE attachment and its MEM attachment
  const int pe_pos = p.pe_noc[(size_t)b * p.S_pe + pe_i];
  const int mem_pos = p.mem_noc[(size_t)b * p.S_mem + mem_i];
  const int lo = min(pe_pos, mem_pos);
  const int hi = max(pe_pos, mem_pos);
  const float hops = (float)(hi - lo + 1);

  // padded tasks are born completed: they never run, never enter a share
  int done_i = live ? 0 : 1;
  float rem_ops = work_i, rem_rd = rd_i, rem_wr = wr_i;
  float finish = 0.0f, pe_bt = 0.0f, mem_bt = 0.0f;
  int bneck = 0, bneck_noc = 0;
  float now = 0.0f;
  int nph = 0;
  float acc = 0.0f;  // the accumulator this thread owns, if any
  s_done[i] = done_i;
  __syncthreads();

  for (int ph = 0; ph < T; ++ph) {
    // ---- ready set: no incomplete parent --------------------------------
    int run = 0;
    if (!done_i) {
      run = 1;
      const uint8_t* row = p.pmask + (size_t)i * T;
      for (int j = 0; j < T; ++j) {
        if (row[j] && !s_done[j]) { run = 0; break; }
      }
    }
    s_run[i] = run;
    s_brun[i] = run ? burst_i : 0.0f;
    __syncthreads();

    // ---- Eq. 1/2 PE share, Eq. 4 memory share (index-order sums) -------
    float load = 0.0f, mem_t = 0.0f;
    if (run) {
      for (int j = 0; j < T; ++j) {
        if (s_pe[j] == pe_i) load += (float)s_run[j];
        if (s_mem[j] == mem_i) mem_t += s_brun[j];
      }
    }
    const float compute = peak_eff / fmaxf(load, 1.0f);
    const float m_bw = (mem_peak * burst_i) / fmaxf(mem_t, TINY);

    // ---- Eq. 3: rank-residue link striping, min over the route ---------
    float n_bw = BIG;
    int arg = 0;
    if (N == 1) {
      const int rank = block_rank(run, s_redi);
      s_link[i] = rank;
      __syncthreads();
      if (run) {
        const int L = max(noc_links[0], 1);
        float link_t = 0.0f;
        for (int j = 0; j < T; ++j) {
          if (s_run[j] && (rank - s_link[j]) % L == 0) link_t += s_brun[j];
        }
        n_bw = (noc_bw[0] * burst_i) / fmaxf(link_t, TINY);
      }
    } else {
      for (int k = 0; k < N; ++k) {
        const int use = run && lo <= k && k <= hi;
        const int rank = block_rank(use, s_redi);
        const int L = max(noc_links[k], 1);
        // user u's link is (rank_u - 1) mod L; the link one-hot has 8 columns
        const int lk = use ? (rank - 1) % L : -1;
        s_link[i] = lk < LINK_ONEHOT ? lk : -1;
        __syncthreads();
        if (use) {
          const int mine = s_link[i];
          float link_t = 0.0f;
          if (mine >= 0) {
            for (int j = 0; j < T; ++j) {
              if (s_link[j] == mine) link_t += s_brun[j];
            }
          }
          const float bw_k = (noc_bw[k] * burst_i) / fmaxf(link_t, TINY);
          if (bw_k < n_bw) { n_bw = bw_k; arg = k; }
        }
        __syncthreads();
      }
    }

    // ---- Eq. 6: phase length = min completion time over running tasks --
    const float bw = fminf(m_bw, n_bw);
    float c_t = BIG;
    if (run) {
      const float comp_t = rem_ops / compute;
      const float comm_t = fmaxf(rem_rd, rem_wr) / bw;
      c_t = fmaxf(comp_t, comm_t);
    }
    const float phi = block_min(c_t, s_redf);
    if (!(phi < BIG * 0.5f)) break;  // nothing runs: every task is done

    // ---- binding resource, drain, retire --------------------------------
    int code = -1;
    float inv_load = 0.0f, traffic_i = 0.0f;
    if (run) {
      const float tot_comp_t = work_i / compute;
      const float tot_comm_t = fmaxf(rd_i, wr_i) / bw;
      code = tot_comp_t >= tot_comm_t ? 0 : (m_bw <= n_bw ? 1 : 2);
      if (code == 0) pe_bt = pe_bt + phi;
      if (code == 1) mem_bt = mem_bt + phi;
      const float d_ops = compute * phi;
      const float d_bw = bw * phi;
      const float dr_ops = fmaxf(rem_ops - d_ops, 0.0f);
      const float dr_rd = fmaxf(rem_rd - d_bw, 0.0f);
      const float dr_wr = fmaxf(rem_wr - d_bw, 0.0f);
      traffic_i = fminf(dr_rd + dr_wr, d_bw + d_bw);
      inv_load = 1.0f / fmaxf(load, 1.0f);
      // c_t <= phi * (1 + 1e-9) in f32: the factor rounds to exactly 1.0f
      if (c_t <= phi * (1.0f + 1e-9f)) {
        done_i = 1;
        finish = now + phi;
        bneck = code;
        bneck_noc = arg;
        rem_ops = 0.0f; rem_rd = 0.0f; rem_wr = 0.0f;
      } else {
        rem_ops = dr_ops; rem_rd = dr_rd; rem_wr = dr_wr;
      }
    }
    now = now + phi;
    nph += 1;
    s_code[i] = code;
    s_arg[i] = arg;
    s_f0[i] = inv_load;
    s_f1[i] = traffic_i;
    __syncthreads();

    // ---- per-candidate sums, each in index order by its owner thread ---
    if (i == OWN_ALP) {
      float s = 0.0f;
      for (int j = 0; j < T; ++j) s += s_f0[j];
      acc = acc + phi * s;
    } else if (i == OWN_TRAFFIC) {
      float s = 0.0f;
      for (int j = 0; j < T; ++j) s += s_f1[j];
      acc = acc + s;
    } else if (i >= OWN_KIND && i < OWN_KIND + 3) {
      const int c = i - OWN_KIND;
      float s = 0.0f;
      for (int j = 0; j < T; ++j) s += s_code[j] == c ? phi : 0.0f;
      acc = acc + s;
    } else if (N > 1 && i >= OWN_NOC && i < OWN_NOC + N) {
      const int k = i - OWN_NOC;
      float s = 0.0f;
      for (int j = 0; j < T; ++j) s += (s_code[j] == 2 && s_arg[j] == k) ? phi : 0.0f;
      acc = acc + s;
    }
    s_done[i] = done_i;
    __syncthreads();
  }

  // ---- after the loop: per-slot bottleneck seconds ----------------------
  const int all_done = __syncthreads_and(done_i);
  s_f0[i] = pe_bt;
  s_f1[i] = mem_bt;
  s_fin[i] = finish;
  const float rw = rd_i + wr_i;
  const float pe_pj = p.pe_pj[(size_t)b * p.S_pe + pe_i];
  const float mem_pj = p.mem_pj[(size_t)b * p.S_mem + mem_i];
  const float noc_pj = p.nocs[(size_t)b * N_NOCS + 0];
  s_f2[i] = live ? pe_pj * work_i + (mem_pj + noc_pj * hops) * rw : 0.0f;
  if (i < N_ACC) s_acc[i] = acc;
  __syncthreads();

  float* out = p.out + (size_t)b * p.out_stride;
  const int o_pe = N_SCAL;
  const int o_mem = o_pe + p.S_pe;
  const int o_noc = o_mem + p.S_mem;
  const int o_wl = o_noc + N;
  const int o_fin = o_wl + p.NW;
  const int o_bn = o_fin + T;
  for (int s = i; s < p.S_pe; s += tp) {
    float v = 0.0f;
    for (int j = 0; j < T; ++j) v += s_pe[j] == s ? s_f0[j] : 0.0f;
    s_slot0[s] = v;
    out[o_pe + s] = v;
  }
  const float* mem_af = p.mem_af + (size_t)b * p.S_mem;
  const float* mem_amb = p.mem_amb + (size_t)b * p.S_mem;
  const float* mem_active = p.mem_active + (size_t)b * p.S_mem;
  for (int s = i; s < p.S_mem; s += tp) {
    float v = 0.0f, cap = 0.0f;
    for (int j = 0; j < T; ++j) {
      if (s_mem[j] == s) {
        v += s_f1[j];
        cap += p.wr[j];
      }
    }
    s_slot1[s] = v;
    out[o_mem + s] = v;
    s_slot2[s] = (mem_af[s] + mem_amb[s] * fmaxf(cap, 1.0f) / 1e6f) * mem_active[s];
  }
  for (int k = i; k < N; k += tp) {
    out[o_noc + k] = N == 1 ? s_acc[OWN_KIND + 2] : s_acc[OWN_NOC + k];
  }
  if (live) {
    out[o_fin + i] = finish;
    const int packed = bneck == 2 ? 2 + 3 * bneck_noc : bneck;
    out[o_bn + i] = __int_as_float(packed);
  }
  __syncthreads();

  // ---- Eq.-7 rollup: one thread, every sum in index order ---------------
  if (i == 0) {
    float dyn_pj = 0.0f;
    for (int j = 0; j < T; ++j) dyn_pj += s_f2[j];
    const float* pl = p.pe_leak + (size_t)b * p.S_pe;
    const float* pa = p.pe_active + (size_t)b * p.S_pe;
    const float* pr = p.pe_area + (size_t)b * p.S_pe;
    const float* ml = p.mem_leak + (size_t)b * p.S_mem;
    const float* nl = p.noc_leak + (size_t)b * N;
    const float* nr = p.noc_area + (size_t)b * N;
    const float* na = p.noc_active + (size_t)b * N;
    float leak_pe = 0.0f, leak_mem = 0.0f, leak_noc = 0.0f;
    float area_pe = 0.0f, area_mem = 0.0f, area_noc = 0.0f;
    for (int s = 0; s < p.S_pe; ++s) {
      leak_pe += pl[s] * pa[s];
      area_pe += pr[s] * pa[s];
    }
    for (int s = 0; s < p.S_mem; ++s) {
      leak_mem += ml[s] * mem_active[s];
      area_mem += s_slot2[s];
    }
    for (int k = 0; k < N; ++k) {
      leak_noc += nl[k] * na[k];
      area_noc += nr[k] * na[k];
    }
    const float leak_w = leak_pe + leak_mem + leak_noc;
    const float energy = dyn_pj * 1e-12f + leak_w * now;
    const float power = now > 0.0f ? energy / fmaxf(now, TINY) : 0.0f;
    const float area = area_pe + area_mem + area_noc;

    const float* bud = p.wlbud + (size_t)b * p.NW;
    float d0 = -BIG;
    for (int w = 0; w < p.NW; ++w) {
      float lat = 0.0f;
      for (int j = 0; j < T; ++j) {
        if (p.wl_id[j] == w) lat = fmaxf(lat, s_fin[j]);
      }
      out[o_wl + w] = lat;
      d0 = fmaxf(d0, (lat - bud[w]) / bud[w]);
    }
    const float* nocs = p.nocs + (size_t)b * N_NOCS;
    const float d1 = (power - nocs[1]) / nocs[1];
    const float d2 = (area - nocs[2]) / nocs[2];
    const float alpha = nocs[3];
    const float f0 = d0 > 0.0f ? d0 : alpha * d0;
    const float f1 = d1 > 0.0f ? d1 : alpha * d1;
    const float f2 = d2 > 0.0f ? d2 : alpha * d2;
    const float fitness = f0 + f1 + f2;

    int top_pe = 0, top_mem = 0;
    for (int s = 1; s < p.S_pe; ++s) {
      if (s_slot0[s] > s_slot0[top_pe]) top_pe = s;
    }
    for (int s = 1; s < p.S_mem; ++s) {
      if (s_slot1[s] > s_slot1[top_mem]) top_mem = s;
    }
    out[0] = now;
    out[1] = energy;
    out[2] = power;
    out[3] = area;
    out[4] = fitness;
    out[5] = s_acc[OWN_ALP];
    out[6] = s_acc[OWN_TRAFFIC];
    out[7] = (float)nph;
    out[8] = all_done ? 1.0f : 0.0f;
    out[9] = s_acc[OWN_KIND + 0];
    out[10] = s_acc[OWN_KIND + 1];
    out[11] = s_acc[OWN_KIND + 2];
    out[12] = (float)top_pe;
    out[13] = (float)top_mem;
  }
}

size_t smem_bytes(int tp, int s_pe, int s_mem) {
  const int s_max = s_pe > s_mem ? (s_pe > tp ? s_pe : tp) : (s_mem > tp ? s_mem : tp);
  return sizeof(int) * (7 * (size_t)tp + 32) +
         sizeof(float) * (5 * (size_t)tp + 3 * (size_t)s_max + 32 + N_ACC);
}

}  // namespace

extern "C" {

// Launch one block per candidate on `stream`. Returns cudaGetLastError()
// after the launch (0 on success); arguments out of range give
// cudaErrorInvalidValue without launching.
int phase_sim_launch(
    const void* work, const void* rd, const void* wr, const void* burst,
    const void* pmask, const void* wl_id,
    const void* task_pe, const void* task_mem, const void* accel,
    const void* pe_peak, const void* pe_pj, const void* pe_leak,
    const void* pe_area, const void* pe_noc, const void* pe_active,
    const void* mem_bw, const void* mem_pj, const void* mem_leak,
    const void* mem_af, const void* mem_amb, const void* mem_noc,
    const void* mem_active,
    const void* noc_bw, const void* noc_links, const void* noc_leak,
    const void* noc_area, const void* noc_active,
    const void* nocs, const void* wlbud,
    void* out, int out_stride,
    int B, int T, int S_pe, int S_mem, int N, int NW, int threads,
    void* stream) {
  if (B <= 0 || T <= 0 || T > threads || threads > 1024 || threads % 32 != 0 ||
      N < 1 || N > MAX_NOC || S_pe < 1 || S_mem < 1 || NW < 1) {
    return (int)cudaErrorInvalidValue;
  }
  Params p;
  p.work = static_cast<const float*>(work);
  p.rd = static_cast<const float*>(rd);
  p.wr = static_cast<const float*>(wr);
  p.burst = static_cast<const float*>(burst);
  p.pmask = static_cast<const uint8_t*>(pmask);
  p.wl_id = static_cast<const int*>(wl_id);
  p.task_pe = static_cast<const int*>(task_pe);
  p.task_mem = static_cast<const int*>(task_mem);
  p.accel = static_cast<const float*>(accel);
  p.pe_peak = static_cast<const float*>(pe_peak);
  p.pe_pj = static_cast<const float*>(pe_pj);
  p.pe_leak = static_cast<const float*>(pe_leak);
  p.pe_area = static_cast<const float*>(pe_area);
  p.pe_noc = static_cast<const int*>(pe_noc);
  p.pe_active = static_cast<const float*>(pe_active);
  p.mem_bw = static_cast<const float*>(mem_bw);
  p.mem_pj = static_cast<const float*>(mem_pj);
  p.mem_leak = static_cast<const float*>(mem_leak);
  p.mem_af = static_cast<const float*>(mem_af);
  p.mem_amb = static_cast<const float*>(mem_amb);
  p.mem_noc = static_cast<const int*>(mem_noc);
  p.mem_active = static_cast<const float*>(mem_active);
  p.noc_bw = static_cast<const float*>(noc_bw);
  p.noc_links = static_cast<const int*>(noc_links);
  p.noc_leak = static_cast<const float*>(noc_leak);
  p.noc_area = static_cast<const float*>(noc_area);
  p.noc_active = static_cast<const float*>(noc_active);
  p.nocs = static_cast<const float*>(nocs);
  p.wlbud = static_cast<const float*>(wlbud);
  p.out = static_cast<float*>(out);
  p.out_stride = out_stride;
  p.B = B;
  p.T = T;
  p.S_pe = S_pe;
  p.S_mem = S_mem;
  p.N = N;
  p.NW = NW;
  const size_t smem = smem_bytes(threads, S_pe, S_mem);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        phase_sim_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  phase_sim_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

const char* phase_sim_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
