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
// are a few hundred bytes and its arithmetic is far below the card's rates;
// the time is the latency of a serial phase loop (each phase depends on the
// last). So the design cuts the latency of one phase, and runs candidates in
// parallel: one block per candidate (grid = B), one thread per task (T padded
// up to a multiple of 32).
//
// Sets of tasks are bitmasks, 32 tasks a word, and the work of a phase
// touches only the tasks a sum needs:
//   - the parent mask arrives packed (ceil(T/32) uint32 words a task), so a
//     task is ready when (parents & ~done) == 0, one AND a word;
//   - the running set, the users of a NoC and the done set are ballots;
//   - a running-order rank is popc(mask & lanemask_le) (plus the earlier
//     words), a PE load is popc(running & same_pe), an exact integer;
//   - every float sum adds the same terms in the same order as the index-
//     ordered loops over all tasks it replaces, and skips only terms that
//     are exactly +0.0f (x + 0.0f == x). The kind and NoC seconds stay
//     repeated `+ phi` (k * phi is not the same f32 as phi added k times);
//   - phi is a min, the per-workload latencies a max: both order-free, so
//     shuffles and shared-memory atomics give them exactly.
// Two instantiations of one kernel:
//   - one warp (T <= 32, every AR workload), where a phase is a chain of
//     dependent latencies and the design shortens it: the same-slot masks
//     come from __match_any_sync once before the loop; each phase the
//     running tasks write their burst, MEM slot, 1/load and traffic to
//     dense arrays in rank order, so every sum over running tasks is a
//     counted loop (loads run ahead of the adds, no divergent bit walks; a
//     link's users are every L-th entry); the three rate divisions, then the
//     four time divisions, are independent of each other; only __syncwarp
//     orders shared memory; every lane carries the per-candidate sums;
//   - several warps (T <= 1024): one mask word a warp in shared memory
//     between block barriers, sums that walk the set bits (__ffs); thread 0
//     carries the per-candidate sums.
// The candidate's per-slot rows are staged in shared memory in one round of
// loads before the loop, and the rollup's seven sums and two argmaxes run
// side by side on lanes of warp 0, each in index order. The phase loop stops
// at the first phase in which no task runs: every later phase of the
// reference is a zero-length no-op.
//
// Numerics follow the plain PyTorch version (ref.py) operation by operation:
// every constant is a float literal, the file is built without fast math and
// with -fmad=false so products and sums round separately, every sum runs in
// task-index order, ranks and loads are integers, and argmax keeps the first
// index on ties. Its outputs are bitwise those of the first design of this
// kernel (task-long loops over every task).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float BIG = 1e30f;
constexpr float TINY = 1e-30f;
constexpr int N_SCAL = 14;      // core/scal_layout.py SCAL_COLS
constexpr int N_NOCS = 4;       // noc_pj, power_budget, area_budget, alpha
constexpr int MAX_NOC = 8;      // core/phase_sim_torch.py MAX_NOC
constexpr int LINK_ONEHOT = 8;  // link ladder tops out at 8 channels
constexpr int MAX_WARPS = 32;   // 1024 threads
constexpr int N_CNT = 3 + MAX_NOC;  // per-warp counts: code 0, 1, 2, then NoC k
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  // workload (shared by every block), T entries / T x PW words
  const float* work;
  const float* rd;
  const float* wr;
  const float* burst;
  const uint32_t* pwords;  // [i * PW + w] bit b: task 32 w + b is a parent of i
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
  int B, T, PW, S_pe, S_mem, N, NW;
};

// Walk the set bits of words[0 .. nw) in ascending order: f(task index).
template <typename F>
__device__ __forceinline__ void walk(const uint32_t* words, int nw, F f) {
  for (int w = 0; w < nw; ++w) {
    uint32_t m = words[w];
    while (m) {
      const int b = __ffs(m) - 1;
      m &= m - 1;
      f(32 * w + b);
    }
  }
}

// Link load of a user at 1-based running-order rank `rank` among the set
// bits of `users` (nw words), L links: the index-ordered sum of the bursts
// of every user whose rank is congruent to it modulo L (a running residue,
// no division in the walk).
__device__ __forceinline__ float link_load(const uint32_t* users, int nw, int rank, int L,
                                           const float* s_burst) {
  const int mine = (rank - 1) % L;
  float link_t = 0.0f;
  int res = 0;  // (pos - 1) mod L of the next user
  walk(users, nw, [&](int j) {
    if (res == mine) link_t += s_burst[j];
    res = res + 1 == L ? 0 : res + 1;
  });
  return link_t;
}

// Ordered sum of d[k0], d[k0 + step], ... below `count`: a counted loop
// whose loads do not wait on the sum.
__device__ __forceinline__ float strided_sum(const float* d, int k0, int step, int count) {
  float s = 0.0f;
#pragma unroll 4
  for (int k = k0; k < count; k += step) s += d[k];
  return s;
}

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

// Shared memory, in 4-byte words, for `tp` threads.
__host__ __device__ inline size_t smem_words(int tp, int s_pe, int s_mem, int n_noc, int n_wl) {
  const int s_max = s_pe > s_mem ? (s_pe > tp ? s_pe : tp) : (s_mem > tp ? s_mem : tp);
  return 2 * (size_t)tp               // s_pe, s_mem
         + MAX_WARPS * (1 + 2 + 2)    // done, running[2], users[2] words
         + MAX_WARPS * N_CNT          // per-warp code counts
         + 5 * (size_t)tp             // burst, wr, f0, f1, f2
         + 3 * (size_t)s_max          // slot sums
         + MAX_WARPS                  // block_min
         + 2 * (size_t)n_wl           // per-workload latency bits, budgets
         + 5 * (size_t)s_pe + 7 * (size_t)s_mem + 4 * (size_t)n_noc + N_NOCS;  // the candidate's rows
}

template <bool ONE_WARP>
__global__ void __launch_bounds__(ONE_WARP ? 32 : 1024) phase_sim_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tp = blockDim.x;
  const int nw = tp >> 5;
  const int i = threadIdx.x;
  const int lane = i & 31, wid = i >> 5;
  const int b = blockIdx.x;
  const int T = p.T;
  const int N = p.N;
  const int s_max = max(max(p.S_pe, p.S_mem), tp);

  int* s_pe = reinterpret_cast<int*>(smem_raw);  // task -> PE slot
  int* s_mem = s_pe + tp;                         // task -> MEM slot
  uint32_t* s_done_w = reinterpret_cast<uint32_t*>(s_mem + tp);  // completed
  uint32_t* s_run_w = s_done_w + MAX_WARPS;   // [2][MAX_WARPS]: running, by phase parity
  uint32_t* s_use_w = s_run_w + 2 * MAX_WARPS;  // [2][MAX_WARPS]: NoC users, by NoC parity
  int* s_cnt = reinterpret_cast<int*>(s_use_w + 2 * MAX_WARPS);  // [warp][N_CNT]
  float* s_burst = reinterpret_cast<float*>(s_cnt + MAX_WARPS * N_CNT);
  float* s_wr = s_burst + tp;
  float* s_f0 = s_wr + tp;     // 1/load, later pe_bt
  float* s_f1 = s_f0 + tp;     // traffic term, later mem_bt
  float* s_f2 = s_f1 + tp;     // dynamic pJ term
  float* s_slot0 = s_f2 + tp;        // pe_b per slot
  float* s_slot1 = s_slot0 + s_max;  // mem_b per slot
  float* s_slot2 = s_slot1 + s_max;  // capacity, then the mem area term per slot
  float* s_redf = s_slot2 + s_max;   // MAX_WARPS
  unsigned* s_wl = reinterpret_cast<unsigned*>(s_redf + MAX_WARPS);  // NW
  // one warp, inside the phase loop: the running tasks' values in rank
  // order (arrays the several-warp path uses otherwise)
  float* d_burst = s_f2;
  int* d_mem = s_mem;
  float* d_inv = s_f0;
  float* d_tr = s_f1;
  float* d_use = s_burst;  // a NoC's users
  // the candidate's per-slot rows, staged once (all loads in one round trip);
  // leak and area enter as the products the rollup sums
  float* r_wlbud = reinterpret_cast<float*>(s_wl + p.NW);
  float* r_pe_peak = r_wlbud + p.NW;
  float* r_pe_pj = r_pe_peak + p.S_pe;
  float* r_pe_leak = r_pe_pj + p.S_pe;     // leak * active
  float* r_pe_area = r_pe_leak + p.S_pe;   // area * active
  float* r_mem_bw = r_pe_area + p.S_pe;
  float* r_mem_pj = r_mem_bw + p.S_mem;
  float* r_mem_leak = r_mem_pj + p.S_mem;  // leak * active
  float* r_mem_af = r_mem_leak + p.S_mem;
  float* r_mem_amb = r_mem_af + p.S_mem;
  float* r_mem_active = r_mem_amb + p.S_mem;
  float* r_noc_bw = r_mem_active + p.S_mem;
  float* r_noc_leak = r_noc_bw + N;        // leak * active
  float* r_noc_area = r_noc_leak + N;      // area * active
  float* r_nocs = r_noc_area + N;          // N_NOCS
  int* r_pe_noc = reinterpret_cast<int*>(r_nocs + N_NOCS);
  int* r_mem_noc = r_pe_noc + p.S_pe;
  int* r_noc_links = r_mem_noc + p.S_mem;
  {
    const size_t bp = (size_t)b * p.S_pe, bm = (size_t)b * p.S_mem, bn = (size_t)b * N;
    for (int s = i; s < p.S_pe; s += tp) {
      r_pe_peak[s] = p.pe_peak[bp + s];
      r_pe_pj[s] = p.pe_pj[bp + s];
      r_pe_leak[s] = p.pe_leak[bp + s] * p.pe_active[bp + s];
      r_pe_area[s] = p.pe_area[bp + s] * p.pe_active[bp + s];
      r_pe_noc[s] = p.pe_noc[bp + s];
    }
    for (int s = i; s < p.S_mem; s += tp) {
      r_mem_bw[s] = p.mem_bw[bm + s];
      r_mem_pj[s] = p.mem_pj[bm + s];
      r_mem_leak[s] = p.mem_leak[bm + s] * p.mem_active[bm + s];
      r_mem_af[s] = p.mem_af[bm + s];
      r_mem_amb[s] = p.mem_amb[bm + s];
      r_mem_active[s] = p.mem_active[bm + s];
      r_mem_noc[s] = p.mem_noc[bm + s];
    }
    for (int k = i; k < N; k += tp) {
      r_noc_bw[k] = p.noc_bw[bn + k];
      r_noc_leak[k] = p.noc_leak[bn + k] * p.noc_active[bn + k];
      r_noc_area[k] = p.noc_area[bn + k] * p.noc_active[bn + k];
      r_noc_links[k] = p.noc_links[bn + k];
    }
    for (int w = i; w < p.NW; w += tp) r_wlbud[w] = p.wlbud[(size_t)b * p.NW + w];
    if (i < N_NOCS) r_nocs[i] = p.nocs[(size_t)b * N_NOCS + i];
  }

  const bool live = i < T;
  const size_t rt = (size_t)b * T;
  const int pe_i = live ? p.task_pe[rt + i] : 0;
  const int mem_i = live ? p.task_mem[rt + i] : 0;
  s_pe[i] = pe_i;
  s_mem[i] = mem_i;

  const float work_i = live ? p.work[i] : 0.0f;
  const float rd_i = live ? p.rd[i] : 0.0f;
  const float wr_i = live ? p.wr[i] : 0.0f;
  const float burst_i = live ? p.burst[i] : 0.0f;
  const float accel_i = live ? p.accel[rt + i] : 1.0f;
  s_burst[i] = burst_i;
  s_wr[i] = wr_i;
  if (ONE_WARP) __syncwarp(); else __syncthreads();  // the staged rows
  const float peak_eff = r_pe_peak[pe_i] * accel_i;
  const float mem_peak = r_mem_bw[mem_i];
  // chain routing: the route is the chain-index interval between the
  // task's PE attachment and its MEM attachment
  const int pe_pos = r_pe_noc[pe_i];
  const int mem_pos = r_mem_noc[mem_i];
  const int lo = min(pe_pos, mem_pos);
  const int hi = max(pe_pos, mem_pos);
  const float hops = (float)(hi - lo + 1);
  const uint32_t lane_le = (2u << lane) - 1u;  // lanes 0 .. lane

  // the parent words of this task (one register word on the one-warp path)
  const uint32_t* my_parents = p.pwords + (size_t)i * p.PW;
  const uint32_t par0 = live ? my_parents[0] : 0u;
  // loop-invariant same-slot masks (one-warp path): live tasks only
  const uint32_t live_m = __ballot_sync(FULL, live);
  uint32_t same_pe = 0u, same_mem = 0u;
  if (ONE_WARP) {
    same_pe = __match_any_sync(FULL, pe_i) & live_m;
    same_mem = __match_any_sync(FULL, mem_i) & live_m;
  }

  // padded tasks are born completed: they never run, never enter a share
  int done_i = live ? 0 : 1;
  float rem_ops = work_i, rem_rd = rd_i, rem_wr = wr_i;
  float finish = 0.0f, pe_bt = 0.0f, mem_bt = 0.0f;
  int bneck = 0, bneck_noc = 0;
  float now = 0.0f;
  int nph = 0;
  // per-candidate sums: every lane (one warp) or thread 0 (several warps)
  float acc_alp = 0.0f, acc_tr = 0.0f;
  float acc_kind[3] = {0.0f, 0.0f, 0.0f};
  float acc_noc[MAX_NOC];
#pragma unroll
  for (int k = 0; k < MAX_NOC; ++k) acc_noc[k] = 0.0f;

  uint32_t done_m = 0u;  // one-warp path: the done set
  if (ONE_WARP) {
    done_m = __ballot_sync(FULL, done_i);
    __syncwarp();
  } else {
    const uint32_t d = __ballot_sync(FULL, done_i);
    if (lane == 0) s_done_w[wid] = d;
    __syncthreads();
  }

  for (int ph = 0; ph < T; ++ph) {
    // ---- ready set: no incomplete parent --------------------------------
    int run = 0;
    uint32_t run_m = 0u;  // one-warp path: the running set
    const uint32_t* run_w = s_run_w + (ph & 1) * MAX_WARPS;
    if (ONE_WARP) {
      run = !done_i && (par0 & ~done_m) == 0u;
      run_m = __ballot_sync(FULL, run);
    } else {
      if (!done_i) {
        run = (par0 & ~s_done_w[0]) == 0u;
        for (int w = 1; w < p.PW && run; ++w) run = (my_parents[w] & ~s_done_w[w]) == 0u;
      }
      const uint32_t r = __ballot_sync(FULL, run);
      if (lane == 0) s_run_w[(ph & 1) * MAX_WARPS + wid] = r;
      __syncthreads();
    }

    // One warp: the running tasks' values go to dense arrays in task order
    // (running task j at pos_j = its rank - 1), so every index-ordered sum
    // over running tasks is a counted loop over those arrays.
    const int n_run = __popc(run_m);
    const int pos = __popc(run_m & (lane_le >> 1));
    if (ONE_WARP) {
      if (run) {
        d_burst[pos] = burst_i;
        d_mem[pos] = mem_i;
      }
      __syncwarp();
    }

    // ---- Eq. 1/2 PE share, Eq. 4 memory share (index-order sums) -------
    float load = 0.0f, mem_t = 0.0f;
    if (ONE_WARP) {
      if (run) {
        load = (float)__popc(run_m & same_pe);
#pragma unroll 4
        for (int k = 0; k < n_run; ++k) {
          const float v = d_burst[k];
          if (d_mem[k] == mem_i) mem_t += v;
        }
      }
    } else if (run) {
      int cnt = 0;
      walk(run_w, nw, [&](int j) {
        if (s_pe[j] == pe_i) cnt += 1;
        if (s_mem[j] == mem_i) mem_t += s_burst[j];
      });
      load = (float)cnt;
    }

    // ---- Eq. 3: rank-residue link striping, min over the route ---------
    // (the single-NoC link load is summed before any of the three rates is
    // divided out, so the three divisions are independent of each other)
    float n_bw = BIG;
    int arg = 0;
    float link_t = 0.0f;  // one NoC: this task's link load
    if (N == 1) {
      const int L = max(r_noc_links[0], 1);
      if (ONE_WARP) {
        if (run) link_t = strided_sum(d_burst, pos % L, L, n_run);  // ranks congruent modulo L
      } else if (run) {
        int rank = __popc(run_w[wid] & lane_le);
        for (int w = 0; w < wid; ++w) rank += __popc(run_w[w]);
        link_t = link_load(run_w, nw, rank, L, s_burst);
      }
    } else {
      for (int k = 0; k < N; ++k) {
        const int use = run && lo <= k && k <= hi;
        const int L = max(r_noc_links[k], 1);
        uint32_t use_m = __ballot_sync(FULL, use);
        const uint32_t* use_w = s_use_w + (k & 1) * MAX_WARPS;
        int rank = __popc(use_m & lane_le);
        if (!ONE_WARP) {
          if (lane == 0) s_use_w[(k & 1) * MAX_WARPS + wid] = use_m;
          __syncthreads();
          for (int w = 0; w < wid; ++w) rank += __popc(use_w[w]);
        }
        // user u's link is (rank_u - 1) mod L; the link one-hot has 8 columns
        const bool onehot = (rank - 1) % L < LINK_ONEHOT;
        float link_k = 0.0f;
        if (ONE_WARP) {
          if (use) d_use[rank - 1] = burst_i;
          __syncwarp();
          if (use && onehot) link_k = strided_sum(d_use, (rank - 1) % L, L, __popc(use_m));
          __syncwarp();
        } else if (use && onehot) {
          link_k = link_load(use_w, nw, rank, L, s_burst);
        }
        if (use) {
          const float bw_k = (r_noc_bw[k] * burst_i) / fmaxf(link_k, TINY);
          if (bw_k < n_bw) { n_bw = bw_k; arg = k; }
        }
      }
    }

    // Only running tasks divide: the others' rates are never read, and their
    // zero loads would send the divisions down the slow path (x / 1e-30).
    float compute = 0.0f, m_bw = 0.0f, inv_load = 0.0f;
    if (run) {
      compute = peak_eff / fmaxf(load, 1.0f);
      m_bw = (mem_peak * burst_i) / fmaxf(mem_t, TINY);
      inv_load = 1.0f / fmaxf(load, 1.0f);
      if (N == 1) n_bw = (r_noc_bw[0] * burst_i) / fmaxf(link_t, TINY);
    }

    // ---- Eq. 6 phase length; binding resource (phi-free parts first) ----
    const float bw = fminf(m_bw, n_bw);
    float c_t = BIG;
    int code = -1;
    if (run) {
      const float comp_t = rem_ops / compute;
      const float comm_t = fmaxf(rem_rd, rem_wr) / bw;
      c_t = fmaxf(comp_t, comm_t);
      const float tot_comp_t = work_i / compute;
      const float tot_comm_t = fmaxf(rd_i, wr_i) / bw;
      code = tot_comp_t >= tot_comm_t ? 0 : (m_bw <= n_bw ? 1 : 2);
      if (ONE_WARP) d_inv[pos] = inv_load;
    }
    int cnt[N_CNT];  // running tasks per binding code, then per binding NoC
#pragma unroll
    for (int c = 0; c < 3; ++c) cnt[c] = __popc(__ballot_sync(FULL, code == c));
#pragma unroll
    for (int k = 0; k < MAX_NOC; ++k)
      cnt[3 + k] = (N > 1 && k < N) ? __popc(__ballot_sync(FULL, code == 2 && arg == k)) : 0;
    float phi;
    if (ONE_WARP) {
      phi = c_t;
      for (int o = 16; o > 0; o >>= 1) phi = fminf(phi, __shfl_xor_sync(FULL, phi, o));
    } else {
      phi = block_min(c_t, s_redf);
    }
    if (!(phi < BIG * 0.5f)) break;  // nothing runs: every task is done

    // ---- drain, retire ---------------------------------------------------
    float traffic_i = 0.0f;
    if (run) {
      if (code == 0) pe_bt = pe_bt + phi;
      if (code == 1) mem_bt = mem_bt + phi;
      const float d_ops = compute * phi;
      const float d_bw = bw * phi;
      const float dr_ops = fmaxf(rem_ops - d_ops, 0.0f);
      const float dr_rd = fmaxf(rem_rd - d_bw, 0.0f);
      const float dr_wr = fmaxf(rem_wr - d_bw, 0.0f);
      traffic_i = fminf(dr_rd + dr_wr, d_bw + d_bw);
      if (ONE_WARP) d_tr[pos] = traffic_i;
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

    // ---- per-candidate sums over the running tasks, in index order -----
    float sum_alp = 0.0f, s_tr = 0.0f;
    if (ONE_WARP) {
      done_m = __ballot_sync(FULL, done_i);
      __syncwarp();
#pragma unroll 4
      for (int k = 0; k < n_run; ++k) {
        sum_alp += d_inv[k];
        s_tr += d_tr[k];
      }
    } else {
      s_f0[i] = run ? inv_load : 0.0f;
      s_f1[i] = traffic_i;
      const uint32_t d = __ballot_sync(FULL, done_i);
      if (lane == 0) {
        s_done_w[wid] = d;
#pragma unroll
        for (int c = 0; c < N_CNT; ++c) s_cnt[wid * N_CNT + c] = cnt[c];
      }
      __syncthreads();
      if (i == 0) {
        walk(run_w, nw, [&](int j) {
          sum_alp += s_f0[j];
          s_tr += s_f1[j];
        });
#pragma unroll
        for (int c = 0; c < N_CNT; ++c) {
          int total = 0;
          for (int w = 0; w < nw; ++w) total += s_cnt[w * N_CNT + c];
          cnt[c] = total;
        }
      }
    }
    if (ONE_WARP || i == 0) {
      acc_alp = acc_alp + phi * sum_alp;
      acc_tr = acc_tr + s_tr;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        float s = 0.0f;
        for (int r = 0; r < cnt[c]; ++r) s += phi;
        acc_kind[c] = acc_kind[c] + s;
      }
      if (N > 1) {
#pragma unroll
        for (int k = 0; k < MAX_NOC; ++k) {
          float s = 0.0f;
          for (int r = 0; r < cnt[3 + k]; ++r) s += phi;
          acc_noc[k] = acc_noc[k] + s;
        }
      }
    }
  }

  // ---- after the loop: per-slot bottleneck seconds ----------------------
  if (ONE_WARP) __syncwarp();  // the loop's last reads of the dense arrays
  const int all_done = ONE_WARP ? __all_sync(FULL, done_i) : __syncthreads_and(done_i);
  s_f0[i] = pe_bt;
  s_f1[i] = mem_bt;
  const float rw = rd_i + wr_i;
  s_f2[i] = live ? r_pe_pj[pe_i] * work_i + (r_mem_pj[mem_i] + r_nocs[0] * hops) * rw : 0.0f;
  for (int w = i; w < p.NW; w += tp) s_wl[w] = 0u;
  for (int s = i; s < s_max; s += tp) {
    s_slot0[s] = 0.0f;
    s_slot1[s] = 0.0f;
    s_slot2[s] = 0.0f;
  }
  if (ONE_WARP) __syncwarp(); else __syncthreads();

  // the latest finish per workload: finish >= +0, so the f32 bits order as
  // unsigned integers and the max is exact in any order
  if (live) atomicMax(&s_wl[p.wl_id[i]], __float_as_uint(finish));
  if (ONE_WARP) {
    // the first task of each slot sums its slot's tasks, in index order (a
    // counted loop, so the loads run ahead of the predicated adds)
    if (live && __ffs(same_pe) - 1 == i) {
      float v = 0.0f;
#pragma unroll 4
      for (int j = i; j < T; ++j) {
        if ((same_pe >> j) & 1u) v += s_f0[j];
      }
      s_slot0[pe_i] = v;
    }
    if (live && __ffs(same_mem) - 1 == i) {
      float v = 0.0f, cap = 0.0f;
#pragma unroll 4
      for (int j = i; j < T; ++j) {
        if ((same_mem >> j) & 1u) {
          v += s_f1[j];
          cap += s_wr[j];
        }
      }
      s_slot1[mem_i] = v;
      s_slot2[mem_i] = cap;
    }
  } else {
    for (int s = i; s < p.S_pe; s += tp) {
      float v = 0.0f;
      for (int j = 0; j < T; ++j) v += s_pe[j] == s ? s_f0[j] : 0.0f;
      s_slot0[s] = v;
    }
    for (int s = i; s < p.S_mem; s += tp) {
      float v = 0.0f, cap = 0.0f;
      for (int j = 0; j < T; ++j) {
        if (s_mem[j] == s) {
          v += s_f1[j];
          cap += s_wr[j];
        }
      }
      s_slot1[s] = v;
      s_slot2[s] = cap;
    }
  }
  if (ONE_WARP) __syncwarp(); else __syncthreads();

  float* out = p.out + (size_t)b * p.out_stride;
  const int o_pe = N_SCAL;
  const int o_mem = o_pe + p.S_pe;
  const int o_noc = o_mem + p.S_mem;
  const int o_wl = o_noc + N;
  const int o_fin = o_wl + p.NW;
  const int o_bn = o_fin + T;
  for (int s = i; s < p.S_pe; s += tp) out[o_pe + s] = s_slot0[s];
  for (int s = i; s < p.S_mem; s += tp) {
    out[o_mem + s] = s_slot1[s];
    s_slot2[s] = (r_mem_af[s] + r_mem_amb[s] * fmaxf(s_slot2[s], 1.0f) / 1e6f) * r_mem_active[s];
  }
  if (i == 0) {
    for (int k = 0; k < N; ++k) {
      float v = acc_kind[2];
#pragma unroll
      for (int kk = 0; kk < MAX_NOC; ++kk)
        if (N > 1 && kk == k) v = acc_noc[kk];
      out[o_noc + k] = v;
    }
  }
  if (live) {
    out[o_fin + i] = finish;
    const int packed = bneck == 2 ? 2 + 3 * bneck_noc : bneck;
    out[o_bn + i] = __int_as_float(packed);
  }
  if (ONE_WARP) __syncwarp(); else __syncthreads();

  // ---- Eq.-7 rollup: every sum in index order ---------------------------
  // The seven sums and two argmaxes are independent: lanes of warp 0 run
  // them side by side, each its own in index order (one loop, one source
  // array a lane), and lane 0 gathers them.
  float sums[7];
  int tops[2];
  if (i < 32) {
    const float* src = s_f2;
    int len = T;
    switch (i) {
      case 1: src = r_pe_leak; len = p.S_pe; break;
      case 2: src = r_pe_area; len = p.S_pe; break;
      case 3: src = r_mem_leak; len = p.S_mem; break;
      case 4: src = s_slot2; len = p.S_mem; break;
      case 5: src = r_noc_leak; len = N; break;
      case 6: src = r_noc_area; len = N; break;
      case 7: src = s_slot0; len = p.S_pe; break;
      case 8: src = s_slot1; len = p.S_mem; break;
      default: break;
    }
    float acc = 0.0f;
    if (i < 7) {
#pragma unroll 4
      for (int k = 0; k < len; ++k) acc += src[k];
    }
    int top = 0;  // argmax, the first index on ties
    if (i == 7 || i == 8) {
      float best = src[0];
#pragma unroll 4
      for (int k = 1; k < len; ++k) {
        const float v = src[k];
        if (v > best) { best = v; top = k; }
      }
    }
#pragma unroll
    for (int k = 0; k < 7; ++k) sums[k] = __shfl_sync(FULL, acc, k);
    tops[0] = __shfl_sync(FULL, top, 7);
    tops[1] = __shfl_sync(FULL, top, 8);
  }
  if (i == 0) {
    const float dyn_pj = sums[0];
    const float leak_pe = sums[1], area_pe = sums[2], leak_mem = sums[3], area_mem = sums[4];
    const float leak_noc = sums[5], area_noc = sums[6];
    const float leak_w = leak_pe + leak_mem + leak_noc;
    const float energy = dyn_pj * 1e-12f + leak_w * now;
    const float power = now > 0.0f ? energy / fmaxf(now, TINY) : 0.0f;
    const float area = area_pe + area_mem + area_noc;

    const float* bud = r_wlbud;
    float d0 = -BIG;
    for (int w = 0; w < p.NW; ++w) {
      const float lat = __uint_as_float(s_wl[w]);
      out[o_wl + w] = lat;
      d0 = fmaxf(d0, (lat - bud[w]) / bud[w]);
    }
    const float* nocs = r_nocs;
    const float d1 = (power - nocs[1]) / nocs[1];
    const float d2 = (area - nocs[2]) / nocs[2];
    const float alpha = nocs[3];
    const float f0 = d0 > 0.0f ? d0 : alpha * d0;
    const float f1 = d1 > 0.0f ? d1 : alpha * d1;
    const float f2 = d2 > 0.0f ? d2 : alpha * d2;
    const float fitness = f0 + f1 + f2;

    const int top_pe = tops[0], top_mem = tops[1];
    out[0] = now;
    out[1] = energy;
    out[2] = power;
    out[3] = area;
    out[4] = fitness;
    out[5] = acc_alp;
    out[6] = acc_tr;
    out[7] = (float)nph;
    out[8] = all_done ? 1.0f : 0.0f;
    out[9] = acc_kind[0];
    out[10] = acc_kind[1];
    out[11] = acc_kind[2];
    out[12] = (float)top_pe;
    out[13] = (float)top_mem;
  }
}

// Once per instantiation: opt in to dynamic shared memory up to `bytes`.
template <bool ONE_WARP> int reserve_smem(size_t bytes) {
  static size_t granted = 48 * 1024;
  if (bytes <= granted) return 0;
  cudaError_t e = cudaFuncSetAttribute(phase_sim_kernel<ONE_WARP>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  granted = bytes;
  return 0;
}

}  // namespace

extern "C" {

// Launch one block per candidate on `stream`. Returns cudaGetLastError()
// after the launch (0 on success); arguments out of range give
// cudaErrorInvalidValue without launching.
int phase_sim_launch(
    const void* work, const void* rd, const void* wr, const void* burst,
    const void* pwords, const void* wl_id,
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
  p.pwords = static_cast<const uint32_t*>(pwords);
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
  p.PW = (T + 31) / 32;
  p.S_pe = S_pe;
  p.S_mem = S_mem;
  p.N = N;
  p.NW = NW;
  const size_t smem = 4 * smem_words(threads, S_pe, S_mem, N, NW);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err;
  if (threads == 32) {
    if ((err = reserve_smem<true>(smem))) return err;
    phase_sim_kernel<true><<<B, 32, smem, st>>>(p);
  } else {
    if ((err = reserve_smem<false>(smem))) return err;
    phase_sim_kernel<false><<<B, threads, smem, st>>>(p);
  }
  return (int)cudaGetLastError();
}

const char* phase_sim_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
