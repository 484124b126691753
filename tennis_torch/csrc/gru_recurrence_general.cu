// GRU recurrence over precomputed input gates at every hidden size from 1 to
// 1023, one launch for all T steps: a cluster of min(16, H) CTAs owning
// ragged runs of units, Wh in registers and shared memory as far as they
// hold it and the rest streamed from L2 every step, the hidden state
// exchanged with st.async and mbarriers.
//
// Replaces tennis_tpu/ops/pallas/gru.py::_recurrence_kernel (launched by
// gru_recurrence_pallas) over the part of its domain that
// csrc/gru_recurrence_async.cu does not take: the TPU kernel runs at any H
// whose f32 gates, outputs and Wh fit its 12 MiB VMEM budget (up to H 1020
// at T 1, B 4; 737 at the 0102 encoder's T 128, B 4), the async kernel only
// at multiples of 8 or 16 up to 512. Given gates_x (T, B, 3H) = x.Wx + bx,
// h0 (B, H), Wh (H, 3H), bh (3H) and valid_length (B), each step computes
//   gh = h.Wh + bh
//   r = sigmoid(gx_r + gh_r), z = sigmoid(gx_z + gh_z)
//   n = tanh(gx_n + r * gh_n), h' = (1 - z) n + z h
// (gate order r, z, n); rows with t >= valid_length keep their carry and
// output 0. Outputs ys (T, B, H) and h_final (B, H), all f32, with expf and
// tanhf (no fast-math). No tensor cores: TF32 would break the 1e-4 f32
// agreement with the plain version. Sums run in a fixed order (each
// thread's rows in k order, then the segments in order, then the bias), so
// two launches agree bit for bit.
//
// What bounds it: the T steps are a serial chain. A step is a (R, H) x
// (H, 3U) product per CTA, the gate math and one exchange of the new h
// between the CTAs of the cluster. Past H ~ 560 a CTA's slice of Wh
// (12 H^2 / 16 bytes: 307 KB at H 640, 780 KB at 1020) is larger than its
// registers and 227 KB of shared memory together, so the rest of it is read
// again every step: all of Wh (at most 12.6 MB) stays in the 50 MB L2, and
// the floor of a step is then those bytes over one SM's L2 bandwidth.
//
// Design. One thread-block cluster of C = min(16, H) CTAs per chunk of
// R <= 8 batch rows (R * ceil(H / C) <= 256). CTA k owns the contiguous
// run of floor(H / C) or ceil(H / C) units that starts at
// k floor(H / C) + min(k, H mod C), and the r, z and n columns of Wh for
// them. Thread (u, s) of the UM * S product threads (UM = ceil(H / C)) sums
// rows [s L, (s + 1) L) of the three columns of its unit u, where L is a
// multiple of 8 of at least kRegL and S L >= H: the first kRegL rows from
// registers, the next LR from shared memory (both loaded once), the last LT
// from a ring of two chunks of kChunkRows rows in shared memory that the
// thread fills itself with cp.async (4-byte copies, or 16-byte ones where
// Wh's rows are contiguous and aligned), one chunk ahead: the last chunk of
// step t issues the first of step t + 1, so that copy overlaps the
// exchange. Rows past H and the column of a unit a CTA does not own (its
// run one shorter than UM) carry zero weights, and the h buffers zeros past
// H, so they add 0.0 to every sum. Each thread reads only the ring entries
// it copied, so the ring needs no CTA barrier: cp.async.wait_group alone
// orders it. The h exchange is the async kernel's: each CTA sends its new
// units into the next h buffer of every CTA (16-byte st.async where its run
// starts and ends on a multiple of 4, else 8- or 4-byte ones) and waits on
// its own mbarrier for nb H 4 bytes a step, whatever the split. Two h
// buffers are enough for the reason the async kernel gives: a CTA barrier
// separates each step's product from its sends. R is the one template
// argument (4 instances); every other size is a runtime value.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxH = 1023;         // hidden size, at most
constexpr int kMaxCluster = 16;     // CTAs per cluster: min(kMaxCluster, H)
constexpr int kMaxThreads = 256;    // threads per CTA, at most
constexpr int kMaxRows = 8;         // batch rows per cluster (R)
constexpr int kRegL = 32;           // rows of each column a thread keeps in registers
constexpr int kChunkRows = 8;       // rows of each column in one streamed chunk
constexpr int kRingSlots = 2;       // chunks of the ring
constexpr int kSmemLimit = 232448;  // H100: the most a block can opt in to
constexpr int kStaticSmem = 64;     // the launcher's allowance for the two mbarriers

struct GruArgs {
  const float* gx;       // (T, B, 3H), unit stride on the gate axis
  long long gx_st, gx_sb;
  const float* h0;       // (B, H) contiguous
  const float* wh;       // (H, 3H), any strides
  long long wh_sk, wh_sj;
  const float* bh;       // (3H,)
  const int* vl;         // (B,)
  float* ys;             // (T, B, H), unit stride on the hidden axis
  long long ys_st, ys_sb;
  float* hfin;           // (B, H) contiguous
  int T, B, H, C, S, L, LR;  // rows per cluster (R) are a template argument
};

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// The partition and the dynamic shared memory of one CTA, in floats: the
// chunk's h, double buffered [2][R][HP] (HP = S L, zeros past H); the
// partial sums [S][R][3 UM]; the staged new units [R][round4(UM)]; the
// resident rows past the registers and the ring, each as float4 groups of
// 4 rows [rows / 4][3][NP][4] (NP = UM S product threads).
struct Plan {
  int UM, NP, NT, HP, LT;
  int red, stage, wres, ring, total;
};

__host__ __device__ inline Plan make_plan(int H, int C, int S, int L, int R, int LR) {
  Plan p;
  p.UM = (H + C - 1) / C;
  p.NP = p.UM * S;
  const int nt = p.NP > R * p.UM ? p.NP : R * p.UM;
  p.NT = (nt + 31) / 32 * 32;
  p.HP = S * L;
  p.LT = L - kRegL - LR;
  p.red = 2 * R * p.HP;
  p.stage = p.red + round4(S * R * 3 * p.UM);
  p.wres = p.stage + R * round4(p.UM);
  p.ring = p.wres + 3 * LR * p.NP;
  p.total = p.ring + (p.LT > 0 ? kRingSlots * 3 * kChunkRows * p.NP : 0);
  return p;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// One cluster barrier: every thread's earlier writes, to its own CTA's
// shared memory or another's, are visible to every thread after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The address that the shared-memory address `local` has in CTA `rank`.
__device__ __forceinline__ uint32_t map_rank(uint32_t local, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(local), "r"(rank));
  return remote;
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(bar) : "memory");
}

// The one arrival of the barrier's phase, with the bytes the phase waits for.
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Returns once the phase of parity `parity` has completed; acquire at
// cluster scope, so the peers' st.async data is visible after it.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// st.async of V floats from `src` (local shared memory) to the
// distributed-shared-memory address `dst`, counted on the mbarrier `bar`
// of the CTA that `dst` lies in.
template <int V>
__device__ __forceinline__ void st_async(uint32_t dst, const float* src,
                                         uint32_t bar) {
  if constexpr (V == 4) {
    const float4 v = *reinterpret_cast<const float4*>(src);
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 "
        "[%0], {%1, %2, %3, %4}, [%5];\n"
        :: "r"(dst), "r"(__float_as_uint(v.x)), "r"(__float_as_uint(v.y)),
           "r"(__float_as_uint(v.z)), "r"(__float_as_uint(v.w)), "r"(bar)
        : "memory");
  } else if constexpr (V == 2) {
    const float2 v = *reinterpret_cast<const float2*>(src);
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 "
        "[%0], {%1, %2}, [%3];\n"
        :: "r"(dst), "r"(__float_as_uint(v.x)), "r"(__float_as_uint(v.y)),
           "r"(bar)
        : "memory");
  } else {
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 "
        "[%0], %1, [%2];\n"
        :: "r"(dst), "r"(__float_as_uint(*src)), "r"(bar) : "memory");
  }
}

// Sends this CTA's staged units ([nb][UP] at `stage`, U of each row) to
// offsets [start, start + U) of every row of the h buffer at `hnext` in
// each of the C CTAs.
template <int V>
__device__ __forceinline__ void send_units(const float* stage, float* hnext,
                                           uint32_t bar, int nb, int U, int UP,
                                           int HP, int start, int C, int tid,
                                           int n_threads) {
  const int per_row = U / V;
  for (int i = tid; i < nb * per_row * C; i += n_threads) {
    const int q = i % C, v = i / C;
    const int b = v / per_row, e = (v % per_row) * V;
    st_async<V>(map_rank(smem_addr(hnext + b * HP + start + e), q),
                stage + b * UP + e, map_rank(bar, q));
  }
}

// cp.async of `bytes` (0 to cp-size) from global `src` into shared `dst`,
// the rest of the cp-size bytes zero-filled.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Returns once every group of this thread but the newest `kRingSlots - 1`
// has landed.
__device__ __forceinline__ void cp_async_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kRingSlots - 1) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Copies rows [k0, k0 + kChunkRows) of this thread's three columns into
// its entries of a ring slot ([kChunkRows / 4][3][NP][4] floats); zeros
// for rows past H and for a column the CTA does not own. `vec`: Wh's rows
// are contiguous (wh_sk 1) and each column starts 16-byte aligned.
__device__ __forceinline__ void issue_chunk(float* slot, const float* const* wcol,
                                            bool col_ok, int k0, int H,
                                            long long sk, int NP, int tid,
                                            bool vec, const float* any) {
#pragma unroll
  for (int g = 0; g < 3; ++g) {
#pragma unroll
    for (int q4 = 0; q4 < kChunkRows / 4; ++q4) {
      float* dst = slot + ((q4 * 3 + g) * NP + tid) * 4;
      const int k = k0 + q4 * 4;
      if (vec) {
        const int n = col_ok ? min(max(H - k, 0), 4) : 0;
        cp_async16(dst, n ? wcol[g] + k : any, 4 * n);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = col_ok && k + e < H;
          cp_async4(dst + e, ok ? wcol[g] + (k + e) * sk : any, ok ? 4 : 0);
        }
      }
    }
  }
  cp_async_commit();
}

// acc[g][b] += h[b][i..i+3] . w[g][i..i+3] for one group of 4 rows.
template <int R>
__device__ __forceinline__ void fma_rows4(float (&acc)[3][R], const float* hs,
                                          int HP, const float4 (&wv)[3]) {
#pragma unroll
  for (int b = 0; b < R; ++b) {
    const float4 hv = *reinterpret_cast<const float4*>(hs + b * HP);
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      acc[g][b] = fmaf(hv.x, wv[g].x, acc[g][b]);
      acc[g][b] = fmaf(hv.y, wv[g].y, acc[g][b]);
      acc[g][b] = fmaf(hv.z, wv[g].z, acc[g][b]);
      acc[g][b] = fmaf(hv.w, wv[g].w, acc[g][b]);
    }
  }
}

template <int R>
__global__ void __launch_bounds__(kMaxThreads, 1)
gru_recurrence_general_kernel(GruArgs a) {
  const int rank = static_cast<int>(cluster_rank());
  const int H = a.H, C = a.C, S = a.S, L = a.L, LR = a.LR;
  const Plan p = make_plan(H, C, S, L, R, LR);
  const int UM = p.UM, UP = round4(UM), J = 3 * UM, NP = p.NP, HP = p.HP;
  const int base = H / C, extra = H % C;
  const int U = base + (rank < extra ? 1 : 0);       // this CTA's units
  const int start = rank * base + min(rank, extra);  // its first unit
  const int row0 = blockIdx.y * R;
  const int nb = min(R, a.B - row0);
  const int tid = threadIdx.x, n_threads = blockDim.x;

  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) uint64_t bar[2];  // one per h buffer
  float* hbuf = smem;
  float* red = smem + p.red;
  float* stage = smem + p.stage;
  float* wres = smem + p.wres;
  float* ring = smem + p.ring;

  // product thread (u, s): rows [sL, sL + L) of the r, z and n columns of
  // unit start + u
  const bool prod = tid < NP;
  const int u = tid % UM, s = tid / UM;
  const bool col_ok = prod && u < U;
  const int k_first = s * L;
  const float* wcol[3];
#pragma unroll
  for (int g = 0; g < 3; ++g) {
    wcol[g] = a.wh + static_cast<long long>(g * H + start + min(u, U - 1)) * a.wh_sj;
  }
  float w[3][kRegL];
#pragma unroll
  for (int g = 0; g < 3; ++g) {
#pragma unroll
    for (int i = 0; i < kRegL; ++i) {
      const int k = k_first + i;
      w[g][i] = col_ok && k < H ? wcol[g][k * a.wh_sk] : 0.f;
    }
  }
  if (prod) {
    for (int i = 0; i < LR; ++i) {
      const int k = k_first + kRegL + i;
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        wres[(((i >> 2) * 3 + g) * NP + tid) * 4 + (i & 3)] =
            col_ok && k < H ? wcol[g][k * a.wh_sk] : 0.f;
      }
    }
  }
  // h0 into buffer 0; rows past the chunk's nb and units past H stay zero
  // in both buffers (no CTA sends those)
  for (int i = tid; i < 2 * R * HP; i += n_threads) {
    const int b = i / HP, k = i % HP;
    hbuf[i] = b < nb && k < H ? a.h0[static_cast<long long>(row0 + b) * H + k] : 0.f;
  }

  // the streamed rows: chunk c holds rows k_stream + c kChunkRows ...
  const int n_chunks = p.LT / kChunkRows;
  const int k_stream = k_first + kRegL + LR;
  const bool vec = a.wh_sk == 1 && a.wh_sj % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(a.wh) & 15) == 0;
  const int slot_floats = 3 * kChunkRows * NP;
  int used = 0;  // chunks consumed; chunk `used` lies in slot used & 1
  if (prod && n_chunks > 0) {
    issue_chunk(ring, wcol, col_ok, k_stream, H, a.wh_sk, NP, tid, vec, a.wh);
  }

  // gate thread: (row gb, unit start + gu) of this CTA's nb x U pairs
  const int gb = tid / UM, gu = tid % UM, unit = start + gu;
  const bool gate = tid < nb * UM && gu < U;
  float bias_r = 0.f, bias_z = 0.f, bias_n = 0.f, h = 0.f;
  int len = 0;
  if (gate) {
    bias_r = a.bh[unit];
    bias_z = a.bh[H + unit];
    bias_n = a.bh[2 * H + unit];
    len = a.vl[row0 + gb];
    h = a.h0[static_cast<long long>(row0 + gb) * H + unit];
  }
  // the cluster's last live step: every CTA of it computes the same
  int t_end = 0;
  for (int b = 0; b < nb; ++b) t_end = max(t_end, min(max(a.vl[row0 + b], 0), a.T));

  const uint32_t bars = smem_addr(bar);  // bar[i] at bars + 8 i
  if (tid == 0) {
    mbar_init(bars);
    mbar_init(bars + 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // every CTA of the cluster runs, its mbarriers are initialised and h0 is
  // in its buffer 0 before any st.async
  cluster_sync();

  const uint32_t bytes = static_cast<uint32_t>(nb) * H * 4;
  const float* gx = a.gx + (row0 + gb) * a.gx_sb + unit;
  float xr = 0.f, xz = 0.f, xn = 0.f;
  if (gate && t_end > 0) {
    xr = gx[0];
    xz = gx[H];
    xn = gx[2 * H];
  }
  const int V = start % 4 == 0 && U % 4 == 0 ? 4 : start % 2 == 0 && U % 2 == 0 ? 2 : 1;
  for (int t = 0; t < t_end; ++t) {
    const bool send = t + 1 < t_end;
    const uint32_t bar_next = bars + 8 * ((t + 1) & 1);
    // bar_next's previous phase (step t - 1's h) completed before step t - 1
    if (tid == 0 && send) mbar_expect(bar_next, bytes);
    if (t > 0) mbar_wait(bars + 8 * (t & 1), ((t - 1) >> 1) & 1);

    if (prod) {
      const float* hs = hbuf + (t & 1) * R * HP + k_first;
      float acc[3][R];
#pragma unroll
      for (int g = 0; g < 3; ++g) {
#pragma unroll
        for (int b = 0; b < R; ++b) acc[g][b] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < kRegL; i += 4) {
        const float4 wv[3] = {make_float4(w[0][i], w[0][i + 1], w[0][i + 2], w[0][i + 3]),
                              make_float4(w[1][i], w[1][i + 1], w[1][i + 2], w[1][i + 3]),
                              make_float4(w[2][i], w[2][i + 1], w[2][i + 2], w[2][i + 3])};
        fma_rows4<R>(acc, hs + i, HP, wv);
      }
      for (int i = 0; i < LR; i += 4) {
        const float4* wq = reinterpret_cast<const float4*>(wres) + (i >> 2) * 3 * NP + tid;
        const float4 wv[3] = {wq[0], wq[NP], wq[2 * NP]};
        fma_rows4<R>(acc, hs + kRegL + i, HP, wv);
      }
      for (int c = 0; c < n_chunks; ++c, ++used) {
        // the next chunk (the first of the next step after the last) into
        // the other slot, whose chunk this thread consumed last; then wait
        // for this one
        const int c_next = c + 1 == n_chunks ? 0 : c + 1;
        issue_chunk(ring + ((used + 1) & 1) * slot_floats, wcol, col_ok,
                    k_stream + c_next * kChunkRows, H, a.wh_sk, NP, tid, vec, a.wh);
        cp_async_wait_ring();
        const float4* wq = reinterpret_cast<const float4*>(ring + (used & 1) * slot_floats) + tid;
        const float* hc = hs + kRegL + LR + c * kChunkRows;
#pragma unroll
        for (int q4 = 0; q4 < kChunkRows / 4; ++q4) {
          const float4 wv[3] = {wq[(q4 * 3) * NP], wq[(q4 * 3 + 1) * NP],
                                wq[(q4 * 3 + 2) * NP]};
          fma_rows4<R>(acc, hc + 4 * q4, HP, wv);
        }
      }
#pragma unroll
      for (int b = 0; b < R; ++b) {
#pragma unroll
        for (int g = 0; g < 3; ++g) red[(s * R + b) * J + g * UM + u] = acc[g][b];
      }
    }
    __syncthreads();  // the partials are complete; the product read h(t)

    if (gate) {
      float hr = 0.f, hz = 0.f, hn = 0.f;
      for (int q = 0; q < S; ++q) {
        const float* pp = red + (q * R + gb) * J;
        hr += pp[gu];
        hz += pp[UM + gu];
        hn += pp[2 * UM + gu];
      }
      hr += bias_r;
      hz += bias_z;
      hn += bias_n;
      const float r = 1.f / (1.f + expf(-(xr + hr)));
      const float z = 1.f / (1.f + expf(-(xz + hz)));
      const float n = tanhf(xn + r * hn);
      const float h_new = (1.f - z) * n + z * h;
      const bool alive = t < len;
      if (alive) h = h_new;
      a.ys[t * a.ys_st + (row0 + gb) * a.ys_sb + unit] = alive ? h_new : 0.f;
      stage[gb * UP + gu] = h;
      if (send) {  // in flight across the exchange
        const float* g = gx + (t + 1) * a.gx_st;
        xr = g[0];
        xz = g[H];
        xn = g[2 * H];
      }
    }
    if (send) {
      __syncthreads();  // the staged units are complete
      float* hnext = hbuf + ((t + 1) & 1) * R * HP;
      if (V == 4) {
        send_units<4>(stage, hnext, bar_next, nb, U, UP, HP, start, C, tid, n_threads);
      } else if (V == 2) {
        send_units<2>(stage, hnext, bar_next, nb, U, UP, HP, start, C, tid, n_threads);
      } else {
        send_units<1>(stage, hnext, bar_next, nb, U, UP, HP, start, C, tid, n_threads);
      }
    }
  }
  if (gate) a.hfin[static_cast<long long>(row0 + gb) * H + unit] = h;
  // the steps past the cluster's longest row: zeros
  const int pairs = nb * U;
  for (int i = tid; i < (a.T - t_end) * pairs; i += n_threads) {
    const int tz = t_end + i / pairs, b = (i % pairs) / U, k = i % U;
    a.ys[tz * a.ys_st + (row0 + b) * a.ys_sb + start + k] = 0.f;
  }
  // the ring's last copies land before the CTA exits
  cp_async_wait_all();
  // no CTA exits while a peer may still store into its shared memory
  cluster_sync();
}

// The attributes a launch of `kernel` needs, and whether one cluster of C
// CTAs of `threads` threads and `smem` bytes fits on the card (asked of
// cudaOccupancyMaxActiveClusters once per device and configuration).
cudaError_t launch_cluster(const void* kernel, int C, dim3 grid, int threads,
                           size_t smem, void* stream, void** args) {
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  if (smem + kStaticSmem > static_cast<size_t>(optin)) return cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if (C > 8) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;

  struct Fit {
    int device;
    const void* kernel;
    size_t smem;
    int threads, C;
  };
  static Fit fits[256];  // configurations known to fit
  static int n_fits = 0;
  bool known = false;
  for (int i = 0; i < n_fits; ++i) {
    const Fit& f = fits[i];
    known = known || (f.device == device && f.kernel == kernel &&
                      f.smem == smem && f.threads == threads && f.C == C);
  }
  if (!known) {
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (clusters < 1) return cudaErrorInvalidConfiguration;
    if (n_fits < 256) fits[n_fits++] = Fit{device, kernel, smem, threads, C};
  }
  err = cudaLaunchKernelExC(&cfg, kernel, args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Whether (H, C, S, L, R, LR) is a partition the kernel takes (gru.general_plan
// in the wrapper chooses one and mirrors these rules).
bool valid_plan(int H, int C, int S, int L, int R, int LR) {
  if (H < 1 || H > kMaxH || C != min(kMaxCluster, H) || S < 1 || L < kRegL ||
      L % kChunkRows || static_cast<long long>(S) * L < H || LR < 0 ||
      LR % kChunkRows || LR > L - kRegL || R < 1 || R > kMaxRows || (R & (R - 1)))
    return false;
  const Plan p = make_plan(H, C, S, L, R, LR);
  return p.NP <= kMaxThreads && R * p.UM <= kMaxThreads &&
         4LL * p.total <= kSmemLimit - kStaticSmem;
}

const void* kernel_for(int R) {
  switch (R) {
    case 1: return reinterpret_cast<const void*>(gru_recurrence_general_kernel<1>);
    case 2: return reinterpret_cast<const void*>(gru_recurrence_general_kernel<2>);
    case 4: return reinterpret_cast<const void*>(gru_recurrence_general_kernel<4>);
    default: return reinterpret_cast<const void*>(gru_recurrence_general_kernel<8>);
  }
}

}  // namespace

// Dynamic shared memory (bytes) of one CTA, or -1 if the kernel does not take
// the partition; the wrapper's mirror (gru.general_plan) computes the same.
extern "C" long long gru_recurrence_general_smem_bytes(int H, int C, int S, int L,
                                                       int R, int LR) {
  if (!valid_plan(H, C, S, L, R, LR)) return -1;
  return 4LL * make_plan(H, C, S, L, R, LR).total;
}

// Returns the CUDA error code (0 on success). The wrapper checks shapes and
// dtypes and picks the partition (C, S, L, R, LR); one cluster of C CTAs
// per R rows.
extern "C" int gru_recurrence_general_launch(
    const float* gx, long long gx_st, long long gx_sb, const float* h0,
    const float* wh, long long wh_sk, long long wh_sj, const float* bh,
    const int* vl, float* ys, long long ys_st, long long ys_sb, float* hfin,
    int T, int B, int H, int C, int S, int L, int R, int LR, void* stream) {
  if (!valid_plan(H, C, S, L, R, LR) || T < 0 || B < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  GruArgs a{gx, gx_st, gx_sb, h0, wh, wh_sk, wh_sj, bh, vl,
            ys, ys_st, ys_sb, hfin, T, B, H, C, S, L, LR};
  void* args[] = {&a};
  const Plan p = make_plan(H, C, S, L, R, LR);
  const dim3 grid(C, (B + R - 1) / R, 1);
  const size_t smem = static_cast<size_t>(4LL * p.total);
  return static_cast<int>(launch_cluster(kernel_for(R), C, grid, p.NT, smem, stream, args));
}
