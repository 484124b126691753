// GRU recurrence over precomputed input gates, one launch for all T steps:
// Wh kept in registers, the hidden state exchanged with st.async and
// mbarriers instead of a per-step cluster barrier.
//
// Replaces tennis_tpu/ops/pallas/gru.py::_recurrence_kernel (launched by
// gru_recurrence_pallas), as csrc/gru_recurrence.cu does: given gates_x
// (T, B, 3H) = x.Wx + bx, h0 (B, H), Wh (H, 3H), bh (3H) and valid_length
// (B), each step computes
//   gh = h.Wh + bh
//   r = sigmoid(gx_r + gh_r), z = sigmoid(gx_z + gh_z)
//   n = tanh(gx_n + r * gh_n), h' = (1 - z) n + z h
// (gate order r, z, n); rows with t >= valid_length keep their carry and
// output 0. Outputs ys (T, B, H) and h_final (B, H), all f32, with expf and
// tanhf (no fast-math).
//
// What bounds it: the T steps are a serial chain; the layer's bytes and
// FLOPs take a few microseconds of the card in all, so the floor is T times
// one step's latency: a (R, H) x (H, 3U) product per CTA, the gate math and
// one exchange of the new h between the CTAs of a cluster (on the H100 an
// st.async + mbarrier round trip takes ~0.3 us at 8 CTAs, ~0.5-1.2 us at 16).
//
// Design. One thread-block cluster of C CTAs (8, or 16 with the
// non-portable cluster size) per chunk of R <= 8 batch rows. CTA k owns
// hidden units [kU, kU + U), U = H / C, and the r, z and n columns of Wh for
// them. Thread (unit u, segment s) keeps the L = H / S weights of its
// segment of all three columns of unit u: the first KR = min(L, kRegL) of
// each in registers for all T steps, the rest (where the slice is larger
// than the register file allows: H = 512 at C = 16 is 192 KiB a CTA) in
// shared memory. R and KR are template arguments, so the product's loops
// unroll with no runtime check (on the H100 a check per 4-row chunk cost
// 11% of a step). No weight is read from device memory inside the loop.
// Each h value a thread loads from shared memory feeds three FMAs: with one
// column a thread, the broadcast reads of h took 3.3 us of a step. Each
// step, CTA k
//   1. waits, by parity, on its own mbarrier for the step's h buffer,
//   2. computes its partial dot products (each thread: its segment of its
//      three columns, for every row, summed in k order),
//   3. after a CTA barrier, sums the S partials of each (row, unit) in
//      segment order, does the gate math and the valid-length mask, writes
//      ys[t] and stages the new units in a local row,
//   4. after a second CTA barrier, sends them into the next h buffer of
//      every CTA of the cluster (itself included) as 16-byte (8- or 4-byte
//      where U is not a multiple of 4)
//      st.async.shared::cluster.mbarrier::complete_tx::bytes stores, which
//      count the bytes on that CTA's mbarrier for the buffer (one bulk copy
//      per row and peer instead was slower by a third).
// Each CTA arms its mbarrier for the next buffer with the bytes it expects
// (nb rows x H floats) once a step; stores that land before the arming
// drive the transaction count below zero, which the mbarrier allows.
//
// Two h buffers are enough because of the CTA barrier between the product
// (step 2) and the sends (step 4): a peer can store step t + 1's values into
// buffer t & 1 only after it has received this CTA's step-t values, which
// this CTA sends only after every one of its threads has finished the step-t
// product that read that buffer. For the same reason no mbarrier receives
// bytes for a phase before its previous phase has completed.
//
// One cluster barrier at the start (every CTA runs, the mbarriers are
// initialised, h0 is in place) and one before exit (no CTA exits while a
// peer may still store into it); none inside the loop. The gate threads load
// gates_x[t + 1] before the wait for step t + 1's h. A cluster's loop stops
// at its rows' longest valid length; the steps past it only write zeros.
// Sums run in a fixed order, so two launches agree bit for bit. No tensor
// cores: the step is latency-bound at 1-8 rows, and TF32 would break the
// 1e-4 f32 agreement with the plain version.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;  // U * S threads per CTA, at most
constexpr int kMaxRows = 8;       // batch rows per cluster (R)
constexpr int kRegL = 32;         // weights of each column a thread keeps in registers
constexpr int kMaxH = 512;        // hidden size, at most
constexpr int kSmemLimit = 232448;  // H100: the most a block can opt in to
constexpr int kProbeFloats = kMaxRows * kMaxH;

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
  int T, B, H, S;  // rows per cluster (R) are a template argument
};

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// Dynamic shared memory of one CTA, in floats: the chunk's h, double
// buffered [2][R][H]; the partial sums [S][R][3U]; the staged new units
// [R][U]; the weights past kRegL of each column of every thread
// [3 (L - kRegL)][U * S].
struct Layout {
  int red, stage, wtail, total;
};

__host__ __device__ inline Layout layout(int H, int C, int S, int R) {
  const int U = H / C, L = H / S;
  const int tail = L > kRegL ? L - kRegL : 0;
  Layout l;
  l.red = 2 * R * H;
  l.stage = l.red + round4(S * R * 3 * U);
  l.wtail = l.stage + round4(R * U);
  l.total = l.wtail + 3 * tail * U * S;
  return l;
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

// Sends this CTA's staged units ([nb][U] at `stage`) to offset rank * U of
// every row of the h buffer at `hnext` in each of the C CTAs.
template <int C, int V>
__device__ __forceinline__ void send_units(const float* stage, float* hnext,
                                           uint32_t bar, int nb, int U, int H,
                                           int rank, int tid, int n_threads) {
  const int per_row = U / V;
  for (int i = tid; i < nb * per_row * C; i += n_threads) {
    const int q = i % C, v = i / C;
    const int b = v / per_row, e = (v % per_row) * V;
    st_async<V>(map_rank(smem_addr(hnext + b * H + rank * U + e), q),
                stage + b * U + e, map_rank(bar, q));
  }
}

template <int C, int R, int KR>
__global__ void __launch_bounds__(kMaxThreads, 1)
gru_recurrence_async_kernel(GruArgs a) {
  const int rank = static_cast<int>(cluster_rank());
  const int H = a.H, U = H / C, J = 3 * U, S = a.S, L = H / S;
  const int n_threads = U * S;
  const int LS = L - KR;  // weights of a column in shared memory
  const int row0 = blockIdx.y * R;
  const int nb = min(R, a.B - row0);
  const int tid = threadIdx.x;

  extern __shared__ __align__(16) float smem[];
  __shared__ __align__(8) uint64_t bar[2];  // one per h buffer
  const Layout lay = layout(H, C, S, R);
  float* hbuf = smem;
  float* red = smem + lay.red;
  float* stage = smem + lay.stage;
  float* wtail = smem + lay.wtail;

  // thread (unit u, segment s): rows [sL, sL + L) of Wh's r, z and n
  // columns of unit rank U + u
  const int u = tid % U, s = tid / U;
  float w[3][KR];
#pragma unroll
  for (int g = 0; g < 3; ++g) {
    const float* wsrc = a.wh + static_cast<long long>(g * H + rank * U + u) * a.wh_sj +
                        static_cast<long long>(s) * L * a.wh_sk;
#pragma unroll
    for (int i = 0; i < KR; ++i) w[g][i] = wsrc[i * a.wh_sk];
    for (int i = 0; i < LS; ++i) {
      wtail[(g * LS + i) * n_threads + tid] = wsrc[(KR + i) * a.wh_sk];
    }
  }
  // h0 into buffer 0; rows past the chunk's nb stay zero in both buffers
  // (the product runs all R rows; no CTA sends those)
  for (int i = tid; i < 2 * R * H; i += n_threads) {
    const int b = i / H;
    hbuf[i] = b < nb ? a.h0[static_cast<long long>(row0 + b) * H + i % H] : 0.f;
  }

  // gate thread: (row gb, unit `unit`) of this CTA's nb x U pairs
  const bool gate = tid < nb * U;
  const int gb = tid / U, gu = tid % U, unit = rank * U + gu;
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
  for (int t = 0; t < t_end; ++t) {
    const bool send = t + 1 < t_end;
    const uint32_t bar_next = bars + 8 * ((t + 1) & 1);
    // bar_next's previous phase (step t - 1's h) completed before step t - 1
    if (tid == 0 && send) mbar_expect(bar_next, bytes);
    if (t > 0) mbar_wait(bars + 8 * (t & 1), ((t - 1) >> 1) & 1);
    const float* hs = hbuf + (t & 1) * R * H + s * L;

    float acc[3][R];
#pragma unroll
    for (int g = 0; g < 3; ++g) {
#pragma unroll
      for (int b = 0; b < R; ++b) acc[g][b] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < KR; i += 4) {
#pragma unroll
      for (int b = 0; b < R; ++b) {
        const float4 hv = *reinterpret_cast<const float4*>(hs + b * H + i);
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          acc[g][b] = fmaf(hv.x, w[g][i], acc[g][b]);
          acc[g][b] = fmaf(hv.y, w[g][i + 1], acc[g][b]);
          acc[g][b] = fmaf(hv.z, w[g][i + 2], acc[g][b]);
          acc[g][b] = fmaf(hv.w, w[g][i + 3], acc[g][b]);
        }
      }
    }
    for (int i = 0; i < LS; i += 4) {
      float wt[3][4];
#pragma unroll
      for (int g = 0; g < 3; ++g) {
#pragma unroll
        for (int e = 0; e < 4; ++e) wt[g][e] = wtail[(g * LS + i + e) * n_threads + tid];
      }
#pragma unroll
      for (int b = 0; b < R; ++b) {
        const float4 hv = *reinterpret_cast<const float4*>(hs + b * H + KR + i);
#pragma unroll
        for (int g = 0; g < 3; ++g) {
          acc[g][b] = fmaf(hv.x, wt[g][0], acc[g][b]);
          acc[g][b] = fmaf(hv.y, wt[g][1], acc[g][b]);
          acc[g][b] = fmaf(hv.z, wt[g][2], acc[g][b]);
          acc[g][b] = fmaf(hv.w, wt[g][3], acc[g][b]);
        }
      }
    }
#pragma unroll
    for (int b = 0; b < R; ++b) {
#pragma unroll
      for (int g = 0; g < 3; ++g) red[(s * R + b) * J + g * U + u] = acc[g][b];
    }
    __syncthreads();  // the partials are complete; the product read h(t)

    if (gate) {
      float hr = 0.f, hz = 0.f, hn = 0.f;
#pragma unroll 8
      for (int q = 0; q < S; ++q) {
        const float* p = red + (q * R + gb) * J;
        hr += p[gu];
        hz += p[U + gu];
        hn += p[2 * U + gu];
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
      stage[gb * U + gu] = h;
      if (send) {  // in flight across the exchange
        const float* g = gx + (t + 1) * a.gx_st;
        xr = g[0];
        xz = g[H];
        xn = g[2 * H];
      }
    }
    if (send) {
      __syncthreads();  // the staged units are complete
      float* hnext = hbuf + ((t + 1) & 1) * R * H;
      if (U % 4 == 0) {
        send_units<C, 4>(stage, hnext, bar_next, nb, U, H, rank, tid, n_threads);
      } else if (U % 2 == 0) {
        send_units<C, 2>(stage, hnext, bar_next, nb, U, H, rank, tid, n_threads);
      } else {
        send_units<C, 1>(stage, hnext, bar_next, nb, U, H, rank, tid, n_threads);
      }
    }
  }
  if (gate) a.hfin[static_cast<long long>(row0 + gb) * H + unit] = h;
  // the steps past the cluster's longest row: zeros
  const int pairs = nb * U;
  for (int i = tid; i < (a.T - t_end) * pairs; i += n_threads) {
    const int tz = t_end + i / pairs, b = (i % pairs) / U, k = i % U;
    a.ys[tz * a.ys_st + (row0 + b) * a.ys_sb + rank * U + k] = 0.f;
  }
  // no CTA exits while a peer may still store into its shared memory
  cluster_sync();
}

// A cluster of C CTAs doing nothing but the exchange that chains the steps
// of the recurrence, `iters` times: each CTA arms its mbarrier for the
// C x `floats` floats it expects, sends `floats` floats into every CTA of
// the cluster as 16-byte st.async stores, and waits on its mbarrier.
// `floats` = rows x U gives the kernel's own exchange; timing it gives the
// serial floor of one step.
template <int C>
__global__ void __launch_bounds__(kMaxThreads, 1)
exchange_probe_kernel(int iters, int floats, float* sink) {
  __shared__ __align__(16) float slot[2][kProbeFloats];
  __shared__ __align__(16) float src[kProbeFloats / 8];
  __shared__ __align__(8) uint64_t bar[2];
  const int rank = static_cast<int>(cluster_rank());
  const int tid = threadIdx.x;
  for (int i = tid; i < kProbeFloats / 8; i += blockDim.x) src[i] = static_cast<float>(i);
  const uint32_t bars = smem_addr(bar);
  if (tid == 0) {
    mbar_init(bars);
    mbar_init(bars + 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();
  for (int it = 0; it < iters; ++it) {
    const uint32_t b = bars + 8 * (it & 1);
    if (tid == 0) mbar_expect(b, static_cast<uint32_t>(C * floats * 4));
    float* dst = slot[it & 1] + rank * floats;
    for (int k = tid; k < (floats / 4) * C; k += blockDim.x) {
      const int q = k % C, v = (k / C) * 4;
      st_async<4>(map_rank(smem_addr(dst + v), q), src + v, map_rank(b, q));
    }
    mbar_wait(b, (it >> 1) & 1);
  }
  cluster_sync();
  if (tid == 0) sink[blockIdx.x] = slot[(iters + 1) & 1][0];
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
  if (smem + 64 > static_cast<size_t>(optin)) return cudaErrorInvalidConfiguration;
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
    int threads;
  };
  static Fit fits[64];  // configurations known to fit
  static int n_fits = 0;
  bool known = false;
  for (int i = 0; i < n_fits; ++i) {
    const Fit& f = fits[i];
    known = known || (f.device == device && f.kernel == kernel &&
                      f.smem == smem && f.threads == threads);
  }
  if (!known) {
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (clusters < 1) return cudaErrorInvalidConfiguration;
    if (n_fits < 64) fits[n_fits++] = Fit{device, kernel, smem, threads};
  }
  err = cudaLaunchKernelExC(&cfg, kernel, args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Whether (H, C, S, R) is a partition the kernel takes (gru.gru_plan in the
// wrapper chooses one and mirrors these rules): L = H / S of 8, 16, or a
// multiple of 4 from kRegL up (the registers take min(L, kRegL) rows of a
// column); R a power of two up to kMaxRows and at most S, so every
// (row, unit) pair has a gate thread.
bool valid_plan(int H, int C, int S, int R) {
  if ((C != 8 && C != 16) || H <= 0 || H > kMaxH || H % C || S <= 0 || H % S)
    return false;
  const int U = H / C, L = H / S;
  return (L == 8 || L == 16 || (L >= kRegL && L % 4 == 0)) &&
         U * S <= kMaxThreads && R >= 1 && R <= kMaxRows && (R & (R - 1)) == 0 &&
         R <= S && 4LL * layout(H, C, S, R).total <= kSmemLimit - 64;
}

template <int C, int R>
const void* kernel_for(int L) {
  switch (L) {
    case 8: return reinterpret_cast<const void*>(gru_recurrence_async_kernel<C, R, 8>);
    case 16: return reinterpret_cast<const void*>(gru_recurrence_async_kernel<C, R, 16>);
    default: return reinterpret_cast<const void*>(gru_recurrence_async_kernel<C, R, kRegL>);
  }
}

template <int C>
const void* kernel_for(int R, int L) {
  switch (R) {
    case 1: return kernel_for<C, 1>(L);
    case 2: return kernel_for<C, 2>(L);
    case 4: return kernel_for<C, 4>(L);
    default: return kernel_for<C, 8>(L);
  }
}

}  // namespace

// Dynamic shared memory (bytes) of one CTA, or -1 if the kernel does not take
// the partition; the wrapper's mirror (gru.gru_plan) computes the same.
extern "C" long long gru_recurrence_async_smem_bytes(int H, int C, int S, int R) {
  if (!valid_plan(H, C, S, R)) return -1;
  return 4LL * layout(H, C, S, R).total;
}

// Returns the CUDA error code (0 on success). The wrapper checks shapes and
// dtypes and picks the partition (C, S, R); one cluster of C CTAs per R rows.
extern "C" int gru_recurrence_async_launch(
    const float* gx, long long gx_st, long long gx_sb, const float* h0,
    const float* wh, long long wh_sk, long long wh_sj, const float* bh,
    const int* vl, float* ys, long long ys_st, long long ys_sb, float* hfin,
    int T, int B, int H, int C, int S, int R, void* stream) {
  if (!valid_plan(H, C, S, R) || T < 0 || B < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  GruArgs a{gx, gx_st, gx_sb, h0, wh, wh_sk, wh_sj, bh, vl,
            ys, ys_st, ys_sb, hfin, T, B, H, S};
  void* args[] = {&a};
  const dim3 grid(C, (B + R - 1) / R, 1);
  const int threads = (H / C) * S;
  const size_t smem = static_cast<size_t>(4LL * layout(H, C, S, R).total);
  const void* kernel = C == 16 ? kernel_for<16>(R, H / S) : kernel_for<8>(R, H / S);
  return static_cast<int>(launch_cluster(kernel, C, grid, threads, smem, stream, args));
}

// `floats` (a multiple of 4, C * floats <= 4096) per peer per round trip.
extern "C" int gru_exchange_probe_launch(int iters, int floats, int cluster,
                                         float* sink, void* stream) {
  if ((cluster != 8 && cluster != 16) || floats < 4 || floats % 4 ||
      cluster * floats > kProbeFloats) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  void* args[] = {&iters, &floats, &sink};
  const void* kernel = cluster == 16
      ? reinterpret_cast<const void*>(exchange_probe_kernel<16>)
      : reinterpret_cast<const void*>(exchange_probe_kernel<8>);
  return static_cast<int>(launch_cluster(kernel, cluster, dim3(cluster, 1, 1),
                                         kMaxThreads, 0, stream, args));
}
