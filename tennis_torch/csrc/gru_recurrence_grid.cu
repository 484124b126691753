// GRU recurrence over precomputed input gates at the widths where one
// cluster cannot hold Wh (H past ~560 up to 1023), one launch for all T
// steps: Wh spread whole over the registers and shared memory of several
// clusters of CTAs, loaded once, and the hidden state exchanged between the
// CTAs through L2 each step.
//
// Replaces tennis_tpu/ops/pallas/gru.py::_recurrence_kernel (launched by
// gru_recurrence_pallas) where csrc/gru_recurrence_general.cu streams part
// of Wh from L2 every step: the TPU kernel holds Wh in its 12 MiB of VMEM
// up to H 1020 at T 1, B 4 (737 at the 0102 encoder's T 128, B 4). Given
// gates_x (T, B, 3H) = x.Wx + bx, h0 (B, H), Wh (H, 3H), bh (3H) and
// valid_length (B), each step computes
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
// What bounds it: the T steps are a serial chain. One cluster of 16 CTAs
// holds at most ~4.7 MB of Wh (registers and 227 KB of shared memory an
// SM); Wh is 12 H^2 bytes (4.9 MB at H 640, 12.6 MB at 1023), so the
// general kernel re-reads the rest from L2 every step, and one SM draws it
// at ~18 GB/s. Spread over G = N x 16 CTAs, Wh stays on chip and a step is a
// (R, H) x (H, 3 H / G) product per CTA, the gate math and one exchange of
// the new h (R H floats) between all G CTAs: the floor of a step is that
// exchange's round trip through L2.
//
// Design. For each chunk of R <= 8 batch rows, a grid of N clusters of
// kCluster CTAs, one CTA an SM; N is the least that holds the slice (the
// wrapper's gru.grid_plan). CTA k of the G owns the contiguous run of
// floor(H / G) or ceil(H / G) units that starts at k floor(H / G) +
// min(k, H mod G), and the r, z and n columns of Wh for them. Thread (u, s)
// of the UM * S product threads (UM = ceil(H / G)) sums rows [s L, (s + 1)
// L) of the three columns of its unit u, L a multiple of 4 of at least
// kRegL with S L >= H: the first kRegL rows from registers, the other L -
// kRegL from shared memory, both loaded once before step 0. Rows past H and
// the column of a unit a CTA does not own carry zero weights and the h
// buffer holds zeros past H, so they add 0.0 to every sum.
//
// The exchange goes through L2 for every CTA, those of its own cluster too:
// with N >= 2 clusters every CTA needs the units of another cluster each
// step, so the L2 round trip is on every step's critical path, and an
// st.async exchange inside the cluster beside it would shorten nothing but
// the loads of the cluster's own units, which run in parallel with the
// others. Each gate thread stores its new unit into a double-buffered h in
// device memory ([2][B][HX], HX = H rounded up to 4; st.global.cg), the CTA
// synchronises, and one thread adds 1 to the chunk's counter with release
// semantics at GPU scope. Before step t + 1, one thread waits with
// ld.acquire.gpu until the counter reaches G (t + 1), the CTA synchronises,
// and its threads copy h(t + 1) into shared memory with ld.global.cg (L2,
// never L1, which is not coherent across SMs). Two buffers are enough: a
// CTA stores h(t + 2) into buffer t & 1 only after every CTA has arrived
// with h(t + 1), and each arrived after its copy of h(t) was done. The
// counters and the buffer are a workspace the wrapper zeroes for each
// launch, so launches on two streams never share one.
//
// Every CTA of a chunk spins on the others, so the launch must have all of
// them resident at once: it is cooperative, and the launcher refuses a grid
// larger than cudaOccupancyMaxActiveClusters allows; a wait longer than
// kSpinCycles traps, so a fault ends the launch with an error instead of a
// hang. R is the one template argument (4 instances); every other size is
// a runtime value.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxH = 1023;          // hidden size, at most
constexpr int kCluster = 16;         // CTAs per cluster
constexpr int kMaxCtas = 112;        // CTAs of a launch (every chunk), at most: the
                                     // 7 clusters an H100 SXM holds at once
constexpr int kMaxThreads = 256;     // threads per CTA, at most
constexpr int kMaxRows = 8;          // batch rows per chunk (R)
constexpr int kRegL = 32;            // rows of each column a thread keeps in registers
constexpr int kRowAlign = 4;         // L is a multiple of it (float4 groups)
constexpr int kCounterStride = 32;   // ints from one chunk's counter to the next
constexpr int kSmemLimit = 232448;   // H100: the most a block can opt in to
constexpr long long kSpinCycles = 2000000000LL;  // ~1 s of SM clock

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
  unsigned int* counters;  // [chunks][kCounterStride], zero at launch
  float* hx;             // [2][B][HX], zero at launch
  int T, B, H, G, S, L;  // rows per chunk (R) are a template argument
};

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// The partition and the dynamic shared memory of one CTA, in floats: the
// chunk's h [R][HP] (HP = S L, zeros past H); the partial sums
// [S][R][3 UM]; the rows past the registers as float4 groups of 4 rows
// [(L - kRegL) / 4][3][NP][4] (NP = UM S product threads).
struct Plan {
  int UM, NP, NT, HP, HX;
  int red, wres, total;
};

__host__ __device__ inline Plan make_plan(int H, int G, int S, int L, int R) {
  Plan p;
  p.UM = (H + G - 1) / G;
  p.NP = p.UM * S;
  const int nt = p.NP > R * p.UM ? p.NP : R * p.UM;
  p.NT = (nt + 31) / 32 * 32;
  p.HP = S * L;
  p.HX = round4(H);
  p.red = R * p.HP;
  p.wres = p.red + round4(S * R * 3 * p.UM);
  p.total = p.wres + 3 * (L - kRegL) * p.NP;
  return p;
}

// One arrival on a chunk's counter: every store this CTA made before the
// CTA barrier that precedes it is visible at GPU scope to whoever reads the
// count that includes it.
__device__ __forceinline__ void arrive(unsigned int* counter) {
  asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" :: "l"(counter) : "memory");
}

__device__ __forceinline__ unsigned int load_acquire(const unsigned int* counter) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(counter) : "memory");
  return v;
}

// Returns once `counter` reaches `target`; traps after kSpinCycles.
__device__ __forceinline__ void wait_arrivals(const unsigned int* counter,
                                              unsigned int target) {
  const long long t0 = clock64();
  while (load_acquire(counter) < target) {
    if (clock64() - t0 > kSpinCycles) __trap();
  }
}

// Copies rows [0, nb) of the exchanged h (row stride HX floats, from L2)
// into `hbuf` (row stride HP).
__device__ __forceinline__ void load_h(float* hbuf, const float* src, int nb,
                                       int HX, int HP, int tid, int n_threads) {
  const int q4 = HX / 4;
  for (int i = tid; i < nb * q4; i += n_threads) {
    const int b = i / q4, q = i % q4;
    const float4 v = __ldcg(reinterpret_cast<const float4*>(src + b * HX) + q);
    *reinterpret_cast<float4*>(hbuf + b * HP + 4 * q) = v;
  }
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
gru_recurrence_grid_kernel(GruArgs a) {
  const int rank = blockIdx.x;  // of the G CTAs of this chunk
  const int H = a.H, G = a.G, S = a.S, L = a.L, LR = L - kRegL;
  const Plan p = make_plan(H, G, S, L, R);
  const int UM = p.UM, J = 3 * UM, NP = p.NP, HP = p.HP, HX = p.HX;
  const int base = H / G, extra = H % G;
  const int U = base + (rank < extra ? 1 : 0);       // this CTA's units
  const int start = rank * base + min(rank, extra);  // its first unit
  const int row0 = blockIdx.y * R;
  const int nb = min(R, a.B - row0);
  const int tid = threadIdx.x, n_threads = blockDim.x;
  unsigned int* counter = a.counters + blockIdx.y * kCounterStride;

  extern __shared__ __align__(16) float smem[];
  float* hbuf = smem;
  float* red = smem + p.red;
  float* wres = smem + p.wres;

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
  // h0; rows past the chunk's nb and units past H stay zero (the exchange
  // copies only nb rows, and zeros past H)
  for (int i = tid; i < R * HP; i += n_threads) {
    const int b = i / HP, k = i % HP;
    hbuf[i] = b < nb && k < H ? a.h0[static_cast<long long>(row0 + b) * H + k] : 0.f;
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
  // the chunk's last live step: every CTA of it computes the same, so all
  // make the same number of arrivals
  int t_end = 0;
  for (int b = 0; b < nb; ++b) t_end = max(t_end, min(max(a.vl[row0 + b], 0), a.T));

  const float* gx = a.gx + (row0 + gb) * a.gx_sb + unit;
  float xr = 0.f, xz = 0.f, xn = 0.f;
  if (gate && t_end > 0) {
    xr = gx[0];
    xz = gx[H];
    xn = gx[2 * H];
  }
  __syncthreads();  // h0 and the resident weights are in shared memory
  for (int t = 0; t < t_end; ++t) {
    const bool send = t + 1 < t_end;
    if (t > 0) {
      if (tid == 0) wait_arrivals(counter, static_cast<unsigned int>(G * t));
      __syncthreads();  // every CTA's h(t) is visible
      load_h(hbuf, a.hx + (static_cast<long long>(t & 1) * a.B + row0) * HX, nb,
             HX, HP, tid, n_threads);
      __syncthreads();
    }

    if (prod) {
      const float* hs = hbuf + k_first;
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
      if (send) {
        __stcg(a.hx + (static_cast<long long>((t + 1) & 1) * a.B + row0 + gb) * HX + unit, h);
        const float* g = gx + (t + 1) * a.gx_st;  // in flight across the exchange
        xr = g[0];
        xz = g[H];
        xn = g[2 * H];
      }
    }
    if (send) {
      __syncthreads();  // every new unit of this CTA is stored
      if (tid == 0) arrive(counter);
    }
  }
  if (gate) a.hfin[static_cast<long long>(row0 + gb) * H + unit] = h;
  // the steps past the chunk's longest row: zeros
  const int pairs = nb * U;
  for (int i = tid; i < (a.T - t_end) * pairs; i += n_threads) {
    const int tz = t_end + i / pairs, b = (i % pairs) / U, k = i % U;
    a.ys[tz * a.ys_st + (row0 + b) * a.ys_sb + start + k] = 0.f;
  }
}

// The exchange alone, `iters` times: each CTA of G stores its run of the
// H units of `nb` rows, arrives, waits for the G arrivals and copies the
// nb x H floats back from L2, as the kernel does between two steps.
__global__ void __launch_bounds__(kMaxThreads, 1)
grid_exchange_probe_kernel(unsigned int* counter, float* hx, int iters, int nb,
                           int H, float* sink) {
  extern __shared__ __align__(16) float smem[];
  const int G = gridDim.x, rank = blockIdx.x, HX = round4(H);
  const int base = H / G, extra = H % G;
  const int U = base + (rank < extra ? 1 : 0);
  const int start = rank * base + min(rank, extra);
  const int tid = threadIdx.x, n_threads = blockDim.x;
  float acc = 0.f;
  for (int it = 0; it < iters; ++it) {
    float* slot = hx + static_cast<long long>(it & 1) * nb * HX;
    for (int i = tid; i < nb * U; i += n_threads) {
      __stcg(slot + (i / U) * HX + start + i % U, acc + i);
    }
    __syncthreads();
    if (tid == 0) {
      arrive(counter);
      wait_arrivals(counter, static_cast<unsigned int>(G * (it + 1)));
    }
    __syncthreads();
    load_h(smem, slot, nb, HX, HX, tid, n_threads);
    __syncthreads();
    acc += smem[tid % (nb * HX)];
  }
  if (tid == 0) sink[rank] = acc;
}

// Launches `kernel` cooperatively as clusters of kCluster CTAs over `grid`,
// after checking that every CTA can be resident at once (asked of
// cudaOccupancyMaxActiveClusters once per device and configuration).
cudaError_t launch_grid(const void* kernel, dim3 grid, int threads, size_t smem,
                        void* stream, void** args) {
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  if (smem > static_cast<size_t>(optin)) return cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if (kCluster > 8) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;  // the occupancy query takes the cluster alone

  struct Fit {
    int device;
    const void* kernel;
    size_t smem;
    int threads, clusters;
  };
  static Fit fits[256];  // the resident clusters of each configuration
  static int n_fits = 0;
  int clusters = -1;
  for (int i = 0; i < n_fits; ++i) {
    const Fit& f = fits[i];
    if (f.device == device && f.kernel == kernel && f.smem == smem &&
        f.threads == threads) {
      clusters = f.clusters;
    }
  }
  if (clusters < 0) {
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (n_fits < 256) fits[n_fits++] = Fit{device, kernel, smem, threads, clusters};
  }
  if (static_cast<long long>(clusters) * kCluster < static_cast<long long>(grid.x) * grid.y) {
    return cudaErrorCooperativeLaunchTooLarge;
  }
  cfg.numAttrs = 2;
  err = cudaLaunchKernelExC(&cfg, kernel, args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// Whether (H, G, S, L, R) over B rows is a partition the kernel takes
// (gru.grid_plan in the wrapper chooses one and mirrors these rules).
bool valid_plan(int H, int G, int S, int L, int R, int B) {
  if (H < 1 || H > kMaxH || G < kCluster || G % kCluster || G > H || S < 1 ||
      L < kRegL || L % kRowAlign || static_cast<long long>(S) * L < H || R < 1 ||
      R > kMaxRows || (R & (R - 1)) || B < 1 ||
      static_cast<long long>(G) * ((B + R - 1) / R) > kMaxCtas)
    return false;
  const Plan p = make_plan(H, G, S, L, R);
  return p.NP <= kMaxThreads && R * p.UM <= kMaxThreads && 4LL * p.total <= kSmemLimit;
}

const void* kernel_for(int R) {
  switch (R) {
    case 1: return reinterpret_cast<const void*>(gru_recurrence_grid_kernel<1>);
    case 2: return reinterpret_cast<const void*>(gru_recurrence_grid_kernel<2>);
    case 4: return reinterpret_cast<const void*>(gru_recurrence_grid_kernel<4>);
    default: return reinterpret_cast<const void*>(gru_recurrence_grid_kernel<8>);
  }
}

}  // namespace

// Dynamic shared memory (bytes) of one CTA, or -1 if the kernel does not take
// the partition; the wrapper's mirror (gru.grid_plan) computes the same.
extern "C" long long gru_recurrence_grid_smem_bytes(int H, int G, int S, int L,
                                                    int R, int B) {
  if (!valid_plan(H, G, S, L, R, B)) return -1;
  return 4LL * make_plan(H, G, S, L, R).total;
}

// Clusters of kCluster CTAs of the kernel for R rows that the card holds at
// once with `smem` bytes of dynamic shared memory each (0 where it holds
// none), or minus the CUDA error code.
extern "C" int gru_recurrence_grid_resident_clusters(int R, long long smem) {
  const void* kernel = kernel_for(R);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess && kCluster > 8) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, 1, 1);
  cfg.blockDim = dim3(kMaxThreads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  return err == cudaSuccess ? clusters : -static_cast<int>(err);
}

// Returns the CUDA error code (0 on success). The wrapper checks shapes and
// dtypes, picks the partition (G, S, L, R) and passes a zeroed workspace of
// kCounterStride ints per chunk of R rows followed by 2 B round4(H) floats;
// one grid of G CTAs per chunk.
extern "C" int gru_recurrence_grid_launch(
    const float* gx, long long gx_st, long long gx_sb, const float* h0,
    const float* wh, long long wh_sk, long long wh_sj, const float* bh,
    const int* vl, float* ys, long long ys_st, long long ys_sb, float* hfin,
    int T, int B, int H, int G, int S, int L, int R, void* workspace,
    void* stream) {
  if (!valid_plan(H, G, S, L, R, B) || T < 0 || workspace == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int chunks = (B + R - 1) / R;
  unsigned int* counters = static_cast<unsigned int*>(workspace);
  float* hx = reinterpret_cast<float*>(counters + chunks * kCounterStride);
  GruArgs a{gx, gx_st, gx_sb, h0, wh, wh_sk, wh_sj, bh, vl, ys, ys_st, ys_sb,
            hfin, counters, hx, T, B, H, G, S, L};
  void* args[] = {&a};
  const Plan p = make_plan(H, G, S, L, R);
  return static_cast<int>(launch_grid(kernel_for(R), dim3(G, chunks, 1), p.NT,
                                      static_cast<size_t>(4LL * p.total), stream,
                                      args));
}

// The exchange probe: `iters` exchanges of nb x H floats among G CTAs (a
// multiple of kCluster, at most kMaxCtas), through a zeroed workspace of
// kCounterStride ints followed by 2 nb round4(H) floats; `sink` holds G
// floats.
extern "C" int gru_grid_exchange_probe_launch(int iters, int nb, int H, int G,
                                              void* workspace, float* sink,
                                              void* stream) {
  if (iters < 1 || nb < 1 || nb > kMaxRows || H < 1 || H > kMaxH || G < kCluster ||
      G % kCluster || G > kMaxCtas || G > H || workspace == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  unsigned int* counter = static_cast<unsigned int*>(workspace);
  float* hx = reinterpret_cast<float*>(counter + kCounterStride);
  void* args[] = {&counter, &hx, &iters, &nb, &H, &sink};
  return static_cast<int>(launch_grid(
      reinterpret_cast<const void*>(grid_exchange_probe_kernel), dim3(G, 1, 1),
      kMaxThreads, static_cast<size_t>(4LL * nb * round4(H)), stream, args));
}
