// One DenseNet-BC dense layer at inference in f32 on Hopper's tensor cores
// (sm_90a): 3xTF32 wgmma, weights split ahead of the launch, an asynchronous ring.
//
// Replaces tennis_tpu/ops/pallas/dense_block.py::_layer_kernel (launched there
// by dense_layer_pallas) at dtype=float32, the case the pixels-path captioner
// runs: its DenseNet src_embed is built in f32, so every eval forward of its
// per-epoch decodes and of evaluate_gnmt goes through this kernel. The same
// function as dense_layer_reference at f32:
//
//   h   = relu(x * inv1 + sh1)            folded BN1, x = state[..., :c_in]
//   b   = relu((h @ w1) * inv2 + sh2)     1x1 conv c_in -> F, folded BN2
//   b   = 0 outside the image             = conv2's zero padding
//   out = conv3x3(b, w2)                  F -> G, written to state[..., c_in:c_in+G]
//
// Arithmetic (3xTF32). Every product a*b of the two convolutions is taken as
// a_lo*b_hi + a_hi*b_lo + a_hi*b_hi, small terms first, into f32
// accumulators, where hi = cvt.rna.tf32(v) and lo = cvt.rna.tf32(v - hi). The
// dropped a_lo*b_lo is ~2^-22 of the product, so the result is as exact as
// f32 FMA (one TF32 product would round each operand to 11 bits). The weights
// come split and laid out as shared-memory images (dense_block.tf32_image,
// built by the wrapper once per set of weights);
// the activations (BN1 + ReLU output, the masked bottleneck) are split in
// registers on the wgmma A fragment.
//
// What bounds it on an H100 (495 TFLOP/s TF32 dense, 3.35 TB/s): a layer does
// 2*(c_in*F + 9*F*G) FLOP per pixel, three tensor-core products each, and
// moves (c_in + G)*4 bytes per pixel: 3xTF32 is bound by operations (an f32
// DenseNet121-512 stack at batch 64: 9.75 ms, against 24.0 ms at the
// 67 TFLOP/s of the FMA units that an f32 SIMT kernel is held to).
//
// Design.
// - One CTA per 8x8 output tile. conv1 runs over the 10x10 haloed tile,
//   padded to two 64-row wgmma tiles: 128 rows for 64 output pixels, 2.0x
//   the conv1 work of its pixels (a SIMT kernel's 112 rows: 1.75x). An
//   8x16 tile (180 haloed rows, 1.5x) does not fit both sets of conv1 sums
//   below in registers; run as two conv1 passes over two ring stages it
//   measured 1.3-2.8x slower (PERF.md).
// - Warp roles: warpgroups 0 and 1 consume; the producer warpgroup's 128
//   threads fill the ring (setmaxnreg 40 / 232).
// - The ring: three stages of [w: 32 KB][x chunk]. Per stage one thread
//   issues one cp.async.bulk of the pre-split weights (w1's 32-channel K
//   chunk, hi and lo, 128 rows; later one w2 tap, hi and lo, 32 rows), and
//   for a conv1 chunk the 128 producer threads copy the haloed tile's 32
//   input channels by 16-byte cp.async (pixels outside the image are skipped;
//   the consumers feed zeros there). Each stage has a full mbarrier (the bulk
//   bytes + every producer thread's cp.async arrival) and an empty one (one
//   arrival per consumer warp).
// - conv1 (128 x c_in) @ (c_in x 128): wgmma m64n128k8 tf32, A from
//   registers (the fragment rows r, r+8 and channels c, c+4 read from the
//   staged chunk, BN1 + ReLU and the split applied there), B (w1, K-major,
//   128-byte swizzle) from the ring; warpgroup w takes row tile w. A chunk's
//   12 wgmmas are one commit group; the next chunk's fragments are built
//   while it runs.
// - Accumulation: the tensor cores truncate as they add into an accumulator,
//   so three products a step summed over a long K on them lie about ten
//   times further off f64 than f32 FMA does (the no_promotion ablation of
//   tools/dense_layer_ablation.py). So every 32-channel block is summed on
//   the tensor cores from zero and then added to f32 registers with
//   round-to-nearest adds.
// - BN2, ReLU and the image mask write the f32 bottleneck tile (100 rows of
//   128, 53 KB) to its own shared region; a named barrier joins the two
//   consumer warpgroups.
// - conv2: nine shifted (64 x 128) @ (128 x 32) products, one tap of w2 a
//   stage and a commit group; the A fragment of tap (dy, dx) is the
//   bottleneck rows shifted by dy * 10 + dx; warpgroup w sums bottleneck
//   channels [64w, 64w+64) of every tap (m64n32k8), and warpgroup 1 hands its
//   sums to warpgroup 0 through shared memory.
// - The growth part goes straight from the f32 sums to the state.
//
// In place, race-free: every CTA reads only channels [0, c_in) and writes only
// channels [c_in, c_in + G) of the same buffer.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kF = 128;        // bottleneck width (bn_size * growth)
constexpr int kG = 32;         // growth rate
constexpr int kChunk = 32;     // input channels per conv1 stage
constexpr int kTaps = 9;
constexpr int kConsumerThreads = 256;
constexpr int kProducerThreads = 128;
constexpr int kThreads = kConsumerThreads + kProducerThreads;
constexpr int kXStride = kChunk + 4;  // floats per staged input row
constexpr int kBStride = kF + 4;      // floats per bottleneck row
// one stage's weights: w1's K chunk (hi, lo) x 128 rows x 32, or one w2 tap
// (4 K blocks x (hi, lo) x 32 rows x 32); rows of 128 bytes, 128-byte swizzle
constexpr int kWBytes = 2 * kF * kChunk * 4;
static_assert(kWBytes == 2 * kG * kF * 4, "a w2 tap fills a stage");
constexpr int kHalfBytes = kWBytes / 2;   // the lo half of a w1 chunk
constexpr int kW2BlockBytes = 2 * kG * 32 * 4;  // one K block of a w2 tap

constexpr int kTile = 8;                    // output tile side
constexpr int kHalo = kTile + 2;            // haloed side of the bottleneck
constexpr int kHaloPx = kHalo * kHalo;      // 100 haloed rows
constexpr int kStages = 3;
constexpr int kStageBytes =
    (kWBytes + kHaloPx * kXStride * 4 + 1023) / 1024 * 1024;
constexpr int kBneckBytes = kHaloPx * kBStride * 4;
constexpr int kSmemBytes = kStages * kStageBytes + kBneckBytes +
                           2 * kStages * 8 + 1024;
static_assert(2 * 64 >= kHaloPx, "two row tiles cover the haloed tile");
static_assert(kWBytes + 128 * 16 * 4 <= kStageBytes, "the reduce fits stage 0");
static_assert(kSmemBytes <= 232448, "fits the opt-in shared memory");

// ---- PTX wrappers -----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
               "l"(src)
               : "memory");
}

// arrives on `bar` once every cp.async this thread issued so far has landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void named_barrier_consumers() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumerThreads) : "memory");
}

// (hi, lo) TF32 halves of v; hi's 13 low bits are zero, as tf32_split's
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  uint32_t h, l;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(h) : "f"(v));
  h &= 0xffffe000u;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(l) : "f"(v - __uint_as_float(h)));
  hi = h;
  lo = l;
}

// K-major operand in shared memory, 128-byte swizzle: rows of 128 bytes
// (32 floats of K), 8-row groups 1024 bytes apart; the address of a K step
// inside the 128-byte row advances the start by 32 bytes.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator accesses across a wgmma wait
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D(64 x N) = A(64 x 8, registers) * B(8 x N, shared) + (acc ? D : 0),
// tf32 in, f32 out
__device__ __forceinline__ void mma_n128(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t b, int acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

__device__ __forceinline__ void mma_n32(float (&d)[16], const uint32_t (&a)[4],
                                         uint64_t b, int acc) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

// ---- the kernel -------------------------------------------------------------

__global__ void __launch_bounds__(kThreads, 1)
dense_layer_f32_tc_kernel(float* state, const float* __restrict__ inv1,
                          const float* __restrict__ sh1,
                          const float* __restrict__ w1t,
                          const float* __restrict__ inv2,
                          const float* __restrict__ sh2,
                          const float* __restrict__ w2t, int H, int W, int C,
                          int c_in, int tiles_x, int tiles_per_image) {
  extern __shared__ uint8_t smem_raw[];
  // the swizzled weight images need 1024-byte aligned stages
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  float* bneck = reinterpret_cast<float*>(smem + kStages * kStageBytes);
  const uint32_t full0 = base + kStages * kStageBytes + kBneckBytes;
  const uint32_t empty0 = full0 + 8 * kStages;

  const int tid = threadIdx.x;
  const int b = blockIdx.x / tiles_per_image;
  const int t_in = blockIdx.x % tiles_per_image;
  const int y0 = (t_in / tiles_x) * kTile;
  const int x0 = (t_in % tiles_x) * kTile;
  const size_t img_base = (size_t)b * H * W;
  const int nk = c_in / kChunk;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      // the producers' cp.async arrivals + expect_tx
      mbar_init(full0 + 8 * s, kProducerThreads + 1);
      mbar_init(empty0 + 8 * s, 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  if (warp >= 8) {
    // ===== producer warpgroup: fills the ring ==============================
    // thread 256 (warp 8, lane 0) copies the weights, all 128 the x chunks
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    const int pt = tid - kConsumerThreads;
    for (int i = 0; i < nk + kTaps; ++i) {
      const int s = i % kStages;
      mbar_wait(empty0 + 8 * s, ((i / kStages) & 1) ^ 1);
      const uint32_t stage = base + s * kStageBytes;
      const uint32_t full = full0 + 8 * s;
      if (pt == 0) {
        mbar_expect_tx(full, kWBytes);
        const float* src = i < nk ? w1t + (size_t)i * (kWBytes / 4)
                                  : w2t + (size_t)(i - nk) * (kWBytes / 4);
        bulk_load(stage, src, kWBytes, full);
      }
      if (i < nk) {
        const uint32_t xs = stage + kWBytes;
        const float* src = state + i * kChunk;
        for (int v = pt; v < kHaloPx * 8; v += kProducerThreads) {
          const int r = v >> 3, seg = v & 7;
          const int iy = y0 - 1 + r / kHalo, ix = x0 - 1 + r % kHalo;
          if (iy >= 0 && iy < H && ix >= 0 && ix < W)
            cp_async16(xs + (r * kXStride + seg * 4) * 4,
                       src + (img_base + (size_t)iy * W + ix) * C + seg * 4);
        }
      }
      cp_async_arrive(full);
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
  } else {
    // ===== consumer warpgroups ==============================================
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int wg = warp >> 2, w4 = warp & 3;
    const int g = lane >> 2, t = lane & 3;

    // conv1: warpgroup wg takes haloed rows [64 wg, 64 wg + 64) and all 128
    // bottleneck channels; fragment half h is row 64 wg + 16 w4 + g + 8 h
    uint32_t valid = 0;
    int xoff[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 64 * wg + 16 * w4 + g + 8 * h;
      const int iy = y0 - 1 + r / kHalo, ix = x0 - 1 + r % kHalo;
      const bool v = r < kHaloPx && iy >= 0 && iy < H && ix >= 0 && ix < W;
      valid |= (v ? 1u : 0u) << h;
      xoff[h] = v ? r * kXStride : 0;
    }

    // The tensor cores truncate as they accumulate: each 32-channel chunk is
    // summed there from zero (part), then added to the f32 sums (acc) with
    // round-to-nearest adds, which keeps the result as exact as f32 FMA.
    // Accumulators are read only after wait_group 0: ptxas serializes every
    // wgmma of a kernel that reads one while any is in flight.
    float acc[64], part[64];
#pragma unroll
    for (int j = 0; j < 64; ++j) acc[j] = part[j] = 0.f;

    // the A fragments of chunk i, K steps kk = 0..3: BN1 + ReLU, split
    auto conv1_fragments = [&](int i, uint32_t (&hi)[4][4],
                               uint32_t (&lo)[4][4]) {
      const float* xs = reinterpret_cast<const float*>(
          smem + (i % kStages) * kStageBytes + kWBytes);
#pragma unroll
      for (int kk = 0; kk < kChunk / 8; ++kk) {
        const int c = i * kChunk + kk * 8 + t;
        const float ia = __ldg(inv1 + c), sa = __ldg(sh1 + c);
        const float ib = __ldg(inv1 + c + 4), sb = __ldg(sh1 + c + 4);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int h = q & 1, hc = q >> 1;
          const float xv = xs[xoff[h] + kk * 8 + t + 4 * hc];
          const float hv = (valid >> h) & 1
                               ? fmaxf(fmaf(xv, hc ? ib : ia, hc ? sb : sa), 0.f)
                               : 0.f;
          split(hv, hi[kk][q], lo[kk][q]);
        }
      }
    };

    // ---- conv1: one commit group a chunk; the next chunk's fragments are
    // built while it runs, into the other of two buffers (the loop is
    // unrolled by two so that neither is ever copied: a copy into the
    // fragments of an in-flight wgmma serializes them all) -----------------
    auto conv1_chunk = [&](int i, const uint32_t (&hi)[4][4],
                           const uint32_t (&lo)[4][4], uint32_t (&nhi)[4][4],
                           uint32_t (&nlo)[4][4]) {
      const int s = i % kStages;
      const uint32_t wb = base + s * kStageBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kChunk / 8; ++kk) {
        const uint64_t dh = desc_sw128(wb + kk * 32);
        const uint64_t dl = desc_sw128(wb + kHalfBytes + kk * 32);
        mma_n128(part, lo[kk], dh, kk > 0);
        mma_n128(part, hi[kk], dl, 1);
        mma_n128(part, hi[kk], dh, 1);
      }
      wgmma_commit();
      if (i + 1 < nk) {
        mbar_wait(full0 + 8 * ((i + 1) % kStages), ((i + 1) / kStages) & 1);
        conv1_fragments(i + 1, nhi, nlo);
      }
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);  // the stage is consumed
      fence_acc(part);
#pragma unroll
      for (int j = 0; j < 64; ++j) acc[j] += part[j];
    };
    uint32_t ahi[2][4][4], alo[2][4][4];
    mbar_wait(full0, 0);
    conv1_fragments(0, ahi[0], alo[0]);
    for (int i = 0; i < nk; i += 2) {
      conv1_chunk(i, ahi[0], alo[0], ahi[1], alo[1]);
      if (i + 1 < nk) conv1_chunk(i + 1, ahi[1], alo[1], ahi[0], alo[0]);
    }

    // ---- BN2, ReLU, image mask -> the f32 bottleneck tile ------------------
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int n = 8 * j + 2 * t;
      const float i0 = __ldg(inv2 + n), s0 = __ldg(sh2 + n);
      const float i1 = __ldg(inv2 + n + 1), s1 = __ldg(sh2 + n + 1);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 64 * wg + 16 * w4 + g + 8 * h;
        if (r < kHaloPx) {
          const bool v = (valid >> h) & 1;
          float2 o;
          o.x = v ? fmaxf(fmaf(acc[4 * j + 2 * h], i0, s0), 0.f) : 0.f;
          o.y = v ? fmaxf(fmaf(acc[4 * j + 2 * h + 1], i1, s1), 0.f) : 0.f;
          *reinterpret_cast<float2*>(bneck + r * kBStride + n) = o;
        }
      }
    }
    named_barrier_consumers();

    // ---- conv2: nine shifted (64 x 128) @ (128 x 32) -----------------------
    // warpgroup wg sums bottleneck channels [64 wg, 64 wg + 64) of every tap
    // (K blocks 2 wg and 2 wg + 1, one part each) for all 64 pixels and 32
    // growth channels, one commit group a tap, the next tap's fragments
    // built while it runs; warpgroup 1 hands its sums to warpgroup 0 through
    // shared memory at the end.
    int boff[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * w4 + g + 8 * h;  // output pixel (r / 8, r % 8)
      boff[h] = ((r / kTile) * kHalo + r % kTile) * kBStride + 64 * wg + t;
    }
    float acc2[16], part2[2][16];
#pragma unroll
    for (int j = 0; j < 16; ++j) acc2[j] = part2[0][j] = part2[1][j] = 0.f;

    auto conv2_fragments = [&](int tap, uint32_t (&hi)[8][4],
                               uint32_t (&lo)[8][4]) {
      const float* bt = bneck + ((tap / 3) * kHalo + tap % 3) * kBStride;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          split(bt[boff[q & 1] + kk * 8 + 4 * (q >> 1)], hi[kk][q], lo[kk][q]);
    };

    uint32_t bhi[2][8][4], blo[2][8][4];
    mbar_wait(full0 + 8 * (nk % kStages), (nk / kStages) & 1);
    conv2_fragments(0, bhi[0], blo[0]);
#pragma unroll
    for (int tap = 0; tap < kTaps; ++tap) {
      const int i = nk + tap;
      const int s = i % kStages;
      const uint32_t wb = base + s * kStageBytes + 2 * wg * kW2BlockBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const int p = kk / 4;
        const uint32_t off = p * kW2BlockBytes + (kk % 4) * 32;
        const uint64_t dh = desc_sw128(wb + off);
        const uint64_t dl = desc_sw128(wb + off + kW2BlockBytes / 2);
        mma_n32(part2[p], blo[tap & 1][kk], dh, kk % 4 != 0);
        mma_n32(part2[p], bhi[tap & 1][kk], dl, 1);
        mma_n32(part2[p], bhi[tap & 1][kk], dh, 1);
      }
      wgmma_commit();
      if (tap + 1 < kTaps) {
        mbar_wait(full0 + 8 * ((i + 1) % kStages), ((i + 1) / kStages) & 1);
        conv2_fragments(tap + 1, bhi[(tap + 1) & 1], blo[(tap + 1) & 1]);
      }
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);  // the stage is consumed
      fence_acc(part2[0]);
      fence_acc(part2[1]);
#pragma unroll
      for (int j = 0; j < 16; ++j) acc2[j] += part2[0][j];
#pragma unroll
      for (int j = 0; j < 16; ++j) acc2[j] += part2[1][j];
    }

    // ---- reduce the two warpgroups' sums, write the growth part in place ---
    // (through the x region of stage 0, which conv2 leaves alone)
    float* red = reinterpret_cast<float*>(smem + kWBytes) + (tid & 127);
    if (wg == 1) {
#pragma unroll
      for (int j = 0; j < 16; ++j) red[128 * j] = acc2[j];
    }
    named_barrier_consumers();
    if (wg == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * w4 + g + 8 * h;
        const int y = y0 + r / kTile, x = x0 + r % kTile;
        if (y < H && x < W) {
          float* dst = state + (img_base + (size_t)y * W + x) * C + c_in;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            *reinterpret_cast<float2*>(dst + 8 * j + 2 * t) = make_float2(
                acc2[4 * j + 2 * h] + red[128 * (4 * j + 2 * h)],
                acc2[4 * j + 2 * h + 1] + red[128 * (4 * j + 2 * h + 1)]);
        }
      }
    }
  }
}

}  // namespace

// Launches one f32 dense layer on `stream`. Returns a cudaError_t: nonzero
// when the arguments are outside what the kernel takes or the launch was
// refused. Pointers: state (B, H, W, C) f32, inv1/sh1 (c_in,) f32, inv2/sh2
// (F,) f32, and the split weight images of dense_block.tf32_image: w1
// (c_in/32, 2, F, 32) f32, w2 (9, F/32, 2, G, 32) f32; all contiguous,
// 16-byte aligned.
extern "C" int dense_layer_f32_tc_launch(void* state, const void* inv1,
                                         const void* sh1, const void* w1,
                                         const void* inv2, const void* sh2,
                                         const void* w2, int batch, int height,
                                         int width, int channels, int c_in,
                                         int bottleneck, int growth,
                                         void* stream) {
  if (bottleneck != kF || growth != kG) return (int)cudaErrorInvalidValue;
  if (batch <= 0 || height <= 0 || width <= 0 || c_in <= 0 ||
      c_in % kChunk != 0 || channels % 4 != 0 || c_in + growth > channels)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      dense_layer_f32_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int tiles_y = (height + kTile - 1) / kTile;
  const int tiles_x = (width + kTile - 1) / kTile;
  const long long grid = (long long)batch * tiles_y * tiles_x;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  dense_layer_f32_tc_kernel<<<(unsigned)grid, kThreads, kSmemBytes,
                              (cudaStream_t)stream>>>(
      static_cast<float*>(state), static_cast<const float*>(inv1),
      static_cast<const float*>(sh1), static_cast<const float*>(w1),
      static_cast<const float*>(inv2), static_cast<const float*>(sh2),
      static_cast<const float*>(w2), height, width, channels, c_in, tiles_x,
      tiles_y * tiles_x);
  return (int)cudaGetLastError();
}
