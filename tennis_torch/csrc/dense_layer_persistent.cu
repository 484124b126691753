// One DenseNet-BC dense layer at inference, persistent variant for the large
// maps (128^2 and 64^2 at 512^2 input), for Hopper (sm_90a).
//
// Replaces tennis_tpu/ops/pallas/dense_block.py::_layer_kernel (launched there
// by dense_layer_pallas), like dense_layer.cu, and computes exactly what
// dense_layer_kernel there computes:
//
//   h   = relu(x * inv1 + sh1)            folded BN1, x = state[..., :c_in]
//   b   = relu((h @ w1) * inv2 + sh2)     1x1 conv c_in -> F, folded BN2
//   b   = 0 outside the image             = conv2's zero padding
//   out = conv3x3(b, w2)                  F -> G, written to state[..., c_in:c_in+G]
//
// on the same unpadded NHWC (B, H, W, C) bf16 state, in place: every CTA reads
// only channels [0, c_in) and writes only [c_in, c_in + G), so no CTA reads
// what another writes. BN1's output and the bottleneck are rounded to bf16 at
// the same two places; the tiles are 8x8 outputs over a 10x10 haloed
// bottleneck, ragged at the image edge.
//
// What bounds it. The tile kernel launches one CTA per 8x8 tile (2048 at
// 8 x 128^2), and each re-reads all of w1 and w2 from L2: ~268 MB of L2->SM
// traffic for a block0 layer whose own HBM bytes are ~25 MB. With the weights
// resident, what is left is per-step work that does not overlap unless the
// design makes it: the copy and BN1 pass of each input chunk, the barrier
// that hands it over, and the ldmatrix reads that feed mma.sync, whose rate
// the 128 B/clock of shared memory bounds before the tensor cores do.
//
// What this design does about it:
// - persistent grid: min(tiles, SMs) CTAs, each walking tiles
//   blockIdx.x, +gridDim.x, ...; w2 (all nine taps) is copied into shared
//   memory once per CTA, and so is w1 where 128 x c_in fits beside it
//   (every block0 layer); otherwise w1 streams chunk by chunk with x;
// - warp specialisation: 4 producer warps fill a ring of kStages 64-channel
//   input chunks with cp.async (16 B, .cg; halo pixels outside the image are
//   zero-filled with src-size 0) and apply BN1 + ReLU in place once their
//   copies land, while 8 consumer warps run the MMAs. Named barriers hand
//   each stage over (FULL) and back (EMPTY), so the copies and BN1 of the
//   next chunks overlap this chunk's MMAs and, across tile boundaries, this
//   tile's BN2 and conv2. A ragged last chunk (c_in % 64 == 32) copies and
//   multiplies only its 32 channels;
// - both convolutions on the tensor cores through ldmatrix + mma.sync
//   m16n8k16 (bf16 in, f32 accumulate). conv1: 2 x 4 consumer warps, warp
//   tile 64x32 (the second row group has 3 of the 7 row tiles). conv2: warp
//   tile 32 pixels x 32 growth channels over one quarter of the 128
//   bottleneck channels (all nine taps); the four quarters' partial sums are
//   added through the bottleneck buffer once every warp has read it.
//
// Shared memory (bytes, kStages = 3; the launcher refuses anything above
// 232,448):
//   w2, 9 x 32 rows x 136                    78,336
//   bottleneck tile, 100 x 136               27,200  (later the 24,576 B of
//                                                     conv2 partial sums)
//   x ring, 3 x 112 x 72                     48,384
//   w1 resident, 128 x (c_in + 8)            256 c_in + 2,048   or
//   w1 ring beside x, 3 x 128 x 72           55,296
//   BN1 vectors                              8 c_in
// w1 is resident up to c_in 288 (232,000 B there); from c_in 320 it streams
// (211,776 B at 320, 213,056 B at 480), which fits up to c_in 2880. Rows are
// padded by 8 elements so that the eight row addresses of every ldmatrix
// fall in distinct bank groups.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 8;                  // output tile side, pixels
constexpr int kHalo = kTile + 2;          // haloed side of the bottleneck tile
constexpr int kHaloPx = kHalo * kHalo;    // 100 bottleneck pixels per tile
constexpr int kRows1 = 112;               // kHaloPx rounded up to 16-row MMA tiles
constexpr int kMTiles1 = kRows1 / 16;     // 7
constexpr int kF = 128;                   // bottleneck width (bn_size * growth)
constexpr int kG = 32;                    // growth rate
constexpr int kChunk = 64;                // input channels per ring stage
constexpr int kChunkStride = kChunk + 8;  // smem row of a chunk: 144 B
constexpr int kFStride = kF + 8;          // smem row of F values: 272 B
constexpr int kConsumers = 256;           // 8 MMA warps
constexpr int kProducers = 128;           // 4 copy + BN1 warps
constexpr int kThreads = kConsumers + kProducers;
constexpr int kTaps = 9;
constexpr int kStages = 3;
constexpr size_t kSmemLimit = 232448;     // H100 opt-in maximum per block

constexpr int kXsElems = kRows1 * kChunkStride;  // x chunk, one stage
constexpr int kWsElems = kF * kChunkStride;      // streamed w1 chunk, one stage
constexpr int kSegs = kChunk / 8;                // 16-byte vectors of a chunk row
constexpr int kXVecs = kHaloPx * kSegs;
constexpr int kXPerThread = (kXVecs + kProducers - 1) / kProducers;
constexpr int kWPerThread = kF * kSegs / kProducers;
static_assert(kChunk % 32 == 0 && kF * kSegs % kProducers == 0, "chunk mapping");
// named barriers: FULL and EMPTY of each ring stage, the consumer warps' own
// and the producer warps' own
constexpr int kFullBar = 1;
constexpr int kEmptyBar = kFullBar + kStages;
constexpr int kConsumerBar = kEmptyBar + kStages;
constexpr int kProducerBar = kConsumerBar + 1;
static_assert(kProducerBar < 16, "16 named barriers");
constexpr int kW2Elems = kTaps * kG * kFStride;
constexpr int kBneckElems = kHaloPx * kFStride;
constexpr int kPartials = 6 * 8 * 32;  // float4s: 6 warps x 32 lanes x 32 floats
static_assert(kPartials * 16 <= kBneckElems * 2, "partial sums alias the bottleneck");

__host__ __device__ constexpr size_t smem_bytes(int c_in, bool w1_resident) {
  return 2 * (size_t)(kW2Elems + kBneckElems +
                      kStages * (kXsElems + (w1_resident ? 0 : kWsElems)) +
                      (w1_resident ? kF * (c_in + 8) : 0)) +
         8 * (size_t)c_in;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; src_bytes 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices; lane l gives the row address of matrix l / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a * b for one 16x8x16 tile: a row-major 16x16, b column-major 16x8.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// relu(x * inv + sh) on 8 bf16 values, f32 math, rounded back to bf16.
__device__ __forceinline__ uint32_t bn_relu2(uint32_t u, const float* inv,
                                             const float* sh) {
  const float lo = __uint_as_float(u << 16);
  const float hi = __uint_as_float(u & 0xffff0000u);
  return pack_bf16x2(fmaxf(lo * inv[0] + sh[0], 0.f),
                     fmaxf(hi * inv[1] + sh[1], 0.f));
}

__device__ __forceinline__ uint4 bn_relu8(uint4 raw, const float* inv,
                                          const float* sh) {
  return make_uint4(bn_relu2(raw.x, inv, sh), bn_relu2(raw.y, inv + 2, sh + 2),
                    bn_relu2(raw.z, inv + 4, sh + 4),
                    bn_relu2(raw.w, inv + 6, sh + 6));
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__global__ void __launch_bounds__(kThreads, 1)
dense_layer_persistent_kernel(__nv_bfloat16* state,
                              const float* __restrict__ inv1,
                              const float* __restrict__ sh1,
                              const __nv_bfloat16* __restrict__ w1,
                              const float* __restrict__ inv2,
                              const float* __restrict__ sh2,
                              const __nv_bfloat16* __restrict__ w2, int H,
                              int W, int C, int c_in, int tiles_x,
                              int tiles_per_image, int n_tiles,
                              bool w1_resident) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* w2s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* bneck = w2s + kW2Elems;
  float4* partials = reinterpret_cast<float4*>(bneck);  // after conv2 only
  __nv_bfloat16* ring = bneck + kBneckElems;
  const int stage_elems = kXsElems + (w1_resident ? 0 : kWsElems);
  __nv_bfloat16* w1s = ring + kStages * stage_elems;  // resident w1
  const int w1_stride = c_in + 8;
  float* s_inv1 =
      reinterpret_cast<float*>(w1s + (w1_resident ? kF * w1_stride : 0));
  float* s_sh1 = s_inv1 + c_in;

  const int tid = threadIdx.x;
  const int n_chunks = (c_in + kChunk - 1) / kChunk;  // the last may be ragged
  const int my_tiles = (n_tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1;
  const int total = my_tiles * n_chunks;  // ring steps of this CTA

  auto tile_origin = [&](int i, int& img, int& y0, int& x0) {
    const int tile = blockIdx.x + i * gridDim.x;
    img = tile / tiles_per_image;
    const int t = tile - img * tiles_per_image;
    const int ty = t / tiles_x;
    y0 = ty * kTile;
    x0 = (t - ty * tiles_x) * kTile;
  };

  if (tid >= kConsumers) {
    // ---- producer warps: fill stage s % kStages with step s's chunk, apply
    // BN1 + ReLU in place, hand it over on FULL; reuse a buffer after its
    // EMPTY. Thread pt copies and transforms the 16-byte vectors
    // v = pt + e * kProducers of a stage (halo pixel v / kSegs, channels
    // (v % kSegs) * 8 of the chunk) and, with w1 streamed, those of the w1
    // chunk. Pixels outside the image are zero-filled and so become
    // relu(sh1), not 0: harmless, because their bottleneck rows are zeroed
    // after BN2, which is conv2's zero padding.
    static_assert(kProducers % kSegs == 0, "a producer keeps one channel segment");
    const int pt = tid - kConsumers;
    // once per CTA: the BN1 vectors, and zeros in the MMA padding rows
    // 100..111 of every x stage (never copied; published by FULL)
    for (int c = pt; c < c_in; c += kProducers) {
      s_inv1[c] = inv1[c];
      s_sh1[c] = sh1[c];
    }
    constexpr int kPadVecs = (kRows1 - kHaloPx) * kChunkStride / 8;
    for (int v = pt; v < kStages * kPadVecs; v += kProducers) {
      *reinterpret_cast<uint4*>(ring + (v / kPadVecs) * stage_elems +
                                kHaloPx * kChunkStride + (v % kPadVecs) * 8) =
          make_uint4(0, 0, 0, 0);
    }
    bar_sync(kProducerBar, kProducers);
    const int seg = pt % kSegs;  // the same for every vector of this thread
    const __nv_bfloat16* src[kXPerThread];
    int bytes[kXPerThread];
    int k = 0, i = 0;  // chunk and tile of step s
    auto transform = [&](int s, int kc) {
      if (seg * 8 < kc) {
        // all loads before any store: the stores could otherwise alias them
        const int c0 = (s % n_chunks) * kChunk + seg * 8;
        float inv[8], sh[8];
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          inv[c] = s_inv1[c0 + c];
          sh[c] = s_sh1[c0 + c];
        }
        uint4* xs = reinterpret_cast<uint4*>(ring + (s % kStages) * stage_elems +
                                             seg * 8);
        uint4 raw[kXPerThread];
#pragma unroll
        for (int e = 0; e < kXPerThread; ++e)
          if (pt + e * kProducers < kXVecs)
            raw[e] = xs[(pt + e * kProducers) / kSegs * (kChunkStride / 8)];
#pragma unroll
        for (int e = 0; e < kXPerThread; ++e)
          if (pt + e * kProducers < kXVecs)
            xs[(pt + e * kProducers) / kSegs * (kChunkStride / 8)] =
                bn_relu8(raw[e], inv, sh);
      }
      bar_arrive(kFullBar + s % kStages, kThreads);
    };
    int prev_kc = 0;
    for (int s = 0; s < total; ++s) {
      if (s >= kStages) bar_sync(kEmptyBar + s % kStages, kThreads);
      if (k == 0) {
        int img, y0, x0;
        tile_origin(i, img, y0, x0);
#pragma unroll
        for (int e = 0; e < kXPerThread; ++e) {
          const int v = pt + e * kProducers, row = v / kSegs;
          const int iy = y0 - 1 + row / kHalo, ix = x0 - 1 + row % kHalo;
          const bool inside =
              v < kXVecs && iy >= 0 && iy < H && ix >= 0 && ix < W;
          bytes[e] = inside ? 16 : 0;
          src[e] = inside ? state + (((size_t)img * H + iy) * W + ix) * C + seg * 8
                          : state;
        }
      }
      const int k0 = k * kChunk, kc = min(kChunk, c_in - k0);
      __nv_bfloat16* xs = ring + (s % kStages) * stage_elems;
#pragma unroll
      for (int e = 0; e < kXPerThread; ++e) {
        const int v = pt + e * kProducers;
        if (v < kXVecs && seg * 8 < kc)
          cp_async16(xs + (v / kSegs) * kChunkStride + seg * 8,
                     src[e] + (bytes[e] ? k0 : 0), bytes[e]);
      }
      if (!w1_resident && seg * 8 < kc) {
#pragma unroll
        for (int e = 0; e < kWPerThread; ++e) {
          const int n = (pt + e * kProducers) / kSegs;
          cp_async16(xs + kXsElems + n * kChunkStride + seg * 8,
                     w1 + (size_t)n * c_in + k0 + seg * 8, 16);
        }
      }
      cp_async_commit();
      // step s's copies are in flight while step s - 1's are transformed
      if (s > 0) {
        cp_async_wait<1>();
        transform(s - 1, prev_kc);
      }
      prev_kc = kc;
      if (++k == n_chunks) {
        k = 0;
        ++i;
      }
    }
    cp_async_wait<0>();
    transform(total - 1, prev_kc);
    // complete the EMPTY barriers of the last kStages steps, which no refill
    // waited for
    for (int s = max(total, kStages); s < total + kStages; ++s)
      bar_sync(kEmptyBar + s % kStages, kThreads);
    return;
  }

  // ---- consumer warps: conv1 per step, then per tile BN2, conv2, store -------
  // Once per CTA, while the producers fill the first stages: the resident
  // weights, w1 in one cp.async group and w2 in the next, so that conv1 of
  // the first tile waits for w1 only.
  if (w1_resident) {
    const int segs = c_in / 8;
    for (int v = tid; v < kF * segs; v += kConsumers) {
      const int n = v / segs, seg = v - n * segs;
      cp_async16(w1s + n * w1_stride + seg * 8,
                 w1 + (size_t)n * c_in + seg * 8, 16);
    }
  }
  cp_async_commit();
  for (int v = tid; v < kTaps * kG * (kF / 8); v += kConsumers) {
    const int row = v >> 4, seg = v & 15;
    cp_async16(w2s + row * kFStride + seg * 8, w2 + (size_t)row * kF + seg * 8,
               16);
  }
  cp_async_commit();
  cp_async_wait<1>();
  bar_sync(kConsumerBar, kConsumers);

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;  // MMA fragment row group
  const int tig = lane & 3;   // thread in group
  // ldmatrix row addresses: A (16 rows x 16 k) and B (16 n x 16 k, two n-tiles)
  const int a_r = lane & 15, a_k = (lane >> 4) * 8;
  const int b_n = (lane & 7) + ((lane >> 4) << 3), b_k = ((lane >> 3) & 1) * 8;
  // conv1 warp tile: row tiles [4 wm, 4 wm + 4) of 7, columns [32 wn, +32)
  const int wm = warp >> 2, wn = warp & 3;
  // conv2 warp tile: pixels [32 wm2, +32), channels [32 kq, +32) of F
  const int wm2 = warp & 1, kq = warp >> 1;
  int a_row2[2];  // bottleneck row of this lane's A row at tap (0, 0)
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int p = (wm2 * 2 + mi) * 16 + a_r;
    a_row2[mi] = (p / kTile) * kHalo + p % kTile;
  }
  // BN2 of this thread's bottleneck columns wn * 32 + j * 8 + tig * 2 (+1)
  float i2[8], s2[8];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      i2[j * 2 + e] = inv2[wn * 32 + j * 8 + tig * 2 + e];
      s2[j * 2 + e] = sh2[wn * 32 + j * 8 + tig * 2 + e];
    }

  float acc1[4][4][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc1[m][j][q] = 0.f;

  int k = 0, i = 0;  // chunk and tile of step s
  for (int s = 0; s < total; ++s) {
    bar_sync(kFullBar + s % kStages, kThreads);  // stage s is filled

    // ---- conv1, one chunk: (112 x kc) @ (kc x 128) --------------------------
    const __nv_bfloat16* xs = ring + (s % kStages) * stage_elems;
    const __nv_bfloat16* wb = w1_resident ? w1s + k * kChunk : xs + kXsElems;
    const int ws = w1_resident ? w1_stride : kChunkStride;
    const int kc = min(kChunk, c_in - k * kChunk);
#pragma unroll
    for (int kk = 0; kk < kChunk; kk += 16) {
      if (kk < kc) {
        uint32_t bfr[2][4];
#pragma unroll
        for (int p = 0; p < 2; ++p)
          ldsm_x4(bfr[p], wb + (wn * 32 + p * 16 + b_n) * ws + kk + b_k);
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          if (wm * 4 + m < kMTiles1) {
            uint32_t a[4];
            ldsm_x4(a, xs + ((wm * 4 + m) * 16 + a_r) * kChunkStride + kk + a_k);
#pragma unroll
            for (int j = 0; j < 4; ++j)
              mma_bf16(acc1[m][j], a, bfr[j >> 1][(j & 1) * 2],
                       bfr[j >> 1][(j & 1) * 2 + 1]);
          }
        }
      }
    }
    bar_arrive(kEmptyBar + s % kStages, kThreads);  // stage s may be refilled
    if (++k < n_chunks) continue;

    // ---- tile i is through conv1 ---------------------------------------------
    int img, y0, x0;
    tile_origin(i, img, y0, x0);
    k = 0;
    ++i;

    // BN2, ReLU, image mask, bf16 round -> bottleneck tile. The last readers
    // of this buffer (the previous tile's partial sums) passed a FULL barrier
    // since, which every consumer thread takes part in.
#pragma unroll
    for (int m = 0; m < 4; ++m) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = (wm * 4 + m) * 16 + gid + half * 8;
        const int iy = y0 - 1 + r / kHalo, ix = x0 - 1 + r % kHalo;
        const bool inside = iy >= 0 && iy < H && ix >= 0 && ix < W;
        if (wm * 4 + m < kMTiles1 && r < kHaloPx) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float v0 =
                fmaxf(acc1[m][j][half * 2] * i2[j * 2] + s2[j * 2], 0.f);
            const float v1 = fmaxf(
                acc1[m][j][half * 2 + 1] * i2[j * 2 + 1] + s2[j * 2 + 1], 0.f);
            *reinterpret_cast<uint32_t*>(bneck + r * kFStride + wn * 32 +
                                         j * 8 + tig * 2) =
                inside ? pack_bf16x2(v0, v1) : 0u;
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc1[m][j][half * 2] = 0.f;
          acc1[m][j][half * 2 + 1] = 0.f;
        }
      }
    }
    cp_async_wait<0>();  // w2 has landed (waits only before the first conv2)
    bar_sync(kConsumerBar, kConsumers);  // the bottleneck tile is complete

    // ---- conv2: nine shifted (64 x 128) @ (128 x 32), K split over warps ----
    float acc2[2][4][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc2[mi][j][q] = 0.f;
#pragma unroll
    for (int t = 0; t < kTaps; ++t) {
      const int shift = (t / 3) * kHalo + t % 3;
#pragma unroll
      for (int kk = 0; kk < 32; kk += 16) {
        const int f0 = kq * 32 + kk;
        uint32_t a[2][4], bfr[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
          ldsm_x4(a[mi], bneck + (a_row2[mi] + shift) * kFStride + f0 + a_k);
#pragma unroll
        for (int p = 0; p < 2; ++p)
          ldsm_x4(bfr[p], w2s + (t * kG + p * 16 + b_n) * kFStride + f0 + b_k);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            mma_bf16(acc2[mi][j], a[mi], bfr[j >> 1][(j & 1) * 2],
                     bfr[j >> 1][(j & 1) * 2 + 1]);
      }
    }
    bar_sync(kConsumerBar, kConsumers);  // done reading the bottleneck tile

    // ---- add the four channel quarters; the warps of quarter 0 write --------
    if (kq > 0) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          partials[(((kq - 1) * 2 + wm2) * 8 + mi * 4 + j) * 32 + lane] =
              make_float4(acc2[mi][j][0], acc2[mi][j][1], acc2[mi][j][2],
                          acc2[mi][j][3]);
    }
    bar_sync(kConsumerBar, kConsumers);
    if (kq == 0) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int src = 0; src < 3; ++src) {
            const float4 p =
                partials[((src * 2 + wm2) * 8 + mi * 4 + j) * 32 + lane];
            acc2[mi][j][0] += p.x;
            acc2[mi][j][1] += p.y;
            acc2[mi][j][2] += p.z;
            acc2[mi][j][3] += p.w;
          }
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int p = (wm2 * 2 + mi) * 16 + gid + half * 8;
          const int y = y0 + p / kTile, x = x0 + p % kTile;
          if (y < H && x < W) {
            __nv_bfloat16* dst =
                state + (((size_t)img * H + y) * W + x) * C + c_in;
#pragma unroll
            for (int j = 0; j < 4; ++j)
              *reinterpret_cast<uint32_t*>(dst + j * 8 + tig * 2) = pack_bf16x2(
                  acc2[mi][j][half * 2], acc2[mi][j][half * 2 + 1]);
          }
        }
      }
    }
  }
}

bool w1_fits(int c_in, size_t limit) { return smem_bytes(c_in, true) <= limit; }

}  // namespace

// Bytes of dynamic shared memory the kernel takes at this c_in, and whether w1
// is resident there (w1_resident may be null). For tests of the Python mirror.
extern "C" long long dense_layer_persistent_smem(int c_in, int* w1_resident) {
  const bool resident = w1_fits(c_in, kSmemLimit);
  if (w1_resident != nullptr) *w1_resident = resident;
  return (long long)smem_bytes(c_in, resident);
}

// Launches one dense layer on `stream` with at most max_ctas persistent CTAs
// (the wrapper passes the SM count). Returns a cudaError_t: nonzero when the
// arguments are outside what the kernel takes, the shared-memory budget is
// exceeded, or the launch was refused. Pointers as for dense_layer_launch.
extern "C" int dense_layer_persistent_launch(
    void* state, const void* inv1, const void* sh1, const void* w1,
    const void* inv2, const void* sh2, const void* w2, int batch, int height,
    int width, int channels, int c_in, int bottleneck, int growth,
    int max_ctas, void* stream) {
  if (bottleneck != kF || growth != kG) return (int)cudaErrorInvalidValue;
  if (batch <= 0 || height <= 0 || width <= 0 || c_in <= 0 || max_ctas <= 0 ||
      c_in % 32 != 0 || channels % 8 != 0 || c_in + growth > channels)
    return (int)cudaErrorInvalidValue;
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return (int)err;
  const size_t limit = optin < (int)kSmemLimit ? (size_t)optin : kSmemLimit;
  const bool resident = w1_fits(c_in, limit);
  const size_t smem = smem_bytes(c_in, resident);
  if (smem > limit) return (int)cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(dense_layer_persistent_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_y = (height + kTile - 1) / kTile;
  const int tiles_x = (width + kTile - 1) / kTile;
  const long long tiles = (long long)batch * tiles_y * tiles_x;
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int grid = tiles < max_ctas ? (int)tiles : max_ctas;
  dense_layer_persistent_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<__nv_bfloat16*>(state), static_cast<const float*>(inv1),
      static_cast<const float*>(sh1), static_cast<const __nv_bfloat16*>(w1),
      static_cast<const float*>(inv2), static_cast<const float*>(sh2),
      static_cast<const __nv_bfloat16*>(w2), height, width, channels, c_in,
      tiles_x, tiles_y * tiles_x, (int)tiles, resident);
  return (int)cudaGetLastError();
}
