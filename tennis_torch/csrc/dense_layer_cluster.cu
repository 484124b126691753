// One DenseNet-BC dense layer at inference, cluster split-K variant for the
// small maps (32^2, 16^2 and the ragged 14x14 and 7x7), for Hopper (sm_90a).
//
// Replaces tennis_tpu/ops/pallas/dense_block.py::_layer_kernel (launched there
// by dense_layer_pallas), like dense_layer.cu and dense_layer_persistent.cu,
// and computes the same function:
//
//   h   = relu(x * inv1 + sh1)            folded BN1, x = state[..., :c_in]
//   b   = relu((h @ w1) * inv2 + sh2)     1x1 conv c_in -> F, folded BN2
//   b   = 0 outside the image             = conv2's zero padding
//   out = conv3x3(b, w2)                  F -> G, written to state[..., c_in:c_in+G]
//
// on the same unpadded NHWC (B, H, W, C) bf16 state, in place: every CTA reads
// only channels [0, c_in) and writes only [c_in, c_in + G). BN1's output and
// the bottleneck are rounded to bf16 at the same two places; tiles are 8x8
// outputs over a 10x10 haloed bottleneck, ragged at the image edge.
//
// What bounds it. At the small maps a layer moves little (0.4-3 MB at batch
// 8) and there are few tiles: 128 at 32^2 and 32 at 16^2 for batch 8, 16
// and 4 at batch 1. One CTA per tile (dense_layer.cu) leaves most of the 132
// SMs idle and walks all of c_in, up to 59 chunks of 32 channels, in one
// CTA. On one SM each chunk step costs ~1 us (copy wait, BN1, barrier,
// ldmatrix + mma.sync), so the time is the length of that chain.
//
// What this design does about it: one thread-block cluster of S CTAs
// (S = 2, 4 or 8, a template argument the launcher picks from its argument)
// per 8x8 tile, splitting the work along its reduction axes.
// - conv1, split-K: CTA r takes 32-channel units [r n / S, (r + 1) n / S) of
//   the n = c_in / 32 units, which cover [0, c_in) once (a CTA with none
//   contributes zeros). It streams them in steps of two units through a
//   double-buffered cp.async ring of x and w1 chunks (halo pixels outside the
//   image zero-filled), applies BN1 + ReLU in place and runs ldmatrix +
//   mma.sync m16n8k16 into a 112 x 128 f32 partial bottleneck, which it
//   stores to shared memory over the dead ring. So the chain is n / S steps
//   long and each CTA reads 1 / S of w1.
// - reduce 1, over distributed shared memory: after a cluster barrier CTA r
//   owns bottleneck channels [128 r / S, 128 (r + 1) / S), reads the S
//   partials of those channels and sums them in rank order (the same result
//   every run), then applies BN2, ReLU, the image mask and the bf16 rounding.
// - conv2, split-K as well: CTA r multiplies its 128 / S bottleneck channels
//   by the matching slice of w2 (all nine taps, copied during conv1) into a
//   64 x 32 f32 partial and stores the rows of output pixels
//   [q 64 / S, (q + 1) 64 / S) into CTA q's receive buffer.
// - after a second cluster barrier CTA q sums the S partials of its pixels
//   in rank order, rounds to bf16 and stores them. No CTA touches another's
//   memory after that barrier, so none outlives a reader.
// (Splitting conv1 over its output channels instead, with every CTA walking
// all of c_in, was measured slower at every small-map shape.)
//
// Shared memory (bytes; CW = 128 / S):
//   x + w1 ring, 2 x (112 x 72 + 128 x 72)   69,120  (later the conv1 partial,
//                                                     100 x 136 f32 = 54,400)
//   w2 slice, 9 x 32 x (CW + 8)              576 (CW + 8)
//   bottleneck slice, 100 x (CW + 8)         200 (CW + 8)
//   receive buffer, S x 64 / S x 40 f32      10,240
// = 79,360 + 776 (CW + 8): 135,232 at S = 2, 110,400 at S = 4 and 97,984 at
// S = 8 (two CTAs per SM at S = 4 and 8). Rows are padded so that the eight
// row addresses of every ldmatrix, and the float2 stores of the partials,
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
constexpr int kOutPx = kTile * kTile;     // 64 output pixels per tile
constexpr int kF = 128;                   // bottleneck width (bn_size * growth)
constexpr int kG = 32;                    // growth rate
constexpr int kUnit = 32;                 // input channels per unit of the split
constexpr int kChunk = 64;                // input channels per ring stage
constexpr int kChunkStride = kChunk + 8;  // smem row of a chunk: 144 B
constexpr int kSegs = kChunk / 8;         // 16-byte vectors of a chunk row
constexpr int kThreads = 256;             // 8 warps
constexpr int kTaps = 9;
constexpr int kStages = 2;
constexpr int kPartStride = kF + 8;       // f32 row of the conv1 partial
constexpr int kOutStride = kG + 8;        // f32 row of a conv2 partial
constexpr size_t kSmemLimit = 232448;     // H100 opt-in maximum per block

constexpr int kXsElems = kRows1 * kChunkStride;  // x chunk, one stage
constexpr int kStageElems = kXsElems + kF * kChunkStride;
constexpr int kXVecs = kHaloPx * kSegs;          // 800 16-byte vectors
constexpr int kXPerThread = (kXVecs + kThreads - 1) / kThreads;
constexpr int kWPerThread = kF * kSegs / kThreads;
constexpr size_t kRingBytes = 2 * (size_t)kStages * kStageElems;
constexpr size_t kPartBytes = 4 * (size_t)kHaloPx * kPartStride;
constexpr size_t kRecvBytes = 4 * (size_t)kOutPx * kOutStride;
static_assert(kPartBytes <= kRingBytes, "the conv1 partial aliases the ring");
static_assert(kThreads % kSegs == 0 && kF * kSegs % kThreads == 0, "copy mapping");

__host__ __device__ constexpr int slice_stride(int s) { return kF / s + 8; }

__host__ __device__ constexpr size_t smem_bytes(int s) {
  return kRingBytes + 2 * (size_t)(kTaps * kG + kHaloPx) * slice_stride(s) +
         kRecvBytes;
}

struct ClusterArgs {
  __nv_bfloat16* state;
  const float* inv1;
  const float* sh1;
  const __nv_bfloat16* w1;
  const float* inv2;
  const float* sh2;
  const __nv_bfloat16* w2;
  int H, W, C, c_in, tiles_x, tiles_per_image;
};

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
__device__ __forceinline__ uint32_t bn_relu2(uint32_t u, float i0, float i1,
                                             float s0, float s1) {
  const float lo = __uint_as_float(u << 16);
  const float hi = __uint_as_float(u & 0xffff0000u);
  return pack_bf16x2(fmaxf(lo * i0 + s0, 0.f), fmaxf(hi * i1 + s1, 0.f));
}

__device__ __forceinline__ uint4 bn_relu8(uint4 raw, const float4 (&inv)[2],
                                          const float4 (&sh)[2]) {
  return make_uint4(
      bn_relu2(raw.x, inv[0].x, inv[0].y, sh[0].x, sh[0].y),
      bn_relu2(raw.y, inv[0].z, inv[0].w, sh[0].z, sh[0].w),
      bn_relu2(raw.z, inv[1].x, inv[1].y, sh[1].x, sh[1].y),
      bn_relu2(raw.w, inv[1].z, inv[1].w, sh[1].z, sh[1].w));
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// One cluster barrier: every thread's earlier writes, to its own CTA's
// shared memory or another's, are visible to every thread after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The address that `local` has in the shared memory of CTA `rank`.
__device__ __forceinline__ uint32_t map_rank(const void* local, uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_addr(local)), "r"(rank));
  return remote;
}

__device__ __forceinline__ float4 ld_cluster_f4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_cluster_f2(uint32_t addr, float x, float y) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};\n" ::"r"(addr), "f"(x),
               "f"(y)
               : "memory");
}

// One CTA per SM at S = 2, whose shared memory allows no second: then the
// registers of two are free for it (spills cost ~5%).
template <int S>
__global__ void __launch_bounds__(kThreads, S == 2 ? 1 : 2)
dense_layer_cluster_kernel(const ClusterArgs a) {
  constexpr int CW = kF / S;             // bottleneck channels this CTA owns
  constexpr int kSlice = slice_stride(S);
  constexpr int kPx = kOutPx / S;        // output pixels this CTA stores
  static_assert(CW % 16 == 0, "conv2 takes 16-channel k steps");
  static_assert(kThreads % (CW / 4) == 0, "a thread keeps its BN2 channels");

  const int rank = static_cast<int>(cluster_rank());

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  float* part = reinterpret_cast<float*>(smem_raw);  // after conv1 only
  __nv_bfloat16* w2s = reinterpret_cast<__nv_bfloat16*>(smem_raw + kRingBytes);
  __nv_bfloat16* bneck = w2s + kTaps * kG * kSlice;
  float* recv = reinterpret_cast<float*>(bneck + kHaloPx * kSlice);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;  // MMA fragment row group
  const int tig = lane & 3;   // thread in group
  const int H = a.H, W = a.W, C = a.C, c_in = a.c_in;

  const int tile = blockIdx.x / S;
  const int img = tile / a.tiles_per_image;
  const int t_in = tile - img * a.tiles_per_image;
  const int y0 = (t_in / a.tiles_x) * kTile;
  const int x0 = (t_in % a.tiles_x) * kTile;
  const size_t img_base = (size_t)img * H * W;

  // this CTA's input channels [k_begin, k_end): whole 32-channel units
  const int n_units = c_in / kUnit;
  const int k_begin = rank * n_units / S * kUnit;
  const int k_end = (rank + 1) * n_units / S * kUnit;
  const int n_steps = (k_end - k_begin + kChunk - 1) / kChunk;

  // ---- copy sources: x vector v = tid + e * 256 (< 800) -> halo pixel v / 8,
  // channels (v % 8) * 8 of a chunk; w1 vector v -> bottleneck row v / 8.
  // The same channel segment for every vector of a thread.
  const int seg = tid % kSegs;
  const __nv_bfloat16* xsrc[kXPerThread];
  bool xin[kXPerThread];
#pragma unroll
  for (int e = 0; e < kXPerThread; ++e) {
    const int row = (tid + e * kThreads) / kSegs;
    const int iy = y0 - 1 + row / kHalo, ix = x0 - 1 + row % kHalo;
    xin[e] = row < kHaloPx && iy >= 0 && iy < H && ix >= 0 && ix < W;
    xsrc[e] = xin[e] ? a.state + (img_base + (size_t)iy * W + ix) * C + seg * 8
                     : a.state;
  }

  auto issue_step = [&](int j) {  // step j into stage j % kStages
    __nv_bfloat16* xs = ring + (j % kStages) * kStageElems;
    const int k0 = k_begin + j * kChunk;
    if (seg * 8 >= k_end - k0) return;  // past a ragged last step
#pragma unroll
    for (int e = 0; e < kXPerThread; ++e) {
      const int v = tid + e * kThreads;
      if (v < kXVecs)
        cp_async16(xs + (v / kSegs) * kChunkStride + seg * 8,
                   xsrc[e] + (xin[e] ? k0 : 0), xin[e] ? 16 : 0);
    }
#pragma unroll
    for (int e = 0; e < kWPerThread; ++e) {
      const int n = (tid + e * kThreads) / kSegs;
      cp_async16(xs + kXsElems + n * kChunkStride + seg * 8,
                 a.w1 + (size_t)n * c_in + k0 + seg * 8, 16);
    }
  };

  // BN1 of this thread's 8 channels of step j, into registers
  float4 inv[2], sh[2];
  auto load_bn1 = [&](int j) {
    const int c = k_begin + j * kChunk + seg * 8;
    if (c < k_end) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        inv[h] = *reinterpret_cast<const float4*>(a.inv1 + c + 4 * h);
        sh[h] = *reinterpret_cast<const float4*>(a.sh1 + c + 4 * h);
      }
    }
  };

  if (n_steps > 0) issue_step(0);
  cp_async_commit();
  if (n_steps > 0) load_bn1(0);
  // zeros in the MMA padding rows 100..111 of every x stage (never copied;
  // published by the first barrier of the loop)
  constexpr int kPadVecs = (kRows1 - kHaloPx) * kChunkStride / 8;
  for (int v = tid; v < kStages * kPadVecs; v += kThreads)
    *reinterpret_cast<uint4*>(ring + (v / kPadVecs) * kStageElems +
                              kHaloPx * kChunkStride + (v % kPadVecs) * 8) =
        make_uint4(0, 0, 0, 0);
  // this CTA's slice of w2, rows (tap, g), channels [rank CW, +CW): its own
  // group, landing during conv1
  for (int v = tid; v < kTaps * kG * (CW / 8); v += kThreads) {
    const int row = v / (CW / 8), s8 = v % (CW / 8);
    cp_async16(w2s + row * kSlice + s8 * 8,
               a.w2 + (size_t)row * kF + rank * CW + s8 * 8, 16);
  }
  cp_async_commit();

  // ---- conv1 over this CTA's channels: (112 x K) @ (K x 128) ----------------
  const int a_r = lane & 15, a_k = (lane >> 4) * 8;
  const int b_n = (lane & 7) + ((lane >> 4) << 3), b_k = ((lane >> 3) & 1) * 8;
  // warp tile: row tiles [4 wm, 4 wm + 4) of 7, columns [32 wn, +32)
  const int wm = warp >> 2, wn = warp & 3;
  float acc1[4][4][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc1[m][j][q] = 0.f;

  for (int j = 0; j < n_steps; ++j) {
    // this thread's copies of step j landed (w2's group may still be out)
    if (j == 0) cp_async_wait<1>(); else cp_async_wait<0>();
    __nv_bfloat16* xs = ring + (j % kStages) * kStageElems;
    const int kc = min(kChunk, k_end - (k_begin + j * kChunk));
    if (seg * 8 < kc) {
      // BN1 + ReLU in place on the vectors this thread copied; pixels outside
      // the image stay zero (their bottleneck rows are masked after BN2).
      // Every load before any store: a store could otherwise alias them.
      uint4 raw[kXPerThread];
#pragma unroll
      for (int e = 0; e < kXPerThread; ++e)
        if (xin[e])
          raw[e] = *reinterpret_cast<const uint4*>(
              xs + ((tid + e * kThreads) / kSegs) * kChunkStride + seg * 8);
#pragma unroll
      for (int e = 0; e < kXPerThread; ++e)
        if (xin[e])
          *reinterpret_cast<uint4*>(
              xs + ((tid + e * kThreads) / kSegs) * kChunkStride + seg * 8) =
              bn_relu8(raw[e], inv, sh);
    }
    if (j + 1 < n_steps) load_bn1(j + 1);  // lands during the MMAs
    // step j is complete for every warp, and every warp is past step j - 1,
    // whose stage the next copy reuses
    __syncthreads();
    if (j + 1 < n_steps) issue_step(j + 1);
    cp_async_commit();

    const __nv_bfloat16* ws = xs + kXsElems;
#pragma unroll
    for (int kk = 0; kk < kChunk; kk += 16) {
      if (kk < kc) {
        uint32_t bfr[2][4];
#pragma unroll
        for (int p = 0; p < 2; ++p)
          ldsm_x4(bfr[p], ws + (wn * 32 + p * 16 + b_n) * kChunkStride + kk + b_k);
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          if (wm * 4 + m < kMTiles1) {
            uint32_t af[4];
            ldsm_x4(af, xs + ((wm * 4 + m) * 16 + a_r) * kChunkStride + kk + a_k);
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
              mma_bf16(acc1[m][jj], af, bfr[jj >> 1][(jj & 1) * 2],
                       bfr[jj >> 1][(jj & 1) * 2 + 1]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();  // w2's slice has landed
  __syncthreads();     // every warp is done with the ring

  // ---- the partial bottleneck, rows < 100, over the ring --------------------
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = (wm * 4 + m) * 16 + gid + half * 8;
      if (wm * 4 + m < kMTiles1 && r < kHaloPx) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          *reinterpret_cast<float2*>(part + r * kPartStride + wn * 32 + jj * 8 +
                                     tig * 2) =
              make_float2(acc1[m][jj][half * 2], acc1[m][jj][half * 2 + 1]);
      }
    }
  cluster_sync();  // every partial is complete; every CTA of the cluster runs

  // ---- reduce 1: channels [rank CW, +CW) over the S partials, BN2, ReLU,
  // image mask, bf16 -> the bottleneck slice. A thread keeps channels c4.
  {
    const int c4 = tid % (CW / 4);
    const int c = rank * CW + c4 * 4;
    const float4 i2 = *reinterpret_cast<const float4*>(a.inv2 + c);
    const float4 s2 = *reinterpret_cast<const float4*>(a.sh2 + c);
    uint32_t src[S];
#pragma unroll
    for (int q = 0; q < S; ++q) src[q] = map_rank(part + c, q);
    for (int r = tid / (CW / 4); r < kHaloPx; r += kThreads / (CW / 4)) {
      float4 v[S];
#pragma unroll
      for (int q = 0; q < S; ++q)
        v[q] = ld_cluster_f4(src[q] + 4 * r * kPartStride);
      float4 sum = v[0];
#pragma unroll
      for (int q = 1; q < S; ++q) sum = add4(sum, v[q]);  // rank order
      const int iy = y0 - 1 + r / kHalo, ix = x0 - 1 + r % kHalo;
      uint2 packed = make_uint2(0u, 0u);
      if (iy >= 0 && iy < H && ix >= 0 && ix < W)
        packed = make_uint2(pack_bf16x2(fmaxf(sum.x * i2.x + s2.x, 0.f),
                                        fmaxf(sum.y * i2.y + s2.y, 0.f)),
                            pack_bf16x2(fmaxf(sum.z * i2.z + s2.z, 0.f),
                                        fmaxf(sum.w * i2.w + s2.w, 0.f)));
      *reinterpret_cast<uint2*>(bneck + r * kSlice + c4 * 4) = packed;
    }
  }
  __syncthreads();  // the bottleneck slice is complete

  // ---- conv2 over this CTA's CW channels: nine shifted (64 x CW) @ (CW x 32)
  // warp tile: output pixels [16 mt, +16), growth channels [16 np, +16)
  const int mt = warp >> 1, np = warp & 1;
  const int p_a = mt * 16 + a_r;
  const int a_row2 = (p_a / kTile) * kHalo + p_a % kTile;  // at tap (0, 0)
  float acc2[2][4];
#pragma unroll
  for (int jj = 0; jj < 2; ++jj)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc2[jj][q] = 0.f;
#pragma unroll
  for (int t = 0; t < kTaps; ++t) {
    const int shift = (t / 3) * kHalo + t % 3;
#pragma unroll
    for (int kk = 0; kk < CW; kk += 16) {
      uint32_t af[4], bfr[4];
      ldsm_x4(af, bneck + (a_row2 + shift) * kSlice + kk + a_k);
      ldsm_x4(bfr, w2s + (t * kG + np * 16 + b_n) * kSlice + kk + b_k);
      mma_bf16(acc2[0], af, bfr[0], bfr[1]);
      mma_bf16(acc2[1], af, bfr[2], bfr[3]);
    }
  }
  // the partial of output pixel p goes to CTA p / kPx, slot [rank][p % kPx]
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int p = mt * 16 + gid + half * 8;
#pragma unroll
    for (int jj = 0; jj < 2; ++jj)
      st_cluster_f2(map_rank(recv + (rank * kPx + p % kPx) * kOutStride +
                                 (np * 2 + jj) * 8 + tig * 2,
                             p / kPx),
                    acc2[jj][half * 2], acc2[jj][half * 2 + 1]);
  }
  // every partial of this CTA's pixels has landed, and no CTA reads another's
  // conv1 partial any more
  cluster_sync();

  // ---- output pixels [rank kPx, +kPx): the S partials in rank order, bf16,
  // stored in place at channels [c_in, c_in + 32)
  for (int i = tid; i < kPx * (kG / 4); i += kThreads) {
    const int pl = i / (kG / 4), g4 = i % (kG / 4);
    float4 sum = *reinterpret_cast<const float4*>(recv + pl * kOutStride + g4 * 4);
#pragma unroll
    for (int q = 1; q < S; ++q)
      sum = add4(sum, *reinterpret_cast<const float4*>(
                          recv + (q * kPx + pl) * kOutStride + g4 * 4));
    const int p = rank * kPx + pl;
    const int y = y0 + p / kTile, x = x0 + p % kTile;
    if (y < H && x < W)
      *reinterpret_cast<uint2*>(a.state + (img_base + (size_t)y * W + x) * C +
                                c_in + g4 * 4) =
          make_uint2(pack_bf16x2(sum.x, sum.y), pack_bf16x2(sum.z, sum.w));
  }
}

const void* kernel_for(int s) {
  switch (s) {
    case 2: return reinterpret_cast<const void*>(dense_layer_cluster_kernel<2>);
    case 4: return reinterpret_cast<const void*>(dense_layer_cluster_kernel<4>);
    case 8: return reinterpret_cast<const void*>(dense_layer_cluster_kernel<8>);
    default: return nullptr;
  }
}

}  // namespace

// Bytes of dynamic shared memory the kernel takes at this cluster size, or -1
// for a cluster size it does not take. For tests of the Python mirror.
extern "C" long long dense_layer_cluster_smem(int cluster) {
  if (kernel_for(cluster) == nullptr) return -1;
  return (long long)smem_bytes(cluster);
}

// Launches one dense layer on `stream` as one cluster of `cluster` CTAs (2, 4
// or 8) per 8x8 output tile. Returns a cudaError_t: nonzero when the
// arguments are outside what the kernel takes, the card cannot give the
// shared memory or co-schedule one such cluster, or the launch was refused.
// Pointers as for dense_layer_launch.
extern "C" int dense_layer_cluster_launch(
    void* state, const void* inv1, const void* sh1, const void* w1,
    const void* inv2, const void* sh2, const void* w2, int batch, int height,
    int width, int channels, int c_in, int bottleneck, int growth,
    int cluster, void* stream) {
  const void* kernel = kernel_for(cluster);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  if (bottleneck != kF || growth != kG) return (int)cudaErrorInvalidValue;
  if (batch <= 0 || height <= 0 || width <= 0 || c_in <= 0 ||
      c_in % kUnit != 0 || channels % 8 != 0 || c_in + growth > channels)
    return (int)cudaErrorInvalidValue;
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_bytes(cluster);
  if (smem > kSmemLimit || smem > (size_t)optin)
    return (int)cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_y = (height + kTile - 1) / kTile;
  const int tiles_x = (width + kTile - 1) / kTile;
  const long long ctas = (long long)batch * tiles_y * tiles_x * cluster;
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)ctas, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;

  // Whether one cluster of this size fits on the card at all: asked once per
  // device and cluster size (the shared memory is fixed by the size).
  static bool fits[64][3];
  const int slot = cluster == 2 ? 0 : cluster == 4 ? 1 : 2;
  if (device >= 64 || !fits[device][slot]) {
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
    if (device < 64) fits[device][slot] = true;
  }

  ClusterArgs args{static_cast<__nv_bfloat16*>(state),
                   static_cast<const float*>(inv1),
                   static_cast<const float*>(sh1),
                   static_cast<const __nv_bfloat16*>(w1),
                   static_cast<const float*>(inv2),
                   static_cast<const float*>(sh2),
                   static_cast<const __nv_bfloat16*>(w2),
                   height, width, channels, c_in, tiles_x, tiles_y * tiles_x};
  void* kargs[] = {&args};
  err = cudaLaunchKernelExC(&cfg, kernel, kargs);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
