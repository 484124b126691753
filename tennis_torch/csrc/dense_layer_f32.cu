// One DenseNet-BC dense layer at inference in f32, in one launch, for Hopper
// (sm_90a).
//
// Replaces tennis_tpu/ops/pallas/dense_block.py::_layer_kernel (launched there
// by dense_layer_pallas) at dtype=float32, the case the pixels-path captioner
// runs: its DenseNet src_embed is built in f32 (tennis_tpu/train_gnmt.py:101),
// so its eval forward in every per-epoch decode and in evaluate_gnmt goes
// through this kernel. It computes the same function, in f32 throughout:
//
//   h   = relu(x * inv1 + sh1)            folded BN1, x = state[..., :c_in]
//   b   = relu((h @ w1) * inv2 + sh2)     1x1 conv c_in -> F, folded BN2
//   b   = 0 outside the image             = conv2's zero padding
//   out = conv3x3(b, w2)                  F -> G, written to state[..., c_in:c_in+G]
//
// with f32 operands, f32 accumulation and no rounding between, as
// dense_layer_reference at f32.
//
// Arithmetic: SIMT FFMA, no tensor cores. TF32 mma.sync would round every
// operand to 10 mantissa bits and move the result away from the JAX package's
// f32; a 3xTF32 split or wgmma design is later work.
//
// The block state is an unpadded NHWC (B, H, W, C) f32 buffer. Each CTA owns
// one 8x8 output tile of one image. conv1 runs over the 10x10 haloed input
// tile (pixels outside the image stage zeros and are never read) in 32-channel
// chunks: the chunk of x, after BN1 and ReLU, and the chunk of w1 are staged
// transposed in shared memory, and each thread accumulates a 7-pixel x
// 8-channel block of the 112 x 128 product in registers. BN2, ReLU and the
// image mask write the 10x10x128 f32 bottleneck tile to shared memory
// (52.8 KB); conv2 then streams w2 one tap at a time through the region the
// conv1 chunks used, each thread accumulating 2 output pixels x 4 growth
// channels over float4 reads of the bottleneck and the tap.
//
// In place, race-free: every CTA reads only channels [0, c_in) and writes only
// channels [c_in, c_in + G) of the same buffer.
//
// What bounds it on an H100 (67 TFLOP/s f32 outside the tensor cores,
// 3.35 TB/s): a layer does 2*(c_in*F + 9*F*G) FLOP per pixel and moves
// (c_in + G)*4 bytes per pixel, ~64-130 FLOP/B at F=128, G=32: every layer is
// bound by the f32 FMA rate, not by memory. This first version is simple and
// right rather than fast: it pays 100/64 = 1.56x conv1 work for the halo, and
// stages each chunk through registers without a pipeline (two CTAs per SM
// overlap one's loads with the other's FMAs).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 8;                 // output tile side, pixels
constexpr int kHalo = kTile + 2;         // haloed side of the bottleneck tile
constexpr int kHaloPx = kHalo * kHalo;   // 100 bottleneck pixels per tile
constexpr int kRows1 = 112;              // kHaloPx rounded up to 16 x 7 rows
constexpr int kF = 128;                  // bottleneck width (bn_size * growth)
constexpr int kG = 32;                   // growth rate
constexpr int kChunk = 32;               // input channels per conv1 stage
constexpr int kThreads = 256;            // 8 warps
constexpr int kTaps = 9;
constexpr int kXStride = kRows1 + 1;     // xs[k][px]: odd stride, conflict-free stores
constexpr int kWStride = kF + 1;         // ws[k][n]: odd stride, conflict-free stores
constexpr int kBStride = kF + 4;         // bneck[px][n], w2s[g][n]: float4 rows
constexpr int kPxPerThread = kRows1 / 16;  // 7 conv1 rows per thread
constexpr int kChPerThread = kF / 16;      // 8 conv1 channels per thread

constexpr int kXsFloats = kChunk * kXStride;
constexpr int kWsFloats = kChunk * kWStride;
constexpr int kRegionAFloats = kXsFloats + kWsFloats;  // conv1 stage, later one w2 tap
constexpr int kW2Floats = kG * kBStride;
constexpr int kBneckFloats = kHaloPx * kBStride;
static_assert(kW2Floats <= kRegionAFloats, "a w2 tap fits the conv1 stage");
static_assert(kRegionAFloats % 4 == 0, "the bottleneck tile is 16-byte aligned");

constexpr size_t kFixedSmemBytes =
    (size_t)(kRegionAFloats + kBneckFloats) * sizeof(float);

__global__ void __launch_bounds__(kThreads, 2)
dense_layer_f32_kernel(float* state, const float* __restrict__ inv1,
                       const float* __restrict__ sh1,
                       const float* __restrict__ w1,
                       const float* __restrict__ inv2,
                       const float* __restrict__ sh2,
                       const float* __restrict__ w2, int H, int W, int C,
                       int c_in, int tiles_x, int tiles_per_image) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                       // [kChunk][kXStride]
  float* ws = xs + kXsFloats;             // [kChunk][kWStride]
  float* w2s = smem;                      // [kG][kBStride], after conv1
  float* bneck = smem + kRegionAFloats;   // [kHaloPx][kBStride]
  float* s_inv1 = bneck + kBneckFloats;   // [c_in]
  float* s_sh1 = s_inv1 + c_in;           // [c_in]

  const int tid = threadIdx.x;
  const int b = blockIdx.x / tiles_per_image;
  const int t_in = blockIdx.x % tiles_per_image;
  const int y0 = (t_in / tiles_x) * kTile;
  const int x0 = (t_in % tiles_x) * kTile;
  const size_t img_base = (size_t)b * H * W;

  for (int c = tid; c < c_in; c += kThreads) {
    s_inv1[c] = inv1[c];
    s_sh1[c] = sh1[c];
  }

  // ---- conv1 over the haloed tile: (112 x c_in) @ (c_in x 128) ------------
  // thread (ty, tx): bottleneck rows ty + 16 i, channels tx + 16 j
  const int ty = tid >> 4;
  const int tx = tid & 15;
  float acc[kPxPerThread][kChPerThread];
#pragma unroll
  for (int i = 0; i < kPxPerThread; ++i)
#pragma unroll
    for (int j = 0; j < kChPerThread; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < c_in; k0 += kChunk) {
    __syncthreads();  // the BN1 vectors are in; the previous chunk is consumed
    // x chunk: 112 rows x 8 float4 segments, BN1 + ReLU, stored transposed
    for (int v = tid; v < kRows1 * (kChunk / 4); v += kThreads) {
      const int row = v >> 3, seg = v & 7;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (row < kHaloPx) {
        const int iy = y0 - 1 + row / kHalo;
        const int ix = x0 - 1 + row % kHalo;
        if (iy >= 0 && iy < H && ix >= 0 && ix < W) {
          const int c = k0 + seg * 4;
          const float4 raw = *reinterpret_cast<const float4*>(
              state + (img_base + (size_t)iy * W + ix) * C + c);
          val.x = fmaxf(raw.x * s_inv1[c] + s_sh1[c], 0.f);
          val.y = fmaxf(raw.y * s_inv1[c + 1] + s_sh1[c + 1], 0.f);
          val.z = fmaxf(raw.z * s_inv1[c + 2] + s_sh1[c + 2], 0.f);
          val.w = fmaxf(raw.w * s_inv1[c + 3] + s_sh1[c + 3], 0.f);
        }
      }
      float* dst = xs + seg * 4 * kXStride + row;
      dst[0] = val.x;
      dst[kXStride] = val.y;
      dst[2 * kXStride] = val.z;
      dst[3 * kXStride] = val.w;
    }
    // w1 chunk: 128 rows x 8 float4 segments of (F, c_in), stored transposed
    for (int v = tid; v < kF * (kChunk / 4); v += kThreads) {
      const int n = v >> 3, seg = v & 7;
      const float4 val = *reinterpret_cast<const float4*>(
          w1 + (size_t)n * c_in + k0 + seg * 4);
      float* dst = ws + seg * 4 * kWStride + n;
      dst[0] = val.x;
      dst[kWStride] = val.y;
      dst[2 * kWStride] = val.z;
      dst[3 * kWStride] = val.w;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kChunk; ++k) {
      float xv[kPxPerThread], wv[kChPerThread];
#pragma unroll
      for (int i = 0; i < kPxPerThread; ++i) xv[i] = xs[k * kXStride + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kChPerThread; ++j) wv[j] = ws[k * kWStride + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kPxPerThread; ++i)
#pragma unroll
        for (int j = 0; j < kChPerThread; ++j)
          acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
    }
  }

  // ---- BN2, ReLU, image mask -> the f32 bottleneck tile in smem ------------
  // (bneck is its own region: writing it while other threads still read the
  // last conv1 chunk is safe)
#pragma unroll
  for (int i = 0; i < kPxPerThread; ++i) {
    const int r = ty + 16 * i;
    if (r < kHaloPx) {
      const int iy = y0 - 1 + r / kHalo;
      const int ix = x0 - 1 + r % kHalo;
      const bool inside = iy >= 0 && iy < H && ix >= 0 && ix < W;
#pragma unroll
      for (int j = 0; j < kChPerThread; ++j) {
        const int n = tx + 16 * j;
        bneck[r * kBStride + n] =
            inside ? fmaxf(acc[i][j] * inv2[n] + sh2[n], 0.f) : 0.f;
      }
    }
  }

  // ---- conv2: 3x3, 128 -> 32, as nine shifted (64 x 128) @ (128 x 32) ------
  // thread (py, gx): output pixels py and py + 32 of the tile, growth
  // channels gx + 8 j; w2 arrives as (3, 3, G, F), one tap (G x F) at a time
  const int gx = tid & 7;
  const int py = tid >> 3;
  float acc2[2][4];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc2[p][j] = 0.f;

  for (int t = 0; t < kTaps; ++t) {
    __syncthreads();  // the previous tap (or the last conv1 chunk) is consumed
    for (int v = tid; v < kG * (kF / 4); v += kThreads) {
      const int g = v >> 5, seg = v & 31;
      *reinterpret_cast<float4*>(w2s + g * kBStride + seg * 4) =
          *reinterpret_cast<const float4*>(w2 + ((size_t)t * kG + g) * kF +
                                           seg * 4);
    }
    __syncthreads();  // the tap is in, the bottleneck tile complete
    const int dy = t / 3, dx = t % 3;
    const float* a0 = bneck + ((py / kTile + dy) * kHalo + py % kTile + dx) * kBStride;
    const float* a1 = a0 + 4 * kHalo * kBStride;  // pixel py + 32: 4 rows down
#pragma unroll 4
    for (int k = 0; k < kF; k += 4) {
      const float4 u0 = *reinterpret_cast<const float4*>(a0 + k);
      const float4 u1 = *reinterpret_cast<const float4*>(a1 + k);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 w = *reinterpret_cast<const float4*>(
            w2s + (gx + 8 * j) * kBStride + k);
        acc2[0][j] = fmaf(u0.x, w.x, acc2[0][j]);
        acc2[0][j] = fmaf(u0.y, w.y, acc2[0][j]);
        acc2[0][j] = fmaf(u0.z, w.z, acc2[0][j]);
        acc2[0][j] = fmaf(u0.w, w.w, acc2[0][j]);
        acc2[1][j] = fmaf(u1.x, w.x, acc2[1][j]);
        acc2[1][j] = fmaf(u1.y, w.y, acc2[1][j]);
        acc2[1][j] = fmaf(u1.z, w.z, acc2[1][j]);
        acc2[1][j] = fmaf(u1.w, w.w, acc2[1][j]);
      }
    }
  }

  // ---- write the growth part in place: state[..., c_in + g] ---------------
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int px = py + 32 * p;
    const int y = y0 + px / kTile;
    const int x = x0 + px % kTile;
    if (y < H && x < W) {
      float* dst = state + (img_base + (size_t)y * W + x) * C + c_in;
#pragma unroll
      for (int j = 0; j < 4; ++j) dst[gx + 8 * j] = acc2[p][j];
    }
  }
}

}  // namespace

// Launches one f32 dense layer on `stream`. Returns a cudaError_t: nonzero
// when the arguments are outside what the kernel takes or the launch was
// refused. Pointers: state (B, H, W, C) f32, inv1/sh1 (c_in,) f32, w1 (F,
// c_in) f32, inv2/sh2 (F,) f32, w2 (3, 3, G, F) f32; all contiguous, 16-byte
// aligned.
extern "C" int dense_layer_f32_launch(void* state, const void* inv1,
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
  const size_t smem = kFixedSmemBytes + 2 * sizeof(float) * (size_t)c_in;
  cudaError_t err = cudaFuncSetAttribute(
      dense_layer_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_y = (height + kTile - 1) / kTile;
  const int tiles_x = (width + kTile - 1) / kTile;
  const long long grid = (long long)batch * tiles_y * tiles_x;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  dense_layer_f32_kernel<<<(unsigned)grid, kThreads, smem,
                           (cudaStream_t)stream>>>(
      static_cast<float*>(state), static_cast<const float*>(inv1),
      static_cast<const float*>(sh1), static_cast<const float*>(w1),
      static_cast<const float*>(inv2), static_cast<const float*>(sh2),
      static_cast<const float*>(w2), height, width, channels, c_in, tiles_x,
      tiles_y * tiles_x);
  return (int)cudaGetLastError();
}
