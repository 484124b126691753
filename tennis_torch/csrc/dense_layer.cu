// One DenseNet-BC dense layer at inference, in one launch, for Hopper (sm_90a).
//
// Replaces tennis_tpu/ops/pallas/dense_block.py::_layer_kernel (launched there
// by dense_layer_pallas). It computes the same function:
//
//   h   = relu(x * inv1 + sh1)            folded BN1, x = state[..., :c_in]
//   b   = relu((h @ w1) * inv2 + sh2)     1x1 conv c_in -> F, folded BN2
//   b   = 0 outside the image             = conv2's zero padding
//   out = conv3x3(b, w2)                  F -> G, written to state[..., c_in:c_in+G]
//
// The block state is an unpadded NHWC (B, H, W, C) bf16 buffer. Each CTA owns
// one 8x8 output tile of one image: it reads the 10x10 haloed input tile
// itself (pixels outside the image are never read), computes the 10x10xF
// bottleneck into shared memory, masks it outside the image and rounds it to
// bf16, then runs the 3x3 conv from shared memory. Ragged sides (7x7, 4x4)
// are tiles that the image edge cuts.
//
// In place, race-free: every CTA reads only channels [0, c_in) and writes only
// channels [c_in, c_in + G) of the same buffer, so no CTA reads what another
// CTA of the same launch writes.
//
// Arithmetic: both convolutions run on the tensor cores through mma.sync
// m16n8k16 (bf16 operands, f32 accumulation). BN and ReLU are f32; the BN1
// output and the bottleneck are rounded to bf16, the operand type of the MMA.
//
// What bounds it on an H100 (989 TFLOP/s bf16, 3.35 TB/s): a layer does
// 2*(c_in*F + 9*F*G) FLOP per pixel and moves (c_in + G)*2 bytes per pixel.
// At F=128, G=32 that is ~470 FLOP/B at c_in=64 (128^2 maps: compute-bound)
// and ~160 FLOP/B at c_in~1000 (32^2 and 16^2 maps: memory-bound). This first
// version is simple and right rather than fast: it pays 112/64 = 1.75x conv1
// work for the halo, uses mma.sync (not wgmma/TMA), and a two-stage
// register-staged pipeline over 32-channel chunks of the input.

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
constexpr int kChunk = 32;                // input channels per conv1 stage
constexpr int kChunkStride = kChunk + 8;  // smem row of a chunk: 80 B, conflict-free
constexpr int kFStride = kF + 8;          // smem row of F values: 272 B, conflict-free
constexpr int kThreads = 256;             // 8 warps
constexpr int kTaps = 9;

constexpr int kXsElems = kRows1 * kChunkStride;     // input chunk, one stage
constexpr int kWsElems = kF * kChunkStride;         // w1 chunk, one stage
constexpr int kStage1Elems = kXsElems + kWsElems;
constexpr int kW2Elems = kG * kFStride;             // one tap of w2, one stage
constexpr int kRegionAElems = 2 * kStage1Elems;     // conv1 stages, later w2 stages
constexpr int kBneckElems = kHaloPx * kFStride;
static_assert(2 * kW2Elems <= kRegionAElems, "w2 stages alias the conv1 stages");

constexpr size_t kFixedSmemBytes =
    (size_t)(kRegionAElems + kBneckElems) * sizeof(__nv_bfloat16);
static_assert(kFixedSmemBytes % 16 == 0, "BN1 vectors follow 16-byte aligned");

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
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
// (bf16 -> f32 is a 16-bit shift of the bit pattern.)
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

__global__ void __launch_bounds__(kThreads, 2)
dense_layer_kernel(__nv_bfloat16* state, const float* __restrict__ inv1,
                   const float* __restrict__ sh1,
                   const __nv_bfloat16* __restrict__ w1,
                   const float* __restrict__ inv2,
                   const float* __restrict__ sh2,
                   const __nv_bfloat16* __restrict__ w2, int H, int W, int C,
                   int c_in, int tiles_x, int tiles_per_image) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* region_a = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* bneck = region_a + kRegionAElems;
  float* s_inv1 = reinterpret_cast<float*>(smem_raw + kFixedSmemBytes);
  float* s_sh1 = s_inv1 + c_in;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2;  // MMA fragment row group
  const int tig = lane & 3;   // thread in group

  const int b = blockIdx.x / tiles_per_image;
  const int t_in = blockIdx.x % tiles_per_image;
  const int y0 = (t_in / tiles_x) * kTile;
  const int x0 = (t_in % tiles_x) * kTile;
  const size_t img_base = (size_t)b * H * W;

  // ---- conv1 over the haloed tile: (112 x c_in) @ (c_in x 128) -------------
  // Each thread stages two 16-byte vectors of the input chunk and two of the
  // w1 chunk in registers; the next chunk's loads are in flight while the
  // tensor cores work on the current one.
  uint4 xr[2], wr[2];
  bool xok[2];

  auto load_chunk = [&](int k0) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int v = tid + s * kThreads;  // 448 input vectors: 112 rows x 4
      xok[s] = false;
      xr[s] = make_uint4(0, 0, 0, 0);
      if (v < kRows1 * 4) {
        const int row = v >> 2, seg = v & 3;
        if (row < kHaloPx) {
          const int iy = y0 - 1 + row / kHalo;
          const int ix = x0 - 1 + row % kHalo;
          if (iy >= 0 && iy < H && ix >= 0 && ix < W) {
            xok[s] = true;
            xr[s] = *reinterpret_cast<const uint4*>(
                state + (img_base + (size_t)iy * W + ix) * C + k0 + seg * 8);
          }
        }
      }
      const int n = v >> 2, seg = v & 3;  // 512 w1 vectors: 128 rows x 4
      wr[s] = *reinterpret_cast<const uint4*>(w1 + (size_t)n * c_in + k0 +
                                              seg * 8);
    }
  };

  auto store_chunk = [&](int k0, int buf) {
    __nv_bfloat16* xs = region_a + buf * kStage1Elems;
    __nv_bfloat16* ws = xs + kXsElems;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int v = tid + s * kThreads;
      const int row = v >> 2, seg = v & 3;
      if (v < kRows1 * 4) {
        // pixels outside the image (and the padding rows) stage zeros; their
        // bottleneck rows are masked after BN2 anyway
        const uint4 val =
            xok[s] ? bn_relu8(xr[s], s_inv1 + k0 + seg * 8, s_sh1 + k0 + seg * 8)
                   : make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(xs + row * kChunkStride + seg * 8) = val;
      }
      *reinterpret_cast<uint4*>(ws + row * kChunkStride + seg * 8) = wr[s];
    }
  };

  load_chunk(0);
  for (int c = tid; c < c_in; c += kThreads) {
    s_inv1[c] = inv1[c];
    s_sh1[c] = sh1[c];
  }
  __syncthreads();

  // warp w owns bottleneck columns [16w, 16w + 16) for all 112 rows
  float acc1[kMTiles1][2][4];
#pragma unroll
  for (int m = 0; m < kMTiles1; ++m)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc1[m][j][q] = 0.f;

  const int n_chunks = c_in / kChunk;
  for (int k = 0; k < n_chunks; ++k) {
    const int buf = k & 1;
    store_chunk(k * kChunk, buf);
    __syncthreads();
    if (k + 1 < n_chunks) load_chunk((k + 1) * kChunk);

    const __nv_bfloat16* xs = region_a + buf * kStage1Elems;
    const __nv_bfloat16* ws = xs + kXsElems;
#pragma unroll
    for (int kk = 0; kk < kChunk; kk += 16) {
      uint32_t bfr[2][2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const __nv_bfloat16* wp =
            ws + (warp * 16 + j * 8 + gid) * kChunkStride + kk + tig * 2;
        bfr[j][0] = lds32(wp);
        bfr[j][1] = lds32(wp + 8);
      }
#pragma unroll
      for (int m = 0; m < kMTiles1; ++m) {
        const __nv_bfloat16* ap = xs + (m * 16 + gid) * kChunkStride + kk + tig * 2;
        uint32_t a[4];
        a[0] = lds32(ap);
        a[1] = lds32(ap + 8 * kChunkStride);
        a[2] = lds32(ap + 8);
        a[3] = lds32(ap + 8 * kChunkStride + 8);
        mma_bf16(acc1[m][0], a, bfr[0][0], bfr[0][1]);
        mma_bf16(acc1[m][1], a, bfr[1][0], bfr[1][1]);
      }
    }
  }

  // ---- BN2, ReLU, image mask, bf16 round -> bottleneck tile in smem ---------
  // (bneck is its own region: writing it while other warps still read the
  // conv1 stages is safe)
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int n = warp * 16 + j * 8 + tig * 2;
    const float i0 = inv2[n], i1 = inv2[n + 1];
    const float s0 = sh2[n], s1 = sh2[n + 1];
#pragma unroll
    for (int m = 0; m < kMTiles1; ++m) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = m * 16 + gid + half * 8;
        if (r < kHaloPx) {
          const int iy = y0 - 1 + r / kHalo;
          const int ix = x0 - 1 + r % kHalo;
          const bool inside = iy >= 0 && iy < H && ix >= 0 && ix < W;
          const float v0 =
              inside ? fmaxf(acc1[m][j][half * 2] * i0 + s0, 0.f) : 0.f;
          const float v1 =
              inside ? fmaxf(acc1[m][j][half * 2 + 1] * i1 + s1, 0.f) : 0.f;
          *reinterpret_cast<uint32_t*>(bneck + r * kFStride + n) =
              pack_bf16x2(v0, v1);
        }
      }
    }
  }

  // ---- conv2: 3x3, 128 -> 32, as nine shifted (64 x 128) @ (128 x 32) -------
  // w2 arrives as (3, 3, G, F); one tap (G x F) per stage, streamed through
  // the region the conv1 stages used.
  uint4 w2r[2];
  auto load_tap = [&](int t) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int v = tid + s * kThreads;  // 512 vectors: 32 rows x 16
      w2r[s] = *reinterpret_cast<const uint4*>(
          w2 + ((size_t)t * kG + (v >> 4)) * kF + (v & 15) * 8);
    }
  };
  auto store_tap = [&](int buf) {
    __nv_bfloat16* w2s = region_a + buf * kW2Elems;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int v = tid + s * kThreads;
      *reinterpret_cast<uint4*>(w2s + (v >> 4) * kFStride + (v & 15) * 8) = w2r[s];
    }
  };

  load_tap(0);
  __syncthreads();  // conv1 stages are free, the bottleneck tile is complete

  // warp w: output rows [16*(w/2), +16) of the 64-pixel tile, growth columns
  // [16*(w%2), +16)
  const int mt = warp >> 1;
  const int nt0 = (warp & 1) * 2;
  const int p0 = mt * 16 + gid;  // output pixel of fragment rows gid / gid+8
  const int oy0 = p0 / kTile, ox0 = p0 % kTile;  // second row: oy0 + 1
  float acc2[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc2[j][q] = 0.f;

  for (int t = 0; t < kTaps; ++t) {
    const int buf = t & 1;
    store_tap(buf);
    __syncthreads();
    if (t + 1 < kTaps) load_tap(t + 1);

    const __nv_bfloat16* w2s = region_a + buf * kW2Elems;
    const int dy = t / 3, dx = t % 3;
    const __nv_bfloat16* a_row0 =
        bneck + ((oy0 + dy) * kHalo + ox0 + dx) * kFStride + tig * 2;
    const __nv_bfloat16* a_row1 = a_row0 + kHalo * kFStride;
#pragma unroll
    for (int kk = 0; kk < kF; kk += 16) {
      uint32_t a[4];
      a[0] = lds32(a_row0 + kk);
      a[1] = lds32(a_row1 + kk);
      a[2] = lds32(a_row0 + kk + 8);
      a[3] = lds32(a_row1 + kk + 8);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const __nv_bfloat16* bp =
            w2s + ((nt0 + j) * 8 + gid) * kFStride + kk + tig * 2;
        mma_bf16(acc2[j], a, lds32(bp), lds32(bp + 8));
      }
    }
  }

  // ---- write the growth part in place: state[..., c_in + g] ----------------
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int y = y0 + oy0 + half;
    const int x = x0 + ox0;
    if (y < H && x < W) {
      __nv_bfloat16* dst = state + (img_base + (size_t)y * W + x) * C + c_in;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int g = (nt0 + j) * 8 + tig * 2;
        *reinterpret_cast<uint32_t*>(dst + g) =
            pack_bf16x2(acc2[j][half * 2], acc2[j][half * 2 + 1]);
      }
    }
  }
}

}  // namespace

// Launches one dense layer on `stream`. Returns a cudaError_t: nonzero when
// the arguments are outside what the kernel takes or the launch was refused.
// Pointers: state (B, H, W, C) bf16, inv1/sh1 (c_in,) f32, w1 (F, c_in) bf16,
// inv2/sh2 (F,) f32, w2 (3, 3, G, F) bf16; all contiguous, 16-byte aligned.
extern "C" int dense_layer_launch(void* state, const void* inv1,
                                  const void* sh1, const void* w1,
                                  const void* inv2, const void* sh2,
                                  const void* w2, int batch, int height,
                                  int width, int channels, int c_in,
                                  int bottleneck, int growth, void* stream) {
  if (bottleneck != kF || growth != kG) return (int)cudaErrorInvalidValue;
  if (batch <= 0 || height <= 0 || width <= 0 || c_in <= 0 ||
      c_in % kChunk != 0 || channels % 8 != 0 || c_in + growth > channels)
    return (int)cudaErrorInvalidValue;
  const size_t smem = kFixedSmemBytes + 2 * sizeof(float) * (size_t)c_in;
  cudaError_t err = cudaFuncSetAttribute(
      dense_layer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_y = (height + kTile - 1) / kTile;
  const int tiles_x = (width + kTile - 1) / kTile;
  const long long grid = (long long)batch * tiles_y * tiles_x;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  dense_layer_kernel<<<(unsigned)grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<__nv_bfloat16*>(state), static_cast<const float*>(inv1),
      static_cast<const float*>(sh1), static_cast<const __nv_bfloat16*>(w1),
      static_cast<const float*>(inv2), static_cast<const float*>(sh2),
      static_cast<const __nv_bfloat16*>(w2), height, width, channels, c_in,
      tiles_x, tiles_y * tiles_x);
  return (int)cudaGetLastError();
}
