// Fused int8 deep tower for Hopper (sm_90a), bound through a plain C entry.
//
// Replaces the TPU kernel `_int8_mlp_kernel`
// (xsdeepfwfm_deprecated_tpu/ops/pallas/int8_mlp.py:26-49). For every hidden
// layer, with the scale taken over a whole `block_b`-row tile:
//   s   = max(amax(|x_tile|), 1e-12) / 127
//   x_q = clip(round_half_even(x / s), -127, 127)            (int8)
//   x   = relu(((float)(x_q @ w_q) * s) * w_scale + b)       (int32 products)
// and the bias-free head is quantized the same way: out = ((float)acc * s) * fc_scale.
//
// What bounds it on an H100 at B = 8192 (390 -> 400 -> 400 -> 400 -> 1):
//   7.8 G int8 operations / 1,979 TOPS   = 3.94 us
//   13.3 MB read once (x and the weights) / 3.35 TB/s = 3.97 us
// so the bound is about 4.0 us, memory-bound by a hair.
//
// Design. A tile's scale needs the abs-max of the whole 512 x 400 tile before
// any of it is quantized, and that tile (800 KB in f32) does not fit in one
// block's shared memory. So each layer is a launch of its own and the
// abs-max travels between launches:
//   absmax   tile abs-max of the input                (atomicMax per tile)
//   quantize f32 activations -> int8 codes, zero-padded to the width W
//   gemm     int8 mma.sync m16n8k32 -> int32, epilogue writes f32
//            activations and atomicMaxes the next layer's tile abs-max
//            (non-negative floats order like their bit patterns)
//   head     quantizes the last activations and dots them with the head
// One tower call is 2 + 2 * n_hidden kernels (8 for the flagship) and one
// memset. Every width is zero-padded to W, a multiple of 32 (416 for the
// flagship): zeros change neither an abs-max nor a sum. A gemm block keeps
// its whole K panel (64 and 32 rows of W bytes) in shared memory, so it has
// no K loop over global memory. Rounding is `__float2int_rn` of an IEEE
// division, and the epilogue uses `__fmul_rn` / `__fadd_rn` so that no FMA
// contraction moves a value across a .5 quantization boundary of the next
// layer. This is the simple first version: wgmma and TMA come later.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;           // gemm block rows (a block_b tile holds whole blocks)
constexpr int ABSMAX_ROWS = 8;   // rows per absmax block: 1,024 blocks at B = 8192
constexpr int BN = 32;           // gemm block columns
constexpr int GEMM_THREADS = 128;
constexpr int ROW_PAD = 16;      // bytes added to each shared-memory row: no bank conflicts
constexpr int THREADS = 256;

__device__ __forceinline__ float tile_scale(unsigned amax_bits) {
  return __fdiv_rn(fmaxf(__uint_as_float(amax_bits), 1e-12f), 127.0f);
}

__device__ __forceinline__ int quantize(float v, float s) {
  const int q = __float2int_rn(__fdiv_rn(v, s));
  return min(max(q, -127), 127);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Max of a non-negative value over the block; the result is valid in thread 0.
__device__ float block_max(float v) {
  __shared__ float partial[32];
  v = warp_max(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) partial[warp] = v;
  __syncthreads();
  if (warp == 0) v = warp_max(lane < (blockDim.x >> 5) ? partial[lane] : 0.0f);
  return v;
}

// amax[tile] = max |x|, ABSMAX_ROWS rows per block, x row-major (rows, cols).
__global__ void __launch_bounds__(THREADS)
absmax_kernel(const float* __restrict__ x, int cols, int block_b, unsigned* __restrict__ amax) {
  const int r0 = blockIdx.x * ABSMAX_ROWS;
  const float* p = x + (size_t)r0 * cols;
  const int n = ABSMAX_ROWS * cols;
  float m = 0.0f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) m = fmaxf(m, fabsf(p[i]));
  m = block_max(m);
  if (threadIdx.x == 0) atomicMax(&amax[r0 / block_b], __float_as_uint(m));
}

// q (rows, W) int8 = codes of x (rows, cols) f32 with row stride ld; the
// columns from cols to W get 0. One thread writes 4 codes.
__global__ void __launch_bounds__(THREADS)
quantize_kernel(const float* __restrict__ x, int ld, int cols, int W, int block_b,
                const unsigned* __restrict__ amax, int8_t* __restrict__ q, int rows) {
  const int per_row = W / 4;
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long)rows * per_row) return;
  const int r = (int)(i / per_row), c = (int)(i % per_row) * 4;
  const float s = tile_scale(amax[r / block_b]);
  const float* xr = x + (size_t)r * ld;
  char4 out;
  out.x = (signed char)(c + 0 < cols ? quantize(xr[c + 0], s) : 0);
  out.y = (signed char)(c + 1 < cols ? quantize(xr[c + 1], s) : 0);
  out.z = (signed char)(c + 2 < cols ? quantize(xr[c + 2], s) : 0);
  out.w = (signed char)(c + 3 < cols ? quantize(xr[c + 3], s) : 0);
  reinterpret_cast<char4*>(q + (size_t)r * W)[c / 4] = out;
}

__device__ __forceinline__ void mma_s8(int* c, const unsigned* a, const unsigned* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float epilogue(int acc, float s, float w_scale, float bias) {
  return fmaxf(__fadd_rn(__fmul_rn(__fmul_rn((float)acc, s), w_scale), bias), 0.0f);
}

// y (rows, W) f32 = relu(((float)(q @ wt^T) * s) * w_scale + bias) for one
// BM x BN tile, q (rows, W) int8 and wt (W, W) int8 both K-contiguous; then
// amax_out[tile] = max(amax_out[tile], max |y| over the block).
// Four warps in a 2 x 2 grid, each 32 x 16 outputs: 2 x 2 mma tiles of 16 x 8.
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ wt,
            const float* __restrict__ w_scale, const float* __restrict__ bias,
            int W, int block_b, const unsigned* __restrict__ amax_in,
            unsigned* __restrict__ amax_out, float* __restrict__ y) {
  extern __shared__ int4 smem[];
  const int ld = W + ROW_PAD;
  int8_t* sa = reinterpret_cast<int8_t*>(smem);
  int8_t* sb = sa + BM * ld;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  const int vecs = W / 16;
  for (int i = threadIdx.x; i < BM * vecs; i += GEMM_THREADS) {
    const int r = i / vecs, v = i % vecs;
    *reinterpret_cast<int4*>(sa + r * ld + v * 16) =
        *reinterpret_cast<const int4*>(q + (size_t)(m0 + r) * W + v * 16);
  }
  for (int i = threadIdx.x; i < BN * vecs; i += GEMM_THREADS) {
    const int r = i / vecs, v = i % vecs;
    *reinterpret_cast<int4*>(sb + r * ld + v * 16) =
        *reinterpret_cast<const int4*>(wt + (size_t)(n0 + r) * W + v * 16);
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 16;
  int acc[2][2][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mi][ni][j] = 0;

  for (int k = 0; k < W; k += 32) {
    unsigned a[2][4], b[2][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int8_t* p = sa + (wm + mi * 16 + g) * ld + k + t * 4;
      a[mi][0] = *reinterpret_cast<const unsigned*>(p);
      a[mi][1] = *reinterpret_cast<const unsigned*>(p + 8 * ld);
      a[mi][2] = *reinterpret_cast<const unsigned*>(p + 16);
      a[mi][3] = *reinterpret_cast<const unsigned*>(p + 8 * ld + 16);
    }
#pragma unroll
    for (int ni = 0; ni < 2; ++ni) {
      const int8_t* p = sb + (wn + ni * 8 + g) * ld + k + t * 4;
      b[ni][0] = *reinterpret_cast<const unsigned*>(p);
      b[ni][1] = *reinterpret_cast<const unsigned*>(p + 16);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);
  }

  const float s = tile_scale(amax_in[m0 / block_b]);
  float m = 0.0f;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 2; ++ni) {
      const int col = n0 + wn + ni * 8 + t * 2;
      const float ws0 = w_scale[col], ws1 = w_scale[col + 1];
      const float b0 = bias[col], b1 = bias[col + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm + mi * 16 + g + h * 8;
        const float v0 = epilogue(acc[mi][ni][2 * h], s, ws0, b0);
        const float v1 = epilogue(acc[mi][ni][2 * h + 1], s, ws1, b1);
        *reinterpret_cast<float2*>(y + (size_t)row * W + col) = make_float2(v0, v1);
        m = fmaxf(m, fmaxf(fabsf(v0), fabsf(v1)));
      }
    }
  }
  m = block_max(m);
  if (threadIdx.x == 0) atomicMax(&amax_out[m0 / block_b], __float_as_uint(m));
}

// out[r] = ((float)(q(y[r]) . fc) * s) * fc_scale, one warp per row.
__global__ void __launch_bounds__(THREADS)
head_kernel(const float* __restrict__ y, const int8_t* __restrict__ fc,
            const float* __restrict__ fc_scale, int W, int block_b,
            const unsigned* __restrict__ amax, float* __restrict__ out, int rows) {
  const int row = blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float s = tile_scale(amax[row / block_b]);
  const float* yr = y + (size_t)row * W;
  int acc = 0;
  for (int k = lane; k < W; k += 32) acc += quantize(yr[k], s) * (int)fc[k];
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) out[row] = __fmul_rn(__fmul_rn((float)acc, s), fc_scale[0]);
}

}  // namespace

// The whole tower on `stream`. x (rows, in_dim) f32; layer l has w_t[l]
// (W, W) int8 laid out [out][in], w_scale[l] and bias[l] (W,) f32, all
// zero-padded; fc (W,) int8 and fc_scale (1,) f32. Scratch: q (rows, W)
// int8, y (rows, W) f32, amax ((n_hidden + 1) * rows / block_b) 32-bit.
// out (rows,) f32. Needs rows % block_b == 0, block_b % 64 == 0,
// W % 32 == 0, in_dim <= W, n_hidden >= 1. Returns cudaGetLastError().
extern "C" int int8_mlp_forward(const float* x, int rows, int in_dim, int W, int n_hidden,
                                int block_b, const void* const* w_t,
                                const void* const* w_scale, const void* const* bias,
                                const int8_t* fc, const float* fc_scale, int8_t* q, float* y,
                                unsigned* amax, float* out, cudaStream_t stream) {
  const int n_tiles = rows / block_b;
  const size_t smem = (size_t)(BM + BN) * (W + ROW_PAD);
  cudaError_t err = cudaFuncSetAttribute(gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemsetAsync(amax, 0, sizeof(unsigned) * (size_t)(n_hidden + 1) * n_tiles, stream);
  if (err != cudaSuccess) return (int)err;

  const long codes = (long)rows * (W / 4);
  const int quant_blocks = (int)((codes + THREADS - 1) / THREADS);
  absmax_kernel<<<rows / ABSMAX_ROWS, THREADS, 0, stream>>>(x, in_dim, block_b, amax);
  quantize_kernel<<<quant_blocks, THREADS, 0, stream>>>(x, in_dim, in_dim, W, block_b, amax, q,
                                                        rows);
  const dim3 gemm_grid(W / BN, rows / BM);
  for (int l = 0; l < n_hidden; ++l) {
    const unsigned* amax_in = amax + (size_t)l * n_tiles;
    if (l > 0)
      quantize_kernel<<<quant_blocks, THREADS, 0, stream>>>(y, W, W, W, block_b, amax_in, q, rows);
    gemm_kernel<<<gemm_grid, GEMM_THREADS, smem, stream>>>(
        q, static_cast<const int8_t*>(w_t[l]), static_cast<const float*>(w_scale[l]),
        static_cast<const float*>(bias[l]), W, block_b, amax_in,
        amax + (size_t)(l + 1) * n_tiles, y);
  }
  head_kernel<<<(rows + THREADS / 32 - 1) / (THREADS / 32), THREADS, 0, stream>>>(
      y, fc, fc_scale, W, block_b, amax + (size_t)n_hidden * n_tiles, out, rows);
  return (int)cudaGetLastError();
}
