// xDeepFM's Compressed Interaction Network, one layer forward and backward, for
// Hopper (sm_90a), bound through a plain C entry.
//
// Replaces no TPU kernel: the JAX package has no CIN. It was added for the
// xDeepFM training cell (B=4096, m=39 fields, D=10, maps 200 x 3). A layer is
//   X^k[r, h] = sum_{i,j} W_k[h, i*m + j] * X^{k-1}[r, i] * X0[r, j]
// over rows r = (b, d), M = B*D. Its plain form (ops/cuda/cin.cin_layer_reference)
// materializes z[r, i*m + j] = X^{k-1}[r, i] * X0[r, j], a (M, H_{k-1}*m) tensor of
// 1.28 GB at that cell's layers 2 and 3, and writes and reads it some five times a
// layer and direction (z, its GEMM, the saved copy, dZ = G*W_k, dZ's products
// with X0 and X^{k-1} and their reductions). None of those bytes are needed.
//
// Layout. Every activation is feature-major: X^kT is (H_k, M), X0T is (m, M),
// so a row of it is one feature map over all rows r, read and written along r.
// W_k keeps its (H_k, H_{k-1}*m) layout, column i*m + j; the wrapper packs it into
// the tiles the kernels read (a copy of 6.2 MB at most, per call).
//
// What bounds it on an H100: fp32 FFMA, no tensor cores (the configuration is
// float32 with TF32 off). Each of the three products (forward, dW, dX) is
// 2*M*H_{k-1}*m*H_k FLOP: 2.805e11 FLOP a direction for the cell's three layers,
// 4.187 ms at 67 TFLOP/s; the bytes (the activations once, W_k, the outputs) are
// about 0.2 GB, 0.06 ms at 3.35 TB/s. So the kernels are bound by the FFMA rate.
//
// Design. One SIMT GEMM core: a block of 256 threads owns an 80 x 200 tile of
// its product, 250 threads each an 8 x 8 register tile (two runs of 4 rows by
// two runs of 4 columns, read as float4 from shared memory), over k-tiles of 20
// in double-buffered shared memory, one barrier a k-tile; two blocks an SM. 200
// columns hold the cell's H_k = 200 maps, or 5 whole field groups of 39, with no
// padded column; 20 divides 200 and 7,800. The kernels differ in how a k-tile
// reaches shared memory and in their epilogues:
//   * forward: the block's X0 rows stay resident in shared memory (m x 80). A
//     thread builds 8 rows of one column kk = i*m + j of the z tile: X^{k-1}'s
//     row i, loaded as two float4 a k-tile ahead into registers, times X0's row
//     j from shared memory. The packed W_k tile streams in by cp.async. Only X^k
//     is written (32.8 MB a layer at the cell).
//   * dW_k = G^T * z (G = dX^k): a tile is 80 columns of z by 200 maps. The
//     rows r are split into a fixed number of slices, since the 200 x 7,800
//     output has too few tiles for 132 SMs; each slice builds its z tile on chip
//     (a task: 4 rows of one column, the X^{k-1} and X0 rows as float4) and
//     writes a partial, and a second kernel sums the partials in slice order.
//     No float atomics, so two runs are bit-equal.
//   * dX: dZ = G * W_k with K = H_k; a block owns 80 rows and walks every group
//     of whole fields (floor(200/m) values of i, 195 columns at m = 39). Each
//     dZ tile is staged in shared memory (over the k-tiles' buffers) and
//     contracted there: dX^{k-1}[r, i] = sum_j X0[r, j] dZ[r, i*m+j] is finished
//     and written, dX0[r, j] += sum_i X^{k-1}[r, i] dZ[r, i*m+j] stays in
//     shared memory for the block's rows and is written once. dZ is never
//     written to device memory.
// Every sum runs in a fixed order, so the results do not change between runs.
// Ragged edges (rows, maps, fields, depth) are masked; m is at most 200.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (a CUDA graph of 20 calls, median
// of 10, at the cell's 40,960 rows; chip_smoke.py phase 26 times the same): layers
// 2 and 3 run the forward at 61% of the fp32 peak (3.11 ms against 1.91), dW at
// 55% and dX at 53% (its on-chip contraction takes 9 points of it); cuBLAS's GEMM
// on a materialized z takes 3.27 ms. The first form, k-tiles of 25 whose z values
// each took an integer division and a scalar load, ran every kernel at 43 to 46%;
// without its producer the forward read 74.5%. Neither a third cp.async stage, nor
// one block an SM with 205 to 227 registers and no spills, nor 16 x 8 register
// tiles (128 threads a block) was faster.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BM = 80;                 // rows of a tile (the register tiles' first index)
constexpr int BN = 200;                // columns of a tile
constexpr int BK = 20;                 // depth of a k-tile
constexpr int TMT = BM / 8;            // compute threads along the rows: 8 rows each
constexpr int COMPUTE = TMT * (BN / 8);   // 250 threads each own an 8 x 8 tile
constexpr int AS = BM + 4;             // row stride of the A tile (a k-row of 80 values)
constexpr int BS = BN;                 // row stride of the B tile
constexpr int A_TILE = BK * AS;
constexpr int B_TILE = BK * BS;
constexpr int CS = BM + 4;             // row stride of the dX kernel's staged dZ tile
constexpr int OPERANDS = 2 * A_TILE + 2 * B_TILE;   // double-buffered
constexpr int STAGED = BN * CS;
constexpr int MAX_M = BN;
constexpr int MAX_K = 1 << 22;         // H_{k-1} * m: `split` is exact below 2^24
constexpr int SEG = 8;                 // the forward's A tile: a thread builds 8 rows of one k
constexpr int FWD_TASKS = BK * (BM / SEG);
constexpr int DW_SEG = 4;              // dW's A tile: a task builds 4 rows r of one column c
constexpr int DW_TASKS = BM * (BK / DW_SEG);
constexpr int DW_PER = (DW_TASKS + THREADS - 1) / THREADS;
static_assert(FWD_TASKS <= THREADS && BK % DW_SEG == 0 && BM % SEG == 0, "tile shapes");

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, the bytes past src_bytes zero-filled
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// dst[r * DS + c] = src[r * ld + c] for r < rows and c < cols, else 0, over an
// R x C tile. vec: src and ld allow 16-byte copies (src 16-byte aligned, ld a
// multiple of 4). `safe` is a valid address that a zero-byte copy names.
template <int R, int C, int DS>
__device__ __forceinline__ void copy_tile(float* dst, const float* src, long long ld, int rows,
                                          int cols, bool vec, const float* safe) {
  static_assert(C % 4 == 0 && DS % 4 == 0, "16-byte rows");
  if (vec) {
    constexpr int C4 = C / 4, N = R * C4;
#pragma unroll
    for (int e0 = 0; e0 < N; e0 += THREADS) {
      const int e = e0 + threadIdx.x;
      if (N % THREADS == 0 || e < N) {
        const int r = e / C4, c = (e - r * C4) * 4;
        const int left = r < rows ? min(4, max(0, cols - c)) : 0;
        cp_async16(dst + r * DS + c, left ? src + r * ld + c : safe, left * 4);
      }
    }
  } else {
    constexpr int N = R * C;
    for (int e = threadIdx.x; e < N; e += THREADS) {
      const int r = e / C, c = e - r * C;
      const bool ok = r < rows && c < cols;
      cp_async4(dst + r * DS + c, ok ? src + r * ld + c : safe, ok ? 4 : 0);
    }
  }
}

// N contiguous floats (N % 4 == 0, both ends 16-byte aligned)
template <int N>
__device__ __forceinline__ void copy_flat(float* dst, const float* src) {
#pragma unroll
  for (int e0 = 0; e0 < N / 4; e0 += THREADS) {
    const int e = e0 + threadIdx.x;
    if ((N / 4) % THREADS == 0 || e < N / 4) cp_async16(dst + 4 * e, src + 4 * e, 16);
  }
}

// kk = i * m + j for 0 <= kk < 2^24: a float product and one correction step
__device__ __forceinline__ void split(int kk, int m, float inv_m, int& i, int& j) {
  i = __float2int_rz(static_cast<float>(kk) * inv_m);
  j = kk - i * m;
  if (j < 0) {
    --i;
    j += m;
  } else if (j >= m) {
    ++i;
    j -= m;
  }
}

// four floats from p[0..3] that lie below `n` values (the rest 0); vec: p is 16-byte aligned
__device__ __forceinline__ float4 load4(const float* __restrict__ p, int n, bool vec) {
  if (vec && n >= 4) return __ldg(reinterpret_cast<const float4*>(p));
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (n > 0) v.x = __ldg(p);
  if (n > 1) v.y = __ldg(p + 1);
  if (n > 2) v.z = __ldg(p + 2);
  if (n > 3) v.w = __ldg(p + 3);
  return v;
}

__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}

// acc += A^T B over one k-tile: A as [BK][AS] (80 rows), B as [BK][BS] (200 columns).
// Thread (tm, tn) owns rows tm*4 + {0..3} and 40 + tm*4 + {0..3}, columns
// tn*4 + {0..3} and 100 + tn*4 + {0..3}.
__device__ __forceinline__ void mma_tile(const float* __restrict__ As,
                                         const float* __restrict__ Bs, int tm, int tn,
                                         float (&acc)[8][8]) {
#pragma unroll
  for (int k = 0; k < BK; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(As + k * AS + tm * 4);
    const float4 a1 = *reinterpret_cast<const float4*>(As + k * AS + BM / 2 + tm * 4);
    const float4 b0 = *reinterpret_cast<const float4*>(Bs + k * BS + tn * 4);
    const float4 b1 = *reinterpret_cast<const float4*>(Bs + k * BS + BN / 2 + tn * 4);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

__device__ __forceinline__ int tile_row(int tm, int i) {
  return (i < 4 ? 0 : BM / 2 - 4) + tm * 4 + i;
}

__device__ __forceinline__ int tile_col(int tn, int j) {
  return (j < 4 ? 0 : BN / 2 - 4) + tn * 4 + j;
}

__device__ __forceinline__ void zero(float (&acc)[8][8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
}

// ---- forward: X^kT (h, rows) = W_k z^T, z built on chip ----
// wf: W_k packed as (ceil(h/BN), ceil(K/BK), BK, BN), wf[n][t][k][c] = W_k[n*BN + c][t*BK + k]
// (0 past the edges), K = hp * m.
__global__ void __launch_bounds__(THREADS, 2)
    forward_kernel(const float* __restrict__ xk1t, const float* __restrict__ x0t,
                   const float* __restrict__ wf, float* __restrict__ out, int hp, int m, int h,
                   int rows) {
  extern __shared__ __align__(16) float smem[];
  float* As = smem;
  float* Bs = smem + 2 * A_TILE;
  float* X0s = smem + OPERANDS;        // [m][BM]
  const int t = threadIdx.x, tm = t % TMT, tn = t / TMT;
  const int r0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int here = min(BM, rows - r0);
  const int K = hp * m, KT = (K + BK - 1) / BK;
  const float inv_m = 1.0f / static_cast<float>(m);
  const bool vec = (rows & 3) == 0;
  const float* wt = wf + static_cast<long long>(blockIdx.y) * KT * B_TILE;

  for (int e = t; e < m * BM; e += THREADS) {
    const int j = e / BM, r = e - j * BM;
    X0s[e] = r < here ? x0t[static_cast<long long>(j) * rows + r0 + r] : 0.f;
  }
  __syncthreads();

  // thread t < FWD_TASKS builds A[k][r .. r+8) = X^{k-1}[i][r..] * X0[j][r..], kk = i*m + j;
  // the X^{k-1} values are loaded a k-tile ahead, X0's come from shared memory
  const int ak = t / (BM / SEG), ar = (t % (BM / SEG)) * SEG;
  float4 xa0, xa1;
  int aj = 0;
  auto load_a = [&](int kt) {
    const int kk = kt * BK + ak;
    xa0 = xa1 = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t < FWD_TASKS && kk < K) {
      int i;
      split(kk, m, inv_m, i, aj);
      const float* p = xk1t + static_cast<long long>(i) * rows + r0 + ar;
      xa0 = load4(p, here - ar, vec);
      xa1 = load4(p + 4, here - ar - 4, vec);
    }
  };
  auto store_a = [&](float* A) {
    if (t < FWD_TASKS) {
      const float* y = X0s + aj * BM + ar;
      *reinterpret_cast<float4*>(A + ak * AS + ar) =
          mul4(xa0, *reinterpret_cast<const float4*>(y));
      *reinterpret_cast<float4*>(A + ak * AS + ar + 4) =
          mul4(xa1, *reinterpret_cast<const float4*>(y + 4));
    }
  };

  float acc[8][8];
  zero(acc);
  auto load_b = [&](int kt) {
    copy_flat<B_TILE>(Bs + (kt & 1) * B_TILE, wt + static_cast<long long>(kt) * B_TILE);
    cp_async_commit();
  };
  load_a(0);
  load_b(0);
  store_a(As);
  cp_async_wait_all();
  __syncthreads();
  for (int kt = 0; kt < KT; ++kt) {
    const int cur = kt & 1;
    const bool next = kt + 1 < KT;
    if (next) {
      load_a(kt + 1);
      load_b(kt + 1);
    }
    if (t < COMPUTE) mma_tile(As + cur * A_TILE, Bs + cur * B_TILE, tm, tn, acc);
    if (next) {
      store_a(As + (cur ^ 1) * A_TILE);
      cp_async_wait_all();
    }
    __syncthreads();
  }

  if (t < COMPUTE) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + tile_col(tn, j);
      if (n >= h) continue;
      float* o = out + static_cast<long long>(n) * rows + r0;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = tile_row(tm, 4 * half);
        if (vec && r + 4 <= here) {
          *reinterpret_cast<float4*>(o + r) = make_float4(acc[4 * half][j], acc[4 * half + 1][j],
                                                          acc[4 * half + 2][j], acc[4 * half + 3][j]);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (r + i < here) o[r + i] = acc[4 * half + i][j];
        }
      }
    }
  }
}

// ---- dW_k: out[s][n][c] = sum over slice s's rows r of G[r][n] * z[r][c] ----
// The tile's rows are columns c of z (K = hp*m of them), its columns maps n.
// g: G = dX^k as (rows, h). out is (slices, h, K). slice_rows is a multiple of BK.
__global__ void __launch_bounds__(THREADS, 2)
    grad_w_kernel(const float* __restrict__ xk1t, const float* __restrict__ x0t,
                  const float* __restrict__ g, float* __restrict__ out, int hp, int m, int h,
                  int rows, int slice_rows) {
  extern __shared__ __align__(16) float smem[];
  float* As = smem;
  float* Bs = smem + 2 * A_TILE;
  const int t = threadIdx.x, tm = t % TMT, tn = t / TMT;
  const int K = hp * m;
  const int c0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int rb = blockIdx.z * slice_rows;
  const int len = min(slice_rows, rows - rb);
  const int KT = (len + BK - 1) / BK;
  const float inv_m = 1.0f / static_cast<float>(m);
  const bool vec = (rows & 3) == 0;
  const bool vec_g = (h & 3) == 0;

  // task q of a thread builds A[k .. k+4)[c] = X^{k-1}[i][r..] * X0[j][r..] for its column
  // c = c0 + task % BM (so i, j are fixed) and rows r = rb + kt*BK + 4*(task / BM) ..
  // (offsets below 2^31: the wrapper takes max(H_{k-1}, m) * rows < 2^31)
  int xoff[DW_PER], yoff[DW_PER];
  float4 xa[DW_PER], ya[DW_PER];
#pragma unroll
  for (int q = 0; q < DW_PER; ++q) {
    const int task = t + q * THREADS, c = c0 + task % BM;
    xoff[q] = yoff[q] = -1;
    if (task < DW_TASKS && c < K) {
      int i, j;
      split(c, m, inv_m, i, j);
      xoff[q] = i * rows + rb + DW_SEG * (task / BM);
      yoff[q] = j * rows + rb + DW_SEG * (task / BM);
    }
  }
  auto load_a = [&](int kt) {
#pragma unroll
    for (int q = 0; q < DW_PER; ++q) {
      const int task = t + q * THREADS;
      const int left = len - kt * BK - DW_SEG * (task / BM);
      xa[q] = ya[q] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (xoff[q] >= 0) {
        xa[q] = load4(xk1t + xoff[q] + kt * BK, left, vec);
        ya[q] = load4(x0t + yoff[q] + kt * BK, left, vec);
      }
    }
  };
  auto store_a = [&](float* A) {
#pragma unroll
    for (int q = 0; q < DW_PER; ++q) {
      const int task = t + q * THREADS;
      if (task < DW_TASKS) {
        float* a = A + DW_SEG * (task / BM) * AS + task % BM;
        a[0] = xa[q].x * ya[q].x;
        a[AS] = xa[q].y * ya[q].y;
        a[2 * AS] = xa[q].z * ya[q].z;
        a[3 * AS] = xa[q].w * ya[q].w;
      }
    }
  };
  auto load_b = [&](int kt) {
    float* B = Bs + (kt & 1) * B_TILE;
    const float* src = g + static_cast<long long>(rb + kt * BK) * h + n0;
    if (h == BN && len - kt * BK >= BK)
      copy_flat<B_TILE>(B, src);    // whole rows of G: the tile is contiguous
    else
      copy_tile<BK, BN, BS>(B, src, h, len - kt * BK, h - n0, vec_g, g);
    cp_async_commit();
  };

  float acc[8][8];
  zero(acc);
  if (KT > 0) {
    load_a(0);
    load_b(0);
    store_a(As);
    cp_async_wait_all();
  }
  __syncthreads();
  for (int kt = 0; kt < KT; ++kt) {
    const int cur = kt & 1;
    const bool next = kt + 1 < KT;
    if (next) {
      load_a(kt + 1);
      load_b(kt + 1);
    }
    if (t < COMPUTE) mma_tile(As + cur * A_TILE, Bs + cur * B_TILE, tm, tn, acc);
    if (next) {
      store_a(As + (cur ^ 1) * A_TILE);
      cp_async_wait_all();
    }
    __syncthreads();
  }

  if (t < COMPUTE) {
    float* o = out + static_cast<long long>(blockIdx.z) * h * K;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + tile_col(tn, j);
      if (n >= h) continue;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int c = c0 + tile_row(tm, i);
        if (c < K) o[static_cast<long long>(n) * K + c] = acc[i][j];
      }
    }
  }
}

// dw[e] = sum over s in order of partial[s][e]
__global__ void sum_slices_kernel(const float* __restrict__ partial, float* __restrict__ dw,
                                  long long n, int slices) {
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; e < n;
       e += static_cast<long long>(gridDim.x) * blockDim.x) {
    float s = partial[e];
    for (int q = 1; q < slices; ++q) s += partial[q * n + e];
    dw[e] = s;
  }
}

// ---- dX: dZ = G W_k a field group at a time, contracted on chip ----
// gt: G as (h, rows). wx: W_k packed as (chunks, ceil(h/BK), BK, BN),
// wx[c][t][k][n] = W_k[t*BK + k][c*grp*m + n] for n < grp*m (0 past the edges),
// grp = BN / m whole fields a chunk.
__global__ void __launch_bounds__(THREADS, 2)
    grad_x_kernel(const float* __restrict__ gt, const float* __restrict__ wx,
                  const float* __restrict__ xk1t, const float* __restrict__ x0t,
                  float* __restrict__ dxk1t, float* __restrict__ dx0t, int hp, int m, int h,
                  int rows) {
  extern __shared__ __align__(16) float smem[];
  const int grp = BN / m, chunks = (hp + grp - 1) / grp;
  float* As = smem;
  float* Bs = smem + 2 * A_TILE;
  float* Cs = smem;                                  // [BN][CS], over the k-tiles' buffers
  float* X0s = smem + (OPERANDS > STAGED ? OPERANDS : STAGED);   // [m][BM]
  float* D0s = X0s + m * BM;                         // dX0 of the block's rows, [m][BM]
  float* Xs = D0s + m * BM;                          // the chunk's X^{k-1} rows, [grp][BM]
  const int t = threadIdx.x, tm = t % TMT, tn = t / TMT;
  const int r0 = blockIdx.x * BM;
  const int here = min(BM, rows - r0);
  const int KT = (h + BK - 1) / BK;
  const bool vec = (rows & 3) == 0;

  for (int e = t; e < m * BM; e += THREADS) {
    const int j = e / BM, r = e - j * BM;
    X0s[e] = r < here ? x0t[static_cast<long long>(j) * rows + r0 + r] : 0.f;
    D0s[e] = 0.f;
  }

  auto load = [&](const float* wt, int kt) {
    const int buf = kt & 1;
    copy_tile<BK, BM, AS>(As + buf * A_TILE, gt + static_cast<long long>(kt) * BK * rows + r0,
                          rows, h - kt * BK, here, vec, gt);
    copy_flat<B_TILE>(Bs + buf * B_TILE, wt + static_cast<long long>(kt) * B_TILE);
    cp_async_commit();
  };

  for (int ch = 0; ch < chunks; ++ch) {
    const float* wt = wx + static_cast<long long>(ch) * KT * B_TILE;
    const int i0 = ch * grp, groups = min(grp, hp - i0);
    float acc[8][8];
    zero(acc);

    __syncthreads();                                 // the last chunk's reads of Cs, Xs are done
    for (int e = t; e < groups * BM; e += THREADS) {   // this chunk's X^{k-1} rows, in the
      const int gi = e / BM, r = e - gi * BM;          // first k-tile's commit group
      const bool ok = r < here;
      cp_async4(Xs + e, ok ? xk1t + static_cast<long long>(i0 + gi) * rows + r0 + r : xk1t,
                ok ? 4 : 0);
    }
    load(wt, 0);
    cp_async_wait_all();
    __syncthreads();
    for (int kt = 0; kt < KT; ++kt) {
      const int cur = kt & 1;
      const bool next = kt + 1 < KT;
      if (next) load(wt, kt + 1);
      if (t < COMPUTE) mma_tile(As + cur * A_TILE, Bs + cur * B_TILE, tm, tn, acc);
      if (next) cp_async_wait_all();
      __syncthreads();
    }

    // stage dZ as Cs[column][row]
    if (t < COMPUTE) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float* c = Cs + tile_col(tn, j) * CS;
#pragma unroll
        for (int half = 0; half < 2; ++half)
          *reinterpret_cast<float4*>(c + tile_row(tm, 4 * half)) =
              make_float4(acc[4 * half][j], acc[4 * half + 1][j], acc[4 * half + 2][j],
                          acc[4 * half + 3][j]);
      }
    }
    __syncthreads();

    for (int e = t; e < groups * BM; e += THREADS) {   // dX^{k-1}[r, i0 + gi], finished
      const int gi = e / BM, r = e - gi * BM;
      if (r < here) {   // four sums of every fourth field, then theirs: shorter chains
        const float* c = Cs + gi * m * CS + r;
        float s[4] = {0.f, 0.f, 0.f, 0.f};
        int j = 0;
        for (; j + 4 <= m; j += 4)
#pragma unroll
          for (int u = 0; u < 4; ++u) s[u] = fmaf(X0s[(j + u) * BM + r], c[(j + u) * CS], s[u]);
        for (; j < m; ++j) s[j & 3] = fmaf(X0s[j * BM + r], c[j * CS], s[j & 3]);
        dxk1t[static_cast<long long>(i0 + gi) * rows + r0 + r] = (s[0] + s[1]) + (s[2] + s[3]);
      }
    }
    for (int e = t; e < m * BM; e += THREADS) {        // dX0[r, j], this chunk's fields added
      const int j = e / BM, r = e - j * BM;
      float s = D0s[e];
      for (int gi = 0; gi < groups; ++gi) s = fmaf(Xs[gi * BM + r], Cs[(gi * m + j) * CS + r], s);
      D0s[e] = s;
    }
  }
  __syncthreads();
  for (int e = t; e < m * BM; e += THREADS) {
    const int j = e / BM, r = e - j * BM;
    if (r < here) dx0t[static_cast<long long>(j) * rows + r0 + r] = D0s[e];
  }
}

constexpr int MAX_DEVICES = 64;

// Lets `kernel` take `bytes` of dynamic shared memory (its most, at any m) on the
// current device, once a device: the call is not stream-ordered, so a launch inside
// a graph's capture finds it made.
template <typename Kernel>
int prepare(Kernel kernel, int bytes, bool (&done)[MAX_DEVICES]) {
  int device = 0;
  int rc = static_cast<int>(cudaGetDevice(&device));
  if (rc || (device < MAX_DEVICES && done[device])) return rc;
  rc = static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
  if (!rc && device < MAX_DEVICES) done[device] = true;
  return rc;
}

int forward_bytes(int m) { return (OPERANDS + m * BM) * (int)sizeof(float); }

int grad_x_bytes(int m) {
  return ((OPERANDS > STAGED ? OPERANDS : STAGED) + (2 * m + BN / m) * BM) * (int)sizeof(float);
}

int most_grad_x_bytes() {
  int most = 0;
  for (int m = 1; m <= MAX_M; ++m) most = grad_x_bytes(m) > most ? grad_x_bytes(m) : most;
  return most;
}

constexpr int GRAD_W_BYTES = OPERANDS * (int)sizeof(float);
bool forward_ready[MAX_DEVICES], grad_w_ready[MAX_DEVICES], grad_x_ready[MAX_DEVICES];

bool bad_shape(int hp, int m, int h, int rows) {
  return m < 1 || m > MAX_M || hp < 1 || h < 1 || rows < 0 || (long long)hp * m > MAX_K ||
         (long long)(hp > m ? hp : m) * rows > 0x7fffffffLL;
}

}  // namespace

extern "C" {

// Geometry the wrapper packs W_k to and sizes its buffers by.
int cin_tile_rows() { return BM; }
int cin_tile_cols() { return BN; }
int cin_tile_depth() { return BK; }
int cin_max_fields() { return MAX_M; }

// X^kT (h, rows) from X^{k-1}T (hp, rows), X0T (m, rows) and W_k packed as
// forward_kernel says. Returns a cudaError_t, without synchronizing.
int cin_forward(const float* xk1t, const float* x0t, const float* wf, float* out, int hp, int m,
                int h, int rows, cudaStream_t stream) {
  if (bad_shape(hp, m, h, rows)) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  int rc = prepare(forward_kernel, forward_bytes(MAX_M), forward_ready);
  if (rc) return rc;
  dim3 grid((rows + BM - 1) / BM, (h + BN - 1) / BN);
  forward_kernel<<<grid, THREADS, forward_bytes(m), stream>>>(xk1t, x0t, wf, out, hp, m, h, rows);
  return (int)cudaGetLastError();
}

// dW_k (h, hp*m) from G (rows, h), X^{k-1}T and X0T: `slices` partials of
// slice_rows rows each (a multiple of the k-tile's depth) into partial
// (slices, h, hp*m), then their sum in slice order into dw; with one slice the
// first kernel writes dw itself.
int cin_grad_w(const float* xk1t, const float* x0t, const float* g, float* partial, float* dw,
               int hp, int m, int h, int rows, int slices, int slice_rows, cudaStream_t stream) {
  if (bad_shape(hp, m, h, rows) || slices < 1 || slice_rows < 1 || slice_rows % BK ||
      (long long)slices * slice_rows < rows)
    return (int)cudaErrorInvalidValue;
  const int K = hp * m;
  const long long n = (long long)h * K;
  if (rows == 0) return (int)cudaMemsetAsync(dw, 0, n * sizeof(float), stream);
  int rc = prepare(grad_w_kernel, GRAD_W_BYTES, grad_w_ready);
  if (rc) return rc;
  dim3 grid((K + BM - 1) / BM, (h + BN - 1) / BN, slices);
  grad_w_kernel<<<grid, THREADS, GRAD_W_BYTES, stream>>>(xk1t, x0t, g, slices == 1 ? dw : partial,
                                                         hp, m, h, rows, slice_rows);
  rc = (int)cudaGetLastError();
  if (rc || slices == 1) return rc;
  const long long need = (n + THREADS - 1) / THREADS;
  const int blocks = (int)(need < 4096 ? need : 4096);
  sum_slices_kernel<<<blocks, THREADS, 0, stream>>>(partial, dw, n, slices);
  return (int)cudaGetLastError();
}

// dX^{k-1}T (hp, rows) and dX0T (m, rows) from G^T (h, rows), W_k packed as
// grad_x_kernel says, X^{k-1}T and X0T.
int cin_grad_x(const float* gt, const float* wx, const float* xk1t, const float* x0t,
               float* dxk1t, float* dx0t, int hp, int m, int h, int rows, cudaStream_t stream) {
  if (bad_shape(hp, m, h, rows)) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  int rc = prepare(grad_x_kernel, most_grad_x_bytes(), grad_x_ready);
  if (rc) return rc;
  grad_x_kernel<<<(rows + BM - 1) / BM, THREADS, grad_x_bytes(m), stream>>>(
      gt, wx, xk1t, x0t, dxk1t, dx0t, hp, m, h, rows);
  return (int)cudaGetLastError();
}

}  // extern "C"
