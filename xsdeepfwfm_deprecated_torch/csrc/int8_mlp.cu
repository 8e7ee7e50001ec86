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
// Operands. Every width is zero-padded to one W (416 for the flagship): zeros
// change neither an abs-max nor a sum. A layer's weights are stored as W/16
// slabs, slab k16 holding bytes [16*k16, 16*k16 + 16) of the K axis for all W
// output channels: w[k16][n][16]. Inside a slab, 8 output channels are 128
// contiguous bytes, which is one wgmma "core matrix" of the no-swizzle K-major
// layout, so two slabs copied to shared memory as they are form the B operand
// of one m64nNk32 product (leading byte offset = one slab, stride byte offset =
// 128). No swizzle, because a row of K = 416 bytes is no multiple of 128 and
// the slab layout needs no such multiple; a core matrix is read as 128
// contiguous bytes, which is free of bank conflicts already.
//
// Two routes, chosen by the wrapper from the shapes alone:
//
// 1. The cluster kernel (`tower_kernel`, entry `int8_mlp_forward`): ONE launch
//    per tower call and no scratch in global memory. A thread block cluster of
//    block_b / 64 blocks (8 for block_b = 512) owns one scale tile; a block
//    owns 64 of its rows for all layers. Two consumer warpgroups and one
//    producer warp.
//    - Activations stay on chip. The block's 64 x W int8 codes live in shared
//      memory in the slab layout (the A operand; a slab is 64 x 16 bytes plus
//      16 of padding). A layer's f32 outputs stay in the registers that held
//      its int32 sums until the tile's scale is known, then are quantized into
//      the A tile in place. The 64 x in_dim f32 input is read once (warp w
//      rows w, w + 8, ..., 8 bytes a lane where in_dim is even) and waits in
//      registers for its scale.
//    - The tile abs-max is reduced on chip: registers, warp shuffles, shared
//      memory, then every block stores its maximum into every block's shared
//      memory with st.async (mapa addresses), which counts the bytes on the
//      receiver's mbarrier; a block goes on when its own 4 * cluster_size
//      bytes are in. No barrier across the cluster after the first. A maximum
//      does not depend on order, so the scale is bit-identical. There are
//      n_hidden + 1 such reductions and no block leaves before the last.
//    - Products are wgmma.mma_async m64nNk32.s32.s8.s8 with N = W / 2, both
//      operands from shared memory, K-major, no swizzle: each consumer
//      warpgroup holds 64 x W/2 int32 sums (W/4 registers a thread, 104 at
//      W = 416; N = 208 is a legal int8 shape).
//    - Weights arrive through a ring of shared-memory stages (12 at W = 416),
//      one stage a K chunk of 32 (two slabs, 32 * W bytes, contiguous in
//      global memory), filled by cp.async.bulk from one producer thread and
//      signalled by mbarriers (full: the bytes have landed; empty: all
//      consumer warps are done with them). The ring runs on across layers, so
//      the next layer's stages load during this layer's epilogue. Every
//      layer's scales and biases and the head's codes come the same way, once.
//    - Quantizing costs no division: v * (1 / s) decides unless it lies within
//      2^-14 of a half-integer, where the IEEE division decides out of line
//      (`quantize_group`); rounding half to even is one float addition.
//    - The head runs in the last epilogue: each thread quantizes its own
//      values, multiplies by the head's codes, and the int32 partial sums are
//      reduced over the quad by shuffles and over the two warpgroups through
//      shared memory.
//    - No multicast: every block fetches every stage itself (from L2 after the
//      first). Sharing a stage among the cluster's blocks with
//      cp.async.bulk .multicast::cluster was tried in two forms, was exact and
//      1.7 to 1.8 times slower, and went out again (PERF.md).
//    It takes W in {64, 128, 256, 416} (W/2 must be an int8 wgmma N, W/4 sums
//    a thread must fit the registers, and the A tile, the ring and 8 layers'
//    vectors must fit 227 KB of shared memory), block_b a multiple of 64 up to
//    512 (a portable cluster has at most 8 blocks), at most 8 hidden layers.
// 2. The layered route (entry `int8_mlp_forward_layered`) for every other
//    shape: each layer a launch of its own, the tile abs-max passed between
//    launches through global memory with atomicMax, mma.sync m16n8k32
//    products; 2 + 2 * n_hidden kernels and a memset per tower call, and
//    scratch for the codes, the f32 activations and the abs-max.
//
// Both round with `__float2int_rn` of an IEEE division (or what provably
// equals it), and the epilogue uses `__fmul_rn` / `__fadd_rn` so that no FMA
// contraction moves a value across a .5 quantization boundary of the next
// layer. On the card both equal the plain PyTorch version exactly.
//
// Measured by chip_smoke.py in one call on an NVIDIA H100 80GB HBM3 at 700.00 W,
// B = 8192, device time by CUDA-graph replay: cluster kernel 0.0564 ms, layered
// route 0.1131 ms. The card holds 15 clusters of 8 blocks at once, so the 16
// tiles of B = 8192 take two waves; the 15 tiles of B = 7680 take 0.0320 ms
// (layered route 0.1112 ms). tower_kernel<416>: 162 registers, no spills,
// 213,920 + 896 bytes of shared memory. Where the time goes: PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;           // rows of one block (a block_b tile holds whole blocks)
constexpr int ABSMAX_ROWS = 8;   // rows per absmax block: 1,024 blocks at B = 8192
constexpr int BN = 32;           // gemm block columns (layered route)
constexpr int GEMM_THREADS = 128;
constexpr int ROW_PAD = 16;      // bytes added to each shared-memory row: no bank conflicts
constexpr int THREADS = 256;

__device__ __forceinline__ float tile_scale(float amax) {
  return __fdiv_rn(fmaxf(amax, 1e-12f), 127.0f);
}

__device__ __forceinline__ int quantize(float v, float s) {
  const int q = __float2int_rn(__fdiv_rn(v, s));
  return min(max(q, -127), 127);
}

// Four codes by the IEEE division, one signed byte each. Out of line: it runs
// for 1 group in 50 and must not sit in the unrolled loops' instruction stream.
__device__ __noinline__ uint32_t quantize4_exact(float v0, float v1, float v2, float v3, float s) {
  return (uint32_t)(quantize(v0, s) & 0xff) | ((uint32_t)(quantize(v1, s) & 0xff) << 8) |
         ((uint32_t)(quantize(v2, s) & 0xff) << 16) | ((uint32_t)(quantize(v3, s) & 0xff) << 24);
}

// q[i] = quantize(v[i], s) for N values without the IEEE division, given
// r = 1 / s rounded to nearest. v * r is within 2^-16 of v / s (|v / s| < 128,
// two roundings of 2^-24 each) and the rounded quotient within 2^-18, so unless
// v * r lies within 2^-14 of a half-integer both round to the same integer; in
// that rare case (1 value in 8,000) the divisions decide for all N. Rounding
// half to even is the float addition of 1.5 * 2^23, whose sum has the integer
// in its low mantissa bits: no conversion instruction, and no branch between
// the N independent chains. Needs |v| <= the abs-max that s came from.
template <int N>
__device__ __forceinline__ void quantize_group(const float (&v)[N], float s, float r,
                                               int (&q)[N]) {
  constexpr float MAGIC = 12582912.0f;   // 1.5 * 2^23
  bool near_half = false;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float y = __fmul_rn(v[i], r);
    const float t = __fadd_rn(y, MAGIC);
    near_half |= fabsf(__fsub_rn(y, __fsub_rn(t, MAGIC))) > 0.5f - 6.103515625e-5f;
    q[i] = __float_as_int(t) - 0x4B400000;   // |v| <= amax, so |v * r| < 127.5: no clamp
  }
  if (near_half) {
#pragma unroll
    for (int k = 0; k < N; k += 4) {
      const uint32_t packed = quantize4_exact(v[k], v[k + 1], v[k + 2], v[k + 3], s);
#pragma unroll
      for (int i = 0; i < 4; ++i) q[k + i] = (int)(int8_t)(packed >> (8 * i));
    }
  }
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float epilogue(int acc, float s, float w_scale, float bias) {
  return fmaxf(__fadd_rn(__fmul_rn(__fmul_rn((float)acc, s), w_scale), bias), 0.0f);
}

// ============================================================ the cluster kernel

constexpr int MAX_LAYERS = 8;
constexpr int MAX_CLUSTER = 8;                 // the portable cluster size
constexpr int CONSUMER_WARPS = 8;              // two warpgroups
constexpr int CONSUMERS = CONSUMER_WARPS * 32;
constexpr int CL_THREADS = CONSUMERS + 32;     // and one producer warp
constexpr int A_SLAB = BM * 16 + 16;           // bytes of one A slab; +16 spreads the input's stores over the banks
constexpr int RING_BYTES = 160 * 1024;

struct TowerParams {
  const float* x;
  float* out;
  const int8_t* w[MAX_LAYERS];
  const float* w_scale[MAX_LAYERS];
  const float* bias[MAX_LAYERS];
  const int8_t* fc;
  const float* fc_scale;
  int in_dim, n_hidden;
  long long* prof;   // where block 0 writes its clock at each step, or null
};

template <int W>
struct Shape {
  static constexpr int NH = W / 2;        // output columns of one consumer warpgroup
  static constexpr int NACC = W / 4;      // int32 sums a thread holds
  static constexpr int KCH = W / 32;      // K chunks = ring stages per layer
  static constexpr int STAGE = 32 * W;    // bytes of one stage: two slabs
  static constexpr int A_BYTES = ((W / 16) * A_SLAB + 127) / 128 * 128;
  static constexpr int NSTAGES = 2 * KCH < RING_BYTES / STAGE ? 2 * KCH : RING_BYTES / STAGE;
  static constexpr int RING = NSTAGES * STAGE;
  static constexpr int VECS = MAX_LAYERS * 2 * W * 4 + W;   // every layer's w_scale and bias, and fc
  static constexpr int SMEM = A_BYTES + RING + VECS;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return r;
}
// Every thread of every block of the cluster arrives and waits once per phase.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}
// The address of this block's shared-memory location `addr` in block `rank` of the cluster.
__device__ __forceinline__ uint32_t map_to_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
// Stores v at `addr` of a peer's shared memory and counts 4 bytes on that peer's barrier `bar`
// (both addresses from map_to_rank): whoever sees the barrier's phase end sees the value.
__device__ __forceinline__ void st_async_f32(uint32_t addr, float v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, [%2];" ::"r"(
                   addr),
               "f"(v), "r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}
// Returns once the barrier has left the phase of the given parity.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
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
__device__ __forceinline__ void consumer_bar() {
  asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS) : "memory");
}

// A K-major, no-swizzle wgmma operand: `lbo` bytes between the two 16-byte K
// halves of a core-matrix pair, `sbo` bytes between groups of 8 rows.
__device__ __forceinline__ uint64_t operand_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// d (64 x N int32, N/2 registers a thread) = or += a (64 x 32 int8) . b (N x 32 int8)^T
template <int N>
struct Wgmma;
template <> struct Wgmma<32> {
  static __device__ __forceinline__ void mma(int (&d)[16], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        " %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};
template <> struct Wgmma<64> {
  static __device__ __forceinline__ void mma(int (&d)[32], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        " %8, %9, %10, %11, %12, %13, %14, %15, "
        " %16, %17, %18, %19, %20, %21, %22, %23, "
        " %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
          "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};
template <> struct Wgmma<128> {
  static __device__ __forceinline__ void mma(int (&d)[64], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        " %8, %9, %10, %11, %12, %13, %14, %15, "
        " %16, %17, %18, %19, %20, %21, %22, %23, "
        " %24, %25, %26, %27, %28, %29, %30, %31, "
        " %32, %33, %34, %35, %36, %37, %38, %39, "
        " %40, %41, %42, %43, %44, %45, %46, %47, "
        " %48, %49, %50, %51, %52, %53, %54, %55, "
        " %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
          "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
          "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
          "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};
template <> struct Wgmma<208> {
  static __device__ __forceinline__ void mma(int (&d)[104], uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %106, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n208k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        " %8, %9, %10, %11, %12, %13, %14, %15, "
        " %16, %17, %18, %19, %20, %21, %22, %23, "
        " %24, %25, %26, %27, %28, %29, %30, %31, "
        " %32, %33, %34, %35, %36, %37, %38, %39, "
        " %40, %41, %42, %43, %44, %45, %46, %47, "
        " %48, %49, %50, %51, %52, %53, %54, %55, "
        " %56, %57, %58, %59, %60, %61, %62, %63, "
        " %64, %65, %66, %67, %68, %69, %70, %71, "
        " %72, %73, %74, %75, %76, %77, %78, %79, "
        " %80, %81, %82, %83, %84, %85, %86, %87, "
        " %88, %89, %90, %91, %92, %93, %94, %95, "
        " %96, %97, %98, %99, %100, %101, %102, %103}, "
        "%104, %105, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
          "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
          "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
          "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
          "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
          "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
          "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
          "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
          "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
          "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
          "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
          "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
          "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
          "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]),
          "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
          "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]),
          "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
          "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
          "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
          "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]),
          "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
          "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
          "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

// The tile's abs-max from this thread's share `m`, for consumer threads; r is
// the reduction's index. Per parity of r: `red` one float per consumer warp,
// `cl_max` one float per block of the cluster, `bar` a barrier that counts
// the bytes peers store into cl_max. Every block stores its maximum into
// every block's cl_max and waits until its own is full: no barrier across
// the cluster, and the values of reduction r + 2 cannot arrive before this
// block has sent r + 1, that is after it has read r.
__device__ __forceinline__ float tile_absmax(float m, int r, float (*red)[CONSUMER_WARPS],
                                             float (*cl_max)[MAX_CLUSTER], uint64_t* bar,
                                             uint32_t rank, uint32_t csize) {
  const int tid = threadIdx.x, par = r & 1;
  m = warp_max(m);
  if ((tid & 31) == 0) red[par][tid >> 5] = m;
  consumer_bar();
  if (tid < (int)csize) {
    float b = red[par][0];
#pragma unroll
    for (int i = 1; i < CONSUMER_WARPS; ++i) b = fmaxf(b, red[par][i]);
    st_async_f32(map_to_rank(smem_u32(&cl_max[par][rank]), (uint32_t)tid), b,
                 map_to_rank(smem_u32(&bar[par]), (uint32_t)tid));
  }
  if (tid == 0) mbar_expect_tx(smem_u32(&bar[par]), 4 * csize);
  mbar_wait(smem_u32(&bar[par]), (r >> 1) & 1);
  float a = cl_max[par][0];
  for (uint32_t i = 1; i < csize; ++i) a = fmaxf(a, cl_max[par][i]);
  return a;
}

// Block 0's first thread notes the SM clock at step i (PROF_STEPS in the wrapper names them).
__device__ __forceinline__ void stamp(long long* prof, int i) {
  if (prof != nullptr && blockIdx.x == 0 && threadIdx.x == 0) prof[i] = clock64();
}

// The block's 64 x in_dim f32 input -> int8 codes in the A tile `sA`; returns
// the tile's scale. Warp w reads rows w, w + 8, ..., lane l the V columns
// V l + 32 V i of each: V = 2 (8-byte loads) where in_dim is even, else 1.
// The values wait in registers for the scale, then go to
// sA[(col / 16) * A_SLAB + row * 16 + col % 16], which is a constant offset
// from a per-thread base; the columns from in_dim to W get code 0.
template <int W, int V>
__device__ __forceinline__ float input_codes(const TowerParams& p, uint8_t* sA,
                                             float (*red)[CONSUMER_WARPS],
                                             float (*cl_max)[MAX_CLUSTER], uint64_t* red_bar,
                                             uint32_t rank, uint32_t csize) {
  constexpr int ITERS = (W + 32 * V - 1) / (32 * V), ROWS = BM / CONSUMER_WARPS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* xb = p.x + (size_t)blockIdx.x * BM * p.in_dim;
  float v[ITERS][ROWS * V];
  float m = 0.0f;
#pragma unroll
  for (int i = 0; i < ITERS; ++i) {
    const int col = V * lane + 32 * V * i;
#pragma unroll
    for (int rr = 0; rr < ROWS; ++rr) {
      const float* src = xb + (size_t)(warp + CONSUMER_WARPS * rr) * p.in_dim + col;
      if (V == 2) {
        const float2 t = col < p.in_dim ? *reinterpret_cast<const float2*>(src)
                                        : make_float2(0.0f, 0.0f);
        v[i][2 * rr] = t.x;
        v[i][2 * rr + 1] = t.y;
        m = fmaxf(m, fmaxf(fabsf(t.x), fabsf(t.y)));
      } else {
        v[i][rr] = col < p.in_dim ? *src : 0.0f;
        m = fmaxf(m, fabsf(v[i][rr]));
      }
    }
  }
  stamp(p.prof, 2);
  cluster_wait();
  stamp(p.prof, 3);
  const float s = tile_scale(tile_absmax(m, 0, red, cl_max, red_bar, rank, csize));
  stamp(p.prof, 4);
  const float r = __frcp_rn(s);
  uint8_t* base = sA + ((V * lane) >> 4) * A_SLAB + ((V * lane) & 15) + warp * 16;
#pragma unroll
  for (int i = 0; i < ITERS; ++i) {
    if (V * lane + 32 * V * i < W) {
#pragma unroll
      for (int k = 0; k < ROWS * V; k += 8) {
        const float v8[8] = {v[i][k],     v[i][k + 1], v[i][k + 2], v[i][k + 3],
                             v[i][k + 4], v[i][k + 5], v[i][k + 6], v[i][k + 7]};
        int q[8];
        quantize_group(v8, s, r, q);
        uint8_t* dst = base + 2 * V * i * A_SLAB + (k / V) * CONSUMER_WARPS * 16;
#pragma unroll
        for (int c = 0; c < 8; c += V) {   // one row's V codes a store
          if (V == 2)
            *reinterpret_cast<uint16_t*>(dst + (c / 2) * CONSUMER_WARPS * 16) =
                (uint16_t)((q[c] & 0xff) | ((q[c + 1] & 0xff) << 8));
          else
            dst[c * CONSUMER_WARPS * 16] = (uint8_t)q[c];
        }
      }
    }
  }
  return s;
}

template <int W>
__global__ void __launch_bounds__(CL_THREADS, 1) tower_kernel(const TowerParams p) {
  using S = Shape<W>;
  extern __shared__ __align__(128) uint8_t tower_smem[];
  __shared__ __align__(8) uint64_t full_bar[S::NSTAGES];
  __shared__ __align__(8) uint64_t empty_bar[S::NSTAGES];
  __shared__ __align__(8) uint64_t red_bar[2];
  __shared__ __align__(8) uint64_t vecs_bar;
  __shared__ float red[2][CONSUMER_WARPS];
  __shared__ float cl_max[2][MAX_CLUSTER];
  __shared__ int head_part[2][BM];
  uint8_t* sA = tower_smem;
  uint8_t* ring = tower_smem + S::A_BYTES;
  const float* s_vecs = reinterpret_cast<const float*>(ring + S::RING);   // [layer][w_scale, bias][W]
  const int8_t* s_fc = reinterpret_cast<const int8_t*>(s_vecs + MAX_LAYERS * 2 * W);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const uint32_t rank = cluster_rank(), csize = cluster_size();

  if (tid == 0) {
    for (int s = 0; s < S::NSTAGES; ++s) {
      mbar_init(smem_u32(&full_bar[s]), 1);
      mbar_init(smem_u32(&empty_bar[s]), CONSUMER_WARPS);
    }
    mbar_init(smem_u32(&red_bar[0]), 1);
    mbar_init(smem_u32(&red_bar[1]), 1);
    mbar_init(smem_u32(&vecs_bar), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  stamp(p.prof, 0);
  __syncthreads();
  stamp(p.prof, 1);
  // the cluster barrier: every block's barriers and shared memory exist before a peer
  // writes to them
  cluster_arrive();

  if (warp == CONSUMER_WARPS) {
    // ---- producer: one thread keeps the ring full, across the layers
    cluster_wait();
    if (lane == 0) {
      // the scales, biases and head codes of all layers, once
      const uint32_t vbar = smem_u32(&vecs_bar), vdst = smem_u32(s_vecs);
      mbar_expect_tx(vbar, p.n_hidden * 2 * W * 4 + W);
      for (int l = 0; l < p.n_hidden; ++l) {
        bulk_copy(vdst + (2 * l) * W * 4, p.w_scale[l], W * 4, vbar);
        bulk_copy(vdst + (2 * l + 1) * W * 4, p.bias[l], W * 4, vbar);
      }
      bulk_copy(smem_u32(s_fc), p.fc, W, vbar);
      int it = 0;
      for (int l = 0; l < p.n_hidden; ++l) {
        for (int kc = 0; kc < S::KCH; ++kc, ++it) {
          const int s = it % S::NSTAGES, use = it / S::NSTAGES;
          const uint32_t full = smem_u32(&full_bar[s]), empty = smem_u32(&empty_bar[s]);
          const int8_t* src = p.w[l] + (size_t)kc * S::STAGE;
          const uint32_t dst = smem_u32(ring + s * S::STAGE);
          if (use > 0) mbar_wait(empty, (use - 1) & 1);
          mbar_expect_tx(full, S::STAGE);
          bulk_copy(dst, src, S::STAGE, full);
        }
      }
    }
    __syncwarp();
  } else {
    // ---- consumers: two warpgroups, each W/2 output columns of the block's 64 rows
    const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, t = lane & 3;
    const int n0 = wg * S::NH;
    int acc[S::NACC];   // each layer's int32 sums, then its f32 outputs

    float s = (p.in_dim & 1) == 0
                  ? input_codes<W, 2>(p, sA, red, cl_max, red_bar, rank, csize)
                  : input_codes<W, 1>(p, sA, red, cl_max, red_bar, rank, csize);
    float r = __frcp_rn(s);
    fence_proxy_async();   // the codes were written by plain stores; wgmma reads through the async proxy
    consumer_bar();
    stamp(p.prof, 5);

    mbar_wait(smem_u32(&vecs_bar), 0);
    const uint32_t a_base = smem_u32(sA), ring_base = smem_u32(ring);
    int it = 0;
    for (int l = 0; l < p.n_hidden; ++l) {
      // a finished product frees its stage: one arrival a warp
      auto release = [&](int stage) {
        if (lane == 0) mbar_arrive(smem_u32(&empty_bar[stage]));
        __syncwarp();
      };
      // one fence a layer: the epilogue touched the accumulators; between products that add
      // into the same registers none is needed
      wgmma_fence();
      for (int kc = 0; kc < S::KCH; ++kc, ++it) {
        const int st = it % S::NSTAGES, use = it / S::NSTAGES;
        mbar_wait(smem_u32(&full_bar[st]), use & 1);
        if (kc == 0) stamp(p.prof, 6 + 5 * l);
        const uint64_t da = operand_desc(a_base + kc * 2 * A_SLAB, A_SLAB, 128);
        const uint64_t db = operand_desc(ring_base + st * S::STAGE + n0 * 16, W * 16, 128);
        Wgmma<S::NH>::mma(acc, da, db, kc > 0);
        wgmma_commit();
        if (kc > 0) {
          // one product stays in flight. Three were slower: a stage comes back later and the
          // ring runs dry.
          wgmma_wait<1>();
          release((it - 1) % S::NSTAGES);
        }
      }
      wgmma_wait<0>();
      release((it - 1) % S::NSTAGES);
      stamp(p.prof, 7 + 5 * l);

      // epilogue: thread (g, t) of warp wl holds rows 16 wl + g and + 8,
      // columns n0 + 8 j + 2 t and + 1, as acc[4 j + 0..1] and acc[4 j + 2..3]
      const float* ws = s_vecs + (2 * l) * W + n0 + 2 * t;
      const float* bs = ws + W;
      float m = 0.0f;
#pragma unroll
      for (int j = 0; j < S::NH / 8; ++j) {
        const float2 w2 = *reinterpret_cast<const float2*>(ws + 8 * j);
        const float2 b2 = *reinterpret_cast<const float2*>(bs + 8 * j);
        const float v0 = epilogue(acc[4 * j + 0], s, w2.x, b2.x);
        const float v1 = epilogue(acc[4 * j + 1], s, w2.y, b2.y);
        const float v2 = epilogue(acc[4 * j + 2], s, w2.x, b2.x);
        const float v3 = epilogue(acc[4 * j + 3], s, w2.y, b2.y);
        m = fmaxf(m, fmaxf(fmaxf(v0, v1), fmaxf(v2, v3)));
        acc[4 * j + 0] = __float_as_int(v0);
        acc[4 * j + 1] = __float_as_int(v1);
        acc[4 * j + 2] = __float_as_int(v2);
        acc[4 * j + 3] = __float_as_int(v3);
      }
      // both warpgroups are past their last product of this layer after the
      // barrier inside, so the A tile may be overwritten
      stamp(p.prof, 8 + 5 * l);
      s = tile_scale(tile_absmax(m, l + 1, red, cl_max, red_bar, rank, csize));
      stamp(p.prof, 9 + 5 * l);
      r = __frcp_rn(s);
      const int row = 16 * wl + g;
      if (l + 1 < p.n_hidden) {
#pragma unroll
        for (int j = 0; j < S::NH / 8; j += 2) {   // columns n0 + 8 j ...: one slab, both halves
          uint8_t* dst = sA + ((n0 + 8 * j) >> 4) * A_SLAB + row * 16 + 2 * t;
          float v[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) v[i] = __int_as_float(acc[4 * j + i]);
          int q[8];
          quantize_group(v, s, r, q);
#pragma unroll
          for (int h = 0; h < 2; ++h) {   // columns + 8 h; rows `row` and `row + 8`
            *reinterpret_cast<uint16_t*>(dst + 8 * h) =
                (uint16_t)((q[4 * h + 0] & 0xff) | ((q[4 * h + 1] & 0xff) << 8));
            *reinterpret_cast<uint16_t*>(dst + 8 * h + 8 * 16) =
                (uint16_t)((q[4 * h + 2] & 0xff) | ((q[4 * h + 3] & 0xff) << 8));
          }
        }
        fence_proxy_async();
        consumer_bar();
        stamp(p.prof, 10 + 5 * l);
      } else {
        // the head: out[r] = ((float)(codes[r] . fc) * s) * fc_scale
        int h0 = 0, h1 = 0;
#pragma unroll
        for (int j = 0; j < S::NH / 8; j += 2) {
          float v[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) v[i] = __int_as_float(acc[4 * j + i]);
          int q[8];
          quantize_group(v, s, r, q);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const char2 f = *reinterpret_cast<const char2*>(s_fc + n0 + 8 * (j + h) + 2 * t);
            h0 += q[4 * h + 0] * (int)f.x + q[4 * h + 1] * (int)f.y;
            h1 += q[4 * h + 2] * (int)f.x + q[4 * h + 3] * (int)f.y;
          }
        }
        h0 += __shfl_xor_sync(0xffffffffu, h0, 1);
        h0 += __shfl_xor_sync(0xffffffffu, h0, 2);
        h1 += __shfl_xor_sync(0xffffffffu, h1, 1);
        h1 += __shfl_xor_sync(0xffffffffu, h1, 2);
        if (t == 0) {
          head_part[wg][row] = h0;
          head_part[wg][row + 8] = h1;
        }
        consumer_bar();
        if (tid < BM)
          p.out[(size_t)blockIdx.x * BM + tid] = __fmul_rn(
              __fmul_rn((float)(head_part[0][tid] + head_part[1][tid]), s), p.fc_scale[0]);
        stamp(p.prof, 10 + 5 * l);
      }
    }
  }
}

template <int W>
cudaError_t configure(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int rows, int block_b,
                      cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      tower_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize, Shape<W>::SMEM);
  if (err != cudaSuccess) return err;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = block_b / BM;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(rows / BM);
  cfg->blockDim = dim3(CL_THREADS);
  cfg->dynamicSmemBytes = Shape<W>::SMEM;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

template <int W>
cudaError_t launch_tower(const TowerParams& p, int rows, int block_b, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure<W>(&cfg, &attr, rows, block_b, stream);
  if (err != cudaSuccess) return err;
  return cudaLaunchKernelEx(&cfg, tower_kernel<W>, p);
}

template <int W>
cudaError_t max_active_clusters(int block_b, int* n) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure<W>(&cfg, &attr, block_b, block_b, nullptr);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(n, tower_kernel<W>, &cfg);
}

// ============================================================ the layered route

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
// Non-negative floats order like their bit patterns, so atomicMax on the bits.
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
  const float s = tile_scale(__uint_as_float(amax[r / block_b]));
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

// y (rows, W) f32 = relu(((float)(q @ w^T) * s) * w_scale + bias) for one
// BM x BN tile, q (rows, W) int8 row-major and w in slabs [W/16][W][16]; then
// amax_out[tile] = max(amax_out[tile], max |y| over the block).
// Four warps in a 2 x 2 grid, each 32 x 16 outputs: 2 x 2 mma tiles of 16 x 8.
// The block keeps its whole K panel (64 and 32 rows of W bytes) in shared memory.
__global__ void __launch_bounds__(GEMM_THREADS)
gemm_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ w,
            const float* __restrict__ w_scale, const float* __restrict__ bias,
            int W, int block_b, const unsigned* __restrict__ amax_in,
            unsigned* __restrict__ amax_out, float* __restrict__ y) {
  extern __shared__ int4 gemm_smem[];
  const int ld = W + ROW_PAD;
  int8_t* sa = reinterpret_cast<int8_t*>(gemm_smem);
  int8_t* sb = sa + BM * ld;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  const int vecs = W / 16;
  for (int i = threadIdx.x; i < BM * vecs; i += GEMM_THREADS) {
    const int r = i / vecs, v = i % vecs;
    *reinterpret_cast<int4*>(sa + r * ld + v * 16) =
        *reinterpret_cast<const int4*>(q + (size_t)(m0 + r) * W + v * 16);
  }
  for (int i = threadIdx.x; i < BN * vecs; i += GEMM_THREADS) {
    const int v = i / BN, r = i % BN;   // BN channels of one slab are contiguous
    *reinterpret_cast<int4*>(sb + r * ld + v * 16) =
        *reinterpret_cast<const int4*>(w + ((size_t)v * W + n0 + r) * 16);
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

  const float s = tile_scale(__uint_as_float(amax_in[m0 / block_b]));
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
  const float s = tile_scale(__uint_as_float(amax[row / block_b]));
  const float* yr = y + (size_t)row * W;
  int acc = 0;
  for (int k = lane; k < W; k += 32) acc += quantize(yr[k], s) * (int)fc[k];
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) out[row] = __fmul_rn(__fmul_rn((float)acc, s), fc_scale[0]);
}

}  // namespace

// Operands of both entries. x (rows, in_dim) f32; layer l has w[l]
// (W/16, W, 16) int8 in slabs, w_scale[l] and bias[l] (W,) f32, all
// zero-padded; fc (W,) int8 and fc_scale (1,) f32; out (rows,) f32. Both need
// rows % block_b == 0, block_b % 64 == 0, in_dim <= W, n_hidden >= 1, and
// return a cudaError_t (0 on success) without synchronizing.

// The cluster kernel: one launch on `stream`, no scratch. W in {64, 128, 256,
// 416}, block_b <= 512, n_hidden <= 8; anything else returns
// cudaErrorInvalidValue. `prof`, if not null, gets 6 + 5 * n_hidden SM clock
// readings of block 0.
extern "C" int int8_mlp_forward(const float* x, int rows, int in_dim, int W, int n_hidden,
                                int block_b, const void* const* w, const void* const* w_scale,
                                const void* const* bias, const int8_t* fc, const float* fc_scale,
                                float* out, long long* prof,
                                cudaStream_t stream) {
  if (n_hidden < 1 || n_hidden > MAX_LAYERS || block_b % BM || block_b > BM * MAX_CLUSTER ||
      rows % block_b || in_dim > W)
    return (int)cudaErrorInvalidValue;
  TowerParams p;
  p.x = x;
  p.out = out;
  for (int l = 0; l < n_hidden; ++l) {
    p.w[l] = static_cast<const int8_t*>(w[l]);
    p.w_scale[l] = static_cast<const float*>(w_scale[l]);
    p.bias[l] = static_cast<const float*>(bias[l]);
  }
  p.fc = fc;
  p.fc_scale = fc_scale;
  p.in_dim = in_dim;
  p.n_hidden = n_hidden;
  p.prof = prof;
  switch (W) {
    case 64: return (int)launch_tower<64>(p, rows, block_b, stream);
    case 128: return (int)launch_tower<128>(p, rows, block_b, stream);
    case 256: return (int)launch_tower<256>(p, rows, block_b, stream);
    case 416: return (int)launch_tower<416>(p, rows, block_b, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// *n_clusters = how many clusters of block_b / 64 blocks of the cluster kernel
// the device holds at once, and *smem_bytes its dynamic shared memory a block.
extern "C" int int8_mlp_max_active_clusters(int W, int block_b, int* n_clusters, int* smem_bytes) {
  switch (W) {
    case 64: *smem_bytes = Shape<64>::SMEM; return (int)max_active_clusters<64>(block_b, n_clusters);
    case 128: *smem_bytes = Shape<128>::SMEM; return (int)max_active_clusters<128>(block_b, n_clusters);
    case 256: *smem_bytes = Shape<256>::SMEM; return (int)max_active_clusters<256>(block_b, n_clusters);
    case 416: *smem_bytes = Shape<416>::SMEM; return (int)max_active_clusters<416>(block_b, n_clusters);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The layered route on `stream`: 2 + 2 * n_hidden kernels and a memset, any W
// that is a multiple of 32. Scratch: q (rows, W) int8, y (rows, W) f32,
// amax ((n_hidden + 1) * rows / block_b) 32-bit.
extern "C" int int8_mlp_forward_layered(const float* x, int rows, int in_dim, int W, int n_hidden,
                                        int block_b, const void* const* w,
                                        const void* const* w_scale, const void* const* bias,
                                        const int8_t* fc, const float* fc_scale, int8_t* q,
                                        float* y, unsigned* amax, float* out,
                                        cudaStream_t stream) {
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
        q, static_cast<const int8_t*>(w[l]), static_cast<const float*>(w_scale[l]),
        static_cast<const float*>(bias[l]), W, block_b, amax_in,
        amax + (size_t)(l + 1) * n_tiles, y);
  }
  head_kernel<<<(rows + THREADS / 32 - 1) / (THREADS / 32), THREADS, 0, stream>>>(
      y, fc, fc_scale, W, block_b, amax + (size_t)n_hidden * n_tiles, out, rows);
  return (int)cudaGetLastError();
}
