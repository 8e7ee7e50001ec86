// One fused Adam pass with L2 over every leaf of a parameter tree, for Hopper
// (sm_90a), bound through a plain C entry.
//
// Replaces no TPU kernel. The JAX package's optimizer is optax under XLA, which
// fuses the update by itself; the port's update ran as about 13 `_foreach`
// passes (train/trainer.Optimizer.update), each reading and writing whole
// leaves, about 136 B a value, and took 68.6% of a training step on an H100 at
// the Avazu model and 49.6% at the Criteo flagship. This kernel was added for that.
//
// Per value, in the order and with the roundings of the `_foreach` path
// (ops/cuda/fused_adam.adam_reference), each scalar the float32 that PyTorch
// makes of its Python number:
//   g  = grad + wd * p                     (wd != 0 only; else g = grad)
//   mu = b1 * mu + (1 - b1) * g            then 0 where |mu| < FLT_MIN, table leaves only
//   nu = b2 * nu + (1 - b2) * (g * g)
//   p  = p - lr * ((mu / bc1) / (sqrt(nu / bc2) + eps))
// with bc1 = 1 - b1^count and bc2 = 1 - b2^count read from the device, so that
// a CUDA graph replays them. `x + alpha * y` is one fused multiply-add, as
// PyTorch's `_foreach_add(x, y, alpha=alpha)` computes it on the card; every
// other operation rounds on its own (`__fmul_rn`, `__fdiv_rn`, `__fsqrt_rn`,
// `__fadd_rn`), never contracted, and the file is built without fast math and
// keeps subnormals, so the results equal the `_foreach` path's bit for bit.
//
// A leaf is stored in float32 or in bfloat16 (`-table_dtype bf16`: the tables,
// their gradients and their moments). PyTorch computes a bfloat16 operation
// in float32 and rounds its result to bfloat16 to the nearest even, and each
// `_foreach` pass stores its result: so a bfloat16 leaf rounds after every
// operation above (b1 * mu and g * g too), and divides by bc1 and bc2 rounded
// to bfloat16 (the division of a bfloat16 tensor by a float32 0-d tensor casts
// the divisor to the tensor's type). A float32 leaf's rounding is the identity.
//
// What bounds it on an H100: it reads p, grad, mu and nu (16 B) and writes p,
// mu and nu (12 B), 28 B a value, and does 17 flops a value, so it is
// memory-bound:
//   Avazu (31,209,993 values):  873,879,804 B / 3.35 TB/s = 0.261 ms
//   Criteo (13,740,101 values): 384,722,828 B / 3.35 TB/s = 0.115 ms
//
// Design. One launch a step for the whole leaf list (a list longer than
// MAX_LEAVES takes one launch for each MAX_LEAVES leaves). The leaves'
// pointers and element counts, the flush, storage and alignment flags and a
// prefix table of their blocks travel by value in the kernel's parameter
// block (`__grid_constant__`), so a CUDA graph captures them with nothing on
// the device to keep alive. A block owns one chunk of CHUNK values of one
// leaf, finds the leaf by walking the prefix table, and branches once on its
// storage type. A launch whose leaves are all float32 runs an instance of the
// kernel without the bfloat16 path: with both paths the compiler spilled
// registers, and the float32 step read 3% slower on an H100. A full chunk of a leaf whose four arrays are 16-byte aligned
// is read 16 B at a time (4 float32 or 8 bfloat16 values): each thread issues
// all of its loads (256 B in float32) before the first value is computed, so
// that many bytes are in flight for the memory system. A leaf's last,
// partial chunk (and every chunk of a leaf that is not aligned) runs one
// value a thread. The data is touched once, so loads and stores
// carry the streaming hint (`ld.global.cs`, `st.global.cs`): it is not kept
// in L2 against the next step's gathers.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700.00 W, device time of a CUDA
// graph of 20 calls (chip_smoke.py phase 24 times the same): 0.1363 ms at
// Criteo's leaves and 0.3108 ms at Avazu's, 84% of the bound (2.82 TB/s),
// where the `_foreach` passes take 0.7206 and 1.5779 ms; with bfloat16 tables
// 0.0774 and 0.1704 ms (the `_foreach` passes 0.6254 and 1.1441).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK = 4096;                     // values a block
constexpr int MAX_LEAVES = 32;                  // leaves the parameter block holds

struct Leaf {
  void* p;
  const void* g;
  void* mu;
  void* nu;
  long long n;
};

struct Params {
  Leaf leaf[MAX_LEAVES];
  int first_block[MAX_LEAVES + 1];   // leaf l owns blocks [first_block[l], first_block[l + 1])
  unsigned flush;                    // bit l: flush leaf l's subnormal first moments
  unsigned vec;                      // bit l: leaf l's four arrays are 16-byte aligned
  unsigned bf16;                     // bit l: leaf l is stored in bfloat16, else float32
  int n_leaves;
  const float* bc1;
  const float* bc2;
  float b1, a1, b2, a2, eps, neg_lr, wd;   // a1 = 1 - b1, a2 = 1 - b2, neg_lr = -lr
  int use_wd;
};

// A storage type: how 16 B unpack to N float32 values and pack back, how one
// value loads and stores, and `round`, the rounding of a stored result.
struct F32 {
  static constexpr int N = 4;
  __device__ static float round(float x) { return x; }
  __device__ static void unpack(const uint4& u, float (&f)[N]) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 pack(const float (&f)[N]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
  __device__ static float load(const void* base, long long i) {
    return __ldcs(static_cast<const float*>(base) + i);
  }
  __device__ static void store(void* base, long long i, float x) {
    __stcs(static_cast<float*>(base) + i, x);
  }
};

struct BF16 {
  static constexpr int N = 8;
  __device__ static unsigned bits(float x) { return __bfloat16_as_ushort(__float2bfloat16_rn(x)); }
  __device__ static float value(unsigned b) { return __uint_as_float(b << 16); }
  __device__ static float round(float x) { return value(bits(x)); }
  __device__ static void unpack(const uint4& u, float (&f)[N]) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {        // the lower half of a word is the first value
      f[2 * k] = value(w[k] & 0xffffu);
      f[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
  __device__ static uint4 pack(const float (&f)[N]) {  // f holds bfloat16 values: exact
    unsigned w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) w[k] = bits(f[2 * k]) | (bits(f[2 * k + 1]) << 16);
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
  __device__ static float load(const void* base, long long i) {
    return value(__ldcs(static_cast<const unsigned short*>(base) + i));
  }
  __device__ static void store(void* base, long long i, float x) {
    __stcs(static_cast<unsigned short*>(base) + i, static_cast<unsigned short>(bits(x)));
  }
};

// x + alpha * y as `_foreach_add(x, y, alpha=alpha)` rounds it on the card.
__device__ __forceinline__ float add_scaled(float x, float alpha, float y) {
  return __fmaf_rn(alpha, y, x);
}

// One value's step in storage S; bc1 and bc2 are the bias corrections as S
// divides by them, flush whether this leaf flushes.
template <typename S>
__device__ __forceinline__ void adam_value(float& p, float grad, float& mu, float& nu,
                                           const Params& a, float bc1, float bc2, bool flush) {
  const float g = a.use_wd ? S::round(add_scaled(grad, a.wd, p)) : grad;
  float m = S::round(add_scaled(S::round(__fmul_rn(mu, a.b1)), a.a1, g));
  if (flush && fabsf(m) < FLT_MIN) m = 0.0f;
  const float v = S::round(add_scaled(S::round(__fmul_rn(nu, a.b2)), a.a2,
                                      S::round(__fmul_rn(g, g))));
  const float upd = S::round(__fdiv_rn(m, bc1));
  const float root = S::round(__fsqrt_rn(S::round(__fdiv_rn(v, bc2))));
  const float den = S::round(__fadd_rn(root, a.eps));
  p = S::round(add_scaled(p, a.neg_lr, S::round(__fdiv_rn(upd, den))));
  mu = m;
  nu = v;
}

// Block `block`'s chunk of leaf l, stored in S.
template <typename S>
__device__ __forceinline__ void adam_chunk(const Params& a, int l, int block) {
  constexpr int PACKETS = CHUNK / (THREADS * S::N);   // 16 B of each array a thread, each
  const Leaf& leaf = a.leaf[l];
  const float bc1 = S::round(__ldg(a.bc1)), bc2 = S::round(__ldg(a.bc2));
  const bool flush = (a.flush >> l) & 1u;
  const long long start = (long long)(block - a.first_block[l]) * CHUNK;
  const long long len = min((long long)CHUNK, leaf.n - start);

  if (len == CHUNK && ((a.vec >> l) & 1u)) {
    const long long base = start / S::N + threadIdx.x;   // in packets of 16 B
    const uint4* p16 = static_cast<const uint4*>(leaf.p) + base;
    const uint4* g16 = static_cast<const uint4*>(leaf.g) + base;
    const uint4* m16 = static_cast<const uint4*>(leaf.mu) + base;
    const uint4* v16 = static_cast<const uint4*>(leaf.nu) + base;
    uint4 p[PACKETS], g[PACKETS], m[PACKETS], v[PACKETS];
#pragma unroll
    for (int k = 0; k < PACKETS; ++k) {
      p[k] = __ldcs(p16 + k * THREADS);
      g[k] = __ldcs(g16 + k * THREADS);
      m[k] = __ldcs(m16 + k * THREADS);
      v[k] = __ldcs(v16 + k * THREADS);
    }
#pragma unroll
    for (int k = 0; k < PACKETS; ++k) {
      float pf[S::N], gf[S::N], mf[S::N], vf[S::N];
      S::unpack(p[k], pf);
      S::unpack(g[k], gf);
      S::unpack(m[k], mf);
      S::unpack(v[k], vf);
#pragma unroll
      for (int j = 0; j < S::N; ++j) adam_value<S>(pf[j], gf[j], mf[j], vf[j], a, bc1, bc2, flush);
      __stcs(static_cast<uint4*>(leaf.p) + base + k * THREADS, S::pack(pf));
      __stcs(static_cast<uint4*>(leaf.mu) + base + k * THREADS, S::pack(mf));
      __stcs(static_cast<uint4*>(leaf.nu) + base + k * THREADS, S::pack(vf));
    }
    return;
  }
  for (long long i = start + threadIdx.x; i < start + len; i += THREADS) {
    float p = S::load(leaf.p, i), m = S::load(leaf.mu, i), v = S::load(leaf.nu, i);
    adam_value<S>(p, S::load(leaf.g, i), m, v, a, bc1, bc2, flush);
    S::store(leaf.p, i, p);
    S::store(leaf.mu, i, m);
    S::store(leaf.nu, i, v);
  }
}

// BF16_LEAVES: some leaf of the launch is bfloat16 (a float32-only launch
// leaves the bfloat16 path, and its registers, out of the kernel).
template <bool BF16_LEAVES>
__global__ void __launch_bounds__(THREADS) fused_adam_kernel(const __grid_constant__ Params a) {
  const int block = blockIdx.x;
  int l = 0;
  while (l + 1 < a.n_leaves && block >= a.first_block[l + 1]) ++l;
  if (BF16_LEAVES && ((a.bf16 >> l) & 1u))
    adam_chunk<BF16>(a, l, block);
  else
    adam_chunk<F32>(a, l, block);
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0; }

}  // namespace

// One Adam step over n_leaves leaves, launched on `stream`: leaf l has n[l]
// values at p[l], g[l], mu[l], nu[l] (contiguous, not overlapping), stored in
// bfloat16 where bf16[l] != 0 and in float32 elsewhere; flush[l] != 0 zeroes
// its subnormal first moments. bc1 and bc2 point to the float32 bias
// corrections on the device. b1, a1 = 1 - b1, b2, a2 = 1 - b2, eps,
// neg_lr = -lr and wd are the float32 scalars of the `_foreach` path;
// use_wd = 0 takes the gradient as it is. Returns a cudaError_t (0 on success)
// without synchronizing; more than MAX_LEAVES leaves, or more blocks than an
// int counts, return cudaErrorInvalidValue.
extern "C" int fused_adam_step(int n_leaves, void* const* p, const void* const* g,
                               void* const* mu, void* const* nu, const long long* n,
                               const int* flush, const int* bf16, const float* bc1,
                               const float* bc2, float b1, float a1, float b2, float a2, float eps,
                               float neg_lr, float wd, int use_wd, cudaStream_t stream) {
  if (n_leaves < 1 || n_leaves > MAX_LEAVES) return (int)cudaErrorInvalidValue;
  Params a = {};
  long long blocks = 0;
  for (int l = 0; l < n_leaves; ++l) {
    a.leaf[l] = {p[l], g[l], mu[l], nu[l], n[l]};
    a.first_block[l] = (int)blocks;
    blocks += (n[l] + CHUNK - 1) / CHUNK;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    if (flush[l]) a.flush |= 1u << l;
    if (bf16[l]) a.bf16 |= 1u << l;
    if (aligned16(p[l]) && aligned16(g[l]) && aligned16(mu[l]) && aligned16(nu[l]))
      a.vec |= 1u << l;
  }
  a.first_block[n_leaves] = (int)blocks;
  a.n_leaves = n_leaves;
  a.bc1 = bc1;
  a.bc2 = bc2;
  a.b1 = b1;
  a.a1 = a1;
  a.b2 = b2;
  a.a2 = a2;
  a.eps = eps;
  a.neg_lr = neg_lr;
  a.wd = wd;
  a.use_wd = use_wd;
  if (blocks == 0) return (int)cudaSuccess;
  if (a.bf16)
    fused_adam_kernel<true><<<(unsigned)blocks, THREADS, 0, stream>>>(a);
  else
    fused_adam_kernel<false><<<(unsigned)blocks, THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}
