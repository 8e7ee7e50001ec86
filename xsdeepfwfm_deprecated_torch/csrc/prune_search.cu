// The DeepLight prune refresh's threshold search and zeroing, for Hopper (sm_90a), bound
// through a plain C entry.
//
// Replaces no TPU kernel. The JAX package (and the port's torch path,
// compression/pruning._bisect) finds each magnitude threshold above 16,384 values by
// 40 halvings of [amax * 2^-120, amax] in log space, each a pass over the leaf: exp
// of the midpoint, `|w| < v`, a count, an IEEE division, a compare and two selects.
// On the card that made about 1,600 small graph nodes a refresh of the Criteo
// flagship, about 9.6 ms of device time, more than a training step. This kernel was
// added for that.
//
// What bounds it on an H100: the refresh must read every pruned value and write it
// back, 8 B a float32 value: 13,740,101 values (the flagship's table, tower and fwlw),
// 0.033 ms at 3.35 TB/s. The search here reads the counted values 6 times (an amax pass
// and 5 counting rounds) and the zeroing reads them once more and writes the pruned
// ones: memory-bound, about 7 reads where the bound counts one read and one write.
//
// Design. One launch a pass for every searched group of the tree, and nothing read
// back to the host: each group (the embedding tables together, one threshold over all
// of them; each tower weight; fwlw where it is large) has its state on the device, and
// the segments (pointer, values counted, values zeroed, storage type, group) travel by
// value in the kernel's parameter block, so a CUDA graph captures them.
//   1. amax: each group's largest magnitude (an atomic max on the float's bits, which
//      orders non-negative floats and keeps a NaN, as torch's max does);
//   2. counting rounds: each resolves the next LEVELS (8) of the ITERS (40) halvings at
//      once, ROUNDS (5) launches.
//      A block builds its group's 255 possible midpoints of the next 8 levels in shared
//      memory, each `0.5f * (lo + hi)` of its interval exactly as the halvings form it,
//      and their expf. A float midpoint lies within its interval and expf is monotone,
//      so each node's left subtree holds thresholds no larger than its own and its right
//      subtree none smaller: walking a value down the tree (`|w| < T` goes left) finds
//      its bin among the 256 gaps, and the count below any node's threshold is the sum
//      of the bins left of it. Counts go into a per-warp shared histogram; the two end
//      bins (below the interval, where the pruned zeros and the parked rows lie, and
//      above it), which hold most values after the first round, are kept in registers,
//      and a middle bin takes one shared atomic for each set of lanes that match
//      (`__match_any_sync`), so a tie or a collapsed cluster does not serialize. A block
//      adds its histogram to the group's in global memory; the group's last block (an
//      atomic ticket) prefix-sums it and replays the 8 halvings with the counts:
//      `(float)count / (float)n < target` by an IEEE division, as `exact_div` divides.
//   3. zeroing: thr = expf(0.5f * (lo + hi)), or 0 where the target is 0; every leaf
//      of every group, padding rows included, has |w| < thr set to +0 in place, and a
//      16-byte packet is written only where it changed.
// A block takes 4,096 values, one batch of 16 a thread, every load issued before the
// first value is walked, so that each walk's 8 dependent shared loads overlap the
// others': larger chunks were slower (an easy round 48 us at 16,384 values a block,
// 36 at 8,192, 31 at 4,096 on an H100 at the Criteo leaves).
// Every rounding is the torch path's: `__fadd_rn`, `__fmul_rn`, `__fdiv_rn`, and
// `expf`/`logf` without fast math, the functions torch's `exp` and `log` call on the
// card (tests/test_torch_prune_search.py holds them equal to torch's over every float
// and expf monotone), so the thresholds equal `_bisect`'s to the bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 4096;                  // values a block: one batch of 16 a thread
static_assert(CHUNK % (THREADS * 16) == 0, "a chunk is whole batches of 16 values a thread");
constexpr int MAX_SEGMENTS = 32;             // segments the parameter block holds
constexpr int ITERS = 40;                    // halvings of the search, as _bisect's
constexpr int LEVELS = 8;                    // halvings a counting round resolves
static_assert(ITERS % LEVELS == 0, "every round resolves LEVELS halvings");
constexpr int ROUNDS = ITERS / LEVELS;
constexpr int BINS = 1 << LEVELS;
constexpr int TOP = BINS - 1;                // the last bin, and the tree's thresholds
constexpr unsigned FULL = 0xffffffffu;
// the torch path's lo = hi + (-120.0 * 0.6931472): the Python float rounded to float32
constexpr float LO_SPAN = (float)(-120.0 * 0.6931472);
constexpr float AMAX_FLOOR = 1e-30f;

struct GroupState {          // one group's search, in the workspace (32 B)
  unsigned amax;             // bits of the largest magnitude
  float lo, hi;              // the interval in log space
  float thr;                 // the threshold, after the last round
  unsigned ticket;           // blocks of this round done
  unsigned pad[3];
};
constexpr int GROUP_BYTES = sizeof(GroupState) + BINS * sizeof(unsigned long long);

struct Segment {
  const void* p;
  long long n;               // leading values counted
  long long n_all;           // values zeroed (the whole leaf)
  int group;
  int bf16;
};

struct Params {
  Segment seg[MAX_SEGMENTS];
  int first_block[MAX_SEGMENTS + 1];        // counting: segment s owns these blocks
  int first_zero_block[MAX_SEGMENTS + 1];   // zeroing
  int group_blocks[MAX_SEGMENTS];           // counting blocks of each group
  long long group_n[MAX_SEGMENTS];          // values counted in each group
  unsigned vec;                             // bit s: segment s is 16-byte aligned
  int n_segments;
  const float* target;                      // a float32 target a group, clamped to [0, 1]
  char* work;                               // GROUP_BYTES a group, zeroed before the search
  int first_round, last_round;
};

__device__ __forceinline__ GroupState* state(const Params& a, int g) {
  return reinterpret_cast<GroupState*>(a.work + (size_t)g * GROUP_BYTES);
}

__device__ __forceinline__ unsigned long long* histogram(const Params& a, int g) {
  return reinterpret_cast<unsigned long long*>(a.work + (size_t)g * GROUP_BYTES +
                                               sizeof(GroupState));
}

// the segment that owns block `block` in a prefix table of blocks
__device__ __forceinline__ int owner(const int* first, int n_segments, int block) {
  int s = 0;
  while (s + 1 < n_segments && block >= first[s + 1]) ++s;
  return s;
}

__device__ __forceinline__ float bf16_value(unsigned bits) { return __uint_as_float(bits << 16); }

__device__ __forceinline__ float half_sum(float lo, float hi) {
  return __fmul_rn(0.5f, __fadd_rn(lo, hi));
}

// Calls f(values, valid) on every value of block `block_in_seg`'s chunk of segment s, read
// as float32, a batch at a time (16 values from 16-byte loads, or 1 on a chunk's ragged
// end, with `valid` false past it), every lane of a warp the same number of times.
template <typename F>
__device__ __forceinline__ void for_chunk(const Params& a, int s, int block_in_seg, F&& f) {
  const Segment& seg = a.seg[s];
  const long long start = (long long)block_in_seg * CHUNK;
  const long long len = min((long long)CHUNK, seg.n - start);
  if (len == CHUNK && ((a.vec >> s) & 1u)) {
    const uint4* p16 = static_cast<const uint4*>(seg.p);
    float x[16];
    if (seg.bf16) {
      const long long base = start / 8 + threadIdx.x;
      for (int k = 0; k < CHUNK / (THREADS * 8); k += 2) {
        const uint4 u0 = __ldg(p16 + base + k * THREADS);
        const uint4 u1 = __ldg(p16 + base + (k + 1) * THREADS);
        const unsigned w[8] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          x[2 * j] = bf16_value(w[j] & 0xffffu);
          x[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
        }
        f(x, true);
      }
    } else {
      const long long base = start / 4 + threadIdx.x;
      for (int k = 0; k < CHUNK / (THREADS * 4); k += 4) {
        uint4 u[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) u[j] = __ldg(p16 + base + (k + j) * THREADS);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          x[4 * j] = __uint_as_float(u[j].x);
          x[4 * j + 1] = __uint_as_float(u[j].y);
          x[4 * j + 2] = __uint_as_float(u[j].z);
          x[4 * j + 3] = __uint_as_float(u[j].w);
        }
        f(x, true);
      }
    }
    return;
  }
  const int steps = (int)((len + THREADS - 1) / THREADS);
  for (int k = 0; k < steps; ++k) {
    const long long i = start + (long long)k * THREADS + threadIdx.x;
    const bool valid = i < start + len;
    float x[1] = {0.0f};
    if (valid)
      x[0] = seg.bf16 ? bf16_value(__ldg(static_cast<const unsigned short*>(seg.p) + i))
                      : __ldg(static_cast<const float*>(seg.p) + i);
    f(x, valid);
  }
}

// 1. Each group's largest magnitude, as bits: for non-negative floats the order of the
// bits is the order of the values, and a NaN's bits lie above +inf.
__global__ void __launch_bounds__(THREADS) amax_kernel(const __grid_constant__ Params a) {
  const int s = owner(a.first_block, a.n_segments, blockIdx.x);
  unsigned m = 0;
  for_chunk(a, s, blockIdx.x - a.first_block[s], [&](const auto& x, bool valid) {
#pragma unroll
    for (int j = 0; j < (int)(sizeof(x) / sizeof(float)); ++j)
      if (valid) m = max(m, __float_as_uint(x[j]) & 0x7fffffffu);
  });
  m = __reduce_max_sync(FULL, m);
  __shared__ unsigned warp_max[WARPS];
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x / 32] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < WARPS; ++w) m = max(m, warp_max[w]);
    atomicMax(&state(a, a.seg[s].group)->amax, m);
  }
}

// 2. One counting round: LEVELS halvings of every group's interval.
__global__ void __launch_bounds__(THREADS) round_kernel(const __grid_constant__ Params a) {
  static_assert(THREADS == BINS, "a thread a bin");
  __shared__ float tree[BINS];                       // node i (1-based, heap order) at tree[i]
  __shared__ unsigned warp_hist[WARPS][BINS];
  __shared__ unsigned long long prefix[BINS];
  __shared__ int last_block;
  const int s = owner(a.first_block, a.n_segments, blockIdx.x);
  const int g = a.seg[s].group;
  GroupState* st = state(a, g);
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;

  float lo, hi;
  if (a.first_round) {
    const float amax = __uint_as_float(st->amax);
    hi = logf(isnan(amax) ? amax : fmaxf(amax, AMAX_FLOOR));
    lo = __fadd_rn(hi, LO_SPAN);
  } else {
    lo = st->lo;
    hi = st->hi;
  }
  // node i's interval by its path from the root: bit 1 = upper half (lo = mid)
  for (int node = threadIdx.x + 1; node < BINS; node += THREADS) {
    float l = lo, h = hi;
    for (int d = 30 - __clz(node); d >= 0; --d) {
      const float mid = half_sum(l, h);
      if ((node >> d) & 1)
        l = mid;
      else
        h = mid;
    }
    tree[node] = expf(half_sum(l, h));
  }
  for (int i = threadIdx.x; i < WARPS * BINS; i += THREADS) (&warp_hist[0][0])[i] = 0;
  __syncthreads();

  // A value below the smallest threshold walks left at every node, one at or above the
  // largest (or a NaN) right: the two end bins, which hold most values after the first
  // round, take two compares and a register count; the others walk the tree.
  const float least = tree[BINS >> 1], most = tree[TOP];
  unsigned below = 0, above = 0;
  unsigned* hist = warp_hist[warp];
  for_chunk(a, s, blockIdx.x - a.first_block[s], [&](const auto& x, bool valid) {
    constexpr int N = sizeof(x) / sizeof(float);
    int bin[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float v = fabsf(x[j]);
      if (v < least) {
        bin[j] = 0;
      } else if (!(v < most)) {
        bin[j] = TOP;
      } else {
        int node = 1;
#pragma unroll
        for (int l = 0; l < LEVELS; ++l) node = 2 * node + !(v < tree[node]);
        bin[j] = node - BINS;
      }
    }
#pragma unroll
    for (int j = 0; j < N; ++j) {
      below += valid && bin[j] == 0;
      above += valid && bin[j] == TOP;
      const bool middle = valid && bin[j] != 0 && bin[j] != TOP;
      const unsigned lanes = __ballot_sync(FULL, middle);
      if (middle) {
        const unsigned peers = __match_any_sync(lanes, bin[j]);
        if (lane == __ffs(peers) - 1) atomicAdd(&hist[bin[j]], (unsigned)__popc(peers));
      }
    }
  });
  below = __reduce_add_sync(FULL, below);
  above = __reduce_add_sync(FULL, above);
  if (lane == 0) {
    atomicAdd(&hist[0], below);
    atomicAdd(&hist[TOP], above);
  }
  __syncthreads();

  unsigned long long* global_hist = histogram(a, g);
  {
    unsigned long long sum = 0;
    for (int w = 0; w < WARPS; ++w) sum += warp_hist[w][threadIdx.x];
    if (sum) atomicAdd(&global_hist[threadIdx.x], sum);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last_block = atomicAdd(&st->ticket, 1u) == (unsigned)a.group_blocks[g] - 1;
  __syncthreads();
  if (!last_block) return;

  // the group's last block: every count is in; prefix-sum the bins and halve LEVELS times
  __threadfence();
  prefix[threadIdx.x] = __ldcg(&global_hist[threadIdx.x]);
  global_hist[threadIdx.x] = 0;                                 // ready for the next round
  __syncthreads();
  for (int off = 1; off < BINS; off <<= 1) {
    const unsigned long long add = threadIdx.x >= off ? prefix[threadIdx.x - off] : 0ull;
    __syncthreads();
    prefix[threadIdx.x] += add;
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const float n = __ll2float_rn(a.group_n[g]);
    const float target = a.target[g];
    float l = lo, h = hi;
    int node = 1;
    for (int d = 0; d < LEVELS; ++d) {
      // node's rank among the thresholds in order: the values below it fill bins 0..rank
      const int rank = ((2 * (node - (1 << d)) + 1) << (LEVELS - 1 - d)) - 1;
      const float mid = half_sum(l, h);
      const bool go_up = __fdiv_rn(__ull2float_rn(prefix[rank]), n) < target;
      if (go_up)
        l = mid;
      else
        h = mid;
      node = 2 * node + (go_up ? 1 : 0);
    }
    st->lo = l;
    st->hi = h;
    if (a.last_round) st->thr = target > 0.0f ? expf(half_sum(l, h)) : 0.0f;
    st->ticket = 0;
  }
}

// 3. |w| < thr set to +0, in place, over every value of every leaf.
__global__ void __launch_bounds__(THREADS) zero_kernel(const __grid_constant__ Params a) {
  const int s = owner(a.first_zero_block, a.n_segments, blockIdx.x);
  const Segment& seg = a.seg[s];
  const float thr = state(a, seg.group)->thr;
  const long long start = (long long)(blockIdx.x - a.first_zero_block[s]) * CHUNK;
  const long long len = min((long long)CHUNK, seg.n_all - start);
  if (len == CHUNK && ((a.vec >> s) & 1u)) {
    uint4* p16 = static_cast<uint4*>(const_cast<void*>(seg.p));
    const int per_packet = seg.bf16 ? 8 : 4;
    const long long base = start / per_packet + threadIdx.x;
    for (int k = 0; k < CHUNK / (THREADS * per_packet); ++k) {
      uint4 u = p16[base + k * THREADS];
      unsigned w[4] = {u.x, u.y, u.z, u.w};
      bool changed = false;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (seg.bf16) {
          if (fabsf(bf16_value(w[j] & 0xffffu)) < thr) { w[j] &= 0xffff0000u; changed = true; }
          if (fabsf(__uint_as_float(w[j] & 0xffff0000u)) < thr) { w[j] &= 0xffffu; changed = true; }
        } else if (fabsf(__uint_as_float(w[j])) < thr) {
          w[j] = 0;
          changed = true;
        }
      }
      if (changed) p16[base + k * THREADS] = make_uint4(w[0], w[1], w[2], w[3]);
    }
    return;
  }
  for (long long i = start + threadIdx.x; i < start + len; i += THREADS) {
    if (seg.bf16) {
      unsigned short* p = static_cast<unsigned short*>(const_cast<void*>(seg.p)) + i;
      if (fabsf(bf16_value(*p)) < thr) *p = 0;
    } else {
      float* p = static_cast<float*>(const_cast<void*>(seg.p)) + i;
      if (fabsf(*p) < thr) *p = 0.0f;
    }
  }
}

__global__ void math_kernel(const float* x, float* exp_out, float* log_out, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    exp_out[i] = expf(x[i]);
    log_out[i] = logf(x[i]);
  }
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0; }

}  // namespace

extern "C" int prune_search_group_bytes() { return GROUP_BYTES; }

// The threshold search of n_groups groups and their zeroing, launched on `stream`:
// segment s holds n_all[s] values at ptr[s] (contiguous; bfloat16 where bf16[s] != 0,
// else float32), of which the first n[s] count towards group group[s]'s threshold.
// target points to n_groups float32 targets on the device, each in [0, 1]; work to
// n_groups * prune_search_group_bytes() zeroed bytes on the device, where group g's
// threshold is the float at byte g * prune_search_group_bytes() + 12 afterwards.
// ITERS halvings in ROUNDS rounds: ROUNDS + 2 launches.
// Returns a cudaError_t (0 on success) without synchronizing; what the kernels do not
// take returns cudaErrorInvalidValue before any launch.
extern "C" int prune_search(int n_segments, const void* const* ptr, const long long* n,
                            const long long* n_all, const int* group, const int* bf16,
                            int n_groups, const float* target, void* work,
                            cudaStream_t stream) {
  if (n_segments < 1 || n_segments > MAX_SEGMENTS || n_groups < 1 || n_groups > n_segments)
    return (int)cudaErrorInvalidValue;
  Params a = {};
  long long blocks = 0, zero_blocks = 0;
  for (int s = 0; s < n_segments; ++s) {
    if (group[s] < 0 || group[s] >= n_groups || n[s] < 0 || n[s] > n_all[s])
      return (int)cudaErrorInvalidValue;
    a.seg[s] = {ptr[s], n[s], n_all[s], group[s], bf16[s] ? 1 : 0};
    a.first_block[s] = (int)blocks;
    a.first_zero_block[s] = (int)zero_blocks;
    const long long b = (n[s] + CHUNK - 1) / CHUNK;
    blocks += b;
    zero_blocks += (n_all[s] + CHUNK - 1) / CHUNK;
    if (zero_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    a.group_blocks[group[s]] += (int)b;
    a.group_n[group[s]] += n[s];
    if (aligned16(ptr[s])) a.vec |= 1u << s;
  }
  for (int g = 0; g < n_groups; ++g)
    if (a.group_blocks[g] == 0) return (int)cudaErrorInvalidValue;
  a.first_block[n_segments] = (int)blocks;
  a.first_zero_block[n_segments] = (int)zero_blocks;
  a.n_segments = n_segments;
  a.target = target;
  a.work = static_cast<char*>(work);

  amax_kernel<<<(unsigned)blocks, THREADS, 0, stream>>>(a);
  int err = (int)cudaGetLastError();
  for (int r = 0; err == 0 && r < ROUNDS; ++r) {
    a.first_round = r == 0;
    a.last_round = r == ROUNDS - 1;
    round_kernel<<<(unsigned)blocks, THREADS, 0, stream>>>(a);
    err = (int)cudaGetLastError();
  }
  if (err == 0 && zero_blocks > 0) {
    zero_kernel<<<(unsigned)zero_blocks, THREADS, 0, stream>>>(a);
    err = (int)cudaGetLastError();
  }
  return err;
}

// expf and logf of n floats, as the search computes them: for the tests, which hold
// them to torch's exp and log on the card.
extern "C" int prune_search_math(const float* x, float* exp_out, float* log_out, long long n,
                                 cudaStream_t stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const long long blocks = min((n + THREADS - 1) / THREADS, 132LL * 64);
  math_kernel<<<(unsigned)blocks, THREADS, 0, stream>>>(x, exp_out, log_out, n);
  return (int)cudaGetLastError();
}
