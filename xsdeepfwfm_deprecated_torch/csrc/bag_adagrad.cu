// DLRM-DCNv2's sparse Adagrad on the batch's distinct table rows, for Hopper (sm_90a),
// bound through a plain C entry.
//
// Replaces no TPU kernel: the JAX package has no multi-hot bags. The port's torch form
// (ops/embedding.bag_adagrad_torch, kept as the CPU path) sorts the B·C ids, adds each id's
// bag gradient into an (N, E) buffer of segment sums with one atomic `index_add_` a
// column, gathers the accumulator into another (N, E) buffer, and scatters the squares
// and the steps into the accumulator and the table with 64-bit atomics: about a dozen
// passes over 0.9 GB buffers where only the distinct rows need to move. At the
// benchmark's cell (B = 8,192, 214 ids a row, E = 128) that took 13.6 ms of a 34 ms step
// on an H100. This kernel was added for that.
//
// Per distinct row r whose ids sit at positions p_1 < p_2 < ... of the (B, C) ids, with
// g_k the gradient of the bag that p_k reads (row p / C, field field_of[p % C]):
//   g   = ((0 + g_1) + g_2) + ...         in position order (see the slices below)
//   acc = acc + g * g
//   w   = w + (rsqrtf(acc + eps) * g) * (-lr)   where acc > 0; w is left as it is elsewhere
// each operation rounded on its own (`__fadd_rn`, `__fmul_rn`, `rsqrtf`, never contracted),
// as the torch form rounds them on the card (`index_add_` with alpha multiplies the
// source by alpha, then adds). Rows no id reads are not touched.
//
// What bounds it on an H100: each bag's gradient read (512 B at E = 128, 212,992 bags),
// each id (4 B) read, each distinct row's weights and accumulator read and written once
// (4 x 512 B, about 1.344 M rows): 2.87 GB, 0.86 ms at 3.35 TB/s. Memory-bound; the
// gathers are 512 B each, so the kernel needs many rows in flight.
//
// Design. The wrapper (ops/cuda/bag_adagrad.py) sorts the ids as int32 keys with their
// positions, stably, so equal keys keep position order. Then two launches, nothing read
// back to the host, no float atomics:
//   1. slice_kernel: one warp for each slice of SLICE (32) sorted ids, one id a lane. A
//      ballot over neighbouring keys finds the segment heads, and the warp walks the
//      slice's pieces (the runs of equal keys) one after the other: a row is one warp,
//      32 lanes x one 16-B vector of E = 128 floats, the bags' gradient rows gathered
//      BATCH (8) at a time and added in order in registers. A piece that is a whole
//      segment steps its row at once. The last piece, where its segment runs on into
//      the next slice, is stored as the slice's partial sum (ceil(N / SLICE) rows of
//      scratch); the first piece, where its segment began in an earlier slice, is left to
//      the second pass. The block adds its heads to `count` (one integer atomic a block).
//   2. join_kernel: one warp a slice again; the warp whose slice holds the head of a
//      segment that runs on adds the slices' partial sums in order (BATCH at a time),
//      then the segment's last piece from the gradients, and steps the row.
// So a segment of thousands of ids (the zipf head of a 3-row field; all 1.75 M ids of a
// warm-up on a one-row stand-in of the table) is summed by many warps, and a result
// depends only on the sorted order: two runs are equal to the bit.
// ops/cuda/bag_adagrad.bag_adagrad_reference repeats this order in plain PyTorch.
//
// Keys from `skip` up are not stepped and not counted: a rank of a sharded step (parallel/
// bag_sharding) hands the whole global batch's ids over, those of rows it does not hold
// mapped to its table's last row, which sort to the end. A slice reads their keys and
// leaves them; the join ends at once where a run-on segment's key is one of them. Both
// kernels take it as a template flag: a step without `skip` (one device) runs the kernels
// as they were, with no vote for it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SLICE = 32;            // sorted ids a warp of the first pass walks: one a lane
constexpr int WARPS = 8;             // warps a block
constexpr int THREADS = 32 * WARPS;
constexpr int BATCH = 8;             // gradient rows (or partial sums) a lane has in flight
constexpr int MAX_COLUMNS = 256;     // columns of the ids, each naming its field in a byte
constexpr int MAX_VECS = 32;         // 16-B vectors a row: E <= 128
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  float4* table;                     // (rows, vecs)
  float4* acc;                       // (rows, vecs)
  const float4* grad;                // (B, fields, vecs) each bag's gradient, rows strided
  long long grad_b, grad_f;          // its strides in 16-B vectors: a batch row, a field
  const int* keys;                   // (n,) the ids' rows, sorted, equal keys in position order
  const long long* pos;              // (n,) each sorted id's position b * columns + c
  float4* partial;                   // (ceil(n / SLICE), vecs): a slice's run-on partial sum
  unsigned long long* count;         // adds the number of distinct rows
  int n, columns, fields, vecs;
  int skip;                          // with kSkip, keys from here up are left: rows held elsewhere
  float eps, neg_lr;
  unsigned char field_of[MAX_COLUMNS];   // column -> its field
};

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}

// The bag gradient row that the id at position p reads.
__device__ __forceinline__ const float4* grad_row(const Params& a, int p) {
  const int b = p / a.columns;
  const int f = a.field_of[p - b * a.columns];
  return a.grad + (long long)b * a.grad_b + (long long)f * a.grad_f;
}

// 0 + the gradients of the sorted ids at lanes [s, e) of the warp (`pos` is each lane's
// position), added in lane order; lane l returns its vector of the row.
__device__ __forceinline__ float4 sum_lanes(const Params& a, int pos, int s, int e, int lane) {
  float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int j0 = s; j0 < e; j0 += BATCH) {
    float4 g[BATCH];
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
      const int p = __shfl_sync(FULL, pos, (j0 + k) & (SLICE - 1));
      g[k] = j0 + k < e && lane < a.vecs ? __ldg(grad_row(a, p) + lane)
                                         : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int k = 0; k < BATCH; ++k)
      if (j0 + k < e) sum = add4(sum, g[k]);
  }
  return sum;
}

__device__ __forceinline__ void adagrad(float& w, float& acc, float g, const Params& a) {
  const float an = __fadd_rn(acc, __fmul_rn(g, g));
  if (an > 0.0f) w = __fadd_rn(w, __fmul_rn(__fmul_rn(rsqrtf(__fadd_rn(an, a.eps)), g), a.neg_lr));
  acc = an;
}

// Steps `row` with its summed gradient; lane l takes the row's l-th vector.
__device__ __forceinline__ void step_row(const Params& a, int row, float4 w, float4 s, float4 g,
                                         int lane) {
  if (lane >= a.vecs) return;
  adagrad(w.x, s.x, g.x, a);
  adagrad(w.y, s.y, g.y, a);
  adagrad(w.z, s.z, g.z, a);
  adagrad(w.w, s.w, g.w, a);
  const long long at = (long long)row * a.vecs + lane;
  a.table[at] = w;
  a.acc[at] = s;
}

// Each lane's vector of `row`'s weights and accumulator, loaded before the gradients so
// that both are in flight together.
__device__ __forceinline__ void load_row(const Params& a, int row, int lane, float4& w, float4& s) {
  if (lane >= a.vecs) return;
  const long long at = (long long)row * a.vecs + lane;
  w = a.table[at];
  s = a.acc[at];
}

template <bool kSkip>
__global__ void __launch_bounds__(THREADS) slice_kernel(const __grid_constant__ Params a) {
  __shared__ unsigned block_heads;
  const int lane = threadIdx.x & 31;
  const long long slice = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (threadIdx.x == 0) block_heads = 0;
  __syncthreads();
  const long long first = slice * SLICE;
  if (first < a.n) {
    const int len = (int)min((long long)SLICE, a.n - first);
    const int key = lane < len ? a.keys[first + lane] : -1;
    // the lanes whose rows are stepped: a prefix of the slice, since the keys are sorted
    const int live = kSkip ? __popc(__ballot_sync(FULL, lane < len && key < a.skip)) : len;
    const bool in = lane < live;
    const int pos = in ? (int)a.pos[first + lane] : 0;
    const int before = first > 0 ? a.keys[first - 1] : -1;
    const int after = first + len < a.n ? a.keys[first + len] : -1;
    const int up = __shfl_up_sync(FULL, key, 1);
    const int prev = lane == 0 ? before : up;
    const unsigned heads = __ballot_sync(FULL, in && key != prev);
    const bool runs_in = __shfl_sync(FULL, key, 0) == before;           // from an earlier slice
    const bool runs_on = (!kSkip || live == len) &&
                         __shfl_sync(FULL, key, len - 1) == after;      // into the next slice
    unsigned rest = !kSkip || live ? heads | 1u : 0u;                   // each piece's first lane
    while (rest) {
      const int s = __ffs(rest) - 1;
      rest &= rest - 1;
      const int e = rest ? __ffs(rest) - 1 : live;
      if (e == live && runs_on) {                      // a partial sum for the second pass
        const float4 sum = sum_lanes(a, pos, s, e, lane);
        if (lane < a.vecs) a.partial[slice * a.vecs + lane] = sum;
      } else if (!(s == 0 && runs_in)) {               // a whole segment: step it now
        const int row = __shfl_sync(FULL, key, s);
        float4 w, acc;
        load_row(a, row, lane, w, acc);
        step_row(a, row, w, acc, sum_lanes(a, pos, s, e, lane), lane);
      }                                                // else the end of a joined segment
    }
    if (lane == 0) atomicAdd(&block_heads, (unsigned)__popc(heads));
  }
  __syncthreads();
  if (threadIdx.x == 0 && block_heads) atomicAdd(a.count, (unsigned long long)block_heads);
}

template <bool kSkip>
__global__ void __launch_bounds__(THREADS) join_kernel(const __grid_constant__ Params a) {
  const int lane = threadIdx.x & 31;
  const long long slice = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const long long first = slice * SLICE;
  if (first + SLICE >= a.n) return;                    // nothing after this slice
  const int key = a.keys[first + SLICE - 1];
  if (kSkip && key >= a.skip) return;                  // a row this rank does not hold
  if (a.keys[first + SLICE] != key) return;            // its last segment ends here
  if (first > 0 && a.keys[first] == key && a.keys[first - 1] == key) return;   // began earlier
  float4 w, acc;
  load_row(a, key, lane, w, acc);
  // the slices whose whole span the segment fills and runs on past, BATCH at a time
  float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (lane < a.vecs) sum = add4(sum, a.partial[slice * a.vecs + lane]);
  long long next = slice + 1;
  for (;;) {
    const long long at = (next + lane) * SLICE;        // lane j looks at slice next + j
    const bool full = lane < BATCH && at + SLICE < a.n && a.keys[at + SLICE - 1] == key &&
                      a.keys[at + SLICE] == key;
    const int k = __ffs(~__ballot_sync(FULL, full)) - 1;
    float4 part[BATCH];
#pragma unroll
    for (int j = 0; j < BATCH; ++j)
      if (j < k && lane < a.vecs) part[j] = a.partial[(next + j) * a.vecs + lane];
#pragma unroll
    for (int j = 0; j < BATCH; ++j)
      if (j < k) sum = add4(sum, part[j]);
    next += k;
    if (k < BATCH) break;
  }
  // the segment's last piece: the first ids of slice `next`
  const long long last = next * SLICE;
  const int len = (int)min((long long)SLICE, a.n - last);
  const bool in = lane < len && a.keys[last + lane] == key;
  const int pos = in ? (int)a.pos[last + lane] : 0;
  const int e = __popc(__ballot_sync(FULL, in));
  sum = add4(sum, sum_lanes(a, pos, 0, e, lane));
  step_row(a, key, w, acc, sum, lane);
}

}  // namespace

extern "C" int bag_adagrad_slice_ids() { return SLICE; }

// One sparse Adagrad step, launched on `stream`. keys (n int32, sorted, equal keys in
// position order) and pos (n int64) are the sorted ids and their positions in the
// (B, columns) ids; field_of[c] is column c's field; grad is (B, fields, width) float32 with
// strides grad_b_stride and grad_f_stride floats (its width contiguous), 16-byte aligned;
// table and acc are (rows, width) float32, 16-byte aligned, every key below rows; keys from
// skip up are left (skip < 0: none); partial is ceil(n / SLICE) x width float32 of scratch;
// count is one int64. Returns a cudaError_t
// (0 on success) without synchronizing; shapes the kernel does not take return
// cudaErrorInvalidValue before any launch.
extern "C" int bag_adagrad_step(float* table, float* acc, const float* grad, const int* keys,
                                const long long* pos, float* partial, long long* count,
                                long long n, int columns, int fields, int width,
                                long long grad_b_stride, long long grad_f_stride,
                                const unsigned char* field_of, int skip, float eps,
                                float neg_lr, cudaStream_t stream) {
  if (n < 0 || n >= 0x7fffffffLL || columns < 1 || columns > MAX_COLUMNS || fields < 1 ||
      width < 4 || width % 4 != 0 || width / 4 > MAX_VECS || grad_b_stride % 4 != 0 ||
      grad_f_stride % 4 != 0)
    return (int)cudaErrorInvalidValue;
  Params a = {};
  for (int c = 0; c < columns; ++c) {
    if (field_of[c] >= fields) return (int)cudaErrorInvalidValue;
    a.field_of[c] = field_of[c];
  }
  a.table = reinterpret_cast<float4*>(table);
  a.acc = reinterpret_cast<float4*>(acc);
  a.grad = reinterpret_cast<const float4*>(grad);
  a.grad_b = grad_b_stride / 4;
  a.grad_f = grad_f_stride / 4;
  a.keys = keys;
  a.pos = pos;
  a.partial = reinterpret_cast<float4*>(partial);
  a.count = reinterpret_cast<unsigned long long*>(count);
  a.n = (int)n;
  a.columns = columns;
  a.fields = fields;
  a.vecs = width / 4;
  a.skip = skip;
  a.eps = eps;
  a.neg_lr = neg_lr;
  if (n == 0) return (int)cudaSuccess;
  const long long slices = (n + SLICE - 1) / SLICE;
  const unsigned blocks = (unsigned)((slices + WARPS - 1) / WARPS);
  if (skip >= 0)
    slice_kernel<true><<<blocks, THREADS, 0, stream>>>(a);
  else
    slice_kernel<false><<<blocks, THREADS, 0, stream>>>(a);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  if (skip >= 0)
    join_kernel<true><<<blocks, THREADS, 0, stream>>>(a);
  else
    join_kernel<false><<<blocks, THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}
