// The fp32 DeepFwFM forward at a small batch as two kernels for Hopper (sm_90a),
// bound through a plain C entry each.
//
// Replaces no TPU kernel: the JAX package runs this forward as XLA ops (the
// packed gather, the FwLW and FwFM contractions and the tower's dots,
// xsdeepfwfm_deprecated_tpu/models/deepfwfm.py). On the card the same forward
// as a graph of ATen and cuBLAS ops is about 40 small kernels that wait on
// each other: at B = 1 they take about 67 us of device time for 1.28 MB of
// weights (Avazu's widths), which the card reads in 0.38 us at 3.35 TB/s.
// So the forward is bound by latency: launches, and memory round trips that
// wait on each other (each near a microsecond at the clocks such a light load
// runs at). The design keeps both few, and runs the two kernels side by side:
//
// 1. `shallow_kernel`, a block a row, the `FM - Component`: R, fwlw_w and lw_w
//    copied to shared memory asynchronously (cp.async) beside the dependent
//    chain of the row's ids and its table rows: each field's index clipped
//    into its field, offset and clamped to the table (as
//    ops/embedding.packed_lookup_serving), the numeric slots' rows scaled by
//    their value; then the FwLW term (or the first-order table's values),
//    weighed by lw_w where the model has it, and the FwFM second order over
//    R_sym = (R + R^T) / 2 without its diagonal, as
//    sum_{k<l} R_sym[k, l] <e_k, e_l>, the pairs walked in order a thread.
//    One sum a row goes out. Its first instruction lets the tower launch
//    (programmatic dependent launch).
// 2. `tower_kernel`, the `Deep - Component`: one thread block cluster (16
//    blocks, a non-portable size) for all rows, the hidden layers and
//    the head. It runs beside the shallow kernel and waits for it only to
//    read its sums at the last layer: each block gathers the rows' field
//    embeddings itself, as the shallow kernel does (the same clipping), so
//    the tower's input is in shared memory after two round trips from its
//    start. Block q owns the columns [q NS, (q + 1) NS) of every layer
//    (NS = ceil(N / 16)). The wrapper lays each block's slice
//    of a layer out contiguous, with its biases (and the head's weights after
//    the last layer): a slab. At its start one thread asks the Tensor Memory
//    Accelerator for the block's slabs, as many layers as shared memory
//    holds, each signalling an mbarrier; a slab whose layer is done is
//    refilled with a later layer's. Thread t takes column t % NS and the
//    inputs k = t / NS + i G (G = 512 / NS groups of NS threads); the layer's
//    input waits in shared memory, transposed, so that one 16-byte load gives
//    a weight's product with four rows. A column's G partial sums are added
//    by a few lanes of a warp and their shuffles, the bias added and the relu
//    taken; those lanes store the output into the next layer's transposed
//    input in every block's shared memory (distributed shared memory) with
//    st.async, each store counted on the receiving block's mbarrier: a block
//    goes on as soon as its own input is whole, with no barrier across the
//    cluster after the first, and no layer's output goes to device memory.
//    The last layer's outputs are weighed by the head at once and summed by
//    row over the block; each block sends its row sums to block 0 the same
//    way, which adds them in block order to the row's shallow sum and the
//    bias and writes the logit.
//
// Products are fp32 FMAs on the CUDA cores, without TF32: the forward's
// arithmetic is the configuration's; only the order of its sums differs from
// the graph of ops. The weights (1.27 MB at Avazu's widths, 1.91 MB at
// Criteo's) stay in the 50 MB L2 from request to request.

#include <cuda_runtime.h>
#include <stdint.h>

namespace small_forward {

constexpr int SHALLOW_THREADS = 256;
constexpr int THREADS = 512;        // a tower block
constexpr int MAX_LAYERS = 8;
constexpr int CLUSTER = 16;         // tower blocks: a cluster of a non-portable size
constexpr int ROW_STEP = 4;         // rows of one 16-byte load of the transposed input

// A batch's ids and values and the packed table they index.
struct Lookup {
  const void* xi;          // (rows, fields - numerical) int32 or int64
  const float* xv;         // (rows, numerical)
  const float* table;      // (table_rows, emb) the second-order table
  const int* first_row;    // (fields,) each field's first packed row
  const int* last_index;   // (fields,) each field's last index (size - 1, at least 0)
  int idx64, fields, numerical, emb, table_rows;
};

struct ShallowParams {
  Lookup in;
  const float* fwlw;       // (fields, emb), or null: then `emb1` gives the first order
  const float* emb1;       // (table_rows, 1) the first-order table, or null
  const float* lw;         // (fields,), or null: the first order is summed unweighed
  const float* cov;        // (fields, fields) R
  float* shallow_out;      // (rows,) first order + second order
};

struct TowerParams {
  Lookup in;
  const float* shallow;            // (rows,) the shallow kernel's sums
  const float* bias;               // (1,) the logit's bias
  const float* slabs[MAX_LAYERS];  // (CLUSTER, slab[l]) each block's slice of layer l
  float* out;                      // (rows,)
  int dims[MAX_LAYERS + 1];
  int slab[MAX_LAYERS];            // floats of a block's slab of layer l, a multiple of 4
  int n_hidden, rows, width;       // width: the widest of dims, the input buffers' rows
  int slots, slot;                 // slabs shared memory holds at once, floats of one
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The next kernel on the stream may start (its blocks wait for this grid's
// results at griddepcontrol.wait).
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}
// Waits until the grid this one depends on has finished and its writes are visible.
__device__ __forceinline__ void wait_for_prerequisite() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// Row `row`'s field f: its packed row of the table, and the value its row is scaled by
// (a numeric slot's value; 1 for a categorical field, whose row is taken as it is).
__device__ __forceinline__ int packed_row(const Lookup& q, size_t row, int f, float* scale) {
  if (f < q.numerical) {
    *scale = q.xv[row * q.numerical + f];
    return q.first_row[f];
  }
  const size_t i = row * (q.fields - q.numerical) + (f - q.numerical);
  long long v = q.idx64 ? static_cast<const long long*>(q.xi)[i]
                        : (long long)static_cast<const int*>(q.xi)[i];
  v = min(max(v, 0LL), (long long)q.last_index[f]) + q.first_row[f];
  *scale = 1.0f;
  return (int)min(max(v, 0LL), (long long)q.table_rows - 1);
}

// ============================================================ shallow_kernel

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__global__ void __launch_bounds__(SHALLOW_THREADS) shallow_kernel(ShallowParams p) {
  extern __shared__ __align__(16) float sm[];
  launch_dependents();
  const int F = p.in.fields, E = p.in.emb, FE = F * E, t = threadIdx.x;
  const size_t row = blockIdx.x;
  float* emb = sm;                                   // (F, E)
  float* cov = emb + FE;                             // (F, F) R
  float* fwlw = cov + F * F;                         // (F, E) fwlw_w, or (F,) first orders
  float* lw = fwlw + FE;                             // (F,)
  float* scale = lw + F;                             // (F,)
  int* at = reinterpret_cast<int*>(scale + F);       // (F,) packed row of each field
  float* red = reinterpret_cast<float*>(at + F);     // a sum a warp

  // the weights, in flight while the ids and then the rows are read
  for (int i = t; i < F * F; i += SHALLOW_THREADS) cp_async4(cov + i, p.cov + i);
  if (p.fwlw != nullptr)
    for (int i = t; i < FE; i += SHALLOW_THREADS) cp_async4(fwlw + i, p.fwlw + i);
  if (p.lw != nullptr)
    for (int f = t; f < F; f += SHALLOW_THREADS) cp_async4(lw + f, p.lw + f);
  asm volatile("cp.async.commit_group;" ::: "memory");
  for (int f = t; f < F; f += SHALLOW_THREADS) at[f] = packed_row(p.in, row, f, &scale[f]);
  __syncthreads();
  for (int i = t; i < FE; i += SHALLOW_THREADS) {
    const int f = i / E;
    const float v = p.in.table[(size_t)at[f] * E + (i - f * E)];
    emb[i] = f < p.in.numerical ? v * scale[f] : v;
  }
  if (p.fwlw == nullptr)
    for (int f = t; f < F; f += SHALLOW_THREADS)
      fwlw[f] = f < p.in.numerical ? p.emb1[at[f]] * scale[f] : p.emb1[at[f]];
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();

  float s = 0.0f;
  for (int f = t; f < F; f += SHALLOW_THREADS) {
    float first;
    if (p.fwlw != nullptr) {
      first = 0.0f;
      for (int e = 0; e < E; ++e) first = fmaf(emb[f * E + e], fwlw[f * E + e], first);
    } else {
      first = fwlw[f];
    }
    s += p.lw != nullptr ? first * lw[f] : first;
  }
  // the pairs k < l in row order, the t-th and every SHALLOW_THREADS-th after it
  int k = 0, l = t + 1;
  while (k < F - 1 && l >= F) {
    l -= F - k - 1;
    ++k;
    l += 1;
  }
  while (k < F - 1) {
    float d0 = 0.0f, d1 = 0.0f;
    int e = 0;
    for (; e + 1 < E; e += 2) {
      d0 = fmaf(emb[k * E + e], emb[l * E + e], d0);
      d1 = fmaf(emb[k * E + e + 1], emb[l * E + e + 1], d1);
    }
    if (e < E) d0 = fmaf(emb[k * E + e], emb[l * E + e], d0);
    s = fmaf(0.5f * (cov[k * F + l] + cov[l * F + k]), d0 + d1, s);
    l += SHALLOW_THREADS;
    while (k < F - 1 && l >= F) {
      l -= F - k - 1;
      ++k;
      l += 1;
    }
  }
  s = warp_sum(s);
  if ((t & 31) == 0) red[t >> 5] = s;
  __syncthreads();
  if (t == 0) {
    float total = 0.0f;
    for (int w = 0; w < SHALLOW_THREADS / 32; ++w) total += red[w];
    p.shallow_out[row] = total;
  }
}

// ============================================================ tower_kernel

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
// Every thread of every block of the cluster arrives and waits once a phase.
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
// Stores v at `addr` of a block's shared memory and counts 4 bytes on that block's
// barrier `bar` (both from map_to_rank): whoever sees the barrier's phase end sees v.
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
// A bulk copy of `bytes` (a multiple of 16) from global to this block's shared memory,
// counted on the barrier `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// A layer's shape as thread t of a block sees it.
struct Slice {
  int K, N, NS, G, g, c, count;   // count: the inputs this thread takes (0 for an idle thread)
  __device__ Slice(const TowerParams& p, int l, int t) {
    K = p.dims[l];
    N = p.dims[l + 1];
    NS = (N + CLUSTER - 1) / CLUSTER;
    G = THREADS / NS;
    g = t / NS;
    c = t - g * NS;
    count = g < G && g < K ? (K - g + G - 1) / G : 0;
  }
};

// Thread 0 asks for block `rank`'s slab of layer l, into its slot.
__device__ __forceinline__ void fetch_slab(const TowerParams& p, int l, uint32_t rank,
                                           float* ring, uint64_t* bars) {
  const int slot = l % p.slots;
  const uint32_t bar = smem_u32(&bars[slot]), bytes = 4u * p.slab[l];
  mbar_expect_tx(bar, bytes);
  bulk_copy(smem_u32(ring + (size_t)slot * p.slot), p.slabs[l] + (size_t)rank * p.slab[l], bytes,
            bar);
}

__global__ void __launch_bounds__(THREADS, 1) tower_kernel(TowerParams p) {
  extern __shared__ __align__(16) float sm[];
  const int t = threadIdx.x, rows = p.rows;
  const int RP = (rows + ROW_STEP - 1) / ROW_STEP * ROW_STEP;
  const uint32_t rank = cluster_rank();
  float* ring = sm;                                     // (slots, slot) the layers' slabs
  float* xs0 = ring + (size_t)p.slots * p.slot;         // a layer's input, transposed: (K, RP)
  float* xs1 = xs0 + p.width * RP;
  float* part = xs1 + p.width * RP;                     // (RP, THREADS) the groups' partial sums
  float* heads = part + RP * THREADS;                   // (CLUSTER, RP) on block 0
  uint64_t* bars = reinterpret_cast<uint64_t*>(heads + CLUSTER * RP);   // (slots,) slabs
  uint64_t* inputs = bars + p.slots;    // (2,) the blocks' outputs in xs1, then in xs0
  uint64_t* head_bar = inputs + 2;      // the blocks' row sums, on block 0

  if (t == 0) {
    for (int s = 0; s < p.slots; ++s) mbar_init(smem_u32(&bars[s]), 1);
    mbar_init(smem_u32(&inputs[0]), 1);
    mbar_init(smem_u32(&inputs[1]), 1);
    mbar_init(smem_u32(head_bar), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int l = 0; l < p.slots; ++l) fetch_slab(p, l, rank, ring, bars);
  }
  // the input: the rows' field embeddings, gathered as the shallow kernel gathers them
  const int F = p.in.fields, E = p.in.emb, in = p.dims[0];
  int* at = reinterpret_cast<int*>(part);               // (rows, F) packed rows, then
  float* scale = part + rows * F;                       // (rows, F) scales, in `part` a while
  for (int i = t; i < rows * F; i += THREADS) {
    const int r = i / F;
    at[i] = packed_row(p.in, r, i - r * F, &scale[i]);
  }
  __syncthreads();
  for (int i = t; i < rows * in; i += THREADS) {
    const int r = i / in, k = i - r * in, f = k / E;
    const float v = p.in.table[(size_t)at[r * F + f] * E + (k - f * E)];
    xs0[k * RP + r] = f < p.in.numerical ? v * scale[r * F + f] : v;
  }
  for (int i = t; i < (RP - rows) * in; i += THREADS) {
    const int r = rows + i / in, k = i % in;
    xs0[k * RP + r] = 0.0f;
  }
  __syncthreads();
  cluster_arrive();   // every block's shared memory exists before a peer stores into it

  float shallow = 0.0f;
  Slice s(p, 0, t);
  for (int l = 0; l < p.n_hidden; ++l) {
    const bool last = l == p.n_hidden - 1;
    if (last && rank == 0 && t < rows) {   // the shallow sums, read while this layer runs
      wait_for_prerequisite();
      shallow = p.shallow[t];
    }
    const float* x = (l & 1) ? xs1 : xs0;
    float* next = (l & 1) ? xs0 : xs1;
    const float* w = ring + (size_t)(l % p.slots) * p.slot;   // (K, NS), then (NS,) biases
    mbar_wait(smem_u32(&bars[l % p.slots]), (l / p.slots) & 1);
    // the products: this thread's column, its inputs, four rows a load
    if (s.count > 0) {
      for (int r0 = 0; r0 < RP; r0 += ROW_STEP) {
        float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        const float* xk = x + s.g * RP + r0;
        const float* wk = w + s.g * s.NS + s.c;
#pragma unroll 4
        for (int i = 0; i < s.count; ++i) {
          const float wv = wk[(size_t)i * s.G * s.NS];
          const float4 v = *reinterpret_cast<const float4*>(xk + (size_t)i * s.G * RP);
          acc.x = fmaf(wv, v.x, acc.x);
          acc.y = fmaf(wv, v.y, acc.y);
          acc.z = fmaf(wv, v.z, acc.z);
          acc.w = fmaf(wv, v.w, acc.w);
        }
        part[(r0 + 0) * THREADS + t] = acc.x;
        part[(r0 + 1) * THREADS + t] = acc.y;
        part[(r0 + 2) * THREADS + t] = acc.z;
        part[(r0 + 3) * THREADS + t] = acc.w;
      }
    }
    __syncthreads();
    if (l == 0) cluster_wait();
    // each output's G partial sums over `lanes` lanes of a warp (as many as the outputs
    // leave), then the bias and the relu; the lanes store the output into the next input
    // of every block of the cluster, its own too, each store counted on that block's
    // barrier; the last layer's head terms stay
    const float* bias = w + s.K * s.NS;
    const uint32_t inbar = smem_u32(&inputs[(l + 1) & 1]);
    const int outs = rows * s.NS, groups = s.G < s.K ? s.G : s.K;
    int lanes = 32;
    while (lanes > 1 && outs * lanes > THREADS) lanes >>= 1;
    const int lane = t & 31, j = lane & (lanes - 1), step = THREADS / lanes;
    for (int o0 = (t >> 5) * (32 / lanes); o0 < outs; o0 += step) {
      const int o = o0 + lane / lanes, r = o / s.NS, c = o - r * s.NS, n = rank * s.NS + c;
      float v = 0.0f;
      if (o < outs)
        for (int g = j; g < groups; g += lanes) v += part[r * THREADS + g * s.NS + c];
      for (int m = lanes >> 1; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
      if (o >= outs) continue;
      const float y = fmaxf(v + bias[c], 0.0f);
      if (last) {
        if (j == 0) next[r * s.NS + c] = y * bias[s.NS + c];
      } else if (n < s.N) {
        const uint32_t at = smem_u32(next + n * RP + r);
        for (uint32_t q = j; q < CLUSTER; q += lanes)
          st_async_f32(map_to_rank(at, q), y, map_to_rank(inbar, q));
      }
    }
    if (last) break;
    if (t == 0) mbar_expect_tx(inbar, 4u * s.N * rows);
    s = Slice(p, l + 1, t);
    mbar_wait(inbar, (l >> 1) & 1);
    // every block is done with this layer: a later layer's slab may take its slot
    if (t == 0 && l + p.slots < p.n_hidden) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      fetch_slab(p, l + p.slots, rank, ring, bars);
    }
  }

  // the head: each block's row sums to block 0, which adds them in block order
  __syncthreads();
  const float* terms = (p.n_hidden & 1) ? xs1 : xs0;
  const uint32_t hbar = smem_u32(head_bar);
  if (t < rows) {
    float sum = 0.0f;
    for (int c = 0; c < s.NS; ++c) sum += terms[t * s.NS + c];
    st_async_f32(map_to_rank(smem_u32(heads + rank * RP + t), 0), sum, map_to_rank(hbar, 0));
  }
  if (rank != 0) return;
  if (t == 0) mbar_expect_tx(hbar, 4u * CLUSTER * rows);
  mbar_wait(hbar, 0);
  if (t < rows) {
    float deep = 0.0f;
    for (int q = 0; q < CLUSTER; ++q) deep += heads[q * RP + t];
    p.out[t] = (shallow + deep) + p.bias[0];
  }
}

size_t tower_smem(int slots, int slot, int width, int rows) {
  const int rp = (rows + ROW_STEP - 1) / ROW_STEP * ROW_STEP;
  return sizeof(float) * ((size_t)slots * slot + (size_t)2 * width * rp + (size_t)rp * THREADS +
                          (size_t)CLUSTER * rp) +
         sizeof(uint64_t) * (slots + 3);
}

cudaError_t configure(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attrs, size_t smem,
                      cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(tower_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(tower_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = CLUSTER;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  attrs[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attrs[1].val.programmaticStreamSerializationAllowed = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(CLUSTER);
  cfg->blockDim = dim3(THREADS);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  cfg->attrs = attrs;
  cfg->numAttrs = 2;
  return cudaSuccess;
}

}  // namespace small_forward

using namespace small_forward;

// shallow_kernel on `rows` rows: shallow_out (rows,). Returns a cudaError_t (0 on
// success) without synchronizing.
extern "C" int small_forward_shallow(const void* xi, int idx64, const float* xv, int rows,
                                     int fields, int numerical, int emb, const float* table,
                                     int table_rows, const int* first_row, const int* last_index,
                                     const float* fwlw, const float* emb1, const float* lw,
                                     const float* cov, float* shallow_out, cudaStream_t stream) {
  if (rows < 1 || fields < 1 || emb < 1 || (fwlw == nullptr && emb1 == nullptr))
    return (int)cudaErrorInvalidValue;
  ShallowParams p{{xi, xv, table, first_row, last_index, idx64, fields, numerical, emb,
                   table_rows},
                  fwlw, emb1, lw, cov, shallow_out};
  const size_t smem = sizeof(float) * ((size_t)fields * fields + 2 * (size_t)fields * emb +
                                       4 * fields + SHALLOW_THREADS / 32);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  shallow_kernel<<<rows, SHALLOW_THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of a tower block: `slots` slabs of `slot` floats, a
// layer's input and output at `width` and `rows`, the partial sums, the head's
// row sums, a barrier a slot, one for each of the two inputs and one for the head.
extern "C" long long small_forward_tower_smem(int slots, int slot, int width, int rows) {
  return (long long)tower_smem(slots, slot, width, rows);
}

// tower_kernel on `rows` rows: out (rows,) = shallow + the tower + bias, one
// cluster of CLUSTER blocks launched after the shallow kernel on `stream`
// as its programmatic dependent; the lookup's operands as the shallow
// kernel's. dims (n_hidden + 1,) the input width (fields * emb) and each
// hidden layer's; slabs[l] (CLUSTER, slab[l]) each block's slice of layer l:
// its (dims[l], NS_l) weights with NS_l = ceil(dims[l + 1] / CLUSTER), its NS_l
// biases, after the last layer the head's NS weights, zero-padded to
// slab[l] floats, a multiple of 4. `slots` slabs of at most `slot` floats fit
// shared memory at once. Returns a cudaError_t without synchronizing.
extern "C" int small_forward_tower(const void* xi, int idx64, const float* xv, int fields,
                                   int numerical, int emb, const float* table, int table_rows,
                                   const int* first_row, const int* last_index,
                                   const float* shallow, const float* bias, int rows,
                                   int n_hidden, const int* dims, const void* const* slabs,
                                   const int* slab, int slots, int slot, float* out,
                                   cudaStream_t stream) {
  if (n_hidden < 1 || n_hidden > MAX_LAYERS || rows < 1 || slots < 1 ||
      slots > n_hidden || dims[0] != fields * emb ||
      2 * fields > THREADS)
    return (int)cudaErrorInvalidValue;
  TowerParams p{};
  p.in = Lookup{xi, xv, table, first_row, last_index, idx64, fields, numerical, emb, table_rows};
  p.shallow = shallow;
  p.bias = bias;
  p.out = out;
  p.n_hidden = n_hidden;
  p.rows = rows;
  p.slots = slots;
  p.slot = slot;
  p.width = 0;
  for (int l = 0; l <= n_hidden; ++l) {
    p.dims[l] = dims[l];
    p.width = dims[l] > p.width ? dims[l] : p.width;
  }
  for (int l = 0; l < n_hidden; ++l) {
    p.slabs[l] = static_cast<const float*>(slabs[l]);
    p.slab[l] = slab[l];
    if (slab[l] % 4 || slab[l] > slot) return (int)cudaErrorInvalidValue;
  }
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attrs[2];
  cudaError_t err = configure(&cfg, attrs, tower_smem(slots, slot, p.width, rows), stream);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, tower_kernel, p);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}
