// sketch.cu — HyperLogLog and count-min updates for filter_log_to_metrics,
// and the flux plane's fused absorb.
//
// Replaces four device programs of the reference package:
//   K6 HyperLogLog._update_impl (ops/sketch.py:137) with _fnv1a_scan (:40),
//      _mix (:66) and hll_index_rank (:76): registers.at[idx].max(rank)
//   K7 CountMin._update_impl (ops/sketch.py:267) with CountMin._hashes
//      (:260): table.at[r, cols[r]].add((lengths >= 0) * weight) for each
//      depth row
//   K10 build_fused_absorb (flux/kernels.py:189): K9's group counts, K6's
//      index and rank scatter-maxed into a per-group register stack for
//      each distinct field, and K7's weight-1 update of the composites, in
//      one launch
//   K9 _counts_impl (flux/kernels.py:80): K10's counts-only launch
// and updates the sketch state in place, which is the reference's
// functional result committed. It also holds the merge of the sharded
// programs (K8 ops/sketch.py:421/486, K9's and K10's mesh halves
// flux/kernels.py:110/348): each shard runs the kernels above into a
// zeroed partial state, and shard_merge folds the n partials into the
// base, the reference's lax.pmax / lax.psum (see shard_merge_kernel). (The flux caller hands K10 freshly
// assembled stacks and a copy of the table, and commits after it
// returns: snapshot in, commit on finish.)
//
// One thread per staged row. The thread hashes bytes [0, length) of its
// row (FNV-1a 32 then the murmur3 fmix32 finaliser, in native uint32
// arithmetic; a negative length hashes no byte and its row changes
// nothing), then does one integer atomic per sketch row it touches:
// atomicMax into a register (HLL) or atomicAdd into a counter (count-min).
// Integer atomics give the same state in any order, so the result equals
// the reference's scatter bit for bit.
//
// What bounds it on an H100: the work is tiny. A 4096-row append reads at
// most 1 MiB of row bytes and 16 KiB of lengths, and makes 4096 (HLL) or
// 16384 (count-min, d = 4) atomics into a 64 KiB / 256 KiB state that
// stays in L2. Bytes bound it at well under a microsecond; in practice a
// launch of 16 blocks is latency-bound: each thread walks a chain of up to
// 256 dependent multiply-xor steps, and 4096 threads fill only a few SMs.
// The design keeps that chain free of other memory traffic (16 B row loads
// that stop at the row's length, the hash in registers) and makes one
// atomic per row and depth. Privatised registers in shared memory and a
// warp-cooperative hash are later levers.
//
// K10 is the same per-row work laid out as a 2-D grid: y picks counts,
// one distinct field or the composites, so a flux append (4096 rows, one
// field plus composites) runs 3 x 16 blocks in one launch, latency-bound
// like K6/K7. Its stack (200 groups x 2^12 registers, 3.2 MiB) and table
// (256 KiB) stay in L2; a row touches one register and d counters.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kFnvOffset = 0x811C9DC5u;
constexpr uint32_t kFnvPrime = 0x01000193u;

// murmur3 fmix32 (reference _mix)
__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// fmix32(FNV-1a 32 over row[0, n)), n = clamp(length, 0, L): the
// reference _fnv1a_scan, whose mask is pos < lengths. Pad bytes past n
// are never read. vec16: L % 16 == 0 and a 16 B aligned batch, so the row
// is read 16 bytes at a time.
__device__ __forceinline__ uint32_t row_hash(const uint8_t* __restrict__ row,
                                             int length, int L, int vec16) {
  const int n = length < 0 ? 0 : (length > L ? L : length);
  uint32_t h = kFnvOffset;
  if (vec16) {
    for (int base = 0; base < n; base += 16) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(row + base));
      const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        if (base + q < n) {
          h = (h ^ ((words[q >> 2] >> ((q & 3) * 8)) & 0xFFu)) * kFnvPrime;
        }
      }
    }
  } else {
    for (int pos = 0; pos < n; ++pos) {
      h = (h ^ __ldg(row + pos)) * kFnvPrime;
    }
  }
  return fmix32(h);
}

__global__ void __launch_bounds__(kThreads)
hll_update_kernel(const uint8_t* __restrict__ batch,
                  const int32_t* __restrict__ lengths,
                  int32_t* __restrict__ registers, int B, int L, int p,
                  int vec16) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int length = lengths[b];
  if (length < 0) return;  // rank 0: registers are >= 0, nothing changes
  const uint32_t h = row_hash(batch + (long long)b * L, length, L, vec16);
  const uint32_t idx = h >> (32 - p);
  // __clz(0) is 32: rest == 0 saturates at the largest rank, 33 - p
  const int rank = min(__clz(h << p) + 1, 33 - p);
  atomicMax(registers + idx, rank);
}

// T is int (int32 table) or unsigned long long (int64 table: two's
// complement addition is the same bit pattern as signed).
template <typename T>
__global__ void __launch_bounds__(kThreads)
cms_update_kernel(const uint8_t* __restrict__ batch,
                  const int32_t* __restrict__ lengths,
                  const int32_t* __restrict__ weights, T* __restrict__ table,
                  int B, int L, int d, int w, int vec16) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int length = lengths[b];
  if (length < 0) return;  // weight 0
  const uint32_t h1 = row_hash(batch + (long long)b * L, length, L, vec16);
  const uint32_t h2 = fmix32(h1) | 1u;  // odd: full-period double hashing
  const T weight = static_cast<T>(static_cast<long long>(
      weights != nullptr ? weights[b] : 1));
  for (int r = 0; r < d; ++r) {
    // the uint32 wrap comes before the modulo, as in the reference
    const uint32_t col = (h1 + static_cast<uint32_t>(r) * h2) %
                         static_cast<uint32_t>(w);
    atomicAdd(table + (long long)r * w + col, weight);
  }
}

// One distinct field of the flux absorb: its staged rows and the register
// stack [n_seg, 2^p] they scatter into.
struct FluxField {
  const uint8_t* batch;     // u8 [B, L]
  const int32_t* lengths;   // i32 [B]
  int32_t* stack;           // i32 [n_seg, 2^p]
};

// K10: the flux plane's fused absorb (reference flux/kernels.py:189
// build_fused_absorb). blockIdx.y picks the task, each thread one row:
//   y = 0        group counts, counts[seg[i]] += valid[i] (K9, :80)
//   y = 1..F     distinct field y-1: stack[seg[i], idx] max= rank (K6's
//                index and rank; a negative length is rank 0, a no-op)
//   y = F + 1    the composites' weight-1 count-min update (K7's columns)
// A segment id outside [0, n_seg) changes nothing (the reference's
// scatter drops out-of-range updates). With F = 0 and no composites this
// is K9's counts-only launch.
__global__ void __launch_bounds__(kThreads)
flux_absorb_kernel(const int32_t* __restrict__ seg,
                   const int32_t* __restrict__ valid, int B, int n_seg,
                   int32_t* __restrict__ counts,
                   const FluxField* __restrict__ fields, int F, int L, int p,
                   int vec16, const uint8_t* __restrict__ comp,
                   const int32_t* __restrict__ comp_len, int Bc, int W,
                   int comp_vec16, int32_t* __restrict__ table, int d,
                   int w) {
  const int task = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (task == 0) {
    if (i >= B) return;
    const int s = seg[i];
    const int v = valid[i];
    if (v != 0 && static_cast<unsigned>(s) < static_cast<unsigned>(n_seg)) {
      atomicAdd(counts + s, v);
    }
    return;
  }
  if (task <= F) {
    if (i >= B) return;
    const FluxField f = fields[task - 1];
    const int length = f.lengths[i];
    if (length < 0) return;
    const int s = seg[i];
    if (static_cast<unsigned>(s) >= static_cast<unsigned>(n_seg)) return;
    const uint32_t h = row_hash(f.batch + (long long)i * L, length, L, vec16);
    const uint32_t idx = h >> (32 - p);
    const int rank = min(__clz(h << p) + 1, 33 - p);
    atomicMax(f.stack + ((long long)s << p) + idx, rank);
    return;
  }
  if (i >= Bc) return;
  const int length = comp_len[i];
  if (length < 0) return;
  const uint32_t h1 = row_hash(comp + (long long)i * W, length, W, comp_vec16);
  const uint32_t h2 = fmix32(h1) | 1u;
  for (int r = 0; r < d; ++r) {
    const uint32_t col = (h1 + static_cast<uint32_t>(r) * h2) %
                         static_cast<uint32_t>(w);
    atomicAdd(table + (long long)r * w + col, 1);
  }
}

// The shard merge: base[i] = max(base[i], parts[s][i]) (op 0, HLL
// registers and register stacks) or base[i] + sum over s of parts[s][i]
// (op 1, counts and count-min deltas) for s in [0, n), parts a
// contiguous [n, numel] buffer. The reference's pmax(max(snapshot,
// updates of shard s)) is max(snapshot, max over s of the updates), and
// its table + psum(delta) is the table plus the sum of the deltas, so
// this equals it bit for bit. Adds go through the unsigned type of the
// same width: two's complement wraps exactly as XLA's integer adds do.
//
// What bounds it on an H100: bytes. Each element reads n + 1 words and
// writes one, with no reuse, so one thread per element, grid-stride,
// with neighbouring threads on neighbouring words (coalesced), is the
// whole design; the n loads of a thread are independent and in flight
// together. At its largest operand, 8 partial stacks of 512 x 4096
// int32, that is 72 MiB of traffic, ~0.02 ms at HBM3's rate. Wider
// loads (int4) and folding the merge into the shards' last launch are
// later levers.
template <typename S, typename U>
__global__ void __launch_bounds__(kThreads)
shard_merge_kernel(const S* __restrict__ parts, int n, S* __restrict__ base,
                   long long numel, int op_add) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < numel; i += stride) {
    S acc = base[i];
    if (op_add) {
      U sum = static_cast<U>(acc);
      for (int s = 0; s < n; ++s) {
        sum += static_cast<U>(__ldg(parts + s * numel + i));
      }
      acc = static_cast<S>(sum);
    } else {
      for (int s = 0; s < n; ++s) {
        const S v = __ldg(parts + s * numel + i);
        acc = v > acc ? v : acc;
      }
    }
    base[i] = acc;
  }
}

int grid_for(int B) { return (B + kThreads - 1) / kThreads; }

}  // namespace

// Plain-C launchers (bound with ctypes). Pointers are device pointers of
// contiguous tensors: batch u8 [B, L], lengths i32 [B], registers i32
// [2^p], weights i32 [B] or null (unit weights), table i32 or i64 [d, w]
// (table_i64 = 1 for i64). Each launches on `stream`, does not
// synchronise, and returns cudaGetLastError() (0 on success; nothing is
// launched when B == 0).
extern "C" int hll_update_launch(const void* batch, const void* lengths,
                                 void* registers, int B, int L, int p,
                                 int vec16, void* stream) {
  if (B <= 0) return 0;
  hll_update_kernel<<<grid_for(B), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(batch), static_cast<const int32_t*>(lengths),
      static_cast<int32_t*>(registers), B, L, p, vec16);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cms_update_launch(const void* batch, const void* lengths,
                                 const void* weights, void* table, int B,
                                 int L, int d, int w, int table_i64, int vec16,
                                 void* stream) {
  if (B <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* bt = static_cast<const uint8_t*>(batch);
  const auto* ln = static_cast<const int32_t*>(lengths);
  const auto* wt = static_cast<const int32_t*>(weights);
  if (table_i64) {
    cms_update_kernel<unsigned long long><<<grid_for(B), kThreads, 0, s>>>(
        bt, ln, wt, static_cast<unsigned long long*>(table), B, L, d, w,
        vec16);
  } else {
    cms_update_kernel<int><<<grid_for(B), kThreads, 0, s>>>(
        bt, ln, wt, static_cast<int*>(table), B, L, d, w, vec16);
  }
  return static_cast<int>(cudaGetLastError());
}

// K10 / K9. seg, valid i32 [B]; counts i32 [n_seg], zeroed by the caller;
// fields: a device array of F FluxField (null when F = 0), each batch
// u8 [B, L]; comp u8 [Bc, W] and comp_len i32 [Bc] (null and Bc = 0 for
// no composites); table i32 [d, w]. Every output is updated in place.
// Nothing is launched when B and Bc are both 0.
extern "C" int flux_absorb_launch(const void* seg, const void* valid, int B,
                                  int n_seg, void* counts, const void* fields,
                                  int F, int L, int p, int vec16,
                                  const void* comp, const void* comp_len,
                                  int Bc, int W, int comp_vec16, void* table,
                                  int d, int w, void* stream) {
  const int rows = B > Bc ? B : Bc;
  if (rows <= 0) return 0;
  const dim3 grid(grid_for(rows), F + (Bc > 0 ? 2 : 1));
  flux_absorb_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(seg), static_cast<const int32_t*>(valid), B,
      n_seg, static_cast<int32_t*>(counts),
      static_cast<const FluxField*>(fields), F, L, p, vec16,
      static_cast<const uint8_t*>(comp), static_cast<const int32_t*>(comp_len),
      Bc, W, comp_vec16, static_cast<int32_t*>(table), d, w);
  return static_cast<int>(cudaGetLastError());
}

// The shard merge. parts i32 or i64 [n, numel] (contiguous), base the same
// dtype [numel]: op 0 takes the max, op 1 adds (table_i64 = 1 for i64).
// Nothing is launched when numel or n is 0.
extern "C" int shard_merge_launch(const void* parts, int n, void* base,
                                  long long numel, int op, int table_i64,
                                  void* stream) {
  if (numel <= 0 || n <= 0) return 0;
  // a grid-stride loop: at most 16 blocks of 256 per SM of the 132
  const long long want = (numel + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  const auto s = static_cast<cudaStream_t>(stream);
  if (table_i64) {
    shard_merge_kernel<long long, unsigned long long>
        <<<grid, kThreads, 0, s>>>(static_cast<const long long*>(parts), n,
                                   static_cast<long long*>(base), numel, op);
  } else {
    shard_merge_kernel<int, unsigned int><<<grid, kThreads, 0, s>>>(
        static_cast<const int*>(parts), n, static_cast<int*>(base), numel,
        op);
  }
  return static_cast<int>(cudaGetLastError());
}
