// sketch.cu — HyperLogLog and count-min updates for filter_log_to_metrics.
//
// Replaces two device programs of the reference package
// (fluentbit_tpu/ops/sketch.py):
//   K6 HyperLogLog._update_impl (:137) with _fnv1a_scan (:40), _mix (:66)
//      and hll_index_rank (:76): registers.at[idx].max(rank)
//   K7 CountMin._update_impl (:267) with CountMin._hashes (:260):
//      table.at[r, cols[r]].add((lengths >= 0) * weight) for each depth row
// and updates the sketch state in place, which is the reference's
// functional result committed.
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
