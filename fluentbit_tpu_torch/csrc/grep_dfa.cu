// grep_dfa.cu — fused super-symbol prepass + DFA walk for filter_grep.
//
// Replaces three device programs of the reference package
// (fluentbit_tpu/ops/grep.py):
//   K1 GrepProgram._super_symbols        (:314)  byte → class → k-stride symbol
//   K2 GrepProgram._super_symbols_pairs  (:343)  the even-k byte-pair variant
//   K3 GrepProgram._match_impl           (:394)  lax.scan of table gathers
// and computes the same verdict as GrepProgram.match:
//   matched[r, b] = (walk(r, b) == ACC) && lengths[r, b] >= 0.
//
// One thread per (rule r, row b). The thread reads its row's bytes 16 B at
// a time, maps each byte through the rule's class map (staged in shared
// memory; positions >= lengths[r, b] take the EOL class), packs k classes
// at radix C[r] into one super-symbol and steps
//   state = trans_flat[r, state * Ck[r] + sym].
// Bytes past a row's length are never read as data (they may be anything:
// the raw path stages rows without zeroing them). No [R, B, Lk] symbol
// array exists in device memory. Even-k programs form
// their symbols from the per-byte class map too: K2's pair table is only a
// faster route to the same super-symbols, so the symbols are equal by
// construction.
//
// End of row: the walk mirrors the reference's padding exactly. After the
// L staged positions it feeds extra = (k - L % k) % k + k EOL classes, so
// at least one full EOL super-step follows the last byte (patterns ending
// in `$` reach ACC only through the EOL class). It does not stop early at
// the row's length; every row walks Lk = (L + extra) / k super-steps.
//
// Counts epilogue (K5's per-rule totals, the reference's
//   counts[r] = sum_b mask[r, b]   at fluentbit_tpu/ops/grep.py:679-691):
// when `counts` is not null, each warp ballots its 32 verdicts (all of one
// rule: a block's rows share blockIdx.y) and its first lane adds the
// popcount with one atomicAdd. No second pass over the mask.
//
// What bounds it on an H100: each row is a chain of Lk dependent gathers
// from trans_flat (1.41 MB for the apache2 rule, k = 3, Lk = 172 at
// L = 512), served from L2 (50 MB) once warm. So latency of that chain, not
// the R*B*L bytes read, sets the time; the design keeps the chain free of
// any other memory traffic (class map in shared memory, row bytes in
// registers, 16 B loads skipped past the row's length) and runs enough rows
// in flight (one per thread, 65536 per bucket) to hide it. Shared-memory
// tables (k = 2 would give 690 x 64 x 4 B = 176 KB) and early exit are
// left for later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kClassMapLen = 257;  // 256 bytes + the EOL entry
constexpr int kAcc = 1;            // regex/dfa.py ACC

struct Walk {
  int state;
  int sym;
  int j;
};

__device__ __forceinline__ void feed(Walk& w, int cls, int C, int k, int Ck,
                                     const int32_t* __restrict__ tf) {
  w.sym = w.sym * C + cls;
  if (++w.j == k) {
    w.state = __ldg(tf + w.state * Ck + w.sym);
    w.sym = 0;
    w.j = 0;
  }
}

// Walks row (r, b), writes its verdict to out and returns it.
__device__ __forceinline__ bool walk_row(
    const uint8_t* __restrict__ batch, const int32_t* __restrict__ lengths,
    const int32_t* __restrict__ trans_flat, const int32_t* cmap,
    const int32_t* __restrict__ c_arr, const int32_t* __restrict__ ck_arr,
    const int32_t* __restrict__ eol_arr,
    const int32_t* __restrict__ start_arr, uint8_t* __restrict__ out, int r,
    int b, int B, int L, int k, long long max_flat, int vec16) {
  const long long row = (long long)r * B + b;
  const int len = lengths[row];
  const int C = c_arr[r];
  const int Ck = ck_arr[r];
  const int eol = eol_arr[r];
  const int32_t* __restrict__ tf = trans_flat + (long long)r * max_flat;
  const uint8_t* __restrict__ src = batch + row * L;
  Walk w{start_arr[r], 0, 0};

  if (vec16) {  // L % 16 == 0 and a 16 B aligned base: uint4 row loads
    for (int base = 0; base < L; base += 16) {
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (base < len) {  // bytes past the length are EOL either way
        v = __ldg(reinterpret_cast<const uint4*>(src + base));
      }
      const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const int byte = (words[q >> 2] >> ((q & 3) * 8)) & 0xFF;
        feed(w, base + q < len ? cmap[byte] : eol, C, k, Ck, tf);
      }
    }
  } else {
    for (int pos = 0; pos < L; ++pos) {
      feed(w, pos < len ? cmap[src[pos]] : eol, C, k, Ck, tf);
    }
  }
  const int extra = (k - L % k) % k + k;
  for (int q = 0; q < extra; ++q) {
    feed(w, eol, C, k, Ck, tf);
  }
  const bool hit = w.state == kAcc && len >= 0;
  out[row] = hit ? 1 : 0;
  return hit;
}

__global__ void __launch_bounds__(kThreads)
grep_dfa_kernel(const uint8_t* __restrict__ batch,
                const int32_t* __restrict__ lengths,
                const int32_t* __restrict__ trans_flat,
                const int32_t* __restrict__ class_maps,
                const int32_t* __restrict__ c_arr,
                const int32_t* __restrict__ ck_arr,
                const int32_t* __restrict__ eol_arr,
                const int32_t* __restrict__ start_arr,
                uint8_t* __restrict__ out, int32_t* __restrict__ counts,
                int B, int L, int k, long long max_flat, int vec16) {
  __shared__ int32_t cmap[kClassMapLen];
  const int r = blockIdx.y;
  for (int i = threadIdx.x; i < kClassMapLen; i += blockDim.x) {
    cmap[i] = class_maps[(long long)r * kClassMapLen + i];
  }
  __syncthreads();

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  // every thread of the block stays to the end: the counts epilogue's
  // ballot needs all 32 lanes of each warp
  const bool hit = b < B && walk_row(batch, lengths, trans_flat, cmap, c_arr,
                                     ck_arr, eol_arr, start_arr, out, r, b,
                                     B, L, k, max_flat, vec16);
  if (counts != nullptr) {
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    if ((threadIdx.x & 31) == 0 && ballot != 0u) {
      atomicAdd(counts + r, __popc(ballot));
    }
  }
}

}  // namespace

// Plain-C launcher (bound with ctypes). Pointers are device pointers of
// contiguous tensors: batch u8 [R, B, L], lengths i32 [R, B], trans_flat
// i32 [R, max_flat], class_maps i32 [R, 257], C/Ck/eol/starts i32 [R],
// out bool [R, B], counts i32 [R] or null (when set, each rule's matched
// rows are added to it). Launches on `stream`, does not synchronise, and
// returns cudaGetLastError() (0 on success, nothing launched when
// R * B == 0).
extern "C" int grep_dfa_launch(const void* batch, const void* lengths,
                               const void* trans_flat, const void* class_maps,
                               const void* c_arr, const void* ck_arr,
                               const void* eol_arr, const void* start_arr,
                               void* out, void* counts, int R, int B, int L,
                               int k, long long max_flat, int vec16,
                               void* stream) {
  if (R <= 0 || B <= 0) return 0;
  dim3 grid((B + kThreads - 1) / kThreads, R);
  grep_dfa_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(batch), static_cast<const int32_t*>(lengths),
      static_cast<const int32_t*>(trans_flat),
      static_cast<const int32_t*>(class_maps),
      static_cast<const int32_t*>(c_arr), static_cast<const int32_t*>(ck_arr),
      static_cast<const int32_t*>(eol_arr),
      static_cast<const int32_t*>(start_arr), static_cast<uint8_t*>(out),
      static_cast<int32_t*>(counts), B, L, k, max_flat, vec16);
  return static_cast<int>(cudaGetLastError());
}
