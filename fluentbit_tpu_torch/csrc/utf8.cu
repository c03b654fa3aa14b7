// utf8.cu — RFC 3629 UTF-8 validation of staged rows.
//
// Replaces the reference package's K11, Utf8Validator._impl
// (fluentbit_tpu/ops/utf8.py:121): a lax.scan of table gathers over the
// columns of a [B, L] u8 batch, 12 byte classes x 9 states (overlongs,
// UTF-16 surrogates ED A0..BF and code points above U+10FFFF rejected),
// and computes the same verdict:
//   valid[b] = walk(row b) == OK && lengths[b] >= 0,
// where positions at or past lengths[b] count as ASCII.
//
// One thread per row. The 256-entry class map and the 9 x 12 transition
// table sit in shared memory (as bytes; the wrapper hands them over as the
// reference's int32 tables). The thread walks its row's first
// min(lengths[b], L) bytes, 16 B at a time when the row width and base
// allow, and stops once the state is DEAD. Both shortcuts are exact:
//   - ASCII keeps OK at OK and takes every other state to DEAD, so the
//     padded tail only matters through the state at the length: a
//     sequence cut at the length ends in a state other than OK and fails,
//     as in the reference;
//   - DEAD has no transition out (_transitions never writes the DEAD
//     row), so the verdict is False from the first DEAD on.
// A row with a negative length (-1: missing value, -2: overflow row) is
// False without reading a byte.
//
// What bounds it on an H100: each row is a chain of dependent shared-memory
// lookups, one per byte up to the length or the first invalid byte; the
// bytes read (at most B * L + 4B, one bool out per row) are a few MB at the
// main path's [4096, 512], well under a microsecond of HBM time. So the
// chain's latency bounds it, as K3's does, with a table in shared memory
// instead of L2. The design keeps the chain free of global traffic (row
// bytes in registers, 16 B loads skipped past the length) and runs one
// row per thread. A warp per row with a parallel-in-time composition, as
// K4 does for grep, is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kClasses = 12;  // ops/utf8.py N_CLASSES
constexpr int kStates = 9;    // ops/utf8.py N_STATES
constexpr int kOk = 0;        // ops/utf8.py OK
constexpr int kDead = 8;      // ops/utf8.py DEAD

__global__ void __launch_bounds__(kThreads)
utf8_validate_kernel(const uint8_t* __restrict__ batch,
                     const int32_t* __restrict__ lengths,
                     const int32_t* __restrict__ class_map,
                     const int32_t* __restrict__ trans,
                     uint8_t* __restrict__ out, int B, int L, int vec16) {
  __shared__ uint8_t cls[256];
  __shared__ uint8_t tr[kStates * kClasses];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    cls[i] = static_cast<uint8_t>(class_map[i]);
  }
  for (int i = threadIdx.x; i < kStates * kClasses; i += blockDim.x) {
    tr[i] = static_cast<uint8_t>(trans[i]);
  }
  __syncthreads();

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int len = lengths[b];
  if (len < 0) {
    out[b] = 0;
    return;
  }
  const int n = len < L ? len : L;
  const uint8_t* __restrict__ src = batch + static_cast<long long>(b) * L;
  int state = kOk;
  if (vec16) {  // L % 16 == 0 and a 16 B aligned base: uint4 row loads
    for (int base = 0; base < n && state != kDead; base += 16) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(src + base));
      const uint32_t words[4] = {v.x, v.y, v.z, v.w};
      const int m = n - base;
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        if (q < m) {
          const int byte = (words[q >> 2] >> ((q & 3) * 8)) & 0xFF;
          state = tr[state * kClasses + cls[byte]];
        }
      }
    }
  } else {
    for (int pos = 0; pos < n && state != kDead; ++pos) {
      state = tr[state * kClasses + cls[src[pos]]];
    }
  }
  out[b] = state == kOk ? 1 : 0;
}

}  // namespace

// Plain-C launcher (bound with ctypes). Pointers are device pointers of
// contiguous tensors: batch u8 [B, L], lengths i32 [B], class_map i32
// [256], trans i32 [9 * 12] (row-major [state, class]), out bool [B].
// Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() (0 on success, nothing launched when B == 0).
extern "C" int utf8_validate_launch(const void* batch, const void* lengths,
                                    const void* class_map, const void* trans,
                                    void* out, int B, int L, int vec16,
                                    void* stream) {
  if (B <= 0) return 0;
  const int blocks = (B + kThreads - 1) / kThreads;
  utf8_validate_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(batch), static_cast<const int32_t*>(lengths),
      static_cast<const int32_t*>(class_map),
      static_cast<const int32_t*>(trans), static_cast<uint8_t*>(out), B, L,
      vec16);
  return static_cast<int>(cudaGetLastError());
}
