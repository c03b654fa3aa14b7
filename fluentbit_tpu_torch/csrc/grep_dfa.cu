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
// One thread per (rule r, row b); a block holds blockDim.x rows of one
// rule (blockIdx.y). The thread walks its row 16 super-symbols at a time: it
// loads the chunk's 16 * ks bytes (ks uint4 loads), maps each byte through
// the rule's class map (in shared memory), packs ks classes at radix C[r]
// into each super-symbol, and then takes the chunk's 16 dependent table
// steps while the next chunk's bytes load and its symbols form (walk_row,
// instantiated for ks = 1..6). Symbols are formed from the per-byte class
// map whatever the stride: K2's pair tables are only a faster route to
// the same super-symbols.
//
// Stop rule (exact by the DFA contract: DEAD = 0 and ACC = 1 map to
// themselves on every class, and the EOL class sends every state to DEAD
// or ACC; TorchGrepProgram checks it when it builds its tables):
//   - the walk feeds the min(len, L) bytes before the row's length, then
//     one super-step holding the EOL class: the last, partial step padded
//     with EOL classes, or a full EOL step when the bytes fill whole
//     steps. The reference feeds every position up to L and k or more EOL
//     classes after them; past the first EOL class its state no longer
//     moves, so both end in the same state;
//   - it leaves the loop once the state is DEAD or ACC (checked per chunk
//     of 16 symbols; steps past n_sym inside the last chunk are all-EOL
//     symbols from DEAD or ACC, which stay put);
//   - a row with a negative length takes no step and never matches.
// No 16 B piece past a row's length is loaded, and no byte past it is fed
// (the raw path stages rows without zeroing them).
//
// Two halves of one design, both on the card:
//   - shared (SHARED = true): the rule's uint16 table at its own stride
//     ks = kp[r] <= k, symbol-major (tab16[r][sym * n_states[r] + s]), is
//     staged once per block into shared memory by one bulk copy
//     (cp.async.bulk, completion on an mbarrier); each step is then one
//     shared-memory load, state = tab[sym * S + state]. The wrapper
//     builds the table at the largest stride whose S * C^ks * 2 bytes fit
//     half an SM's shared memory, so that two blocks share an SM
//     (apache2: 690 states, 8 classes, ks = 2, 88,320 B);
//   - global (SHARED = false): a program whose table fits at no stride
//     steps through trans_flat[r, state * Ck[r] + sym] at the program's k,
//     served from L2, as before.
//
// Counts epilogue (K5's per-rule totals, the reference's
//   counts[r] = sum_b mask[r, b]   at fluentbit_tpu/ops/grep.py:679-691):
// when `counts` is not null, each warp ballots its 32 verdicts (all of one
// rule) and its first lane adds the popcount with one atomicAdd. Every
// lane of the warp reaches the ballot: an early stop leaves the walk's
// loop, it never returns.
//
// What bounds it on an H100: latency, not bytes. A launch costs ~2 us
// before any work, a block then waits for its class map and table (88 KB
// for apache2: ~1.6 us together, the "empty" time in PERF.md §6), and a
// row is a chain of ~len / ks + 1 dependent shared-memory loads, so the
// longest row of the batch sets the rest (~35 ns a step). Blocks of
// 4 warps (8 above 2 blocks an SM: scan_block) beat one warp a block on
// the card although they leave SMs idle at 1024 or 4096 rows: every block
// stages the table, and a row's chain is no shorter on an idle SM.
// ptxas (-Xptxas -v, sm_90a, CUDA 12.8): 61 registers for the global half,
// 64 for the shared half, no spills; dynamic shared memory 1,056 B + the
// table (89,376 B for apache2).

#include <cstdint>
#include <cuda_runtime.h>

#include "bulk_copy.cuh"

namespace {

using bulk_copy::table_copy;
using bulk_copy::table_wait;

constexpr int kMaxThreads = 256;
constexpr int kClassMapLen = 257;  // 256 bytes + the EOL entry
constexpr int kMaxSmem = 232448;   // a block's shared memory on Hopper
constexpr int kMaxDevices = 64;
constexpr int kClassMapPad = 260;  // 1040 B: keeps the table 16 B aligned
constexpr int kAcc = 1;            // regex/dfa.py ACC (DEAD = 0 below it)
constexpr int kTableOffset = 16 + kClassMapPad * 4;  // mbarrier | cmap | table

// Bytes [b0, b0 + 16 * KS) of the row as 4 * KS little-endian words;
// bytes at or past `lim` are never read (they come back 0).
template <int KS>
__device__ __forceinline__ void row_words(const uint8_t* __restrict__ src,
                                          int b0, int lim, int vec16,
                                          uint32_t (&w)[4 * KS]) {
#pragma unroll
  for (int i = 0; i < KS; ++i) {
    const int base = b0 + 16 * i;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (base < lim) {
      if (vec16) {  // L % 16 == 0 and a 16 B aligned base: one uint4 load
        v = __ldg(reinterpret_cast<const uint4*>(src + base));
      } else {
        uint32_t x[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int q = 0; q < 16; ++q) {
          if (base + q < lim) x[q >> 2] |= uint32_t(src[base + q]) << ((q & 3) * 8);
        }
        v = make_uint4(x[0], x[1], x[2], x[3]);
      }
    }
    w[4 * i] = v.x;
    w[4 * i + 1] = v.y;
    w[4 * i + 2] = v.z;
    w[4 * i + 3] = v.w;
  }
}

struct Rule {
  const uint16_t* tab;             // shared half: the staged table
  const int32_t* __restrict__ tf;  // global half: the rule's trans_flat row
  int S, Ck, C, eol;
};

// The 16 super-symbols of one chunk, each as the part of its table index
// that does not depend on the state (sym * S in the shared half's
// symbol-major table, sym in trans_flat): KS classes a symbol, bytes at
// or past `lim` read as the EOL class.
template <int KS, bool SHARED>
__device__ __forceinline__ void chunk_symbols(const Rule& u, const int* cmap,
                                              const uint32_t (&w)[4 * KS],
                                              int b0, int lim,
                                              int (&off)[16]) {
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    int sym = 0;
#pragma unroll
    for (int i = 0; i < KS; ++i) {
      const int p = q * KS + i;
      const int byte = (w[p >> 2] >> ((p & 3) * 8)) & 0xFF;
      sym = sym * u.C + (b0 + p < lim ? cmap[byte] : u.eol);
    }
    off[q] = SHARED ? sym * u.S : sym;
  }
}

// The verdict of one row under the stop rule: n_sym = min(len, L) / KS
// + 1 super-symbols (the last holds the EOL class), 16 at a time; the
// next chunk's bytes load, and its symbols form, while this chunk's 16
// dependent table steps run. Steps past n_sym are all-EOL symbols from
// DEAD or ACC, which map to themselves, so a chunk runs whole.
template <int KS, bool SHARED>
__device__ __forceinline__ bool walk_row(const Rule& u, const int* cmap,
                                         const uint8_t* __restrict__ src,
                                         int len, int L, int start,
                                         int vec16) {
  if (len < 0) return false;
  const int lim = len < L ? len : L;
  const int n_sym = lim / KS + 1;
  int state = start;
  uint32_t w[4 * KS];
  int off[16];
  row_words<KS>(src, 0, lim, vec16, w);
  chunk_symbols<KS, SHARED>(u, cmap, w, 0, lim, off);
  for (int t0 = 0; t0 < n_sym && state > kAcc; t0 += 16) {
    const int b1 = (t0 + 16) * KS;
    row_words<KS>(src, b1, lim, vec16, w);
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      state = SHARED ? u.tab[off[q] + state]
                     : __ldg(u.tf + state * u.Ck + off[q]);
    }
    chunk_symbols<KS, SHARED>(u, cmap, w, b1, lim, off);
  }
  return state == kAcc;
}

// One row's verdict at its stride (uniform over the block: one rule).
template <bool SHARED>
__device__ __forceinline__ bool walk_at(int ks, const Rule& u,
                                        const int* cmap,
                                        const uint8_t* __restrict__ src,
                                        int len, int L, int start,
                                        int vec16) {
  switch (ks) {
    case 1: return walk_row<1, SHARED>(u, cmap, src, len, L, start, vec16);
    case 2: return walk_row<2, SHARED>(u, cmap, src, len, L, start, vec16);
    case 3: return walk_row<3, SHARED>(u, cmap, src, len, L, start, vec16);
    case 4: return walk_row<4, SHARED>(u, cmap, src, len, L, start, vec16);
    case 5: return walk_row<5, SHARED>(u, cmap, src, len, L, start, vec16);
    default: return walk_row<6, SHARED>(u, cmap, src, len, L, start, vec16);
  }
}

template <bool SHARED>
__global__ void __launch_bounds__(kMaxThreads)
grep_dfa_kernel(const uint8_t* __restrict__ batch,
                const int32_t* __restrict__ lengths,
                const int32_t* __restrict__ trans_flat,
                const int16_t* __restrict__ tab16,
                const int32_t* __restrict__ class_maps,
                const int32_t* __restrict__ c_arr,
                const int32_t* __restrict__ ck_arr,
                const int32_t* __restrict__ eol_arr,
                const int32_t* __restrict__ start_arr,
                const int32_t* __restrict__ n_states_arr,
                const int32_t* __restrict__ kp_arr, uint8_t* __restrict__ out,
                int32_t* __restrict__ counts, int B, int L, int k,
                long long max_flat, long long tab_width, int vec16) {
  // layout: mbarrier (16 B) | class map i32 [260] | table u16 (shared half)
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  int32_t* cmap = reinterpret_cast<int32_t*>(smem + 16);
  uint16_t* tab = reinterpret_cast<uint16_t*>(smem + kTableOffset);

  const int r = blockIdx.y;
  if (SHARED && threadIdx.x == 0) {  // the whole row: no wait for sizes
    table_copy(tab, tab16 + r * tab_width, unsigned(tab_width) * 2u, bar);
  }
  const int ks = SHARED ? kp_arr[r] : k;
  Rule u;
  u.C = c_arr[r];
  u.eol = eol_arr[r];
  if (SHARED) {
    u.S = n_states_arr[r];
    u.Ck = 0;
    u.tab = tab;
    u.tf = nullptr;
  } else {
    u.S = 0;
    u.Ck = ck_arr[r];
    u.tab = nullptr;
    u.tf = trans_flat + (long long)r * max_flat;
  }
  // the row's length and first bytes load while the table lands
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  const long long row = (long long)r * B + b;
  const bool mine = b < B;
  const int len = mine ? lengths[row] : -1;
  for (int i = threadIdx.x; i < kClassMapLen; i += blockDim.x) {
    cmap[i] = class_maps[(long long)r * kClassMapLen + i];
  }
  __syncthreads();
  if (SHARED) table_wait(bar);

  bool hit = false;
  if (mine) {
    hit = walk_at<SHARED>(ks, u, cmap, batch + row * L, len, L, start_arr[r],
                          vec16);
    out[row] = hit ? 1 : 0;
  }
  if (counts != nullptr) {
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    if ((threadIdx.x & 31) == 0 && ballot != 0u) {
      atomicAdd(counts + r, __popc(ballot));
    }
  }
}

template <bool SHARED>
int launch(dim3 grid, int threads, int smem, cudaStream_t stream,
           const void* batch, const void* lengths, const void* trans_flat,
           const void* tab16, const void* class_maps, const void* c_arr,
           const void* ck_arr, const void* eol_arr, const void* start_arr,
           const void* n_states_arr, const void* kp_arr, void* out,
           void* counts, int B, int L, int k, long long max_flat,
           long long tab_width, int vec16) {
  if (smem > 48 * 1024) {  // once a device: let the kernel take 227 KB
    static bool opened[kMaxDevices] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev >= kMaxDevices || !opened[dev]) {
      e = cudaFuncSetAttribute(grep_dfa_kernel<SHARED>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem);
      if (e != cudaSuccess) return static_cast<int>(e);
      if (dev < kMaxDevices) opened[dev] = true;
    }
  }
  grep_dfa_kernel<SHARED><<<grid, threads, smem, stream>>>(
      static_cast<const uint8_t*>(batch), static_cast<const int32_t*>(lengths),
      static_cast<const int32_t*>(trans_flat),
      static_cast<const int16_t*>(tab16),
      static_cast<const int32_t*>(class_maps),
      static_cast<const int32_t*>(c_arr), static_cast<const int32_t*>(ck_arr),
      static_cast<const int32_t*>(eol_arr),
      static_cast<const int32_t*>(start_arr),
      static_cast<const int32_t*>(n_states_arr),
      static_cast<const int32_t*>(kp_arr), static_cast<uint8_t*>(out),
      static_cast<int32_t*>(counts), B, L, k, max_flat, tab_width, vec16);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain-C launcher (bound with ctypes). Pointers are device pointers of
// contiguous tensors: batch u8 [R, B, L], lengths i32 [R, B], trans_flat
// i32 [R, max_flat], class_maps i32 [R, 257], C/Ck/eol/starts i32 [R],
// out bool [R, B], counts i32 [R] or null (when set, each rule's matched
// rows are added to it). tab16 (u16 [R, tab_width], tab_width a multiple
// of 8), n_states and kp (i32 [R]) are the shared half's table and are
// read only when tab16 is not null; `smem` is the block's dynamic shared
// bytes and `threads` (a multiple of 32, <= 256) the rows a block, from
// the wrapper's scan_block. Launches on `stream`, does not synchronise,
// and returns the CUDA error (0 on success, nothing launched when
// R * B == 0).
extern "C" int grep_dfa_launch(const void* batch, const void* lengths,
                               const void* trans_flat, const void* tab16,
                               const void* class_maps, const void* c_arr,
                               const void* ck_arr, const void* eol_arr,
                               const void* start_arr, const void* n_states_arr,
                               const void* kp_arr, void* out, void* counts,
                               int R, int B, int L, int k, long long max_flat,
                               long long tab_width, int threads, int smem,
                               int vec16, void* stream) {
  if (R <= 0 || B <= 0) return 0;
  if (threads <= 0 || threads > kMaxThreads || threads % 32 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((B + threads - 1) / threads, R);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tab16 != nullptr) {
    return launch<true>(grid, threads, smem, s, batch, lengths, trans_flat,
                        tab16, class_maps, c_arr, ck_arr, eol_arr, start_arr,
                        n_states_arr, kp_arr, out, counts, B, L, k, max_flat,
                        tab_width, vec16);
  }
  return launch<false>(grid, threads, smem, s, batch, lengths, trans_flat,
                       tab16, class_maps, c_arr, ck_arr, eol_arr, start_arr,
                       n_states_arr, kp_arr, out, counts, B, L, k, max_flat,
                       tab_width, vec16);
}
