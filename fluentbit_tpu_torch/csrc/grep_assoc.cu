// grep_assoc.cu — the parallel-in-time DFA walk for filter_grep and
// filter_rewrite_tag.
//
// Replaces one device program of the reference package
// (fluentbit_tpu/ops/grep.py):
//   K4 GrepProgram._match_assoc_impl  (:413)  segment transition functions
//      over all states, a log-depth composition tree, the read at starts
// and computes the same verdict as GrepProgram.match with kernel="assoc":
//   matched[r, b] = (F_line[starts[r]] == ACC) && lengths[r, b] >= 0,
// bit-identical to the scan (K3, grep_dfa.cu) and to match_assoc_plain.
//
// Layout: blocks of 8 warps, one rule per block row (blockIdx.y). The
// block stages the rule's uint16 table (tab16, symbol-major:
// tab[sym * n_states[r] + s], at the rule's stride kp[r] <= k) into shared
// memory with one bulk copy, and its class map beside it, once for every
// row it walks. A warp walks Q = 32 / P rows at a time: lane (q, s) holds
// state s (and s + 32 when the program has more than 32 states) of row q,
// P the program's state count rounded up to 8, 16 or 32. A row's
// n_sym = min(len, L) / kp + 1 super-symbols (the last always holds the
// EOL class) cut into G = ceil(n_sym / m) segments of m, and the segments
// into windows of W, a power of two with W x m <= 256 symbols (8 at
// m = 32; one segment above 128; fewer where the wrapper's shared-memory
// budget says so), whose symbols the warp's slot holds one window at a
// time, so that a block's shared memory does not grow with L. For each
// window:
//   1. the row's P lanes load its 16 B pieces within the window, up to
//      the row's length (no piece past it is loaded; bytes past it inside
//      the last piece read as EOL), map them through the class map and
//      pack the super-symbols at stride kp (1, 2 or 4, the strides
//      TorchGrepProgram builds K4's tables at; a lane packs its own 16
//      bytes), as table offsets sym * S in the slot;
//   2. lane s walks the window's segments from state s, 8 at a time as
//      independent chains in registers: f_g[s] = T_m(...T_1(s));
//   3. the segment functions compose in registers, (f∘g)[s] = g[f[s]]:
//      lane s reads g at lane f[s] with one __shfl_sync (two above 32
//      states), in log2(8) rounds with no shared memory and no block
//      barrier; the composed function is read at the row's state
//      (starts[r] at first), which carries to the next 8 segments.
// Segments past the one that holds the first EOL class are left out. They
// hold only EOL super-symbols, and by the DFA contract (DEAD and ACC map to
// themselves on every class, the EOL class sends every state to DEAD or
// ACC; TorchGrepProgram checks it when it builds its tables) the first EOL
// class already put every walk from starts[r] in DEAD or ACC, which every
// later segment maps to itself: the reference's tree composes them, and
// leaving them out gives the same state. The same argument lets the last
// segment stop at n_sym. tests/test_torch_assoc.py pins it against the
// reference. A row with a negative length walks nothing and never matches.
// Lanes of states s >= n_states[r] keep the identity: unreachable from
// starts[r], and no load leaves the rule's table.
//
// Counts epilogue (K5's per-rule totals, counts[r] = sum_b mask[r, b]):
// when `counts` is not null, each warp ballots its rows' verdicts and its
// first lane adds the popcount with one atomicAdd.
//
// What bounds it on an H100: latency. A row's sequential depth is, per
// window, one L2 round trip for its bytes, the symbol packing, m dependent
// steps of two shared-memory loads each (the symbol, then the table; up to
// 8 segments' chains in flight a lane; a row's lanes read one 2S-byte
// symbol row of the table, so no bank conflict within a row) and log2(8)
// shuffle rounds. Cutting segments shorter, 8 chains of ~n_sym / 8 steps,
// measured slower on the card than 1-3 chains of 32: the warps of an SM
// share its shared-memory pipe, and a chain-step is two loads wherever it
// falls. At config 3's tail read (S <= 12, syslog rows of 60-300 B) the
// launch (~2 us) and each block's fixed start (class map, table, lengths:
// ~1.1-1.6 us, the "empty" time in PERF.md §6) are about half of a
// launch's time.
// Above 64 states (only with kernel="assoc" pinned: "auto" takes the
// scan there) the functions move to shared memory (walk_wide below).
// Blocks of 8 warps measured faster than 4, 16 or 32 on the card (the
// table and class map are staged once per block), and the step loop
// unrolled by 4 faster than not.
// ptxas (-Xptxas -v, sm_90a, CUDA 12.8): 64 registers with functions of
// <= 32 states in registers (no spills), 64 with <= 64 (20 B of spill
// stores and 16 B of spill loads), 60 with wider ones in shared memory
// (no spills). Dynamic shared memory: 1,056 B + the table + 8
// warps x (32 / P) rows x W x m x 2 B, whatever L is (16,384 B of
// symbols at config 3's P = 8 and m = 32).

#include <cstdint>
#include <cuda_runtime.h>

#include "bulk_copy.cuh"

namespace {

using bulk_copy::table_copy;
using bulk_copy::table_wait;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;          // warps per block
constexpr int kChunk = 8;          // segment functions held in registers
constexpr int kClassMapLen = 257;  // 256 bytes + the EOL entry
constexpr int kMaxSmem = 232448;   // a block's shared memory on Hopper
constexpr int kMaxDevices = 64;
constexpr int kClassMapPad = 260;  // 1040 B: keeps the table 16 B aligned
constexpr int kAcc = 1;            // regex/dfa.py ACC
constexpr int kTableOffset = 16 + kClassMapPad * 4;  // mbarrier | cmap | table

// o = "a, then b": o[s] = b[a[s]], b read from the lane that holds state
// a[s] of the same row (shuffle width P; above 32 states P is 32 and a
// lane's second value is state s + 32).
template <int NV>
__device__ __forceinline__ void compose(const int (&a)[NV], const int (&b)[NV],
                                        int (&o)[NV], int P) {
  int t[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    if (NV == 1) {
      t[v] = __shfl_sync(kFull, b[0], a[v], P);
    } else {
      const int lo = __shfl_sync(kFull, b[0], a[v] & 31);
      const int hi = __shfl_sync(kFull, b[NV - 1], a[v] & 31);
      t[v] = a[v] < 32 ? lo : hi;
    }
  }
#pragma unroll
  for (int v = 0; v < NV; ++v) o[v] = t[v];
}

// f[c]: the function's value at state c (the same c on the row's lanes).
template <int NV>
__device__ __forceinline__ int read_at(const int (&f)[NV], int c, int P) {
  if (NV == 1) return __shfl_sync(kFull, f[0], c, P);
  const int lo = __shfl_sync(kFull, f[0], c & 31);
  const int hi = __shfl_sync(kFull, f[NV - 1], c & 31);
  return c < 32 ? lo : hi;
}

// The super-symbols of the 16-byte piece at byte c (a multiple of 16) at
// a stride KP dividing 16, from its 16 classes (a byte each in y), as
// table offsets sym * S: symbols c / KP .. (c + 16) / KP - 1, of which
// those in the window [j0, j0 + win) are written, at syms[sym - j0].
template <int KP>
__device__ __forceinline__ void piece_symbols(const uint32_t (&y)[4], int c,
                                              int C, int S, int j0, int win,
                                              uint16_t* syms) {
#pragma unroll
  for (int t = 0; t < 16 / KP; ++t) {
    int sym = 0;
#pragma unroll
    for (int i = 0; i < KP; ++i) {
      const int p = t * KP + i;
      sym = sym * C + int((y[p >> 2] >> (8 * (p & 3))) & 0xFFu);
    }
    const int j = c / KP + t - j0;
    if (j >= 0 && j < win) syms[j] = static_cast<uint16_t>(sym * S);
  }
}

// Walks segments g0 .. g0 + NG - 1 of the row over the window's symbols
// (syms[j - j0] for the row's symbol j; symbols at or past n_lim, the
// row's or the window's end, are not stepped, so segments past it stay
// the identity), composes them and returns the state the row reaches
// from `cur` after them.
template <int NV, int NG>
__device__ __forceinline__ int walk_chunk(const uint16_t* tab,
                                          const uint16_t* syms, int j0,
                                          int n_lim, int S, int m, int steps,
                                          int g0, int s, int P, int cur) {
  int f[NG][NV];
#pragma unroll
  for (int g = 0; g < NG; ++g) {
#pragma unroll
    for (int v = 0; v < NV; ++v) f[g][v] = s + 32 * v;
  }
#pragma unroll 4
  for (int i = 0; i < steps; ++i) {
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int j = (g0 + g) * m + i;
      if (j < n_lim) {
        const int off = syms[j - j0];
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          if (s + 32 * v < S) f[g][v] = tab[off + f[g][v]];
        }
      }
    }
  }
  if constexpr (NG >= 8) {
    compose<NV>(f[0], f[1], f[0], P);
    compose<NV>(f[2], f[3], f[1], P);
    compose<NV>(f[4], f[5], f[2], P);
    compose<NV>(f[6], f[7], f[3], P);
  }
  if constexpr (NG >= 4) {
    compose<NV>(f[0], f[1], f[0], P);
    compose<NV>(f[2], f[3], f[1], P);
  }
  if constexpr (NG >= 2) compose<NV>(f[0], f[1], f[0], P);
  return read_at<NV>(f[0], cur, P);
}

// Above 64 states (kernel="assoc" pinned on a large program) a row's
// segment functions live in the warp's shared memory instead: lanes walk
// states s = lane, lane + 32, ... of up to `ngw` segments at once
// (`ngw` chains in flight a lane), store f_g[s] in `fbuf` [ngw][S], and
// the row's state then steps through the chunk's functions, one
// broadcast load a segment. Segments g_lo .. g_hi - 1 of the window
// whose symbols syms holds from j0 on; one row a warp; no block barrier.
__device__ __forceinline__ int walk_wide(const uint16_t* tab,
                                         const uint16_t* syms, int j0,
                                         int n_lim, int S, int m,
                                         uint16_t* fbuf, int ngw, int lane,
                                         int cur, int g_lo, int g_hi) {
  for (int g0 = g_lo; g0 < g_hi; g0 += ngw) {
    const int span = min(ngw, g_hi - g0);
    const int steps = min(m, n_lim - g0 * m);
    for (int s0 = lane; s0 < S; s0 += 32) {
      int st[kChunk];
#pragma unroll
      for (int g = 0; g < kChunk; ++g) st[g] = s0;
      for (int i = 0; i < steps; ++i) {
#pragma unroll
        for (int g = 0; g < kChunk; ++g) {
          const int j = (g0 + g) * m + i;
          if (g < span && j < n_lim) st[g] = tab[syms[j - j0] + st[g]];
        }
      }
#pragma unroll
      for (int g = 0; g < kChunk; ++g) {
        if (g < span) fbuf[g * S + s0] = static_cast<uint16_t>(st[g]);
      }
    }
    __syncwarp();
    for (int g = 0; g < span; ++g) cur = fbuf[g * S + cur];
    __syncwarp();  // the next chunk overwrites fbuf
  }
  return cur;
}

// NV = 1 or 2: a function in registers (<= 32 or <= 64 states); NV = 0:
// in shared memory (walk_wide, one row a warp, P = 32).
template <int NV>
__global__ void __launch_bounds__(kWarps * 32)
grep_assoc_kernel(const uint8_t* __restrict__ batch,
                  const int32_t* __restrict__ lengths,
                  const int16_t* __restrict__ tab16,
                  const int32_t* __restrict__ class_maps,
                  const int32_t* __restrict__ c_arr,
                  const int32_t* __restrict__ eol_arr,
                  const int32_t* __restrict__ start_arr,
                  const int32_t* __restrict__ n_states_arr,
                  const int32_t* __restrict__ kp_arr,
                  uint8_t* __restrict__ out, int32_t* __restrict__ counts,
                  int B, int L, int m, long long tab_width, int P, int win,
                  int ngw, int s_alloc, int vec16) {
  // layout: mbarrier (16 B) | class map i32 [260] | table u16
  // [tab_width] | symbols u16 [warps][Q][win] | (NV = 0) segment
  // functions u16 [warps][ngw][s_alloc]
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  int32_t* cmap = reinterpret_cast<int32_t*>(smem + 16);
  uint16_t* tab = reinterpret_cast<uint16_t*>(smem + kTableOffset);
  const int Q = 32 / P;
  uint16_t* sym_slots = tab + tab_width;

  const int r = blockIdx.y;
  if (threadIdx.x == 0) {  // the whole row: no wait for the rule's sizes
    table_copy(tab, tab16 + r * tab_width, unsigned(tab_width) * 2u, bar);
  }
  const int S = n_states_arr[r];
  const int kp = kp_arr[r];
  const int C = c_arr[r];
  const int eol = eol_arr[r];
  const int start = start_arr[r];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int q = lane / P;
  const int s = lane - q * P;
  const int wsegs = win / m;  // segments a window
  uint16_t* syms = sym_slots + (warp * Q + q) * win;
  uint16_t* fbuf = sym_slots + kWarps * Q * win + warp * ngw * s_alloc;
  int eol_sym = 0;  // the all-EOL super-symbol
  for (int i = 0; i < kp; ++i) eol_sym = eol_sym * C + eol;
  const int groups = (B + Q - 1) / Q;
  const int stride = gridDim.x * kWarps;
  // a row's length loads one group ahead (the first while the table lands)
  auto length_of = [&](int grp) {
    const int b = grp * Q + q;
    return grp < groups && b < B ? lengths[(long long)r * B + b] : -1;
  };
  int len_next = length_of(blockIdx.x * kWarps + warp);
  for (int i = threadIdx.x; i < kClassMapLen; i += blockDim.x) {
    cmap[i] = class_maps[(long long)r * kClassMapLen + i];
  }
  __syncthreads();
  table_wait(bar);

  for (int grp = blockIdx.x * kWarps + warp; grp < groups;
       grp += stride) {  // uniform over the warp
    const int b = grp * Q + q;
    const long long row = (long long)r * B + b;
    const int len = len_next;
    len_next = length_of(grp + stride);
    const int lim = len < 0 ? 0 : (len < L ? len : L);
    const int n_sym = len < 0 ? 0 : lim / kp + 1;
    const uint8_t* __restrict__ src = batch + row * L;
    const int segs = __reduce_max_sync(kFull, (n_sym + m - 1) / m);
    const int n_max = __reduce_max_sync(kFull, n_sym);
    int cur = start;
    for (int w0 = 0; w0 < segs; w0 += wsegs) {  // a window of wsegs
      const int j0 = w0 * m;                    // its first symbol
      const int c1 = min(lim, (j0 + win) * kp);
      __syncwarp();  // the previous window's symbols are read
      // the window's symbols: each lane maps the row's 16 B pieces up to
      // the length (no piece past it is loaded) through the class map,
      // positions at or past the length to EOL, and packs them
#pragma unroll 4
      for (int c = ((j0 * kp) & ~15) + 16 * s; c < c1; c += 16 * P) {
        uint32_t x[4] = {0u, 0u, 0u, 0u};
        if (vec16) {  // L % 16 == 0 and a 16 B aligned base
          const uint4 v = __ldg(reinterpret_cast<const uint4*>(src + c));
          x[0] = v.x;
          x[1] = v.y;
          x[2] = v.z;
          x[3] = v.w;
        } else {
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            if (c + i < lim) {
              x[i >> 2] |= uint32_t(src[c + i]) << ((i & 3) * 8);
            }
          }
        }
        uint32_t y[4];
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          y[w] = 0u;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int cls = c + 4 * w + i < lim
                                ? cmap[(x[w] >> (8 * i)) & 0xFF] : eol;
            y[w] |= uint32_t(cls) << (8 * i);
          }
        }
        if (kp == 1) {
          piece_symbols<1>(y, c, C, S, j0, win, syms);
        } else if (kp == 2) {
          piece_symbols<2>(y, c, C, S, j0, win, syms);
        } else {  // 4: the wrapper refuses any other stride
          piece_symbols<4>(y, c, C, S, j0, win, syms);
        }
      }
      // a length on a 16 B boundary leaves the all-EOL symbol unwritten
      const int j_eol = lim / kp - j0;
      if (s == 0 && len >= 0 && lim % 16 == 0 && j_eol >= 0 && j_eol < win) {
        syms[j_eol] = static_cast<uint16_t>(eol_sym * S);
      }
      __syncwarp();
      const int g_hi = min(segs, w0 + wsegs);
      const int n_lim = min(n_sym, g_hi * m);
      if constexpr (NV == 0) {
        cur = walk_wide(tab, syms, j0, n_lim, S, m, fbuf, ngw, lane, cur, w0,
                        g_hi);
      } else {
        for (int g0 = w0; g0 < g_hi; g0 += kChunk) {  // 8 segments at once
          const int span = g_hi - g0;
          const int steps = min(m, n_max - g0 * m);
          if (span > 4) {
            cur = walk_chunk<NV, 8>(tab, syms, j0, n_lim, S, m, steps, g0, s,
                                    P, cur);
          } else if (span > 2) {
            cur = walk_chunk<NV, 4>(tab, syms, j0, n_lim, S, m, steps, g0, s,
                                    P, cur);
          } else if (span > 1) {
            cur = walk_chunk<NV, 2>(tab, syms, j0, n_lim, S, m, steps, g0, s,
                                    P, cur);
          } else {
            cur = walk_chunk<NV, 1>(tab, syms, j0, n_lim, S, m, steps, g0, s,
                                    P, cur);
          }
        }
      }
    }
    const bool hit = len >= 0 && cur == kAcc;
    if (s == 0 && b < B) out[row] = hit ? 1 : 0;
    if (counts != nullptr) {
      const unsigned ballot = __ballot_sync(kFull, s == 0 && hit);
      if (lane == 0 && ballot != 0u) atomicAdd(counts + r, __popc(ballot));
    }
  }
}

template <int NV>
int launch(dim3 grid, int smem, cudaStream_t stream, const void* batch,
           const void* lengths, const void* tab16, const void* class_maps,
           const void* c_arr, const void* eol_arr, const void* start_arr,
           const void* n_states_arr, const void* kp_arr, void* out,
           void* counts, int B, int L, int m, long long tab_width, int P,
           int win, int ngw, int s_alloc, int vec16) {
  if (smem > 48 * 1024) {  // once a device: let the kernel take 227 KB
    static bool opened[kMaxDevices] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev >= kMaxDevices || !opened[dev]) {
      e = cudaFuncSetAttribute(grep_assoc_kernel<NV>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem);
      if (e != cudaSuccess) return static_cast<int>(e);
      if (dev < kMaxDevices) opened[dev] = true;
    }
  }
  grep_assoc_kernel<NV><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const uint8_t*>(batch),
      static_cast<const int32_t*>(lengths),
      static_cast<const int16_t*>(tab16),
      static_cast<const int32_t*>(class_maps),
      static_cast<const int32_t*>(c_arr), static_cast<const int32_t*>(eol_arr),
      static_cast<const int32_t*>(start_arr),
      static_cast<const int32_t*>(n_states_arr),
      static_cast<const int32_t*>(kp_arr), static_cast<uint8_t*>(out),
      static_cast<int32_t*>(counts), B, L, m, tab_width, P, win, ngw,
      s_alloc, vec16);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain-C launcher (bound with ctypes). Pointers are device pointers of
// contiguous tensors: batch u8 [R, B, L], lengths i32 [R, B], tab16 u16
// [R, tab_width] (tab_width a multiple of 8), class_maps i32 [R, 257],
// C/eol/starts/n_states/kp i32 [R], out bool [R, B], counts i32 [R] or
// null (when set, each rule's matched rows are added to it). S is the
// program's largest state count, m the segment length, P the lanes of a
// row (8, 16 or 32; S rounded up, 32 above 32 states), win a row's
// symbol slots (a window of win / m segments, a power of two), ngw the
// segments walked at once above 64 states (their functions in shared
// memory; 0 up to 64), gx the blocks of a rule and `smem` the dynamic
// shared bytes, all from the wrapper's assoc_block. Every kp[r] must be
// 1, 2 or 4 (the wrapper checks it).
// Launches on `stream`, does not synchronise, and returns the CUDA error
// (0 on success, nothing launched when R * B == 0).
extern "C" int grep_assoc_launch(const void* batch, const void* lengths,
                                 const void* tab16, const void* class_maps,
                                 const void* c_arr, const void* eol_arr,
                                 const void* start_arr,
                                 const void* n_states_arr, const void* kp_arr,
                                 void* out, void* counts, int R, int B, int L,
                                 int S, int m, long long tab_width, int P,
                                 int win, int ngw, int gx, int smem,
                                 int vec16, void* stream) {
  if (R <= 0 || B <= 0) return 0;
  const bool wide = S > 64;
  const int wsegs = m < 1 || win % m ? 0 : win / m;
  if (S < 1 || m < 1 || gx < 1 || !(P == 8 || P == 16 || P == 32) ||
      (S <= 32 ? S > P : P != 32) || wsegs < 1 || (wsegs & (wsegs - 1)) ||
      (wide ? ngw < 1 || ngw > kChunk : ngw != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(gx, R);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wide) {
    return launch<0>(grid, smem, st, batch, lengths, tab16, class_maps, c_arr,
                     eol_arr, start_arr, n_states_arr, kp_arr, out, counts, B,
                     L, m, tab_width, P, win, ngw, S, vec16);
  }
  if (S > 32) {
    return launch<2>(grid, smem, st, batch, lengths, tab16, class_maps, c_arr,
                     eol_arr, start_arr, n_states_arr, kp_arr, out, counts, B,
                     L, m, tab_width, P, win, 0, S, vec16);
  }
  return launch<1>(grid, smem, st, batch, lengths, tab16, class_maps, c_arr,
                   eol_arr, start_arr, n_states_arr, kp_arr, out, counts, B, L,
                   m, tab_width, P, win, 0, S, vec16);
}
