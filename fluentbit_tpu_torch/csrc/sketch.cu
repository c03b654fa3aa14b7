// sketch.cu — HyperLogLog and count-min updates for filter_log_to_metrics,
// and the flux plane's fused absorb.
//
// Replaces four device programs of the reference package:
//   K6 HyperLogLog._update_impl (ops/sketch.py:137) with _fnv1a_scan (:40),
//      _mix (:66) and hll_index_rank (:76): registers.at[idx].max(rank).
//      One launch serves any number of register arrays: row i updates the
//      array of its group seg[i] (the flux state's branch above 512
//      groups, whose reference runs it per group on the host,
//      flux/state.py:476); the single-array call is G = 1.
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
// Every row is hashed over bytes [0, length) (FNV-1a 32 then the murmur3
// fmix32 finaliser, in native uint32 arithmetic; a negative length hashes
// no byte and its row changes nothing) and scattered with integer atomics
// (max into a register, add into a counter). Integer max and add give the
// same state in any order and any grouping, so the result equals the
// reference's scatter bit for bit.
//
// What bounds K6, K7 and K10 on an H100: neither bytes nor operations. A
// 4096-row append reads at most 1 MiB of row bytes (0.3 us at HBM's rate)
// and makes ~1M integer operations (0.03 us); the state (K6: 2^p words;
// K7: a d x w table, 256 KiB at 4 x 16384 int32; K10: 200 groups x 2^12
// registers, 3.2 MiB, and a 256 KiB table) stays in L2. What costs is
// latency: each row's FNV-1a chain of up to L dependent xor-multiply
// steps (~6 cycles each; the step does not compose into a shorter form,
// so the chain stays serial in one thread), the row's loads in front of
// it, the atomics on a hot word, and the launch. The design:
//   - a block is one warp of 32 rows, so 4096 rows are 128 blocks and
//     reach most of the 132 SMs (K10's tasks in blockIdx.y: 3 x 128);
//   - each lane loads its row's first kHead = 32 bytes into registers
//     before anything waits: the length, the segment id and that head
//     are independent loads, and an identifier or a short composite
//     needs no more (config 4's user ids are 11 bytes; copying a whole
//     window before the lengths were known moved 256 B a row for them);
//   - the rest of a longer row goes to shared memory with cp.async (16 B
//     pieces, coalesced: the 32 rows are contiguous in [B, L]), started
//     once the lengths are in, up to kWin bytes a row at a time and only
//     as far as the warp's longest row, every piece in flight at once. A
//     row's slot is kSlot = kWin + 16 bytes, an odd number of 16 B
//     pieces, so the 8 lanes of a quarter-warp's 16 B shared loads hit
//     distinct banks; each lane reads its next piece before it hashes
//     the current;
//   - a warp walks only as many windows as its longest row needs;
//   - K7's and K10's contended atomics are folded in the warp first (a
//     Zipf group or value puts many lanes of a warp on one count,
//     register or counter; config 4's paths are Zipf(1.1)):
//     lanes on one word combine by __reduce_max_sync / __reduce_add_sync
//     (a popcount for unit weights) into one atomic. The first live
//     lane's word folds; in a launch of kMatchRows rows or more every
//     word does, found by __match_any_sync (see warp_fold). K7 and K10's
//     composites task are one device function (warp_cms_add), and K7's
//     weights sum exactly: an int32 table's mod 2^32, as its atomicAdd
//     wraps, an int64 table's in two 16-bit halves (warp_weight_sum). A
//     block is one warp, so a shared-memory copy of the counts would
//     gather no more lanes than this. K6 does not fold: an HLL counts
//     values of high cardinality (config 4's user ids), where the fold
//     cost K6 more on the card than it saved on the smoke's Zipf rows;
//   - K6's register arrays and K10's field descriptors travel by value
//     in the kernel's parameters (__grid_constant__), so a launch needs
//     no copy to the card first (K6 above 1024 groups excepted).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr uint32_t kFnvOffset = 0x811C9DC5u;
constexpr uint32_t kFnvPrime = 0x01000193u;
constexpr unsigned kFull = 0xFFFFFFFFu;

// murmur3 fmix32 (reference _mix)
__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// ---------------------------------------------------------------------------
// K6, K7 and K10: a warp of 32 rows, staged through shared memory
// ---------------------------------------------------------------------------

constexpr int kWarp = 32;
constexpr int kWin = 256;          // bytes of a row staged at a time
constexpr int kSlot = kWin + 16;   // 17 pieces of 16 B: odd, conflict-free

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Start the copy of bytes [w0 + lo, w0 + hi) of rows r0 .. r0 + 31 (those
// below B; clipped to L) into stage, byte w0 + c of row i at i * kSlot + c;
// lo and hi are multiples of 16, 0 <= lo < hi <= kWin. vec16 (L % 16 ==
// 0, 16 B aligned batch): asynchronous 16 B pieces, completed by
// cp_async_wait_all; else byte copies. Every lane of the warp calls it.
__device__ __forceinline__ void stage_range(uint8_t* stage,
                                            const uint8_t* __restrict__ batch,
                                            int r0, int B, int L, int w0,
                                            int lo, int hi, int vec16,
                                            int lane) {
  const int rows = min(kWarp, B - r0);
  hi = min(hi, L - w0);
  if (rows <= 0 || hi <= lo) return;
  const uint8_t* src = batch + static_cast<long long>(r0) * L + w0;
  if (vec16) {
    // a lane copies piece `col` of every step-th row: neighbouring lanes
    // take neighbouring pieces, and no division is left in the loop
    const int pieces = (hi - lo) >> 4;  // 1 .. 16
    const int step = kWarp / pieces;
    if (lane >= step * pieces) return;
    const int col = lo + ((lane % pieces) << 4);
    for (int row = lane / pieces; row < rows; row += step) {
      cp_async16(stage + row * kSlot + col,
                 src + static_cast<long long>(row) * L + col);
    }
  } else {
    for (int row = 0; row < rows; ++row) {
      for (int col = lo + lane; col < hi; col += kWarp) {
        stage[row * kSlot + col] = __ldg(src + static_cast<long long>(row) * L
                                         + col);
      }
    }
  }
}

// The first kHead bytes of a lane's own row, in registers, loaded before
// its length is known (vec16 only: 16 B loads inside [B, L]; bytes past
// the length are masked when hashed). An identifier or a short composite
// needs no more; longer rows stage the rest of a window once the lengths
// are in, only as far as the warp's longest row.
constexpr int kHead = 32;

struct Head {
  uint4 a, b;  // bytes [0, 16) and [16, 32)
};

__device__ __forceinline__ Head load_head(const uint8_t* __restrict__ batch,
                                          int row, int B, int L, int vec16) {
  Head hd{};
  if (vec16 && row < B && L > 0) {
    const uint4* p = reinterpret_cast<const uint4*>(
        batch + static_cast<long long>(row) * L);
    hd.a = __ldg(p);
    if (L >= kHead) hd.b = __ldg(p + 1);
  }
  return hd;
}

__device__ __forceinline__ int round16(int n) { return (n + 15) & ~15; }

__device__ __forceinline__ uint32_t fnv_piece(uint32_t h, const uint4 v,
                                              int count) {
  const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    if (q < count) {
      h = (h ^ ((words[q >> 2] >> ((q & 3) * 8)) & 0xFFu)) * kFnvPrime;
    }
  }
  return h;
}

// FNV-1a 32 over the first count (0 .. kWin) bytes of a staged slot,
// carrying h. The next piece is read before the current one is hashed;
// a slot has kWin / 16 + 1 pieces, so that read stays inside it.
__device__ __forceinline__ uint32_t fnv_slot(uint32_t h, const uint8_t* slot,
                                             int count) {
  const uint4* piece = reinterpret_cast<const uint4*>(slot);
  const int full = count >> 4;
  uint4 cur = piece[0];
  for (int j = 0; j < full; ++j) {
    const uint4 next = piece[j + 1];
    h = fnv_piece(h, cur, 16);
    cur = next;
  }
  return fnv_piece(h, cur, count & 15);
}

// fmix32(FNV-1a 32) of bytes [0, n) of row r0 + lane, n in [0, L] (0 for
// a lane with no row), hd its load_head: the reference's _fnv1a_scan,
// whose mask is pos < lengths (pad bytes past n are never hashed). With
// vec16 the head is hashed from registers and a warp whose rows all fit
// it touches no shared memory; otherwise the warp stages and walks as
// many windows as its longest row needs, each only as wide as that row.
// Every lane calls it.
__device__ __forceinline__ uint32_t warp_row_hash(uint8_t* stage,
                                                  const uint8_t* __restrict__
                                                      batch,
                                                  int r0, int B, int L,
                                                  int vec16, int n,
                                                  const Head& hd, int lane) {
  const int longest = __reduce_max_sync(kFull, n);
  uint32_t h = kFnvOffset;
  int lo = 0;  // bytes of window 0 already hashed
  if (vec16) {
    h = fnv_piece(h, hd.a, min(n, 16));
    h = fnv_piece(h, hd.b, min(max(n - 16, 0), 16));
    if (longest <= kHead) return fmix32(h);
    lo = kHead;
  }
  stage_range(stage, batch, r0, B, L, 0, lo, round16(min(longest, kWin)),
              vec16, lane);
  const uint8_t* slot = stage + lane * kSlot;
  for (int w0 = 0;; w0 += kWin) {
    cp_async_wait_all();
    __syncwarp();
    h = fnv_slot(h, slot + lo, max(min(n - w0, kWin) - lo, 0));
    if (w0 + kWin >= longest) break;
    lo = 0;
    __syncwarp();  // every lane is done with the window before it is reused
    stage_range(stage, batch, r0, B, L, w0 + kWin, 0,
                round16(min(longest - w0 - kWin, kWin)), vec16, lane);
  }
  return fmix32(h);
}

// The warp's fold of contended atomics. By default the lanes on the first
// live lane's word (a hot group count, register or counter) fold into one
// atomic from that lane, and every other live lane makes its own: one
// broadcast and one ballot. With every_word, __match_any_sync groups
// every word of the warp, one atomic per word. K10 takes every_word from
// kMatchRows rows: with many warps on an SM the match's latency hides,
// while the atomics on a hot group count grow with the rows (on the card,
// the match cost K10 more than it saved at 4096 rows, and saved more than
// it cost at 65536).
constexpr int kMatchRows = 16384;

struct WarpFold {
  unsigned same;  // the live lanes on this lane's word, if folded
  bool lead;      // this lane makes the folded atomic
  bool folded;    // this lane's update is in a folded atomic
};

template <typename K>
__device__ __forceinline__ WarpFold warp_fold(unsigned live_mask, K key,
                                              int lane, bool every_word) {
  if (every_word) {
    const unsigned same = __match_any_sync(live_mask, key);
    return {same, lane == __ffs(same) - 1, true};
  }
  const int first = __ffs(live_mask) - 1;
  const K first_key = __shfl_sync(live_mask, key, first);
  const unsigned same = __ballot_sync(live_mask, key == first_key);
  return {same, lane == first, key == first_key};
}

// *addr = max(*addr, rank) for each live lane. Every lane calls it.
__device__ __forceinline__ void warp_scatter_max(bool live, int32_t* addr,
                                                 int rank, int lane,
                                                 bool every_word) {
  const unsigned live_mask = __ballot_sync(kFull, live);
  if (!live) return;
  const WarpFold f = warp_fold(
      live_mask, reinterpret_cast<unsigned long long>(addr), lane,
      every_word);
  if (!f.folded) {
    atomicMax(addr, rank);
    return;
  }
  const int top = __reduce_max_sync(f.same, rank);
  if (f.lead) atomicMax(addr, top);
}

// HLL register index and rank of a hash at precision p (1 <= p <= 24).
// __clz(0) is 32: rest == 0 saturates at the largest rank, 33 - p.
__device__ __forceinline__ uint32_t hll_index(uint32_t h, int p) {
  return h >> (32 - p);
}
__device__ __forceinline__ int hll_rank(uint32_t h, int p) {
  return min(__clz(h << p) + 1, 33 - p);
}

// K6's register arrays by value, in the kernel's parameters: N pointers,
// N = 1 (one array) or kGroupsByValue (up to 1024 groups, 8 KB). No copy
// to the card before a launch; but the parameters travel with every
// launch, and a 31 KB block of them (CUDA 12.1's limit) cost more than
// the kernel, so above kGroupsByValue groups the pointers come from a
// device array instead (the N = 1 kernel with by_value = 0).
constexpr int kGroupsByValue = 1024;

template <int N>
struct RegPtrs {
  int32_t* p[N];
};

// K6 (hll_update_launch): a block is one warp of 32 rows. Row b updates
// register array seg[b] of the G (with seg null, array 0): regs.p[s]
// (by_value, G <= N), else group_regs[s] (a device array of G). A
// segment id outside [0, G) changes nothing.
template <int N>
__global__ void __launch_bounds__(kWarp)
hll_update_kernel(const uint8_t* __restrict__ batch,
                  const int32_t* __restrict__ lengths,
                  const int32_t* __restrict__ seg,
                  int32_t* const* __restrict__ group_regs,
                  const __grid_constant__ RegPtrs<N> regs, int by_value,
                  int G, int B, int L, int p, int vec16) {
  __shared__ __align__(16) uint8_t stage[kWarp * kSlot];
  const int lane = threadIdx.x;
  const int r0 = blockIdx.x * kWarp;
  const int b = r0 + lane;
  const bool in = b < B;
  // three independent loads: length, segment id and the row's bytes
  const int length = in ? __ldg(lengths + b) : -1;
  const int s = (in && seg != nullptr) ? __ldg(seg + b) : 0;
  const Head hd = load_head(batch, b, B, L, vec16);
  const bool live = length >= 0 &&
                    static_cast<unsigned>(s) < static_cast<unsigned>(G);
  int32_t* base = nullptr;
  if (live) base = by_value ? regs.p[N == 1 ? 0 : s] : group_regs[s];
  const uint32_t h = warp_row_hash(stage, batch, r0, B, L, vec16,
                                   live ? min(length, L) : 0, hd, lane);
  if (live) atomicMax(base + hll_index(h, p), hll_rank(h, p));
}

// The exact sum of the weights of the lanes in `mask` (every one of them
// calls it), as a table word. int32: one reduction over uint32, which
// wraps mod 2^32 as the atomicAdds it replaces do. int64: a sum of 32
// int32 weights passes 32 bits, where __reduce_add_sync alone would wrap,
// so the weight v = hi * 2^16 + lo (hi = v >> 16 signed, lo its low 16
// bits) is summed in two halves that cannot overflow (|sum hi| <= 2^20,
// sum lo < 2^21) and joined in 64 bits.
template <typename T>
__device__ __forceinline__ T warp_weight_sum(unsigned mask, int32_t v);
template <>
__device__ __forceinline__ int warp_weight_sum<int>(unsigned mask,
                                                    int32_t v) {
  return static_cast<int>(__reduce_add_sync(mask, static_cast<unsigned>(v)));
}
template <>
__device__ __forceinline__ unsigned long long
warp_weight_sum<unsigned long long>(unsigned mask, int32_t v) {
  const int hi = __reduce_add_sync(mask, v >> 16);
  const unsigned lo = __reduce_add_sync(mask, static_cast<unsigned>(v) &
                                                  0xFFFFu);
  return static_cast<unsigned long long>(
      static_cast<long long>(hi) * 65536LL + static_cast<long long>(lo));
}

// The count-min update of a warp of 32 rows (K7, and K10's composites
// task with unit weights): a live lane adds its weight v (1 when unit) at
// column (h1 + r * h2) % w of each depth row r < d, h2 = fmix32(h1) | 1
// (odd: full-period double hashing), the uint32 wrap before the modulo as
// in the reference's CountMin._hashes. Lanes on one word fold into one
// atomic (warp_fold; every word when every_word). T is int (int32 table)
// or unsigned long long (int64 table: two's complement addition is the
// same bit pattern as signed, so a weight is sign-extended). Every lane
// calls it.
template <typename T>
__device__ __forceinline__ void warp_cms_add(T* __restrict__ table, int d,
                                             int w, uint32_t h1, bool live,
                                             int32_t v, bool unit, int lane,
                                             bool every_word) {
  const uint32_t h2 = fmix32(h1) | 1u;
  const unsigned live_mask = __ballot_sync(kFull, live);
  if (!live) return;
  for (int r = 0; r < d; ++r) {
    const uint32_t col = (h1 + static_cast<uint32_t>(r) * h2) %
                         static_cast<uint32_t>(w);
    const WarpFold fold = warp_fold(live_mask, col, lane, every_word);
    T add = static_cast<T>(static_cast<long long>(unit ? 1 : v));
    // a lane alone on its word adds its own weight: no reduction (with
    // every word matched, each of up to 32 groups would run its own)
    if (fold.folded && (fold.same & (fold.same - 1)) != 0) {
      add = unit ? T(__popc(fold.same)) : warp_weight_sum<T>(fold.same, v);
    }
    if (!fold.folded || fold.lead) {
      atomicAdd(table + static_cast<long long>(r) * w + col, add);
    }
  }
}

// K7 (cms_update_launch): a block is one warp of 32 rows. Row b adds
// weights[b] (1 when weights is null) to each depth row of the table
// when lengths[b] >= 0 (the reference's (lengths >= 0) * weight). T as
// in warp_cms_add.
template <typename T>
__global__ void __launch_bounds__(kWarp)
cms_update_kernel(const uint8_t* __restrict__ batch,
                  const int32_t* __restrict__ lengths,
                  const int32_t* __restrict__ weights, T* __restrict__ table,
                  int B, int L, int d, int w, int vec16) {
  __shared__ __align__(16) uint8_t stage[kWarp * kSlot];
  const int lane = threadIdx.x;
  const int r0 = blockIdx.x * kWarp;
  const int b = r0 + lane;
  const bool in = b < B;
  // three independent loads: length, weight and the row's bytes
  const int length = in ? __ldg(lengths + b) : -1;
  const int32_t v = (in && weights != nullptr) ? __ldg(weights + b) : 1;
  const Head hd = load_head(batch, b, B, L, vec16);
  const bool live = length >= 0;
  const uint32_t h1 = warp_row_hash(stage, batch, r0, B, L, vec16,
                                    live ? min(length, L) : 0, hd, lane);
  warp_cms_add<T>(table, d, w, h1, live, v, weights == nullptr, lane,
                  B >= kMatchRows);
}

// One distinct field of the flux absorb: its staged rows and the register
// stack [n_seg, 2^p] they scatter into.
struct FluxField {
  const uint8_t* batch;     // u8 [B, L]
  const int32_t* lengths;   // i32 [B]
  int32_t* stack;           // i32 [n_seg, 2^p]
};

// the distinct fields one launch takes by value (a spec with more takes
// another launch for each further kMaxFields)
constexpr int kMaxFields = 8;

// K10's arguments, passed by value as one __grid_constant__ parameter:
// no descriptor array to copy to the card before a launch.
struct FluxArgs {
  const int32_t* seg;       // i32 [B]
  const int32_t* valid;     // i32 [B]
  int32_t* counts;          // i32 [n_seg]; null: no counts task
  int B, n_seg;
  FluxField fields[kMaxFields];
  int F, L, p, vec16;
  int has_comp;             // 0: no composites task
  const uint8_t* comp;      // u8 [Bc, W]
  const int32_t* comp_len;  // i32 [Bc]
  int32_t* table;           // i32 [d, w]
  int Bc, W, comp_vec16, d, w;
};

// K10: the flux plane's fused absorb (reference flux/kernels.py:189
// build_fused_absorb). A block is one warp of 32 rows; blockIdx.y picks
// the task:
//   counts (first, when a.counts is set)  counts[seg[i]] += valid[i] (K9)
//   field f (the next a.F)  stack_f[seg[i], idx] max= rank (K6's index and
//                           rank; a negative length is rank 0, a no-op)
//   composites (last, when a.has_comp)  K7's weight-1 count-min update
// A segment id outside [0, n_seg) changes nothing (the reference's
// scatter drops out-of-range updates). With no fields and no composites
// this is K9's counts-only launch.
__global__ void __launch_bounds__(kWarp)
flux_absorb_kernel(const __grid_constant__ FluxArgs a) {
  __shared__ __align__(16) uint8_t stage[kWarp * kSlot];
  const int lane = threadIdx.x;
  const int r0 = blockIdx.x * kWarp;
  const int task = static_cast<int>(blockIdx.y) - (a.counts != nullptr);
  const bool every_word = max(a.B, a.Bc) >= kMatchRows;
  if (task < a.F) {
    if (r0 >= a.B) return;  // the whole warp
    const int i = r0 + lane;
    const bool in = i < a.B;
    const int s = in ? __ldg(a.seg + i) : 0;
    const bool seg_ok = static_cast<unsigned>(s) <
                        static_cast<unsigned>(a.n_seg);
    if (task < 0) {  // counts
      const int v = in ? __ldg(a.valid + i) : 0;
      const bool live = v != 0 && seg_ok;
      const unsigned live_mask = __ballot_sync(kFull, live);
      if (!live) return;
      const WarpFold fold = warp_fold(live_mask, s, lane, every_word);
      if (!fold.folded) {
        atomicAdd(a.counts + s, v);
        return;
      }
      const int sum = __reduce_add_sync(fold.same, v);
      if (fold.lead) atomicAdd(a.counts + s, sum);
      return;
    }
    const FluxField f = a.fields[task];
    const int length = in ? __ldg(f.lengths + i) : -1;
    const Head hd = load_head(f.batch, i, a.B, a.L, a.vec16);
    const bool live = length >= 0 && seg_ok;
    const uint32_t h = warp_row_hash(stage, f.batch, r0, a.B, a.L, a.vec16,
                                     live ? min(length, a.L) : 0, hd, lane);
    int32_t* const addr =
        live ? f.stack + (static_cast<long long>(s) << a.p) + hll_index(h, a.p)
             : nullptr;
    warp_scatter_max(live, addr, hll_rank(h, a.p), lane, every_word);
    return;
  }
  if (r0 >= a.Bc) return;
  const int i = r0 + lane;
  const bool in = i < a.Bc;
  const int length = in ? __ldg(a.comp_len + i) : -1;
  const Head hd = load_head(a.comp, i, a.Bc, a.W, a.comp_vec16);
  const bool live = length >= 0;
  const uint32_t h1 = warp_row_hash(stage, a.comp, r0, a.Bc, a.W,
                                    a.comp_vec16, live ? min(length, a.W) : 0,
                                    hd, lane);
  warp_cms_add<int>(a.table, a.d, a.w, h1, live, 1, true, lane, every_word);
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

int warps_for(int B) { return (B + kWarp - 1) / kWarp; }

}  // namespace

// Plain-C launchers (bound with ctypes). Pointers are device pointers of
// contiguous tensors unless said otherwise: batch u8 [B, L], lengths i32
// [B], registers i32 [2^p], weights i32 [B] or null (unit weights), table
// i32 or i64 [d, w] (table_i64 = 1 for i64). Each launches on `stream`,
// does not synchronise, and returns cudaGetLastError() (0 on success;
// nothing is launched when there is no row).

// K6. regs: a HOST array of G pointers (each to i32 [2^p]), taken by
// value when G <= kGroupsByValue (G = 1 for one array, seg null); else
// group_regs, a device array of the G pointers (regs may be null). seg
// i32 [B] when G > 1.
extern "C" int hll_update_launch(const void* batch, const void* lengths,
                                 const void* seg, const void* const* regs,
                                 const void* group_regs, int G, int B, int L,
                                 int p, int vec16, void* stream) {
  if (B <= 0 || G <= 0) return 0;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* bt = static_cast<const uint8_t*>(batch);
  const auto* ln = static_cast<const int32_t*>(lengths);
  const auto* sg = static_cast<const int32_t*>(seg);
  const auto dev = static_cast<int32_t* const*>(group_regs);
  const bool by_value = regs != nullptr && G <= kGroupsByValue;
  if (!by_value && dev == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (by_value && G > 1) {
    RegPtrs<kGroupsByValue> many{};
    for (int g = 0; g < G; ++g) {
      many.p[g] = static_cast<int32_t*>(const_cast<void*>(regs[g]));
    }
    hll_update_kernel<kGroupsByValue><<<warps_for(B), kWarp, 0, st>>>(
        bt, ln, sg, nullptr, many, 1, G, B, L, p, vec16);
  } else {
    RegPtrs<1> one{};
    if (by_value) one.p[0] = static_cast<int32_t*>(const_cast<void*>(regs[0]));
    hll_update_kernel<1><<<warps_for(B), kWarp, 0, st>>>(
        bt, ln, sg, dev, one, by_value, G, B, L, p, vec16);
  }
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
    cms_update_kernel<unsigned long long><<<warps_for(B), kWarp, 0, s>>>(
        bt, ln, wt, static_cast<unsigned long long*>(table), B, L, d, w,
        vec16);
  } else {
    cms_update_kernel<int><<<warps_for(B), kWarp, 0, s>>>(
        bt, ln, wt, static_cast<int*>(table), B, L, d, w, vec16);
  }
  return static_cast<int>(cudaGetLastError());
}

// K10 / K9: one launch. seg, valid i32 [B]; counts i32 [n_seg], or null
// for no counts task; fields: a HOST array of 3 * F pointers (batch u8
// [B, L], lengths i32 [B], stack i32 [n_seg, 2^p] for each field), F <=
// kMaxFields (cudaErrorInvalidValue otherwise; the caller splits a longer
// spec); comp u8 [Bc, W] and comp_len i32 [Bc], table i32 [d, w] (Bc = 0
// or a null table for no composites). Every output is updated in place.
// Nothing is launched when there is no task or no row.
extern "C" int flux_absorb_launch(const void* seg, const void* valid, int B,
                                  int n_seg, void* counts,
                                  const void* const* fields, int F, int L,
                                  int p, int vec16, const void* comp,
                                  const void* comp_len, int Bc, int W,
                                  int comp_vec16, void* table, int d, int w,
                                  void* stream) {
  if (F < 0 || F > kMaxFields) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  FluxArgs a{};
  a.seg = static_cast<const int32_t*>(seg);
  a.valid = static_cast<const int32_t*>(valid);
  a.counts = static_cast<int32_t*>(counts);
  a.B = B;
  a.n_seg = n_seg;
  for (int k = 0; k < F; ++k) {
    a.fields[k].batch = static_cast<const uint8_t*>(fields[3 * k]);
    a.fields[k].lengths = static_cast<const int32_t*>(fields[3 * k + 1]);
    a.fields[k].stack = static_cast<int32_t*>(
        const_cast<void*>(fields[3 * k + 2]));
  }
  a.F = F;
  a.L = L;
  a.p = p;
  a.vec16 = vec16;
  // (comp itself may be null: a [Bc, 0] batch has no bytes)
  const bool has_comp = table != nullptr && Bc > 0;
  a.has_comp = has_comp;
  a.comp = static_cast<const uint8_t*>(comp);
  a.comp_len = static_cast<const int32_t*>(comp_len);
  a.table = static_cast<int32_t*>(table);
  a.Bc = has_comp ? Bc : 0;
  a.W = W;
  a.comp_vec16 = comp_vec16;
  a.d = d;
  a.w = w;
  const int tasks = (counts != nullptr) + F + (has_comp ? 1 : 0);
  const int rows = B > a.Bc ? B : a.Bc;
  if (tasks == 0 || rows <= 0) return 0;
  const dim3 grid(warps_for(rows), tasks);
  flux_absorb_kernel<<<grid, kWarp, 0, static_cast<cudaStream_t>(stream)>>>(
      a);
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
