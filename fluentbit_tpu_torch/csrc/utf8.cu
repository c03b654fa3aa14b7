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
// What bounds it on an H100: neither bytes nor operations. The bytes a
// launch must read (each row up to its length, 4 B of length, 1 B out)
// are ~1 MB at the main path's [4096, 512], 0.3 us of HBM time. A walk of
// the DFA is a chain of dependent lookups, one per byte, so a row walked
// by one thread costs its length in lookup latencies (~1024 dependent
// shared-memory loads for a 512 B row); that chain, not the data, is what
// held the one-thread-per-row kernel at ~0.03 ms whatever the row count.
// This design takes the chain apart, and leaves the launch, the block's
// table and two global latencies (the length, then the row) as its floor
// where a warp has one row (the main path's 4096); where it has many
// (~8 at 65536 rows), each row's walk and composition, in turn, add up:
//   - a warp per row, 512 B (a window of 32 pieces of 16 B) at a time:
//     lane l loads piece l with one 16 B load, coalesced across the warp,
//     and every lane's load is in flight before any lane waits. A piece
//     wholly at or past the row's length is not loaded; bytes of a piece
//     at or past the length are zeroed, which is ASCII, as in the
//     reference;
//   - each lane computes its piece's transition map (the state each
//     start state reaches over the piece's 16 bytes). An all-ASCII piece
//     needs no lookup: its map takes OK to OK and every other state to
//     DEAD. A window whose pieces are all ASCII skips the rest;
//   - the warp composes the 32 maps in order in 5 shuffle steps (a tree:
//     after the step of offset o, lane l with l % 2o == 0 holds the map of
//     pieces [l, l + 2o)); the map of the window then takes the carried
//     state to the next. A row stops after the window that holds its
//     length, or once the state is DEAD (DEAD has no way out, so the stop
//     is exact);
//   - a map is eight states wide: DEAD is absorbing, so its entry is
//     implied, and any value of 8 or more means DEAD. It lives in two
//     forms. The selector form packs state s's image into bits 4s..4s+3 of
//     a uint32. The table form holds it in byte s of two uint32s (lo:
//     states 0-3, hi: 4-7), each byte 0x80 | image, or 0xFF. Then
//     g o f is two PRMTs, prmt(g.lo, g.hi, f) and prmt(g.lo, g.hi, f >> 16)
//     in table form: a selector nibble of 8 or more picks a byte's sign,
//     which every table byte has set, so DEAD gives 0xFF, DEAD again;
//   - a byte's own map, in selector form, comes from a 256-entry table in
//     shared memory that each block of 8 warps builds once from the class
//     map and the transition table it is handed. A lane walks its piece's
//     16 bytes backwards, R <- R o m(byte), from the identity: all 16
//     lookups are independent of R, and the chain is 32 PRMTs;
//   - blocks loop over rows, at most 8 blocks of 8 warps per SM, so the
//     table is built once per block and a warp's next length is loaded
//     before its current row is walked.
// The vec16 == 0 path (L % 16 != 0, or an unaligned base; the wrapper
// copies strided views) loads a piece's bytes one by one. A row with a
// negative length (-1: missing value, -2: overflow row) is False without
// reading a byte.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarp * kWarpsPerBlock;  // one table entry each
constexpr int kBlocksPerSm = 8;                   // 8 x 256: an SM's 2048
constexpr int kPiece = 16;
constexpr int kWindow = kWarp * kPiece;           // 512 bytes
constexpr int kClasses = 12;  // ops/utf8.py N_CLASSES
constexpr int kOk = 0;        // ops/utf8.py OK
constexpr int kDead = 8;      // ops/utf8.py DEAD
constexpr unsigned kFull = 0xFFFFFFFFu;

// table forms (see the header): the identity, and the map of an all-ASCII
// piece (OK -> OK, every other state -> DEAD)
constexpr uint32_t kIdentityLo = 0x83828180u, kIdentityHi = 0x87868584u;
constexpr uint32_t kAsciiLo = 0xFFFFFF80u, kAsciiHi = 0xFFFFFFFFu;

// PTX prmt in its default mode: selector nibble i picks byte (nibble & 7)
// of {a, b} into byte i, or with the nibble's bit 3 set, that byte's sign
// replicated
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b,
                                         uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

// table form -> selector form: the low nibble of each of the 8 bytes
__device__ __forceinline__ uint32_t selector(uint32_t lo, uint32_t hi) {
  lo &= 0x0F0F0F0Fu;
  hi &= 0x0F0F0F0Fu;
  // bytes 0 and 2 of each now hold two nibbles each, in order
  return prmt(lo | (lo >> 4), hi | (hi >> 4), 0x6420u);
}

// the bytes of word i (bytes 4i .. 4i + 3 of a piece) before `count`
__device__ __forceinline__ uint32_t keep(int count, int i) {
  const int k = count - 4 * i;
  return k >= 4 ? kFull : (k <= 0 ? 0u : (1u << (8 * k)) - 1u);
}

// A lane's piece of one window of a row: bytes [base, base + 16) of src,
// base = w0 + 16 * lane, with bytes at or past n zeroed (ASCII); a piece
// wholly past n is not loaded.
struct Piece {
  uint32_t w[4];
};

__device__ __forceinline__ Piece load_piece(const uint8_t* __restrict__ src,
                                            int w0, int n, int vec16,
                                            int lane) {
  const int base = w0 + lane * kPiece;
  const int count = min(max(n - base, 0), kPiece);
  Piece p = {{0u, 0u, 0u, 0u}};
  if (count > 0) {
    if (vec16) {
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(src + base));
      p.w[0] = v.x & keep(count, 0);
      p.w[1] = v.y & keep(count, 1);
      p.w[2] = v.z & keep(count, 2);
      p.w[3] = v.w & keep(count, 3);
    } else {
#pragma unroll
      for (int q = 0; q < kPiece; ++q) {
        if (q < count) {
          p.w[q >> 2] |= static_cast<uint32_t>(__ldg(src + base + q))
                         << (8 * (q & 3));
        }
      }
    }
  }
  return p;
}

// The state after one window whose pieces the warp's lanes hold: `state`
// (not DEAD) carried through the window. Every lane calls it and gets the
// same state.
__device__ __forceinline__ int window_state(const uint32_t* sel,
                                            const Piece& p, int state) {
  const bool ascii = ((p.w[0] | p.w[1] | p.w[2] | p.w[3]) & 0x80808080u) == 0;
  if (__all_sync(kFull, ascii)) return state == kOk ? kOk : kDead;
  uint32_t lo = kAsciiLo, hi = kAsciiHi;
  if (!ascii) {
    uint32_t m[kPiece];
#pragma unroll
    for (int q = 0; q < kPiece; ++q) {
      m[q] = sel[(p.w[q >> 2] >> (8 * (q & 3))) & 0xFFu];
    }
    lo = kIdentityLo;
    hi = kIdentityHi;
#pragma unroll
    for (int q = kPiece - 1; q >= 0; --q) {  // R <- R o m(byte q)
      const uint32_t nlo = prmt(lo, hi, m[q]);
      hi = prmt(lo, hi, m[q] >> 16);
      lo = nlo;
    }
  }
  // the 32 maps in order: lane l takes its map, then lane l + o's
#pragma unroll
  for (int o = 1; o < kWarp; o <<= 1) {
    const uint32_t plo = __shfl_down_sync(kFull, lo, o);
    const uint32_t phi = __shfl_down_sync(kFull, hi, o);
    const uint32_t f = selector(lo, hi);
    lo = prmt(plo, phi, f);
    hi = prmt(plo, phi, f >> 16);
  }
  // lane 0 holds the window's map: byte `state` is 0x80 | image, or 0xFF
  const uint32_t image = prmt(lo, hi, static_cast<uint32_t>(state)) & 0xFu;
  return __shfl_sync(kFull, image >= kDead ? kDead : static_cast<int>(image),
                     0);
}

__device__ __forceinline__ int length_of(const int32_t* __restrict__ lengths,
                                         int row, int B) {
  return row < B ? __ldg(lengths + row) : -1;
}

// (kBlocksPerSm in the bounds holds it to 32 registers, so that the
// launcher's grid of kBlocksPerSm blocks a SM is resident at once: at 34,
// 6 fit. Loading a warp's next row before walking the current one, to
// hide the load, took it past 32, spilled, and gained nothing on the card)
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
utf8_validate_kernel(const uint8_t* __restrict__ batch,
                     const int32_t* __restrict__ lengths,
                     const int32_t* __restrict__ class_map,
                     const int32_t* __restrict__ trans,
                     uint8_t* __restrict__ out, int B, int L, int vec16) {
  __shared__ uint32_t sel[256];
  const int lane = threadIdx.x & (kWarp - 1);
  const int stride = gridDim.x * kWarpsPerBlock;
  int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  // the warp's first length is in flight while the block builds its table
  int len = length_of(lengths, row, B);
  {
    // byte threadIdx.x's map in selector form: trans[s][class] for the
    // 8 states below DEAD (DEAD's row is all DEAD)
    const int c = __ldg(class_map + threadIdx.x);
    uint32_t m = 0;
#pragma unroll
    for (int s = 0; s < kDead; ++s) {
      m |= static_cast<uint32_t>(__ldg(trans + s * kClasses + c)) << (4 * s);
    }
    sel[threadIdx.x] = m;
  }
  __syncthreads();
  for (; row < B; row += stride) {
    const int len_next = length_of(lengths, row + stride, B);
    int state = kDead;
    if (len >= 0) {
      const int n = len < L ? len : L;
      const uint8_t* __restrict__ src = batch + static_cast<long long>(row) * L;
      state = kOk;
      for (int w0 = 0; w0 < n && state != kDead; w0 += kWindow) {
        state = window_state(sel, load_piece(src, w0, n, vec16, lane), state);
      }
    }
    if (lane == 0) out[row] = state == kOk ? 1 : 0;
    len = len_next;
  }
}

}  // namespace

// Plain-C launcher (bound with ctypes). Pointers are device pointers of
// contiguous tensors: batch u8 [B, L], lengths i32 [B], class_map i32
// [256], trans i32 [9 * 12] (row-major [state, class]), out bool [B].
// vec16: L % 16 == 0 and a 16 B aligned batch. Launches on `stream`, does
// not synchronise, and returns cudaGetLastError() (0 on success, nothing
// launched when B == 0).
extern "C" int utf8_validate_launch(const void* batch, const void* lengths,
                                    const void* class_map, const void* trans,
                                    void* out, int B, int L, int vec16,
                                    void* stream) {
  if (B <= 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int want = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int blocks = want < sms * kBlocksPerSm ? want : sms * kBlocksPerSm;
  utf8_validate_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(batch), static_cast<const int32_t*>(lengths),
      static_cast<const int32_t*>(class_map),
      static_cast<const int32_t*>(trans), static_cast<uint8_t*>(out), B, L,
      vec16);
  return static_cast<int>(cudaGetLastError());
}
