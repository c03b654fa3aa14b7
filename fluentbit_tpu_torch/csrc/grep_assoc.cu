// grep_assoc.cu — the parallel-in-time DFA walk for filter_grep and
// filter_rewrite_tag.
//
// Replaces one device program of the reference package
// (fluentbit_tpu/ops/grep.py):
//   K4 GrepProgram._match_assoc_impl  (:413)  segment transition functions
//      over all states, a log2(G2)-deep composition tree, the read at starts
// and computes the same verdict as GrepProgram.match with kernel="assoc":
//   matched[r, b] = (F_line[starts[r]] == ACC) && lengths[r, b] >= 0,
// bit-identical to the scan (K3, grep_dfa.cu) and to match_assoc_plain.
//
// One block per (rule r, row b). The block
//   1. stages the row's bytes up to its length in shared memory (16 B loads
//      when the rows are 16 B aligned) and the rule's class map beside them;
//   2. forms the row's Lk super-symbols from the per-byte classes at radix
//      C[r], exactly as grep_dfa.cu's feed does: positions past the length
//      take the EOL class, and the reference's tail of
//      extra = (k - L % k) % k + k EOL classes follows the L positions;
//      symbols past Lk, up to G2 * m, are the all-EOL super-symbol (the
//      reference's padding of the segment grid to a power of two);
//   3. walks every segment g of m super-symbols from every state s of the
//      rule, one thread per (g, s) pair (threads loop when G2 * S passes
//      the block): F[g][s] = T_m(...T_1(s)), m dependent trans_flat loads;
//   4. composes the segment functions in log2(G2) rounds,
//      (f∘g)[s] = g[f[s]], ping-ponging two uint16 [G2][S] buffers in
//      shared memory with a __syncthreads between rounds;
//   5. reads the whole-line function at starts[r].
// The walk covers s < n_states[r] only. The reference walks all
// S = max_states states of the program, and for a rule with fewer states
// the index s * Ck[r] + c can pass the end of its trans_flat row (JAX clamps
// such a gather). States s >= n_states[r] are unreachable from starts[r]:
// the chain F_G2[...F_1[start]] only visits real states, so leaving them
// out is exact and keeps every load inside the rule's row. A row with a
// negative length has no match whatever its bytes: its block writes 0 and
// returns at once. Bytes past a row's length are never staged (the raw
// path leaves them unzeroed).
//
// Counts epilogue (K5's per-rule totals, counts[r] = sum_b mask[r, b]):
// when `counts` is not null, thread 0 adds its block's verdict with one
// atomicAdd, only for a matched row. A block holds one row's verdict, so
// there is no warp of verdicts to aggregate here; the adds of one rule
// meet at one address, at most B of them per launch.
//
// What bounds it on an H100: each (g, s) thread is a chain of m = 32
// dependent gathers from trans_flat (k-stride tables of 0.1-1.4 MB per
// rule, served from L2 once warm), and a block does G2 * S such chains
// where the scan does one chain of Lk (about G2 * S / 2 times the scan's
// loads at config 3's shapes). Its sequential depth is m + log2(G2) instead
// of Lk, so it wins only when the card has idle lanes to spend on the
// S-fold extra work, as on a small batch; at a full batch the extra loads
// set the time. A simple layout first: warp-level composition by shuffles,
// several rows per block and skipping segments past the row's length are
// left for later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kClassMapLen = 257;  // 256 bytes + the EOL entry
constexpr int kClassMapPad = 260;  // 1040 B: keeps what follows 16 B aligned
constexpr int kAcc = 1;            // regex/dfa.py ACC

__global__ void grep_assoc_kernel(const uint8_t* __restrict__ batch,
                                  const int32_t* __restrict__ lengths,
                                  const int32_t* __restrict__ trans_flat,
                                  const int32_t* __restrict__ class_maps,
                                  const int32_t* __restrict__ c_arr,
                                  const int32_t* __restrict__ ck_arr,
                                  const int32_t* __restrict__ eol_arr,
                                  const int32_t* __restrict__ start_arr,
                                  const int32_t* __restrict__ n_states_arr,
                                  uint8_t* __restrict__ out,
                                  int32_t* __restrict__ counts, int B, int L,
                                  int k, long long max_flat, int S, int m,
                                  int Lk, int G2, int vec16) {
  // layout (the wrapper's assoc_launch_shape sizes it): row bytes
  // [roundup16(L)] | class map i32 [260] | symbols i32 [roundup4(Lk)] |
  // two function buffers u16 [G2][S]
  extern __shared__ __align__(16) unsigned char smem[];
  const int l_pad = (L + 15) & ~15;
  uint8_t* row = smem;
  int32_t* cmap = reinterpret_cast<int32_t*>(smem + l_pad);
  int32_t* syms = cmap + kClassMapPad;
  uint16_t* fa = reinterpret_cast<uint16_t*>(syms + ((Lk + 3) & ~3));
  uint16_t* fb = fa + G2 * S;

  const int b = blockIdx.x;
  const int r = blockIdx.y;
  const long long rowi = (long long)r * B + b;
  const int len = lengths[rowi];
  if (len < 0) {  // uniform over the block: no barrier is skipped
    if (threadIdx.x == 0) out[rowi] = 0;
    return;
  }
  const int lim = len < L ? len : L;
  const uint8_t* __restrict__ src = batch + rowi * L;
  if (vec16) {  // L % 16 == 0 and a 16 B aligned base: uint4 row loads
    const int nvec = (lim + 15) >> 4;  // bytes past the length are EOL
    for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
      reinterpret_cast<uint4*>(row)[i] =
          __ldg(reinterpret_cast<const uint4*>(src) + i);
    }
  } else {
    for (int i = threadIdx.x; i < lim; i += blockDim.x) row[i] = src[i];
  }
  for (int i = threadIdx.x; i < kClassMapLen; i += blockDim.x) {
    cmap[i] = class_maps[(long long)r * kClassMapLen + i];
  }
  __syncthreads();

  const int C = c_arr[r];
  const int Ck = ck_arr[r];
  const int eol = eol_arr[r];
  const int s_r = min(n_states_arr[r], S);
  for (int j = threadIdx.x; j < Lk; j += blockDim.x) {
    int sym = 0;
    for (int i = 0, p = j * k; i < k; ++i, ++p) {
      sym = sym * C + (p < lim ? cmap[row[p]] : eol);
    }
    syms[j] = sym;
  }
  int eol_super = 0;  // k EOL classes: the padding segments' symbol
  for (int i = 0; i < k; ++i) eol_super = eol_super * C + eol;
  __syncthreads();

  const int32_t* __restrict__ tf = trans_flat + (long long)r * max_flat;
  for (int q = threadIdx.x; q < G2 * s_r; q += blockDim.x) {
    const int g = q / s_r;
    const int s = q - g * s_r;
    int state = s;
    for (int i = 0, j = g * m; i < m; ++i, ++j) {
      const int sym = j < Lk ? syms[j] : eol_super;
      state = __ldg(tf + (long long)state * Ck + sym);
    }
    fa[g * S + s] = static_cast<uint16_t>(state);
  }
  __syncthreads();

  for (int width = G2; width > 1; width >>= 1) {
    const int half = width >> 1;
    for (int q = threadIdx.x; q < half * s_r; q += blockDim.x) {
      const int h = q / s_r;
      const int s = q - h * s_r;
      const uint16_t* f = fa + (2 * h) * S;  // the earlier segment
      const uint16_t* g = fa + (2 * h + 1) * S;
      fb[h * S + s] = g[f[s]];
    }
    __syncthreads();
    uint16_t* t = fa;
    fa = fb;
    fb = t;
  }
  if (threadIdx.x == 0) {
    const bool hit = fa[start_arr[r]] == kAcc;
    out[rowi] = hit ? 1 : 0;
    if (hit && counts != nullptr) atomicAdd(counts + r, 1);
  }
}

}  // namespace

// Plain-C launcher (bound with ctypes). Pointers are device pointers of
// contiguous tensors: batch u8 [R, B, L], lengths i32 [R, B], trans_flat
// i32 [R, max_flat], class_maps i32 [R, 257], C/Ck/eol/starts/n_states
// i32 [R], out bool [R, B], counts i32 [R] or null (when set, each rule's
// matched rows are added to it). S is the program's largest state count, m the
// segment length, Lk the super-symbols of a row, G2 the segments rounded
// up to a power of two, `threads` the block size and `smem` the dynamic
// shared bytes, all computed by the wrapper. Launches one block per
// (rule, row) on `stream`, does not synchronise, and returns the CUDA
// error (0 on success, nothing launched when R * B == 0).
extern "C" int grep_assoc_launch(const void* batch, const void* lengths,
                                 const void* trans_flat,
                                 const void* class_maps, const void* c_arr,
                                 const void* ck_arr, const void* eol_arr,
                                 const void* start_arr,
                                 const void* n_states_arr, void* out,
                                 void* counts, int R, int B, int L, int k,
                                 long long max_flat,
                                 int S, int m, int Lk, int G2, int threads,
                                 int smem, int vec16, void* stream) {
  if (R <= 0 || B <= 0) return 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        grep_assoc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid(B, R);
  grep_assoc_kernel<<<grid, threads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(batch),
      static_cast<const int32_t*>(lengths),
      static_cast<const int32_t*>(trans_flat),
      static_cast<const int32_t*>(class_maps),
      static_cast<const int32_t*>(c_arr), static_cast<const int32_t*>(ck_arr),
      static_cast<const int32_t*>(eol_arr),
      static_cast<const int32_t*>(start_arr),
      static_cast<const int32_t*>(n_states_arr), static_cast<uint8_t*>(out),
      static_cast<int32_t*>(counts), B, L, k, max_flat, S, m, Lk, G2, vec16);
  return static_cast<int>(cudaGetLastError());
}
