// codec_host.cpp — the host msgpack codec of the raw chunk path.
//
// The port's own trimmed copy of the functions of the reference package's
// native/fbtpu_native.cpp that the raw grep path needs, with the same
// results on every input:
//
//   fbtpu_count_records   (:309)  count top-level msgpack objects
//   fbtpu_scan_offsets    (:321)  per-record byte offsets
//   fbtpu_stage_field     (:411)  stage one top-level string field of each
//                                 record into a [B, L] u8 matrix + lengths
//   fbtpu_stage_field_mt  (:787)  the same, the extraction split over a
//                                 persistent worker pool
//   fbtpu_compact         (:999)  copy the kept records' byte spans
//   fbtpu_grep_match      (:846)  the host DFA twin: one walk finds every
//                                 rule key's value per record, then each
//                                 rule's DFA runs over the values
//                                 (fbtpu_grep_match_v2 with its
//                                 dfa_run_block, :41, at one byte a step)
//   fbtpu_stage_field_f64 (:506)  stage one top-level numeric field of
//                                 each record as f64 + its kind
//
// with the msgpack skip and container/string header readers they call.
// The reference's fused grep walk (grep_filter, its k-stepped and accel
// tables) and its sketch helpers are not here.
//
// Built with g++ -O3 -fPIC -shared -std=c++17 -pthread at first use
// (ops/cuda_build.py) and bound with ctypes. Every function returns -1 on
// a malformed buffer and -2 when a caller's buffer is too small; the
// caller then declines to the decoded path, which raises on malformed
// input as the reference's does.

#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

namespace {

// Advance over one msgpack object, headers only. nullptr on a truncated
// or unknown object, or past 64 levels of nesting.
const uint8_t *skip_obj(const uint8_t *p, const uint8_t *end, int depth) {
    if (p >= end || depth > 64) return nullptr;
    uint8_t b = *p++;
    uint32_t n;
    if (b <= 0x7f || b >= 0xe0) return p;                 // fixint
    if ((b & 0xe0) == 0xa0) {                             // fixstr
        n = b & 0x1f;
        return p + n <= end ? p + n : nullptr;
    }
    if ((b & 0xf0) == 0x90) {                             // fixarray
        n = b & 0x0f;
        for (uint32_t i = 0; i < n; i++) {
            p = skip_obj(p, end, depth + 1);
            if (!p) return nullptr;
        }
        return p;
    }
    if ((b & 0xf0) == 0x80) {                             // fixmap
        n = b & 0x0f;
        for (uint32_t i = 0; i < 2 * n; i++) {
            p = skip_obj(p, end, depth + 1);
            if (!p) return nullptr;
        }
        return p;
    }
    switch (b) {
    case 0xc0: case 0xc2: case 0xc3: return p;            // nil/bool
    case 0xcc: case 0xd0: return p + 1 <= end ? p + 1 : nullptr;
    case 0xcd: case 0xd1: return p + 2 <= end ? p + 2 : nullptr;
    case 0xce: case 0xd2: case 0xca: return p + 4 <= end ? p + 4 : nullptr;
    case 0xcf: case 0xd3: case 0xcb: return p + 8 <= end ? p + 8 : nullptr;
    case 0xd9: case 0xc4:                                 // str8/bin8
        if (p + 1 > end) return nullptr;
        n = p[0]; p += 1;
        return p + n <= end ? p + n : nullptr;
    case 0xda: case 0xc5:                                 // str16/bin16
        if (p + 2 > end) return nullptr;
        n = ((uint32_t)p[0] << 8) | p[1]; p += 2;
        return p + n <= end ? p + n : nullptr;
    case 0xdb: case 0xc6:                                 // str32/bin32
        if (p + 4 > end) return nullptr;
        n = ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16)
          | ((uint32_t)p[2] << 8) | p[3]; p += 4;
        return p + n <= end ? p + n : nullptr;
    case 0xdc:                                            // array16
        if (p + 2 > end) return nullptr;
        n = ((uint32_t)p[0] << 8) | p[1]; p += 2;
        for (uint32_t i = 0; i < n; i++) {
            p = skip_obj(p, end, depth + 1);
            if (!p) return nullptr;
        }
        return p;
    case 0xdd:                                            // array32
        if (p + 4 > end) return nullptr;
        n = ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16)
          | ((uint32_t)p[2] << 8) | p[3]; p += 4;
        for (uint32_t i = 0; i < n; i++) {
            p = skip_obj(p, end, depth + 1);
            if (!p) return nullptr;
        }
        return p;
    case 0xde:                                            // map16
        if (p + 2 > end) return nullptr;
        n = ((uint32_t)p[0] << 8) | p[1]; p += 2;
        for (uint32_t i = 0; i < 2 * n; i++) {
            p = skip_obj(p, end, depth + 1);
            if (!p) return nullptr;
        }
        return p;
    case 0xdf:                                            // map32
        if (p + 4 > end) return nullptr;
        n = ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16)
          | ((uint32_t)p[2] << 8) | p[3]; p += 4;
        for (uint32_t i = 0; i < 2 * n; i++) {
            p = skip_obj(p, end, depth + 1);
            if (!p) return nullptr;
        }
        return p;
    case 0xd4: return p + 2 <= end ? p + 2 : nullptr;     // fixext1
    case 0xd5: return p + 3 <= end ? p + 3 : nullptr;     // fixext2
    case 0xd6: return p + 5 <= end ? p + 5 : nullptr;     // fixext4
    case 0xd7: return p + 9 <= end ? p + 9 : nullptr;     // fixext8
    case 0xd8: return p + 17 <= end ? p + 17 : nullptr;   // fixext16
    case 0xc7:                                            // ext8
        if (p + 2 > end) return nullptr;
        n = p[0]; p += 2;
        return p + n <= end ? p + n : nullptr;
    case 0xc8:                                            // ext16
        if (p + 3 > end) return nullptr;
        n = ((uint32_t)p[0] << 8) | p[1]; p += 3;
        return p + n <= end ? p + n : nullptr;
    case 0xc9:                                            // ext32
        if (p + 5 > end) return nullptr;
        n = ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16)
          | ((uint32_t)p[2] << 8) | p[3]; p += 5;
        return p + n <= end ? p + n : nullptr;
    }
    return nullptr;
}

// Container and string headers at p: the element count (or byte length)
// into *n, the position after the header returned; nullptr when p holds
// another type or the header is cut.
const uint8_t *read_array_hdr(const uint8_t *p, const uint8_t *end,
                              uint32_t *n) {
    if (p >= end) return nullptr;
    uint8_t b = *p++;
    if ((b & 0xf0) == 0x90) { *n = b & 0x0f; return p; }
    if (b == 0xdc) {
        if (p + 2 > end) return nullptr;
        *n = ((uint32_t)p[0] << 8) | p[1];
        return p + 2;
    }
    if (b == 0xdd) {
        if (p + 4 > end) return nullptr;
        *n = ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16)
           | ((uint32_t)p[2] << 8) | p[3];
        return p + 4;
    }
    return nullptr;
}

const uint8_t *read_map_hdr(const uint8_t *p, const uint8_t *end,
                            uint32_t *n) {
    if (p >= end) return nullptr;
    uint8_t b = *p++;
    if ((b & 0xf0) == 0x80) { *n = b & 0x0f; return p; }
    if (b == 0xde) {
        if (p + 2 > end) return nullptr;
        *n = ((uint32_t)p[0] << 8) | p[1];
        return p + 2;
    }
    if (b == 0xdf) {
        if (p + 4 > end) return nullptr;
        *n = ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16)
           | ((uint32_t)p[2] << 8) | p[3];
        return p + 4;
    }
    return nullptr;
}

const uint8_t *read_str_hdr(const uint8_t *p, const uint8_t *end,
                            uint32_t *n) {
    if (p >= end) return nullptr;
    uint8_t b = *p++;
    if ((b & 0xe0) == 0xa0) { *n = b & 0x1f; return p; }
    if (b == 0xd9) {
        if (p + 1 > end) return nullptr;
        *n = p[0];
        return p + 1;
    }
    if (b == 0xda) {
        if (p + 2 > end) return nullptr;
        *n = ((uint32_t)p[0] << 8) | p[1];
        return p + 2;
    }
    if (b == 0xdb) {
        if (p + 4 > end) return nullptr;
        *n = ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16)
           | ((uint32_t)p[2] << 8) | p[3];
        return p + 4;
    }
    return nullptr;
}

// One record's field extraction: stage the top-level string field `key`
// of the record at rec_start into out_row[max_len]. Returns the staged
// length, -1 for a missing or non-string value or a non-map body, -2 for
// a value longer than max_len. Bytes of out_row past the length are left
// as they were. When the record is the common 2-element [[ts, meta], body]
// shape, *rec_end_out gets the end the pair walk found (sparing a second
// skip_obj walk); otherwise it is left untouched.
int32_t stage_one_record(const uint8_t *rec_start, const uint8_t *end,
                         const uint8_t *key, long long keylen,
                         uint8_t *out_row, long long max_len,
                         const uint8_t **rec_end_out) {
    uint32_t outer;
    const uint8_t *q = read_array_hdr(rec_start, end, &outer);
    int32_t flen = -1;
    if (q && outer >= 2) {
        // skip the header element (array [ts, meta] or scalar ts)
        const uint8_t *body = skip_obj(q, end, 0);
        if (body) {
            uint32_t pairs;
            const uint8_t *kv = read_map_hdr(body, end, &pairs);
            if (kv) {
                // scan ALL pairs: duplicate map keys are legal msgpack,
                // and a dict decode keeps the LAST occurrence
                const uint8_t *hit = nullptr;
                uint32_t hit_len = 0;
                int hit_kind = 0;  // 0 none, 1 string, 2 non-string
                for (uint32_t i = 0; i < pairs && kv; i++) {
                    uint32_t klen;
                    const uint8_t *kstr = read_str_hdr(kv, end, &klen);
                    const uint8_t *val;
                    bool match = false;
                    if (kstr) {
                        val = kstr + klen;
                        if (val > end) { kv = nullptr; break; }
                        match = ((long long)klen == keylen &&
                                 memcmp(kstr, key, klen) == 0);
                    } else {
                        val = skip_obj(kv, end, 0);  // non-str key
                        if (!val) { kv = nullptr; break; }
                    }
                    if (match) {
                        uint32_t vlen;
                        const uint8_t *vstr = read_str_hdr(val, end, &vlen);
                        if (vstr && vstr + vlen <= end) {
                            hit = vstr;
                            hit_len = vlen;
                            hit_kind = 1;
                        } else {
                            hit_kind = 2;  // non-string value
                        }
                    }
                    kv = skip_obj(val, end, 0);
                }
                if (hit_kind == 1) {
                    if ((long long)hit_len > max_len) {
                        flen = -2;  // overflow row
                    } else {
                        memcpy(out_row, hit, hit_len);
                        flen = (int32_t)hit_len;
                    }
                }
                if (kv && outer == 2 && rec_end_out)
                    *rec_end_out = kv;  // pair walk ended at record end
            }
        }
    }
    return flen;
}

}  // namespace

extern "C" {

long long fbtpu_count_records(const uint8_t *buf, long long len) {
    const uint8_t *p = buf, *end = buf + len;
    long long count = 0;
    while (p < end) {
        p = skip_obj(p, end, 0);
        if (!p) return -1;
        count++;
    }
    return count;
}

// offsets[count+1]: record i spans [offsets[i], offsets[i+1])
long long fbtpu_scan_offsets(const uint8_t *buf, long long len,
                             long long *offsets, long long max_records) {
    const uint8_t *p = buf, *end = buf + len;
    long long count = 0;
    while (p < end) {
        if (count >= max_records) return -2;  // caller buffer too small
        offsets[count] = p - buf;
        p = skip_obj(p, end, 0);
        if (!p) return -1;
        count++;
    }
    offsets[count] = len;
    return count;
}

// Stage each record's top-level string field `key` into out[B][max_len].
// Records are [[ts, meta], body] (V2) or [ts, body] (legacy); non-map
// bodies and missing/non-string values get length -1; oversize -2.
// offsets: record offsets out (B+1 entries) or NULL.
long long fbtpu_stage_field(const uint8_t *buf, long long buflen,
                            const uint8_t *key, long long keylen,
                            uint8_t *out, int32_t *lengths,
                            long long max_records, long long max_len,
                            long long *offsets) {
    const uint8_t *p = buf, *end = buf + buflen;
    long long rec = 0;
    while (p < end) {
        if (rec >= max_records) return -2;
        if (offsets) offsets[rec] = p - buf;
        const uint8_t *rec_start = p;
        const uint8_t *rec_end = nullptr;
        lengths[rec] = stage_one_record(rec_start, end, key, keylen,
                                        out + rec * max_len, max_len,
                                        &rec_end);
        p = rec_end ? rec_end : skip_obj(rec_start, end, 0);
        if (!p) return -1;
        rec++;
    }
    if (offsets) offsets[rec] = buflen;
    return rec;
}

// Copy the records whose keep[i] != 0 into out, preserving order.
// offsets has n+1 entries (from fbtpu_stage_field / fbtpu_scan_offsets).
// Returns the bytes written (-1 on an offset outside the buffer); out
// must hold buflen bytes (the worst case).
long long fbtpu_compact(const uint8_t *buf, long long buflen,
                        const long long *offsets, const uint8_t *keep,
                        long long n, uint8_t *out) {
    long long w = 0;
    for (long long i = 0; i < n; i++) {
        if (!keep[i]) continue;
        long long a = offsets[i], b = offsets[i + 1];
        if (a < 0 || b > buflen || b < a) return -1;
        memcpy(out + w, buf + a, (size_t)(b - a));
        w += b - a;
    }
    return w;
}

}  // extern "C"

// ---------------------------------------------------------------------
// Threaded staging: phase 1 is the serial boundary walk (record i+1's
// start depends on record i's end, but it only skips headers); phase 2
// fans the per-record field extraction and row copies out over a
// persistent worker pool. Workers park on a condition variable between
// jobs, so a dispatch costs one notify_all and one wait for the caller.
// ---------------------------------------------------------------------

namespace {

// slice-parallel job: fn(ctx, slice) for slices 1..n-1 on pool workers,
// slice 0 on the caller's thread
typedef void (*pool_fn)(const void *ctx, int slice);

struct PoolJob {
    pool_fn fn;
    const void *ctx;
    int n_slices;
};

struct WorkPool {
    std::mutex m;
    std::condition_variable cv_work;
    std::condition_variable cv_done;
    uint64_t gen = 0;
    int remaining = 0;
    int n_workers = 0;
    PoolJob job{};
    // serialises dispatch: the job and remaining slots hold one job
    std::mutex run_m;

    void worker(int idx) {
        uint64_t seen = 0;
        for (;;) {
            PoolJob j;
            {
                std::unique_lock<std::mutex> lk(m);
                cv_work.wait(lk, [&] { return gen != seen; });
                seen = gen;
                j = job;
            }
            if (idx + 1 < j.n_slices) j.fn(j.ctx, idx + 1);
            {
                std::lock_guard<std::mutex> lk(m);
                if (--remaining == 0) cv_done.notify_one();
            }
        }
    }

    // start once; the pool's size is fixed at first use (detached
    // threads for the process's lifetime: the library is never unloaded)
    void ensure(int want_workers) {
        std::lock_guard<std::mutex> lk(m);
        if (n_workers > 0) return;
        n_workers = want_workers;
        for (int i = 0; i < want_workers; i++)
            std::thread([this, i] { worker(i); }).detach();
    }

    void run(pool_fn fn, const void *ctx, int n_slices) {
        std::lock_guard<std::mutex> run_lk(run_m);
        {
            std::lock_guard<std::mutex> lk(m);
            job = PoolJob{fn, ctx, n_slices};
            remaining = n_workers;
            gen++;
        }
        cv_work.notify_all();
        fn(ctx, 0);
        std::unique_lock<std::mutex> lk(m);
        cv_done.wait(lk, [&] { return remaining == 0; });
    }
};

// deliberately leaked: detached workers may be parked in cv_work.wait at
// process exit, and destroying a condvar with waiters is undefined
WorkPool &g_pool = *new WorkPool;

// the most slices a call may use: the hardware's threads, at most 16
int max_slices() {
    unsigned hw = std::thread::hardware_concurrency();
    int n = hw ? (int)hw : 1;
    return n > 16 ? 16 : n;
}

struct StageJob {
    const uint8_t *buf;
    const uint8_t *end;
    const uint8_t *key;
    long long keylen;
    uint8_t *out;
    int32_t *lengths;
    const long long *offsets;
    long long n_rec;
    long long max_len;
    long long slice;  // records per slice
};

void stage_run_slice(const StageJob &j, int sx) {
    long long lo = (long long)sx * j.slice;
    long long hi = lo + j.slice < j.n_rec ? lo + j.slice : j.n_rec;
    for (long long r = lo; r < hi; r++)
        j.lengths[r] = stage_one_record(j.buf + j.offsets[r], j.end,
                                        j.key, j.keylen,
                                        j.out + r * j.max_len, j.max_len,
                                        nullptr);
}

void stage_slice_adapter(const void *ctx, int sx) {
    stage_run_slice(*(const StageJob *)ctx, sx);
}

}  // namespace

extern "C" {

// Threaded fbtpu_stage_field. offsets is REQUIRED (n+1 entries, filled
// by the boundary walk). nthreads counts every slice, the caller's
// included, and is capped at the hardware's threads and 16. One slice,
// or fewer than 1024 records, takes the serial walk: there the dispatch
// handshake would cost more than it saves.
long long fbtpu_stage_field_mt(const uint8_t *buf, long long buflen,
                               const uint8_t *key, long long keylen,
                               uint8_t *out, int32_t *lengths,
                               long long max_records, long long max_len,
                               long long *offsets, int nthreads) {
    const int cap = max_slices();
    if (nthreads > cap) nthreads = cap;
    if (nthreads < 2)
        return fbtpu_stage_field(buf, buflen, key, keylen, out, lengths,
                                 max_records, max_len, offsets);
    long long n = fbtpu_scan_offsets(buf, buflen, offsets, max_records);
    if (n < 0) return n;
    if (n < 1024) {
        StageJob j{buf, buf + buflen, key, keylen, out, lengths,
                   offsets, n, max_len, n};
        stage_run_slice(j, 0);
        return n;
    }
    // the pool is sized once to the cap; each call caps its own slices
    // (workers past n_slices do nothing)
    g_pool.ensure(cap - 1);
    int slices = g_pool.n_workers + 1;
    if (slices > nthreads) slices = nthreads;
    long long slice = (n + slices - 1) / slices;
    StageJob j{buf, buf + buflen, key, keylen, out, lengths,
               offsets, n, max_len, slice};
    g_pool.run(stage_slice_adapter, &j, (int)((n + slice - 1) / slice));
    return n;
}

}  // extern "C"

// ---------------------------------------------------------------------
// The host DFA twin (the reference's fbtpu_grep_match_v2 and
// dfa_run_block): the verdicts the raw path's batch hooks of rewrite_tag,
// parser and log_to_metrics build on the host, with or without a device.
// ---------------------------------------------------------------------

namespace {

// rows walked together: independent state chains hide the dependent-load
// latency of a scalar table walk
const int kDfaLanes = 8;

// Run one DFA over up to kDfaLanes values. DEAD (0) and ACC (1) are
// absorbing, and so is the EOL class at DEAD/ACC, so a row shorter than
// the block's longest spins on EOL. A missing value (nullptr) starts at
// DEAD and never matches.
void dfa_run_block(const int16_t *trans, const int32_t *cmap, int32_t C,
                   int32_t start, const uint8_t *const *vals,
                   const uint32_t *lens, int nrows, uint8_t *out) {
    int32_t eol = cmap[256];
    int32_t s[kDfaLanes];
    const uint8_t *v[kDfaLanes];
    uint32_t l[kDfaLanes], maxlen = 0;
    for (int j = 0; j < kDfaLanes; j++) {
        if (j < nrows && vals[j] != nullptr) {
            v[j] = vals[j];
            l[j] = lens[j];
            s[j] = start;
            if (l[j] > maxlen) maxlen = l[j];
        } else {
            v[j] = nullptr;
            l[j] = 0;
            s[j] = 0;
        }
    }
    for (uint32_t pos = 0; pos <= maxlen; pos++) {
        int32_t c[kDfaLanes], acc = 0;
        for (int j = 0; j < kDfaLanes; j++)
            c[j] = pos < l[j] ? cmap[v[j][pos]] : eol;
        for (int j = 0; j < kDfaLanes; j++) {
            s[j] = trans[s[j] * C + c[j]];
            acc |= s[j];
        }
        // states are non-negative: OR <= 1 iff every chain is in
        // {DEAD, ACC}, all absorbed
        if (acc <= 1) break;
    }
    for (int j = 0; j < kDfaLanes && j < nrows; j++)
        out[j] = (uint8_t)(s[j] == 1);
}

struct MatchJob {
    const uint8_t *const *vals;  // [n_keys][stride] value pointers
    const uint32_t *vlens;
    long long stride;
    long long n_rec;
    const int32_t *key_of_rule;
    long long n_rules;
    const int16_t *trans_cat;
    const long long *troffs;
    const int32_t *cmaps;
    const int32_t *starts;
    const int32_t *ncls;
    uint8_t *match_out;          // [n_rules][stride]
    long long slice;             // rows per slice, a multiple of the lanes
};

void match_rows(const MatchJob &j, long long lo, long long hi) {
    for (long long r = 0; r < j.n_rules; r++) {
        const int16_t *trans = j.trans_cat + j.troffs[r];
        const int32_t *cmap = j.cmaps + r * 257;
        const uint8_t *const *kv = j.vals + j.key_of_rule[r] * j.stride;
        const uint32_t *kl = j.vlens + j.key_of_rule[r] * j.stride;
        uint8_t *out = j.match_out + r * j.stride;
        for (long long i = lo; i < hi; i += kDfaLanes) {
            int nrows = (int)(hi - i < kDfaLanes ? hi - i : kDfaLanes);
            dfa_run_block(trans, cmap, j.ncls[r], j.starts[r], kv + i,
                          kl + i, nrows, out + i);
        }
    }
}

void match_slice_adapter(const void *ctx, int sx) {
    const MatchJob &j = *(const MatchJob *)ctx;
    long long lo = (long long)sx * j.slice;
    long long hi = lo + j.slice < j.n_rec ? lo + j.slice : j.n_rec;
    if (lo < hi) match_rows(j, lo, hi);
}

// the largest key set one walk resolves (the reference's FBTPU_MAX_KEYS)
const long long kMaxKeys = 64;

// Numeric value at p: 1 for a msgpack integer, 2 for a float (its value
// in *out), 0 for anything else (strings, bool and nil included). Integers
// convert with IEEE round-to-nearest, as Python's float(int) does.
int read_numeric(const uint8_t *p, const uint8_t *end, double *out) {
    if (p >= end) return 0;
    uint8_t b = *p++;
    if (b <= 0x7f) { *out = (double)b; return 1; }            // pos fixint
    if (b >= 0xe0) { *out = (double)(int8_t)b; return 1; }    // neg fixint
    uint64_t v = 0;
    switch (b) {
    case 0xcc: if (p + 1 > end) return 0;
        *out = (double)p[0]; return 1;
    case 0xcd: if (p + 2 > end) return 0;
        *out = (double)(((uint32_t)p[0] << 8) | p[1]); return 1;
    case 0xce: if (p + 4 > end) return 0;
        *out = (double)(((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16)
                        | ((uint32_t)p[2] << 8) | p[3]);
        return 1;
    case 0xcf: if (p + 8 > end) return 0;
        for (int i = 0; i < 8; i++) v = (v << 8) | p[i];
        *out = (double)v;
        return 1;
    case 0xd0: if (p + 1 > end) return 0;
        *out = (double)(int8_t)p[0]; return 1;
    case 0xd1: if (p + 2 > end) return 0;
        *out = (double)(int16_t)(((uint16_t)p[0] << 8) | p[1]); return 1;
    case 0xd2: if (p + 4 > end) return 0;
        *out = (double)(int32_t)(((uint32_t)p[0] << 24)
                                 | ((uint32_t)p[1] << 16)
                                 | ((uint32_t)p[2] << 8) | p[3]);
        return 1;
    case 0xd3: if (p + 8 > end) return 0;
        for (int i = 0; i < 8; i++) v = (v << 8) | p[i];
        *out = (double)(int64_t)v;
        return 1;
    case 0xca: {
        if (p + 4 > end) return 0;
        uint32_t w = ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16)
                   | ((uint32_t)p[2] << 8) | p[3];
        float f;
        memcpy(&f, &w, 4);
        *out = (double)f;
        return 2;
    }
    case 0xcb: {
        if (p + 8 > end) return 0;
        for (int i = 0; i < 8; i++) v = (v << 8) | p[i];
        double d;
        memcpy(&d, &v, 8);
        *out = d;
        return 2;
    }
    }
    return 0;
}

}  // namespace

extern "C" {

// One msgpack walk extracts each record's value of every key (the LAST
// occurrence of a duplicate key; a string value only: another type, a
// non-map body or a missing key leave nullptr), then each rule runs its
// DFA (trans_cat + troffs[r]: int16 [S, C] with C = ncls[r]; cmaps +
// r * 257: int32 class map, 256 = EOL; starts[r]) over its key's values.
// match_out: [n_rules][max_records] u8 verdicts; offsets: the record
// boundaries (max_records + 1). nthreads counts every slice of the DFA
// sweep, the caller's included; below 4096 records the sweep is serial.
// Returns the record count, -1 on a malformed buffer (or more than 64
// keys), -2 when there are more records than max_records.
long long fbtpu_grep_match(const uint8_t *buf, long long buflen,
                           const uint8_t *keys_cat,
                           const long long *key_offs, long long n_keys,
                           const int32_t *key_of_rule, long long n_rules,
                           const int16_t *trans_cat,
                           const long long *troffs,
                           const int32_t *cmaps, const int32_t *starts,
                           const int32_t *ncls, uint8_t *match_out,
                           long long max_records, long long *offsets,
                           int nthreads) {
    if (n_keys > kMaxKeys) return -1;
    const uint8_t *p = buf, *end = buf + buflen;
    long long rec = 0;
    std::vector<const uint8_t *> vals((size_t)(n_keys * max_records));
    std::vector<uint32_t> vlens((size_t)(n_keys * max_records));
    while (p < end) {
        if (rec >= max_records) return -2;
        offsets[rec] = p - buf;
        const uint8_t *rec_start = p;
        for (long long kx = 0; kx < n_keys; kx++)
            vals[kx * max_records + rec] = nullptr;
        uint32_t outer;
        const uint8_t *rec_end = nullptr;
        const uint8_t *q = read_array_hdr(p, end, &outer);
        if (q && outer >= 2) {
            const uint8_t *body = skip_obj(q, end, 0);
            if (body) {
                uint32_t pairs;
                const uint8_t *kv = read_map_hdr(body, end, &pairs);
                if (kv) {
                    for (uint32_t i = 0; i < pairs && kv; i++) {
                        uint32_t klen;
                        const uint8_t *kstr = read_str_hdr(kv, end, &klen);
                        const uint8_t *val;
                        long long match_kx = -1;
                        if (kstr) {
                            val = kstr + klen;
                            if (val > end) { kv = nullptr; break; }
                            for (long long kx = 0; kx < n_keys; kx++) {
                                long long kl =
                                    key_offs[kx + 1] - key_offs[kx];
                                if (kl == (long long)klen &&
                                    memcmp(kstr, keys_cat + key_offs[kx],
                                           klen) == 0) {
                                    match_kx = kx;
                                    break;
                                }
                            }
                        } else {
                            val = skip_obj(kv, end, 0);  // non-str key
                            if (!val) { kv = nullptr; break; }
                        }
                        if (match_kx >= 0) {
                            uint32_t vlen;
                            const uint8_t *vstr =
                                read_str_hdr(val, end, &vlen);
                            long long slot = match_kx * max_records + rec;
                            if (vstr && vstr + vlen <= end) {
                                vals[slot] = vstr;
                                vlens[slot] = vlen;
                            } else {
                                vals[slot] = nullptr;  // non-string
                            }
                        }
                        kv = skip_obj(val, end, 0);
                    }
                    if (kv && outer == 2) rec_end = kv;
                }
            }
        }
        p = rec_end ? rec_end : skip_obj(rec_start, end, 0);
        if (!p) return -1;
        rec++;
    }
    offsets[rec] = buflen;
    MatchJob j{vals.data(), vlens.data(), max_records, rec, key_of_rule,
               n_rules, trans_cat, troffs, cmaps, starts, ncls, match_out,
               rec};
    const int cap = max_slices();
    if (nthreads > cap) nthreads = cap;
    if (nthreads < 2 || rec < 4096) {
        match_rows(j, 0, rec);
        return rec;
    }
    g_pool.ensure(cap - 1);
    int slices = g_pool.n_workers + 1;
    if (slices > nthreads) slices = nthreads;
    long long slice = (rec + slices - 1) / slices;
    j.slice = (slice + kDfaLanes - 1) / kDfaLanes * kDfaLanes;
    g_pool.run(match_slice_adapter, &j,
               (int)((rec + j.slice - 1) / j.slice));
    return rec;
}

// Stage the top-level numeric field `key` of each record: out[i] its
// value as f64, kinds[i] 1 for an integer, 2 for a float, 0 for a
// missing or non-numeric value (strings included) or a non-map body, the
// last occurrence of a duplicate key deciding. Returns the record count,
// -1 on a malformed buffer, -2 when there are more than max_records.
long long fbtpu_stage_field_f64(const uint8_t *buf, long long buflen,
                                const uint8_t *key, long long keylen,
                                double *out, uint8_t *kinds,
                                long long max_records) {
    const uint8_t *p = buf, *end = buf + buflen;
    long long rec = 0;
    while (p < end) {
        if (rec >= max_records) return -2;
        const uint8_t *rec_start = p;
        out[rec] = 0.0;
        kinds[rec] = 0;
        uint32_t outer;
        const uint8_t *q = read_array_hdr(rec_start, end, &outer);
        const uint8_t *rec_end = nullptr;
        if (q && outer >= 2) {
            const uint8_t *body = skip_obj(q, end, 0);
            if (body) {
                uint32_t pairs;
                const uint8_t *kv = read_map_hdr(body, end, &pairs);
                if (kv) {
                    for (uint32_t i = 0; i < pairs && kv; i++) {
                        uint32_t klen;
                        const uint8_t *kstr = read_str_hdr(kv, end, &klen);
                        const uint8_t *val;
                        bool match = false;
                        if (kstr) {
                            val = kstr + klen;
                            if (val > end) { kv = nullptr; break; }
                            match = ((long long)klen == keylen &&
                                     memcmp(kstr, key, klen) == 0);
                        } else {
                            val = skip_obj(kv, end, 0);
                            if (!val) { kv = nullptr; break; }
                        }
                        if (match) {
                            double v;
                            int kind = read_numeric(val, end, &v);
                            // a non-numeric last occurrence leaves the
                            // value as it was, as the reference does
                            if (kind) out[rec] = v;
                            kinds[rec] = (uint8_t)kind;
                        }
                        kv = skip_obj(val, end, 0);
                    }
                    if (kv && outer == 2) rec_end = kv;
                }
            }
        }
        p = rec_end ? rec_end : skip_obj(rec_start, end, 0);
        if (!p) return -1;
        rec++;
    }
    return rec;
}

}  // extern "C"
