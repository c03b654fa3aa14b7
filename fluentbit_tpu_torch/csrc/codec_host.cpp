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
//
// with the msgpack skip and container/string header readers they call.
// The reference's host DFA twins (grep_match, grep_filter) and sketch
// helpers are not here: the port matches on its device (or with the
// kernels' plain torch versions on the CPU).
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
