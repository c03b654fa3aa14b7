// codec_py.cpp — the log-event codec as a CPython extension.
//
// The port's own C++ counterpart of the reference package's C codec
// (native/fbtpu_codec.c), computing the same results on every input:
//
//   decode_events(buf)          → list[LogEvent]   (the decoder, :26-236,
//                                                   :495-531)
//   pack_event(ts, meta, body)  → bytes            (the packer, :299-493)
//   parser_json_batch(buf, key) → (out, n, parsed) (the JSON transcoder,
//                                                   :535-1410)
//   _init(LogEvent, EventTime)  registers the port's classes
//
// The decoder is the twin of codec/msgpack.Unpacker + codec/events.
// _to_event: strings decode UTF-8 with errors="replace"; an unhashable map
// key becomes its repr(); ext type 0 of 8 bytes becomes EventTime(sec,
// nsec) and any other ext type raises FallbackError (the caller decodes
// that buffer with the plain Python decoder); a torn trailing record ends
// the list and keeps the decoded prefix; V2 [[ts, meta], body] and legacy
// [ts, body] records both become LogEvent(timestamp, body, metadata, raw).
// Nesting deeper than MAX_DEPTH raises ValueError ("nesting") instead of
// overflowing the C stack.
//
// Built with g++ -O3 -fPIC -shared -std=c++17 -I<Python include> at first
// use (ops/cuda_build.py) and imported as the module fbtpu_torch_codec.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <stdint.h>
#include <string.h>

static PyObject *g_logevent = NULL;   /* codec.events.LogEvent */
static PyObject *g_eventtime = NULL;  /* codec.msgpack.EventTime */
static PyObject *g_fallback = NULL;   /* fbtpu_torch_codec.FallbackError */
static PyObject *g_truncated = NULL;  /* internal: torn trailing record */

/* nesting bound: the pure-Python decoder dies with a recoverable
 * RecursionError around CPython's ~1000-frame limit; unbounded C
 * recursion would overflow the REAL stack and segfault the process on
 * a hostile buffer (b"\x91" * N). 512 covers any sane log event. */
#define MAX_DEPTH 512

typedef struct {
    const uint8_t *p;
    const uint8_t *end;
    int depth;
} rd;

static int need(rd *r, Py_ssize_t n) {
    if (r->end - r->p < n) {
        /* the Python Unpacker treats a torn tail as end-of-stream
         * (OutOfData stops iteration, the decoded prefix is returned);
         * decode_events must mirror that, so truncation gets its own
         * exception type the loop can swallow */
        PyErr_SetString(g_truncated, "truncated msgpack");
        return -1;
    }
    return 0;
}

/* every caller need()s before calling — hoisting the check here would
 * double it on the hottest decode path */
static uint64_t rd_be(rd *r, int n) {
    uint64_t v = 0;
    for (int i = 0; i < n; i++) v = (v << 8) | r->p[i];
    r->p += n;
    return v;
}

static PyObject *decode_obj(rd *r);

static PyObject *decode_str(rd *r, Py_ssize_t n) {
    if (need(r, n) < 0) return NULL;
    PyObject *s = PyUnicode_DecodeUTF8((const char *)r->p, n, "replace");
    r->p += n;
    return s;
}

static PyObject *decode_bin(rd *r, Py_ssize_t n) {
    if (need(r, n) < 0) return NULL;
    PyObject *b = PyBytes_FromStringAndSize((const char *)r->p, n);
    r->p += n;
    return b;
}

static PyObject *decode_ext(rd *r, int code, Py_ssize_t n) {
    if (need(r, n) < 0) return NULL;
    if (code == 0 && n == 8) {
        uint32_t sec = ((uint32_t)r->p[0] << 24) | ((uint32_t)r->p[1] << 16)
                     | ((uint32_t)r->p[2] << 8) | r->p[3];
        uint32_t nsec = ((uint32_t)r->p[4] << 24) | ((uint32_t)r->p[5] << 16)
                      | ((uint32_t)r->p[6] << 8) | r->p[7];
        r->p += 8;
        return PyObject_CallFunction(g_eventtime, "kk",
                                     (unsigned long)sec,
                                     (unsigned long)nsec);
    }
    /* non-EventTime ext: the Python decoder builds ExtType — punt */
    PyErr_SetString(g_fallback, "non-EventTime ext type");
    return NULL;
}

static PyObject *decode_array(rd *r, Py_ssize_t n) {
    PyObject *lst = PyList_New(n);
    if (!lst) return NULL;
    r->depth++;
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *it = decode_obj(r);
        if (!it) { r->depth--; Py_DECREF(lst); return NULL; }
        PyList_SET_ITEM(lst, i, it);
    }
    r->depth--;
    return lst;
}

static PyObject *decode_map(rd *r, Py_ssize_t n) {
    PyObject *d = PyDict_New();
    if (!d) return NULL;
    r->depth++;
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *k = decode_obj(r);
        if (!k) { r->depth--; Py_DECREF(d); return NULL; }
        if (PyDict_Check(k) || PyList_Check(k)) {
            /* unhashable keys degrade to repr() (msgpack.py parity) */
            PyObject *rep = PyObject_Repr(k);
            Py_DECREF(k);
            if (!rep) { Py_DECREF(d); return NULL; }
            k = rep;
        }
        PyObject *v = decode_obj(r);
        if (!v) { r->depth--; Py_DECREF(k); Py_DECREF(d); return NULL; }
        if (PyDict_SetItem(d, k, v) < 0) {
            r->depth--;
            Py_DECREF(k); Py_DECREF(v); Py_DECREF(d);
            return NULL;
        }
        Py_DECREF(k);
        Py_DECREF(v);
    }
    r->depth--;
    return d;
}

static PyObject *decode_obj(rd *r) {
    if (r->depth >= MAX_DEPTH) {
        PyErr_SetString(PyExc_ValueError, "msgpack nesting too deep");
        return NULL;
    }
    if (need(r, 1) < 0) return NULL;
    uint8_t b = *r->p++;
    if (b < 0x80) return PyLong_FromLong(b);
    if (b >= 0xE0) return PyLong_FromLong((long)b - 0x100);
    if (b <= 0x8F) return decode_map(r, b & 0x0F);
    if (b <= 0x9F) return decode_array(r, b & 0x0F);
    if (b <= 0xBF) return decode_str(r, b & 0x1F);
    switch (b) {
    case 0xC0: Py_RETURN_NONE;
    case 0xC2: Py_RETURN_FALSE;
    case 0xC3: Py_RETURN_TRUE;
    case 0xC4: if (need(r, 1) < 0) return NULL;
        return decode_bin(r, (Py_ssize_t)rd_be(r, 1));
    case 0xC5: if (need(r, 2) < 0) return NULL;
        return decode_bin(r, (Py_ssize_t)rd_be(r, 2));
    case 0xC6: if (need(r, 4) < 0) return NULL;
        return decode_bin(r, (Py_ssize_t)rd_be(r, 4));
    case 0xC7: {
        if (need(r, 2) < 0) return NULL;
        Py_ssize_t n = (Py_ssize_t)rd_be(r, 1);
        int code = (int8_t)rd_be(r, 1);
        return decode_ext(r, code, n);
    }
    case 0xC8: {
        if (need(r, 3) < 0) return NULL;
        Py_ssize_t n = (Py_ssize_t)rd_be(r, 2);
        int code = (int8_t)rd_be(r, 1);
        return decode_ext(r, code, n);
    }
    case 0xC9: {
        if (need(r, 5) < 0) return NULL;
        Py_ssize_t n = (Py_ssize_t)rd_be(r, 4);
        int code = (int8_t)rd_be(r, 1);
        return decode_ext(r, code, n);
    }
    case 0xCA: {
        if (need(r, 4) < 0) return NULL;
        uint32_t u = (uint32_t)rd_be(r, 4);
        float f;
        memcpy(&f, &u, 4);
        return PyFloat_FromDouble((double)f);
    }
    case 0xCB: {
        if (need(r, 8) < 0) return NULL;
        uint64_t u = rd_be(r, 8);
        double d;
        memcpy(&d, &u, 8);
        return PyFloat_FromDouble(d);
    }
    case 0xCC: if (need(r, 1) < 0) return NULL;
        return PyLong_FromUnsignedLong((unsigned long)rd_be(r, 1));
    case 0xCD: if (need(r, 2) < 0) return NULL;
        return PyLong_FromUnsignedLong((unsigned long)rd_be(r, 2));
    case 0xCE: if (need(r, 4) < 0) return NULL;
        return PyLong_FromUnsignedLong((unsigned long)rd_be(r, 4));
    case 0xCF: if (need(r, 8) < 0) return NULL;
        return PyLong_FromUnsignedLongLong(
            (unsigned long long)rd_be(r, 8));
    case 0xD0: if (need(r, 1) < 0) return NULL;
        return PyLong_FromLong((int8_t)rd_be(r, 1));
    case 0xD1: if (need(r, 2) < 0) return NULL;
        return PyLong_FromLong((int16_t)rd_be(r, 2));
    case 0xD2: if (need(r, 4) < 0) return NULL;
        return PyLong_FromLong((int32_t)rd_be(r, 4));
    case 0xD3: if (need(r, 8) < 0) return NULL;
        return PyLong_FromLongLong((int64_t)rd_be(r, 8));
    case 0xD4: case 0xD5: case 0xD6: case 0xD7: case 0xD8: {
        Py_ssize_t n = (Py_ssize_t)1 << (b - 0xD4);
        if (need(r, 1) < 0) return NULL;
        int code = (int8_t)rd_be(r, 1);
        return decode_ext(r, code, n);
    }
    case 0xD9: if (need(r, 1) < 0) return NULL;
        return decode_str(r, (Py_ssize_t)rd_be(r, 1));
    case 0xDA: if (need(r, 2) < 0) return NULL;
        return decode_str(r, (Py_ssize_t)rd_be(r, 2));
    case 0xDB: if (need(r, 4) < 0) return NULL;
        return decode_str(r, (Py_ssize_t)rd_be(r, 4));
    case 0xDC: if (need(r, 2) < 0) return NULL;
        return decode_array(r, (Py_ssize_t)rd_be(r, 2));
    case 0xDD: if (need(r, 4) < 0) return NULL;
        return decode_array(r, (Py_ssize_t)rd_be(r, 4));
    case 0xDE: if (need(r, 2) < 0) return NULL;
        return decode_map(r, (Py_ssize_t)rd_be(r, 2));
    case 0xDF: if (need(r, 4) < 0) return NULL;
        return decode_map(r, (Py_ssize_t)rd_be(r, 4));
    default:
        PyErr_Format(PyExc_ValueError, "invalid msgpack byte 0x%02x", b);
        return NULL;
    }
}

/* obj (the decoded outer list) + raw span → LogEvent
 * (codec/events._to_event parity) */
static PyObject *to_event(PyObject *obj, PyObject *raw) {
    if (!PyList_Check(obj) || PyList_GET_SIZE(obj) == 0) {
        PyObject *rep = PyObject_Repr(obj);
        PyErr_Format(PyExc_ValueError, "invalid log event: %U",
                     rep ? rep : PyUnicode_FromString("?"));
        Py_XDECREF(rep);
        return NULL;
    }
    PyObject *header = PyList_GET_ITEM(obj, 0);  /* borrowed */
    PyObject *ts, *meta, *body;
    if (PyList_Check(header)) {
        ts = PyList_GET_SIZE(header) > 0
            ? PyList_GET_ITEM(header, 0) : NULL;
        if (ts == NULL) {
            ts = PyLong_FromLong(0);
        } else {
            Py_INCREF(ts);
        }
        meta = PyList_GET_SIZE(header) > 1
            && PyDict_Check(PyList_GET_ITEM(header, 1))
            ? PyList_GET_ITEM(header, 1) : NULL;
        body = PyList_GET_SIZE(obj) > 1
            && PyDict_Check(PyList_GET_ITEM(obj, 1))
            ? PyList_GET_ITEM(obj, 1) : NULL;
    } else {
        ts = header;
        Py_INCREF(ts);
        meta = NULL;
        body = PyList_GET_SIZE(obj) > 1
            && PyDict_Check(PyList_GET_ITEM(obj, 1))
            ? PyList_GET_ITEM(obj, 1) : NULL;
    }
    if (body == NULL) {
        body = PyDict_New();
        if (!body) { Py_DECREF(ts); return NULL; }
    } else {
        Py_INCREF(body);
    }
    if (meta == NULL) {
        meta = PyDict_New();
        if (!meta) { Py_DECREF(ts); Py_DECREF(body); return NULL; }
    } else {
        Py_INCREF(meta);
    }
    PyObject *ev = PyObject_CallFunctionObjArgs(
        g_logevent, ts, body, meta, raw, NULL);
    Py_DECREF(ts);
    Py_DECREF(body);
    Py_DECREF(meta);
    return ev;
}

/* ------------------------------------------------------------------ */
/* Packing — byte-exact twin of codec/msgpack._pack (exact-type
 * dispatch; anything outside the known set raises FallbackError and
 * the caller reruns the Python packer). */

typedef struct {
    uint8_t *buf;
    Py_ssize_t len, cap;
    int depth;
} wr;

static int wr_reserve(wr *w, Py_ssize_t extra) {
    if (w->len + extra <= w->cap) return 0;
    Py_ssize_t ncap = w->cap ? w->cap : 256;
    while (ncap < w->len + extra) ncap *= 2;
    uint8_t *nb = (uint8_t *)PyMem_Realloc(w->buf, (size_t)ncap);
    if (!nb) { PyErr_NoMemory(); return -1; }
    w->buf = nb;
    w->cap = ncap;
    return 0;
}

static int wr_bytes(wr *w, const void *p, Py_ssize_t n) {
    if (wr_reserve(w, n) < 0) return -1;
    memcpy(w->buf + w->len, p, n);
    w->len += n;
    return 0;
}

static int wr_u8(wr *w, uint8_t b) { return wr_bytes(w, &b, 1); }

static int wr_be(wr *w, uint64_t v, int n) {
    uint8_t tmp[8];
    for (int i = n - 1; i >= 0; i--) { tmp[i] = v & 0xff; v >>= 8; }
    return wr_bytes(w, tmp, n);
}

static int pack_obj(wr *w, PyObject *obj);

static int pack_header(wr *w, Py_ssize_t n, uint8_t fixbase,
                       uint8_t b16, uint8_t b32, int fixmax) {
    if (n < fixmax) return wr_u8(w, (uint8_t)(fixbase | n));
    if (n <= 0xFFFF) {
        if (wr_u8(w, b16) < 0) return -1;
        return wr_be(w, (uint64_t)n, 2);
    }
    if (wr_u8(w, b32) < 0) return -1;
    return wr_be(w, (uint64_t)n, 4);
}

static int pack_obj(wr *w, PyObject *obj) {
    if (w->depth >= MAX_DEPTH) {
        PyErr_SetString(PyExc_ValueError, "msgpack nesting too deep");
        return -1;
    }
    if (obj == Py_None) return wr_u8(w, 0xC0);
    PyTypeObject *t = Py_TYPE(obj);
    if (obj == Py_True) return wr_u8(w, 0xC3);
    if (obj == Py_False) return wr_u8(w, 0xC2);
    if (t == &PyLong_Type) {
        int overflow = 0;
        long long v = PyLong_AsLongLongAndOverflow(obj, &overflow);
        if (overflow > 0) {  /* > i64 max: may still fit u64 */
            unsigned long long u = PyLong_AsUnsignedLongLong(obj);
            if (PyErr_Occurred()) {
                PyErr_Clear();
                PyErr_SetString(PyExc_OverflowError,
                                "int too large for msgpack");
                return -1;
            }
            if (wr_u8(w, 0xCF) < 0) return -1;
            return wr_be(w, (uint64_t)u, 8);
        }
        if (overflow < 0) {
            PyErr_SetString(PyExc_OverflowError,
                            "int too small for msgpack");
            return -1;
        }
        if (v >= 0) {
            if (v < 0x80) return wr_u8(w, (uint8_t)v);
            if (v <= 0xFF) {
                if (wr_u8(w, 0xCC) < 0) return -1;
                return wr_u8(w, (uint8_t)v);
            }
            if (v <= 0xFFFF) {
                if (wr_u8(w, 0xCD) < 0) return -1;
                return wr_be(w, (uint64_t)v, 2);
            }
            if (v <= 0xFFFFFFFFLL) {
                if (wr_u8(w, 0xCE) < 0) return -1;
                return wr_be(w, (uint64_t)v, 4);
            }
            if (wr_u8(w, 0xCF) < 0) return -1;
            return wr_be(w, (uint64_t)v, 8);
        }
        if (v >= -32) return wr_u8(w, (uint8_t)(int8_t)v);
        if (v >= -128) {
            if (wr_u8(w, 0xD0) < 0) return -1;
            return wr_u8(w, (uint8_t)(int8_t)v);
        }
        if (v >= -32768) {
            if (wr_u8(w, 0xD1) < 0) return -1;
            return wr_be(w, (uint64_t)(uint16_t)(int16_t)v, 2);
        }
        if (v >= -2147483648LL) {
            if (wr_u8(w, 0xD2) < 0) return -1;
            return wr_be(w, (uint64_t)(uint32_t)(int32_t)v, 4);
        }
        if (wr_u8(w, 0xD3) < 0) return -1;
        return wr_be(w, (uint64_t)v, 8);
    }
    if (t == &PyFloat_Type) {
        double d = PyFloat_AS_DOUBLE(obj);
        uint64_t u;
        memcpy(&u, &d, 8);
        if (wr_u8(w, 0xCB) < 0) return -1;
        return wr_be(w, u, 8);
    }
    if (t == &PyUnicode_Type) {
        Py_ssize_t n;
        const char *s = PyUnicode_AsUTF8AndSize(obj, &n);
        if (!s) return -1;
        if (n < 32) {
            if (wr_u8(w, (uint8_t)(0xA0 | n)) < 0) return -1;
        } else if (n <= 0xFF) {
            if (wr_u8(w, 0xD9) < 0 || wr_u8(w, (uint8_t)n) < 0)
                return -1;
        } else if (n <= 0xFFFF) {
            if (wr_u8(w, 0xDA) < 0 || wr_be(w, (uint64_t)n, 2) < 0)
                return -1;
        } else {
            if (wr_u8(w, 0xDB) < 0 || wr_be(w, (uint64_t)n, 4) < 0)
                return -1;
        }
        return wr_bytes(w, s, n);
    }
    if (t == &PyBytes_Type || t == &PyByteArray_Type
            || t == &PyMemoryView_Type) {
        PyObject *b = PyBytes_FromObject(obj);
        if (!b) return -1;
        Py_ssize_t n = PyBytes_GET_SIZE(b);
        int rc;
        if (n <= 0xFF)
            rc = wr_u8(w, 0xC4) < 0 ? -1 : wr_u8(w, (uint8_t)n);
        else if (n <= 0xFFFF)
            rc = wr_u8(w, 0xC5) < 0 ? -1 : wr_be(w, (uint64_t)n, 2);
        else
            rc = wr_u8(w, 0xC6) < 0 ? -1 : wr_be(w, (uint64_t)n, 4);
        if (rc == 0) rc = wr_bytes(w, PyBytes_AS_STRING(b), n);
        Py_DECREF(b);
        return rc;
    }
    if (t == &PyList_Type || t == &PyTuple_Type) {
        Py_ssize_t n = PySequence_Fast_GET_SIZE(obj);
        if (pack_header(w, n, 0x90, 0xDC, 0xDD, 16) < 0) return -1;
        PyObject **items = PySequence_Fast_ITEMS(obj);
        w->depth++;
        for (Py_ssize_t i = 0; i < n; i++)
            if (pack_obj(w, items[i]) < 0) { w->depth--; return -1; }
        w->depth--;
        return 0;
    }
    if (t == &PyDict_Type) {
        Py_ssize_t n = PyDict_GET_SIZE(obj);
        if (pack_header(w, n, 0x80, 0xDE, 0xDF, 16) < 0) return -1;
        Py_ssize_t pos = 0;
        PyObject *k, *v;
        w->depth++;
        while (PyDict_Next(obj, &pos, &k, &v)) {
            if (pack_obj(w, k) < 0) { w->depth--; return -1; }
            if (pack_obj(w, v) < 0) { w->depth--; return -1; }
        }
        w->depth--;
        return 0;
    }
    if ((PyObject *)t == g_eventtime) {
        PyObject *sec = PyObject_GetAttrString(obj, "sec");
        PyObject *nsec = PyObject_GetAttrString(obj, "nsec");
        if (!sec || !nsec) { Py_XDECREF(sec); Py_XDECREF(nsec); return -1; }
        uint32_t s = (uint32_t)PyLong_AsUnsignedLongLongMask(sec);
        uint32_t ns = (uint32_t)PyLong_AsUnsignedLongLongMask(nsec);
        Py_DECREF(sec);
        Py_DECREF(nsec);
        if (wr_u8(w, 0xD7) < 0 || wr_u8(w, 0x00) < 0) return -1;
        if (wr_be(w, s, 4) < 0) return -1;
        return wr_be(w, ns, 4);
    }
    /* ExtType, subclasses, exotic types: let the Python packer decide */
    PyErr_SetString(g_fallback, "type outside the fast-pack set");
    return -1;
}

static PyObject *py_pack_event(PyObject *, PyObject *args) {
    PyObject *ts, *meta, *body;
    if (!PyArg_ParseTuple(args, "OOO", &ts, &meta, &body)) return NULL;
    wr w = {NULL, 0, 0, 0};
    /* [[ts, meta], body] */
    if (wr_u8(&w, 0x92) < 0 || wr_u8(&w, 0x92) < 0
            || pack_obj(&w, ts) < 0 || pack_obj(&w, meta) < 0
            || pack_obj(&w, body) < 0) {
        PyMem_Free(w.buf);
        return NULL;
    }
    PyObject *out = PyBytes_FromStringAndSize((const char *)w.buf, w.len);
    PyMem_Free(w.buf);
    return out;
}

static PyObject *py_decode_events(PyObject *, PyObject *arg) {
    Py_buffer view;
    if (PyObject_GetBuffer(arg, &view, PyBUF_SIMPLE) < 0) return NULL;
    rd r = {(const uint8_t *)view.buf,
            (const uint8_t *)view.buf + view.len, 0};
    PyObject *events = PyList_New(0);
    if (!events) { PyBuffer_Release(&view); return NULL; }
    while (r.p < r.end) {
        const uint8_t *start = r.p;
        PyObject *obj = decode_obj(&r);
        if (!obj) {
            if (PyErr_ExceptionMatches(g_truncated)) {
                /* torn trailing record: Python-parity — keep prefix */
                PyErr_Clear();
                break;
            }
            goto fail;
        }
        PyObject *raw = PyBytes_FromStringAndSize(
            (const char *)start, r.p - start);
        if (!raw) { Py_DECREF(obj); goto fail; }
        PyObject *ev = to_event(obj, raw);
        Py_DECREF(obj);
        Py_DECREF(raw);
        if (!ev) goto fail;
        int rc = PyList_Append(events, ev);
        Py_DECREF(ev);
        if (rc < 0) goto fail;
    }
    PyBuffer_Release(&view);
    return events;
fail:
    Py_DECREF(events);
    PyBuffer_Release(&view);
    return NULL;
}

/* ------------------------------------------------------------------ */
/* filter_parser JSON fast path — whole-chunk JSON→msgpack transcode.
 *
 * parser_json_batch(buf, key) walks the concatenated V2 log-event
 * buffer once and, for every record whose top-level string field `key`
 * holds a JSON object, rewrites the record as
 * ``[[ts, meta], <parsed object>]`` — byte-exactly what the per-record
 * path (json.loads → dict → pack_event) produces:
 *
 *   - JSON object keys keep first-position/last-value duplicate
 *     semantics (Python dict insertion behavior);
 *   - ints pack with pack_obj's minimal-width rules, floats as f64,
 *     NaN/Infinity with CPython's exact bit patterns;
 *   - strings unescape (incl. surrogate pairs) to UTF-8;
 *   - parse failures / non-object documents / missing or non-string
 *     field values leave the record verbatim (the per-record path
 *     re-emits ev.raw for those).
 *
 * Anything the C path cannot reproduce bit-exactly raises
 * FallbackError and the caller runs the per-record path for the whole
 * chunk: legacy (V1) records, non-canonical msgpack in a parsed
 * record's [ts, meta] header (re-encode would change bytes), bin-typed
 * field values (decoded with errors="replace" upstream), invalid UTF-8
 * in the JSON text, ints beyond u64/i64, lone surrogate escapes, torn
 * trailing records, pathological nesting. */

#define JT_SYNTAX   (-1)  /* json.loads would fail → record verbatim */
#define JT_FALLBACK (-2)  /* bit-exactness not guaranteed → chunk decline */
#define JT_NOMEM    (-3)
#define JT_MAX_DEPTH 64
#define JT_MAX_ENTRIES 128

/* ---- span-level msgpack walking (no PyObject) ---- */

static const uint8_t *mp_skip_span(const uint8_t *p, const uint8_t *end,
                                   int depth);

static const uint8_t *mp_skip_n(const uint8_t *p, const uint8_t *end,
                                long long n, int depth) {
    for (long long i = 0; i < n; i++) {
        p = mp_skip_span(p, end, depth);
        if (!p) return NULL;
    }
    return p;
}

static const uint8_t *mp_skip_span(const uint8_t *p, const uint8_t *end,
                                   int depth) {
    if (depth > MAX_DEPTH || p >= end) return NULL;
    uint8_t b = *p++;
    long long n;
    if (b < 0x80 || b >= 0xE0) return p;              /* fixint */
    if (b <= 0x8F) return mp_skip_n(p, end, 2LL * (b & 0x0F), depth + 1);
    if (b <= 0x9F) return mp_skip_n(p, end, b & 0x0F, depth + 1);
    if (b <= 0xBF) { n = b & 0x1F; return (end - p >= n) ? p + n : NULL; }
    switch (b) {
    case 0xC0: case 0xC2: case 0xC3: return p;
    case 0xC4: case 0xD9:
        if (end - p < 1) return NULL;
        n = p[0]; p += 1; return (end - p >= n) ? p + n : NULL;
    case 0xC5: case 0xDA:
        if (end - p < 2) return NULL;
        n = ((long long)p[0] << 8) | p[1]; p += 2;
        return (end - p >= n) ? p + n : NULL;
    case 0xC6: case 0xDB:
        if (end - p < 4) return NULL;
        n = ((long long)p[0] << 24) | ((long long)p[1] << 16)
          | ((long long)p[2] << 8) | p[3];
        p += 4; return (end - p >= n) ? p + n : NULL;
    case 0xC7:
        if (end - p < 2) return NULL;
        n = p[0]; p += 2; return (end - p >= n) ? p + n : NULL;
    case 0xC8:
        if (end - p < 3) return NULL;
        n = ((long long)p[0] << 8) | p[1]; p += 3;
        return (end - p >= n) ? p + n : NULL;
    case 0xC9:
        if (end - p < 5) return NULL;
        n = ((long long)p[0] << 24) | ((long long)p[1] << 16)
          | ((long long)p[2] << 8) | p[3];
        p += 5; return (end - p >= n) ? p + n : NULL;
    case 0xCA: return (end - p >= 4) ? p + 4 : NULL;
    case 0xCB: return (end - p >= 8) ? p + 8 : NULL;
    case 0xCC: case 0xD0: return (end - p >= 1) ? p + 1 : NULL;
    case 0xCD: case 0xD1: return (end - p >= 2) ? p + 2 : NULL;
    case 0xCE: case 0xD2: return (end - p >= 4) ? p + 4 : NULL;
    case 0xCF: case 0xD3: return (end - p >= 8) ? p + 8 : NULL;
    case 0xD4: case 0xD5: case 0xD6: case 0xD7: case 0xD8:
        n = 1 + ((long long)1 << (b - 0xD4));
        return (end - p >= n) ? p + n : NULL;
    case 0xDC:
        if (end - p < 2) return NULL;
        n = ((long long)p[0] << 8) | p[1];
        return mp_skip_n(p + 2, end, n, depth + 1);
    case 0xDD:
        if (end - p < 4) return NULL;
        n = ((long long)p[0] << 24) | ((long long)p[1] << 16)
          | ((long long)p[2] << 8) | p[3];
        return mp_skip_n(p + 4, end, n, depth + 1);
    case 0xDE:
        if (end - p < 2) return NULL;
        n = ((long long)p[0] << 8) | p[1];
        return mp_skip_n(p + 2, end, 2 * n, depth + 1);
    case 0xDF:
        if (end - p < 4) return NULL;
        n = ((long long)p[0] << 24) | ((long long)p[1] << 16)
          | ((long long)p[2] << 8) | p[3];
        return mp_skip_n(p + 4, end, 2 * n, depth + 1);
    default: return NULL;                              /* 0xC1 */
    }
}

/* str header reader: NULL when the object at p is not a str */
static const uint8_t *mp_str_hdr(const uint8_t *p, const uint8_t *end,
                                 long long *len_out) {
    if (p >= end) return NULL;
    uint8_t b = *p;
    if (b >= 0xA0 && b <= 0xBF) { *len_out = b & 0x1F; return p + 1; }
    if (b == 0xD9 && end - p >= 2) { *len_out = p[1]; return p + 2; }
    if (b == 0xDA && end - p >= 3) {
        *len_out = ((long long)p[1] << 8) | p[2]; return p + 3;
    }
    if (b == 0xDB && end - p >= 5) {
        *len_out = ((long long)p[1] << 24) | ((long long)p[2] << 16)
                 | ((long long)p[3] << 8) | p[4];
        return p + 5;
    }
    return NULL;
}

/* strict RFC 3629 validator — mirrors CPython's UTF-8 decoder, which
 * replaces exactly the sequences this rejects (so a fully valid span
 * means errors="replace" upstream was an identity). */
static int utf8_valid(const uint8_t *p, long long n) {
    const uint8_t *end = p + n;
    while (p < end) {
        uint8_t c = *p;
        if (c < 0x80) { p++; continue; }
        if (c < 0xC2) return 0;
        if (c < 0xE0) {
            if (end - p < 2 || (p[1] & 0xC0) != 0x80) return 0;
            p += 2; continue;
        }
        if (c < 0xF0) {
            uint8_t lo = 0x80, hi = 0xBF;
            if (c == 0xE0) lo = 0xA0;
            else if (c == 0xED) hi = 0x9F;      /* no surrogates */
            if (end - p < 3 || p[1] < lo || p[1] > hi
                    || (p[2] & 0xC0) != 0x80) return 0;
            p += 3; continue;
        }
        if (c < 0xF5) {
            uint8_t lo = 0x80, hi = 0xBF;
            if (c == 0xF0) lo = 0x90;
            else if (c == 0xF4) hi = 0x8F;      /* <= U+10FFFF */
            if (end - p < 4 || p[1] < lo || p[1] > hi
                    || (p[2] & 0xC0) != 0x80
                    || (p[3] & 0xC0) != 0x80) return 0;
            p += 4; continue;
        }
        return 0;
    }
    return 1;
}

/* canonicality walk: 0 = decode→pack_obj round-trips to the same
 * bytes, JT_FALLBACK = it would not (or we cannot prove it), sets
 * *nx to the element end. Applied to the [ts, meta] header of parsed
 * records, whose bytes the transcoder copies verbatim in place of the
 * per-record path's re-encode. */
static int mp_canonical(const uint8_t *p, const uint8_t *end, int depth,
                        const uint8_t **nx) {
    if (depth > JT_MAX_DEPTH || p >= end) return JT_FALLBACK;
    uint8_t b = *p;
    long long n, i;
    const uint8_t *q;
    if (b < 0x80 || b >= 0xE0) { *nx = p + 1; return 0; }  /* fixint */
    if (b <= 0x8F || b == 0xDE || b == 0xDF) {             /* map */
        if (b <= 0x8F) { n = b & 0x0F; q = p + 1; }
        else if (b == 0xDE) {
            if (end - p < 3) return JT_FALLBACK;
            n = ((long long)p[1] << 8) | p[2]; q = p + 3;
            if (n < 16) return JT_FALLBACK;
        } else {
            if (end - p < 5) return JT_FALLBACK;
            n = ((long long)p[1] << 24) | ((long long)p[2] << 16)
              | ((long long)p[3] << 8) | p[4];
            q = p + 5;
            if (n <= 0xFFFF) return JT_FALLBACK;
        }
        /* map keys: require str keys and no duplicates — anything else
         * (int/float key collisions, dup dedup) can re-pack differently */
        const uint8_t *keys[16];
        long long klens[16];
        for (i = 0; i < n; i++) {
            long long klen;
            const uint8_t *kstr = mp_str_hdr(q, end, &klen);
            if (!kstr || klen > end - kstr) return JT_FALLBACK;
            int rc = mp_canonical(q, end, depth + 1, &q);
            if (rc) return rc;
            if (i < 16) {
                for (long long j = 0; j < i; j++)
                    if (klens[j] == klen
                            && memcmp(keys[j], kstr, klen) == 0)
                        return JT_FALLBACK;
                keys[i] = kstr; klens[i] = klen;
            } else {
                return JT_FALLBACK;  /* >16 keys: skip the dup proof */
            }
            rc = mp_canonical(q, end, depth + 1, &q);
            if (rc) return rc;
        }
        *nx = q;
        return 0;
    }
    if (b <= 0x9F || b == 0xDC || b == 0xDD) {             /* array */
        if (b <= 0x9F) { n = b & 0x0F; q = p + 1; }
        else if (b == 0xDC) {
            if (end - p < 3) return JT_FALLBACK;
            n = ((long long)p[1] << 8) | p[2]; q = p + 3;
            if (n < 16) return JT_FALLBACK;
        } else {
            if (end - p < 5) return JT_FALLBACK;
            n = ((long long)p[1] << 24) | ((long long)p[2] << 16)
              | ((long long)p[3] << 8) | p[4];
            q = p + 5;
            if (n <= 0xFFFF) return JT_FALLBACK;
        }
        for (i = 0; i < n; i++) {
            int rc = mp_canonical(q, end, depth + 1, &q);
            if (rc) return rc;
        }
        *nx = q;
        return 0;
    }
    if ((b >= 0xA0 && b <= 0xBF) || b == 0xD9 || b == 0xDA
            || b == 0xDB) {                                /* str */
        long long slen;
        const uint8_t *s = mp_str_hdr(p, end, &slen);
        if (!s || slen > end - s) return JT_FALLBACK;
        if (b == 0xD9 && slen < 32) return JT_FALLBACK;
        if (b == 0xDA && slen <= 0xFF) return JT_FALLBACK;
        if (b == 0xDB && slen <= 0xFFFF) return JT_FALLBACK;
        if (!utf8_valid(s, slen)) return JT_FALLBACK;  /* replace ≠ id */
        *nx = s + slen;
        return 0;
    }
    switch (b) {
    case 0xC0: case 0xC2: case 0xC3: *nx = p + 1; return 0;
    case 0xC4:                                             /* bin8 */
        if (end - p < 2) return JT_FALLBACK;
        n = p[1];
        if (end - (p + 2) < n) return JT_FALLBACK;
        *nx = p + 2 + n;
        return 0;
    case 0xC5:
        if (end - p < 3) return JT_FALLBACK;
        n = ((long long)p[1] << 8) | p[2];
        if (n <= 0xFF || end - (p + 3) < n) return JT_FALLBACK;
        *nx = p + 3 + n;
        return 0;
    case 0xC6:
        if (end - p < 5) return JT_FALLBACK;
        n = ((long long)p[1] << 24) | ((long long)p[2] << 16)
          | ((long long)p[3] << 8) | p[4];
        if (n <= 0xFFFF || end - (p + 5) < n) return JT_FALLBACK;
        *nx = p + 5 + n;
        return 0;
    case 0xCB: return (end - p >= 9) ? (*nx = p + 9, 0) : JT_FALLBACK;
    case 0xCC:
        if (end - p < 2 || p[1] < 0x80) return JT_FALLBACK;
        *nx = p + 2; return 0;
    case 0xCD: {
        if (end - p < 3) return JT_FALLBACK;
        uint64_t v = ((uint64_t)p[1] << 8) | p[2];
        if (v <= 0xFF) return JT_FALLBACK;
        *nx = p + 3; return 0;
    }
    case 0xCE: {
        if (end - p < 5) return JT_FALLBACK;
        uint64_t v = ((uint64_t)p[1] << 24) | ((uint64_t)p[2] << 16)
                   | ((uint64_t)p[3] << 8) | p[4];
        if (v <= 0xFFFF) return JT_FALLBACK;
        *nx = p + 5; return 0;
    }
    case 0xCF: {
        if (end - p < 9) return JT_FALLBACK;
        uint64_t v = 0;
        for (i = 1; i <= 8; i++) v = (v << 8) | p[i];
        if (v <= 0xFFFFFFFFULL) return JT_FALLBACK;
        *nx = p + 9; return 0;
    }
    case 0xD0: {
        if (end - p < 2) return JT_FALLBACK;
        int8_t v = (int8_t)p[1];
        if (v >= -32) return JT_FALLBACK;
        *nx = p + 2; return 0;
    }
    case 0xD1: {
        if (end - p < 3) return JT_FALLBACK;
        int16_t v = (int16_t)(((uint16_t)p[1] << 8) | p[2]);
        if (v >= -128) return JT_FALLBACK;
        *nx = p + 3; return 0;
    }
    case 0xD2: {
        if (end - p < 5) return JT_FALLBACK;
        int32_t v = (int32_t)(((uint32_t)p[1] << 24)
                              | ((uint32_t)p[2] << 16)
                              | ((uint32_t)p[3] << 8) | p[4]);
        if (v >= -32768) return JT_FALLBACK;
        *nx = p + 5; return 0;
    }
    case 0xD3: {
        if (end - p < 9) return JT_FALLBACK;
        uint64_t u = 0;
        for (i = 1; i <= 8; i++) u = (u << 8) | p[i];
        if ((int64_t)u >= -2147483648LL) return JT_FALLBACK;
        *nx = p + 9; return 0;
    }
    case 0xD7:                    /* fixext8: EventTime round-trips */
        if (end - p < 10 || p[1] != 0x00) return JT_FALLBACK;
        *nx = p + 10;
        return 0;
    /* float32 re-packs as float64; other ext types build ExtType —
     * both change bytes on re-encode */
    default: return JT_FALLBACK;
    }
}

/* ---- JSON scanner/emitter ---- */

typedef struct {
    const uint8_t *p, *end;
    wr *w;
    int depth;
} jt;

static int jt_value(jt *t);

static void jt_ws(jt *t) {
    while (t->p < t->end) {
        uint8_t c = *t->p;
        if (c == ' ' || c == '\t' || c == '\n' || c == '\r') t->p++;
        else break;
    }
}

static int wr_insert(wr *w, Py_ssize_t at, const uint8_t *hdr, int n) {
    if (wr_reserve(w, n) < 0) return JT_NOMEM;
    memmove(w->buf + at + n, w->buf + at, w->len - at);
    memcpy(w->buf + at, hdr, n);
    w->len += n;
    return 0;
}

static int jt_close_str(wr *w, Py_ssize_t start) {
    Py_ssize_t n = w->len - start;
    uint8_t hdr[5];
    int hl;
    if (n < 32) { hdr[0] = (uint8_t)(0xA0 | n); hl = 1; }
    else if (n <= 0xFF) { hdr[0] = 0xD9; hdr[1] = (uint8_t)n; hl = 2; }
    else if (n <= 0xFFFF) {
        hdr[0] = 0xDA; hdr[1] = (uint8_t)(n >> 8); hdr[2] = (uint8_t)n;
        hl = 3;
    } else {
        hdr[0] = 0xDB;
        hdr[1] = (uint8_t)(n >> 24); hdr[2] = (uint8_t)(n >> 16);
        hdr[3] = (uint8_t)(n >> 8); hdr[4] = (uint8_t)n;
        hl = 5;
    }
    return wr_insert(w, start, hdr, hl);
}

static int jt_close_seq(wr *w, Py_ssize_t start, long long n,
                        uint8_t fixbase, uint8_t b16, uint8_t b32) {
    uint8_t hdr[5];
    int hl;
    if (n < 16) { hdr[0] = (uint8_t)(fixbase | n); hl = 1; }
    else if (n <= 0xFFFF) {
        hdr[0] = b16; hdr[1] = (uint8_t)(n >> 8); hdr[2] = (uint8_t)n;
        hl = 3;
    } else {
        hdr[0] = b32;
        hdr[1] = (uint8_t)(n >> 24); hdr[2] = (uint8_t)(n >> 16);
        hdr[3] = (uint8_t)(n >> 8); hdr[4] = (uint8_t)n;
        hl = 5;
    }
    return wr_insert(w, start, hdr, hl);
}

static int wr_utf8cp(wr *w, uint32_t cp) {
    uint8_t b[4];
    int n;
    if (cp < 0x80) { b[0] = (uint8_t)cp; n = 1; }
    else if (cp < 0x800) {
        b[0] = 0xC0 | (cp >> 6); b[1] = 0x80 | (cp & 0x3F); n = 2;
    } else if (cp < 0x10000) {
        b[0] = 0xE0 | (cp >> 12); b[1] = 0x80 | ((cp >> 6) & 0x3F);
        b[2] = 0x80 | (cp & 0x3F); n = 3;
    } else {
        b[0] = 0xF0 | (cp >> 18); b[1] = 0x80 | ((cp >> 12) & 0x3F);
        b[2] = 0x80 | ((cp >> 6) & 0x3F); b[3] = 0x80 | (cp & 0x3F);
        n = 4;
    }
    return wr_bytes(w, b, n) < 0 ? JT_NOMEM : 0;
}

static int jt_hex4(jt *t, uint32_t *out) {
    if (t->end - t->p < 4) return JT_SYNTAX;
    uint32_t v = 0;
    for (int i = 0; i < 4; i++) {
        uint8_t c = t->p[i];
        uint32_t d;
        if (c >= '0' && c <= '9') d = c - '0';
        else if (c >= 'a' && c <= 'f') d = c - 'a' + 10;
        else if (c >= 'A' && c <= 'F') d = c - 'A' + 10;
        else return JT_SYNTAX;
        v = (v << 4) | d;
    }
    t->p += 4;
    *out = v;
    return 0;
}

static int jt_string(jt *t) {
    t->p++;  /* opening quote */
    Py_ssize_t start = t->w->len;
    for (;;) {
        /* bulk-copy the plain run */
        const uint8_t *run = t->p;
        while (t->p < t->end && *t->p != '"' && *t->p != '\\'
               && *t->p >= 0x20)
            t->p++;
        if (t->p > run && wr_bytes(t->w, run, t->p - run) < 0)
            return JT_NOMEM;
        if (t->p >= t->end) return JT_SYNTAX;
        uint8_t c = *t->p;
        if (c == '"') { t->p++; break; }
        if (c < 0x20) return JT_SYNTAX;  /* strict: raw control char */
        t->p++;  /* backslash */
        if (t->p >= t->end) return JT_SYNTAX;
        uint8_t e = *t->p++;
        int rc = 0;
        switch (e) {
        case '"': rc = wr_u8(t->w, '"'); break;
        case '\\': rc = wr_u8(t->w, '\\'); break;
        case '/': rc = wr_u8(t->w, '/'); break;
        case 'b': rc = wr_u8(t->w, '\b'); break;
        case 'f': rc = wr_u8(t->w, '\f'); break;
        case 'n': rc = wr_u8(t->w, '\n'); break;
        case 'r': rc = wr_u8(t->w, '\r'); break;
        case 't': rc = wr_u8(t->w, '\t'); break;
        case 'u': {
            uint32_t cp;
            int hrc = jt_hex4(t, &cp);
            if (hrc) return hrc;
            if (cp >= 0xDC00 && cp <= 0xDFFF)
                return JT_FALLBACK;  /* lone low surrogate */
            if (cp >= 0xD800 && cp <= 0xDBFF) {
                if (t->end - t->p < 6 || t->p[0] != '\\'
                        || t->p[1] != 'u')
                    return JT_FALLBACK;  /* lone high surrogate */
                t->p += 2;
                uint32_t lo;
                hrc = jt_hex4(t, &lo);
                if (hrc) return hrc;
                if (lo < 0xDC00 || lo > 0xDFFF) return JT_FALLBACK;
                cp = 0x10000 + ((cp - 0xD800) << 10) + (lo - 0xDC00);
            }
            hrc = wr_utf8cp(t->w, cp);
            if (hrc) return hrc;
            rc = 0;
            break;
        }
        default: return JT_SYNTAX;
        }
        if (rc < 0) return JT_NOMEM;
    }
    return jt_close_str(t->w, start);
}

static int wr_pack_int(wr *w, int neg, unsigned long long mag) {
    int rc;
    if (!neg) {
        if (mag < 0x80) return wr_u8(w, (uint8_t)mag) < 0 ? JT_NOMEM : 0;
        if (mag <= 0xFF) {
            rc = wr_u8(w, 0xCC) < 0 || wr_u8(w, (uint8_t)mag) < 0;
        } else if (mag <= 0xFFFF) {
            rc = wr_u8(w, 0xCD) < 0 || wr_be(w, mag, 2) < 0;
        } else if (mag <= 0xFFFFFFFFULL) {
            rc = wr_u8(w, 0xCE) < 0 || wr_be(w, mag, 4) < 0;
        } else {
            rc = wr_u8(w, 0xCF) < 0 || wr_be(w, mag, 8) < 0;
        }
        return rc ? JT_NOMEM : 0;
    }
    if (mag > 0x8000000000000000ULL) return JT_FALLBACK;  /* < i64 min */
    long long v = (long long)(0 - mag);
    if (v >= -32)
        return wr_u8(w, (uint8_t)(int8_t)v) < 0 ? JT_NOMEM : 0;
    if (v >= -128)
        rc = wr_u8(w, 0xD0) < 0 || wr_u8(w, (uint8_t)(int8_t)v) < 0;
    else if (v >= -32768)
        rc = wr_u8(w, 0xD1) < 0
            || wr_be(w, (uint64_t)(uint16_t)(int16_t)v, 2) < 0;
    else if (v >= -2147483648LL)
        rc = wr_u8(w, 0xD2) < 0
            || wr_be(w, (uint64_t)(uint32_t)(int32_t)v, 4) < 0;
    else
        rc = wr_u8(w, 0xD3) < 0 || wr_be(w, (uint64_t)v, 8) < 0;
    return rc ? JT_NOMEM : 0;
}

static int wr_pack_f64(wr *w, double d) {
    uint64_t u;
    memcpy(&u, &d, 8);
    if (wr_u8(w, 0xCB) < 0 || wr_be(w, u, 8) < 0) return JT_NOMEM;
    return 0;
}

static int wr_pack_f64_bits(wr *w, uint64_t bits) {
    if (wr_u8(w, 0xCB) < 0 || wr_be(w, bits, 8) < 0) return JT_NOMEM;
    return 0;
}

static int jt_number(jt *t) {
    const uint8_t *tok = t->p;
    int neg = 0, is_float = 0;
    if (t->p < t->end && *t->p == '-') { neg = 1; t->p++; }
    if (t->p >= t->end) return JT_SYNTAX;
    if (*t->p == '0') {
        t->p++;
        if (t->p < t->end && *t->p >= '0' && *t->p <= '9')
            return JT_SYNTAX;  /* leading zero */
    } else if (*t->p >= '1' && *t->p <= '9') {
        while (t->p < t->end && *t->p >= '0' && *t->p <= '9') t->p++;
    } else {
        return JT_SYNTAX;
    }
    if (t->p < t->end && *t->p == '.') {
        is_float = 1;
        t->p++;
        if (t->p >= t->end || *t->p < '0' || *t->p > '9')
            return JT_SYNTAX;
        while (t->p < t->end && *t->p >= '0' && *t->p <= '9') t->p++;
    }
    if (t->p < t->end && (*t->p == 'e' || *t->p == 'E')) {
        is_float = 1;
        t->p++;
        if (t->p < t->end && (*t->p == '+' || *t->p == '-')) t->p++;
        if (t->p >= t->end || *t->p < '0' || *t->p > '9')
            return JT_SYNTAX;
        while (t->p < t->end && *t->p >= '0' && *t->p <= '9') t->p++;
    }
    Py_ssize_t toklen = t->p - tok;
    if (is_float) {
        char buf[384];
        if (toklen >= (Py_ssize_t)sizeof(buf)) return JT_FALLBACK;
        memcpy(buf, tok, toklen);
        buf[toklen] = '\0';
        char *endp = NULL;
        double d = strtod(buf, &endp);
        if (endp != buf + toklen) return JT_FALLBACK;
        return wr_pack_f64(t->w, d);
    }
    /* integer: accumulate magnitude with overflow detection */
    const uint8_t *q = tok + neg;
    unsigned long long mag = 0;
    for (; q < t->p; q++) {
        unsigned long long d = (unsigned long long)(*q - '0');
        if (mag > (0xFFFFFFFFFFFFFFFFULL - d) / 10)
            return JT_FALLBACK;  /* Python bigint territory */
        mag = mag * 10 + d;
    }
    return wr_pack_int(t->w, neg, mag);
}

static int jt_object(jt *t) {
    if (++t->depth > JT_MAX_DEPTH) { t->depth--; return JT_FALLBACK; }
    t->p++;  /* '{' */
    wr *w = t->w;
    Py_ssize_t start = w->len;
    struct { Py_ssize_t koff, kend, vend; } ents[JT_MAX_ENTRIES];
    long long n = 0;
    jt_ws(t);
    if (t->p < t->end && *t->p == '}') {
        t->p++;
    } else {
        for (;;) {
            jt_ws(t);
            if (t->p >= t->end || *t->p != '"') { t->depth--; return JT_SYNTAX; }
            Py_ssize_t koff = w->len;
            int rc = jt_string(t);
            if (rc) { t->depth--; return rc; }
            Py_ssize_t kend = w->len;
            jt_ws(t);
            if (t->p >= t->end || *t->p != ':') { t->depth--; return JT_SYNTAX; }
            t->p++;
            jt_ws(t);
            rc = jt_value(t);
            if (rc) { t->depth--; return rc; }
            Py_ssize_t vend = w->len;
            /* duplicate key → Python dict semantics: keep the FIRST
             * position, take the LAST value */
            long long dup = -1;
            for (long long i = 0; i < n; i++) {
                if (ents[i].kend - ents[i].koff == kend - koff
                        && memcmp(w->buf + ents[i].koff, w->buf + koff,
                                  kend - koff) == 0) {
                    dup = i;
                    break;
                }
            }
            if (dup >= 0) {
                Py_ssize_t nvlen = vend - kend;
                Py_ssize_t ovoff = ents[dup].kend;
                Py_ssize_t ovend = ents[dup].vend;
                Py_ssize_t ovlen = ovend - ovoff;
                uint8_t *tmp = (uint8_t *)PyMem_Malloc(nvlen ? nvlen : 1);
                if (!tmp) { t->depth--; return JT_NOMEM; }
                memcpy(tmp, w->buf + kend, nvlen);
                w->len = koff;  /* drop the new entry from the tail */
                Py_ssize_t delta = nvlen - ovlen;
                if (delta > 0 && wr_reserve(w, delta) < 0) {
                    PyMem_Free(tmp);
                    t->depth--;
                    return JT_NOMEM;
                }
                memmove(w->buf + ovoff + nvlen, w->buf + ovend,
                        w->len - ovend);
                memcpy(w->buf + ovoff, tmp, nvlen);
                PyMem_Free(tmp);
                w->len += delta;
                for (long long i = 0; i < n; i++) {
                    if (ents[i].koff > ovoff) {
                        ents[i].koff += delta;
                        ents[i].kend += delta;
                    }
                    if (ents[i].vend >= ovend) ents[i].vend += delta;
                }
            } else {
                if (n >= JT_MAX_ENTRIES) { t->depth--; return JT_FALLBACK; }
                ents[n].koff = koff;
                ents[n].kend = kend;
                ents[n].vend = vend;
                n++;
            }
            jt_ws(t);
            if (t->p >= t->end) { t->depth--; return JT_SYNTAX; }
            if (*t->p == ',') { t->p++; continue; }
            if (*t->p == '}') { t->p++; break; }
            t->depth--;
            return JT_SYNTAX;
        }
    }
    t->depth--;
    return jt_close_seq(w, start, n, 0x80, 0xDE, 0xDF);
}

static int jt_array(jt *t) {
    if (++t->depth > JT_MAX_DEPTH) { t->depth--; return JT_FALLBACK; }
    t->p++;  /* '[' */
    Py_ssize_t start = t->w->len;
    long long n = 0;
    jt_ws(t);
    if (t->p < t->end && *t->p == ']') {
        t->p++;
    } else {
        for (;;) {
            jt_ws(t);
            int rc = jt_value(t);
            if (rc) { t->depth--; return rc; }
            n++;
            jt_ws(t);
            if (t->p >= t->end) { t->depth--; return JT_SYNTAX; }
            if (*t->p == ',') { t->p++; continue; }
            if (*t->p == ']') { t->p++; break; }
            t->depth--;
            return JT_SYNTAX;
        }
    }
    t->depth--;
    return jt_close_seq(t->w, start, n, 0x90, 0xDC, 0xDD);
}

static int jt_lit(jt *t, const char *word, Py_ssize_t wl) {
    if (t->end - t->p < wl || memcmp(t->p, word, wl) != 0)
        return JT_SYNTAX;
    t->p += wl;
    return 0;
}

static int jt_value(jt *t) {
    if (t->p >= t->end) return JT_SYNTAX;
    uint8_t c = *t->p;
    int rc;
    switch (c) {
    case '{': return jt_object(t);
    case '[': return jt_array(t);
    case '"': return jt_string(t);
    case 't':
        rc = jt_lit(t, "true", 4);
        if (rc) return rc;
        return wr_u8(t->w, 0xC3) < 0 ? JT_NOMEM : 0;
    case 'f':
        rc = jt_lit(t, "false", 5);
        if (rc) return rc;
        return wr_u8(t->w, 0xC2) < 0 ? JT_NOMEM : 0;
    case 'n':
        rc = jt_lit(t, "null", 4);
        if (rc) return rc;
        return wr_u8(t->w, 0xC0) < 0 ? JT_NOMEM : 0;
    /* CPython's json accepts these constants by default and maps them
     * to float('nan')/float('inf') — match the exact bit patterns */
    case 'N':
        rc = jt_lit(t, "NaN", 3);
        if (rc) return rc;
        return wr_pack_f64_bits(t->w, 0x7FF8000000000000ULL);
    case 'I':
        rc = jt_lit(t, "Infinity", 8);
        if (rc) return rc;
        return wr_pack_f64_bits(t->w, 0x7FF0000000000000ULL);
    case '-':
        if (t->end - t->p >= 2 && t->p[1] == 'I') {
            rc = jt_lit(t, "-Infinity", 9);
            if (rc) return rc;
            return wr_pack_f64_bits(t->w, 0xFFF0000000000000ULL);
        }
        return jt_number(t);
    default:
        if (c >= '0' && c <= '9') return jt_number(t);
        return JT_SYNTAX;
    }
}

/* one record: 1 = parsed + re-emitted, 0 = copied verbatim,
 * JT_FALLBACK / JT_NOMEM on the chunk-decline paths */
static int transcode_record(const uint8_t *rec, const uint8_t *end,
                            const uint8_t *key, Py_ssize_t keylen,
                            wr *w, const uint8_t **rec_end_out) {
    const uint8_t *rend = mp_skip_span(rec, end, 0);
    if (!rend) return JT_FALLBACK;  /* malformed or torn tail */
    *rec_end_out = rend;
    /* the per-record path re-encodes legacy / odd-arity records as V2;
     * only the exact [[ts, meta], body] shape copies through */
    if (*rec != 0x92) return JT_FALLBACK;
    const uint8_t *hdr = rec + 1;
    if (hdr >= end || *hdr != 0x92) return JT_FALLBACK;
    const uint8_t *ts = hdr + 1;
    const uint8_t *meta = mp_skip_span(ts, end, 0);
    if (!meta) return JT_FALLBACK;
    const uint8_t *body = mp_skip_span(meta, end, 0);
    if (!body || body >= rend) return JT_FALLBACK;
    /* body must be a map; otherwise the record passes through */
    uint8_t b = *body;
    long long pairs;
    const uint8_t *kv;
    if (b >= 0x80 && b <= 0x8F) { pairs = b & 0x0F; kv = body + 1; }
    else if (b == 0xDE && end - body >= 3) {
        pairs = ((long long)body[1] << 8) | body[2];
        kv = body + 3;
    } else if (b == 0xDF && end - body >= 5) {
        pairs = ((long long)body[1] << 24) | ((long long)body[2] << 16)
              | ((long long)body[3] << 8) | body[4];
        kv = body + 5;
    } else {
        goto verbatim;
    }
    {
        /* find the LAST occurrence of the key (dict decode keeps it) */
        const uint8_t *vstr = NULL;
        long long vlen = 0;
        int hit_kind = 0;  /* 0 none, 1 str, 2 other, 3 bin */
        for (long long i = 0; i < pairs; i++) {
            long long klen;
            const uint8_t *kstr = mp_str_hdr(kv, end, &klen);
            const uint8_t *val;
            int match = 0;
            if (kstr && klen <= end - kstr) {
                val = kstr + klen;
                match = (klen == keylen && memcmp(kstr, key, klen) == 0);
            } else {
                val = mp_skip_span(kv, end, 0);  /* non-str key */
                if (!val) return JT_FALLBACK;
            }
            if (match) {
                if (val >= end) return JT_FALLBACK;
                long long sl;
                const uint8_t *s = mp_str_hdr(val, end, &sl);
                if (s && sl <= end - s) {
                    vstr = s;
                    vlen = sl;
                    hit_kind = 1;
                } else if (*val == 0xC4 || *val == 0xC5
                           || *val == 0xC6) {
                    /* bin value: _to_str decodes with errors="replace"
                     * and still parses — C can't reproduce that */
                    hit_kind = 3;
                } else {
                    hit_kind = 2;  /* non-string: _to_str → None */
                }
            }
            kv = mp_skip_span(val, end, 0);
            if (!kv) return JT_FALLBACK;
        }
        if (hit_kind == 3) return JT_FALLBACK;
        if (hit_kind != 1) goto verbatim;
        /* JSON must be an object for _do_json to replace the body */
        const uint8_t *jp = vstr, *jend = vstr + vlen;
        while (jp < jend && (*jp == ' ' || *jp == '\t' || *jp == '\n'
                             || *jp == '\r'))
            jp++;
        if (jp >= jend || *jp != '{') goto verbatim;
        if (!utf8_valid(vstr, vlen)) return JT_FALLBACK;
        /* the header bytes stand in for the per-record re-encode, so
         * they must be canonical (decode→pack round-trip identity) */
        const uint8_t *nx;
        if (mp_canonical(ts, meta, 0, &nx) || nx != meta)
            return JT_FALLBACK;
        if (mp_canonical(meta, body, 0, &nx) || nx != body)
            return JT_FALLBACK;
        Py_ssize_t ckpt = w->len;
        if (wr_u8(w, 0x92) < 0 || wr_u8(w, 0x92) < 0
                || wr_bytes(w, ts, body - ts) < 0)
            return JT_NOMEM;
        jt t = {jp, jend, w, 0};
        int rc = jt_object(&t);
        if (rc == 0) {
            jt_ws(&t);
            if (t.p != t.end) rc = JT_SYNTAX;  /* trailing garbage */
        }
        if (rc == JT_SYNTAX) {
            w->len = ckpt;  /* json.loads would fail → verbatim */
            goto verbatim;
        }
        if (rc) return rc;
        return 1;
    }
verbatim:
    if (wr_bytes(w, rec, rend - rec) < 0) return JT_NOMEM;
    return 0;
}

static PyObject *py_parser_json_batch(PyObject *, PyObject *args) {
    Py_buffer view;
    const char *key;
    Py_ssize_t keylen;
    if (!PyArg_ParseTuple(args, "y*y#", &view, &key, &keylen))
        return NULL;
    const uint8_t *p = (const uint8_t *)view.buf;
    const uint8_t *end = p + view.len;
    wr w = {NULL, 0, 0, 0};
    long long n = 0, parsed = 0;
    int rc = 0;
    while (p < end) {
        const uint8_t *rec_end = NULL;
        rc = transcode_record(p, end, (const uint8_t *)key, keylen,
                              &w, &rec_end);
        if (rc < 0) break;
        parsed += rc;
        n++;
        p = rec_end;
    }
    if (rc < 0) {
        PyMem_Free(w.buf);
        PyBuffer_Release(&view);
        if (rc == JT_FALLBACK)
            PyErr_SetString(g_fallback,
                            "record outside the fast-transcode set");
        else if (!PyErr_Occurred())
            PyErr_NoMemory();
        return NULL;
    }
    PyObject *out = PyBytes_FromStringAndSize((const char *)w.buf, w.len);
    PyMem_Free(w.buf);
    PyBuffer_Release(&view);
    if (!out) return NULL;
    PyObject *res = Py_BuildValue("(NLL)", out, n, parsed);
    return res;
}

static PyObject *py_init(PyObject *, PyObject *args) {
    PyObject *logevent, *eventtime;
    if (!PyArg_ParseTuple(args, "OO", &logevent, &eventtime)) return NULL;
    Py_XINCREF(logevent);
    Py_XINCREF(eventtime);
    Py_XSETREF(g_logevent, logevent);
    Py_XSETREF(g_eventtime, eventtime);
    Py_RETURN_NONE;
}

static PyMethodDef methods[] = {
    {"decode_events", py_decode_events, METH_O,
     "decode a concatenated log-event msgpack buffer → list[LogEvent]"},
    {"pack_event", py_pack_event, METH_VARARGS,
     "pack_event(ts, meta, body) → V2 log-event msgpack bytes"},
    {"parser_json_batch", py_parser_json_batch, METH_VARARGS,
     "parser_json_batch(buf, key) → (out, n_records, n_parsed): "
     "whole-chunk JSON field transcode (filter_parser fast path); "
     "raises FallbackError when the per-record path must run"},
    {"_init", py_init, METH_VARARGS,
     "register the LogEvent and EventTime classes"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "fbtpu_torch_codec",
    "the port's log-event codec (C++)", -1, methods,
    NULL, NULL, NULL, NULL,
};

PyMODINIT_FUNC PyInit_fbtpu_torch_codec(void) {
    PyObject *m = PyModule_Create(&moduledef);
    if (!m) return NULL;
    g_fallback = PyErr_NewException("fbtpu_torch_codec.FallbackError",
                                    PyExc_ValueError, NULL);
    if (!g_fallback || PyModule_AddObject(m, "FallbackError",
                                          g_fallback) < 0) {
        Py_XDECREF(g_fallback);
        Py_DECREF(m);
        return NULL;
    }
    Py_INCREF(g_fallback);  /* module owns one, we keep one */
    g_truncated = PyErr_NewException("fbtpu_torch_codec.TruncatedError",
                                     PyExc_ValueError, NULL);
    if (!g_truncated || PyModule_AddObject(m, "TruncatedError",
                                           g_truncated) < 0) {
        Py_XDECREF(g_truncated);
        Py_DECREF(m);
        return NULL;
    }
    Py_INCREF(g_truncated);
    return m;
}
