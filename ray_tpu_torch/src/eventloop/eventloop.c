/* Native event-loop + dispatch core for the control plane's hot lane.
 *
 * Counterpart of the reference's C++ core-worker event loop (reference:
 * src/ray/core_worker/ + rpc/ — the inner recv/demux/dispatch loop that
 * Python only observes): rpc.py keeps the protocol and the slow path,
 * but a Connection that arms the native lane moves
 *
 *   - the writer thread  (frame ring, coalesced writev, high-water
 *     backpressure) and
 *   - the reader thread  (bulk recv, [u32 len] reassembly, 0xA9 binary
 *     demux, tagged-value decode, BATCHED GIL delivery to one Python
 *     callback; pickle/exotic frames pass through as raw bytes) and
 *   - the cast flusher   (process-wide ~1 ms pass, adjacent same-kind
 *     record merging per wirefmt.coalesce_casts semantics, CAST_BATCH
 *     assembly — all without the GIL) and
 *   - the direct_ack sink (owner side: delivery acks parsed and
 *     retained in C, drained in bulk by the direct plane's watchdog)
 *
 * into pthreads that touch Python exactly once per BATCH of inbound
 * frames. Fault injection stays at the Python/native boundary: send
 * faults are applied in rpc.Connection._send before bytes reach the
 * ring, recv faults in the Python delivery callback, and rpc.py routes
 * casts back through the pure-Python buffer whenever the chaos plane
 * is armed — so the native lane never hides a frame from the fault
 * matrix.
 *
 * Decoder/encoder fragments mirror src/specenc/specenc.c and the
 * pure-Python half in wirefmt.py BYTE-FOR-BYTE; any C-side parse
 * failure downgrades that one frame to raw-bytes passthrough, so the
 * Python decoder (and its typed WireDecodeError close-the-connection
 * contract) remains the single source of error semantics.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <errno.h>
#include <pthread.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <sys/socket.h>
#include <sys/uio.h>
#include <time.h>
#include <unistd.h>

/* ------------------------------------------------------------------ */
/* wire kind table — MUST mirror wirefmt.KIND_CODES (codes are wire
 * protocol: never renumber, only append). tools/rtlint's RT-W pass
 * cross-checks this enum against the Python table so the two can
 * never drift; evloop.py additionally refuses to load a module whose
 * kind_codes() disagree at runtime. */

enum rt_kind {
    RT_KIND_DIRECT_PUSH = 1,
    RT_KIND_DIRECT_ACK = 2,
    RT_KIND_DIRECT_REJ = 3,
    RT_KIND_OWNER_SEALED = 4,
    RT_KIND_TASK_STARTED = 5,
    RT_KIND_TASK_FINISHED = 6,
    RT_KIND_SEAL_OBJECTS = 7,
    RT_KIND_PUSH_TASK = 8,
    RT_KIND_SUBMIT_TASK = 9,
    RT_KIND_SUBMIT_ACTOR_TASK = 10,
    RT_KIND_CAST_BATCH = 11,
    RT_KIND_CANCEL_DIRECT = 12,
    RT_KIND_PUT_INLINE = 13,
    RT_KIND_DEL_REF = 14,
    RT_KIND_DEL_BORROW = 15,
    RT_KIND_ADD_BORROW = 16,
};

#define RT_KIND_MAX 16

static const char *rt_kind_names[RT_KIND_MAX + 1] = {
    NULL,
    "direct_push",
    "direct_ack",
    "direct_rej",
    "owner_sealed",
    "task_started",
    "task_finished",
    "seal_objects",
    "push_task",
    "submit_task",
    "submit_actor_task",
    "__cast_batch__",
    "cancel_direct",
    "put_inline",
    "del_ref",
    "del_borrow",
    "add_borrow",
};

#define WIRE_MAGIC 0xA9
#define WIRE_VERSION 1

/* tagged-value codec tags (mirror wirefmt.py / specenc.c) */
#define T_NONE 0
#define T_STR 1
#define T_BYTES 2
#define T_INT 3
#define T_FLOAT 4
#define T_TRUE 5
#define T_FALSE 6
#define T_LSTR 7
#define T_DSF 8
#define T_PAIR_SI 9
#define T_LIST 10
#define T_MAP 11
#define T_TUPLE 12

#define MAX_DEPTH 64

/* ------------------------------------------------------------------ */
/* varint / parse helpers (no GIL needed) */

static int rd_varint(const uint8_t *b, size_t n, size_t *off, uint64_t *out)
{
    uint64_t v = 0;
    int shift = 0;
    while (1) {
        if (*off >= n)
            return -1;
        uint8_t c = b[(*off)++];
        v |= (uint64_t)(c & 0x7F) << shift;
        if (!(c & 0x80)) {
            *out = v;
            return 0;
        }
        shift += 7;
        if (shift > 63)
            return -1;
    }
}

static void wr_varint(uint8_t *b, size_t *off, uint64_t v)
{
    while (v >= 0x80) {
        b[(*off)++] = (uint8_t)((v & 0x7F) | 0x80);
        v >>= 7;
    }
    b[(*off)++] = (uint8_t)v;
}

static size_t varint_len(uint64_t v)
{
    size_t n = 1;
    while (v >= 0x80) {
        v >>= 7;
        n++;
    }
    return n;
}

/* skip one length-prefixed string/bytes run */
static int skip_lp(const uint8_t *b, size_t n, size_t *off)
{
    uint64_t len;
    if (rd_varint(b, n, off, &len))
        return -1;
    if (len > n - *off)
        return -1;
    *off += (size_t)len;
    return 0;
}

/* skip one tagged value; returns 0 ok, -1 corrupt */
static int skip_value(const uint8_t *b, size_t n, size_t *off, int depth)
{
    if (depth > MAX_DEPTH || *off >= n)
        return -1;
    uint8_t tag = b[(*off)++];
    uint64_t cnt, i;
    switch (tag) {
    case T_NONE:
    case T_TRUE:
    case T_FALSE:
        return 0;
    case T_STR:
    case T_BYTES:
        return skip_lp(b, n, off);
    case T_INT:
        return rd_varint(b, n, off, &cnt);
    case T_FLOAT:
        if (n - *off < 8)
            return -1;
        *off += 8;
        return 0;
    case T_LSTR:
        if (rd_varint(b, n, off, &cnt) || cnt > n - *off)
            return -1;
        for (i = 0; i < cnt; i++)
            if (skip_lp(b, n, off))
                return -1;
        return 0;
    case T_LIST:
    case T_TUPLE:
        if (rd_varint(b, n, off, &cnt) || cnt > n - *off)
            return -1;
        for (i = 0; i < cnt; i++)
            if (skip_value(b, n, off, depth + 1))
                return -1;
        return 0;
    case T_DSF:
        if (rd_varint(b, n, off, &cnt) || cnt > (n - *off) / 9)
            return -1;
        for (i = 0; i < cnt; i++) {
            if (skip_lp(b, n, off) || n - *off < 8)
                return -1;
            *off += 8;
        }
        return 0;
    case T_MAP:
        if (rd_varint(b, n, off, &cnt) || cnt > (n - *off) / 2)
            return -1;
        for (i = 0; i < cnt; i++)
            if (skip_lp(b, n, off) || skip_value(b, n, off, depth + 1))
                return -1;
        return 0;
    case T_PAIR_SI:
        if (skip_lp(b, n, off))
            return -1;
        return rd_varint(b, n, off, &cnt);
    default:
        return -1;
    }
}

/* ------------------------------------------------------------------ */
/* tagged-value -> PyObject decoder (GIL held). Mirrors wirefmt._dec;
 * any failure returns NULL with no Python exception set — the caller
 * downgrades the frame to raw passthrough and Python replays the
 * decode (keeping ONE source of error semantics). */

static PyObject *dec_value(const uint8_t *b, size_t n, size_t *off,
                           int depth)
{
    if (depth > MAX_DEPTH || *off >= n)
        return NULL;
    uint8_t tag = b[(*off)++];
    uint64_t cnt, i;
    switch (tag) {
    case T_NONE:
        Py_RETURN_NONE;
    case T_TRUE:
        Py_RETURN_TRUE;
    case T_FALSE:
        Py_RETURN_FALSE;
    case T_STR: {
        if (rd_varint(b, n, off, &cnt) || cnt > n - *off)
            return NULL;
        PyObject *s = PyUnicode_DecodeUTF8((const char *)b + *off,
                                           (Py_ssize_t)cnt, NULL);
        if (s == NULL) {
            PyErr_Clear();
            return NULL;
        }
        *off += (size_t)cnt;
        return s;
    }
    case T_BYTES: {
        if (rd_varint(b, n, off, &cnt) || cnt > n - *off)
            return NULL;
        PyObject *s = PyBytes_FromStringAndSize((const char *)b + *off,
                                                (Py_ssize_t)cnt);
        if (s == NULL) {
            PyErr_Clear();
            return NULL;
        }
        *off += (size_t)cnt;
        return s;
    }
    case T_INT: {
        if (rd_varint(b, n, off, &cnt))
            return NULL;
        /* zigzag */
        int64_t v = (int64_t)(cnt >> 1) ^ -(int64_t)(cnt & 1);
        return PyLong_FromLongLong(v);
    }
    case T_FLOAT: {
        double d;
        if (n - *off < 8)
            return NULL;
        memcpy(&d, b + *off, 8);
        *off += 8;
        return PyFloat_FromDouble(d);
    }
    case T_LSTR:
    case T_LIST:
    case T_TUPLE: {
        if (rd_varint(b, n, off, &cnt) || cnt > n - *off)
            return NULL;
        PyObject *lst = (tag == T_TUPLE)
                            ? PyTuple_New((Py_ssize_t)cnt)
                            : PyList_New((Py_ssize_t)cnt);
        if (lst == NULL) {
            PyErr_Clear();
            return NULL;
        }
        for (i = 0; i < cnt; i++) {
            PyObject *it;
            if (tag == T_LSTR) {
                uint64_t sl;
                if (rd_varint(b, n, off, &sl) || sl > n - *off) {
                    Py_DECREF(lst);
                    return NULL;
                }
                it = PyUnicode_DecodeUTF8((const char *)b + *off,
                                          (Py_ssize_t)sl, NULL);
                if (it == NULL)
                    PyErr_Clear();
                else
                    *off += (size_t)sl;
            } else {
                it = dec_value(b, n, off, depth + 1);
            }
            if (it == NULL) {
                Py_DECREF(lst);
                return NULL;
            }
            if (tag == T_TUPLE)
                PyTuple_SET_ITEM(lst, (Py_ssize_t)i, it);
            else
                PyList_SET_ITEM(lst, (Py_ssize_t)i, it);
        }
        return lst;
    }
    case T_DSF: {
        if (rd_varint(b, n, off, &cnt) || cnt > (n - *off) / 9)
            return NULL;
        PyObject *d = PyDict_New();
        if (d == NULL) {
            PyErr_Clear();
            return NULL;
        }
        for (i = 0; i < cnt; i++) {
            uint64_t sl;
            double fv;
            if (rd_varint(b, n, off, &sl) || sl > n - *off)
                goto dsf_fail;
            PyObject *k = PyUnicode_DecodeUTF8((const char *)b + *off,
                                               (Py_ssize_t)sl, NULL);
            if (k == NULL) {
                PyErr_Clear();
                goto dsf_fail;
            }
            *off += (size_t)sl;
            if (n - *off < 8) {
                Py_DECREF(k);
                goto dsf_fail;
            }
            memcpy(&fv, b + *off, 8);
            *off += 8;
            PyObject *v = PyFloat_FromDouble(fv);
            if (v == NULL || PyDict_SetItem(d, k, v) < 0) {
                PyErr_Clear();
                Py_DECREF(k);
                Py_XDECREF(v);
                goto dsf_fail;
            }
            Py_DECREF(k);
            Py_DECREF(v);
        }
        return d;
    dsf_fail:
        Py_DECREF(d);
        return NULL;
    }
    case T_MAP: {
        if (rd_varint(b, n, off, &cnt) || cnt > (n - *off) / 2)
            return NULL;
        PyObject *d = PyDict_New();
        if (d == NULL) {
            PyErr_Clear();
            return NULL;
        }
        for (i = 0; i < cnt; i++) {
            uint64_t sl;
            if (rd_varint(b, n, off, &sl) || sl > n - *off)
                goto map_fail;
            PyObject *k = PyUnicode_DecodeUTF8((const char *)b + *off,
                                               (Py_ssize_t)sl, NULL);
            if (k == NULL) {
                PyErr_Clear();
                goto map_fail;
            }
            *off += (size_t)sl;
            PyObject *v = dec_value(b, n, off, depth + 1);
            if (v == NULL || PyDict_SetItem(d, k, v) < 0) {
                PyErr_Clear();
                Py_DECREF(k);
                Py_XDECREF(v);
                goto map_fail;
            }
            Py_DECREF(k);
            Py_DECREF(v);
        }
        return d;
    map_fail:
        Py_DECREF(d);
        return NULL;
    }
    case T_PAIR_SI: {
        uint64_t sl;
        if (rd_varint(b, n, off, &sl) || sl > n - *off)
            return NULL;
        PyObject *s = PyUnicode_DecodeUTF8((const char *)b + *off,
                                           (Py_ssize_t)sl, NULL);
        if (s == NULL) {
            PyErr_Clear();
            return NULL;
        }
        *off += (size_t)sl;
        if (rd_varint(b, n, off, &cnt)) {
            Py_DECREF(s);
            return NULL;
        }
        int64_t v = (int64_t)(cnt >> 1) ^ -(int64_t)(cnt & 1);
        PyObject *iv = PyLong_FromLongLong(v);
        if (iv == NULL) {
            PyErr_Clear();
            Py_DECREF(s);
            return NULL;
        }
        PyObject *t = PyTuple_Pack(2, s, iv);
        Py_DECREF(s);
        Py_DECREF(iv);
        if (t == NULL)
            PyErr_Clear();
        return t;
    }
    default:
        return NULL;
    }
}

/* ------------------------------------------------------------------ */
/* connection object */

typedef struct frame {
    struct frame *next;
    uint32_t len; /* full wire bytes incl. 4-byte length prefix */
    uint8_t data[];
} frame_t;

typedef struct castrec {
    struct castrec *next;
    uint8_t kind;
    uint32_t len;
    uint8_t data[];
} castrec_t;

typedef struct conn {
    int fd;     /* our dup(); C owns it */
    int closed; /* under mu */
    int freed_bufs;
    int threads_live; /* under g_mu */
    pthread_mutex_t mu;
    pthread_cond_t cv; /* writer wakeup + drain/highwater waiters */
    pthread_mutex_t fl_mu; /* serializes cast flushes (order!) */

    /* send ring */
    frame_t *q_head, *q_tail;
    size_t q_bytes;
    size_t high_water;
    int writer_idle;

    /* cast buffer */
    castrec_t *cb_head, *cb_tail;
    int cb_count;

    /* counters for flusher-built frames (Python folds them in) */
    unsigned long long fl_frames, fl_bytes;

    /* direct_ack sink (owner side) */
    int ack_sink; /* under mu */
    uint8_t *acks;
    size_t acks_len, acks_cap;
    unsigned long long acks_sunk;

    PyObject *callback; /* owned; reader thread uses under GIL */

    struct conn *next_all; /* global registry (flusher walk) */
} conn_t;

static pthread_mutex_t g_mu = PTHREAD_MUTEX_INITIALIZER;
static conn_t *g_conns = NULL;
static int g_flusher_running = 0;
static int g_live_conns = 0;

#define CAST_BATCH_MAX 512
#define READ_CHUNK (256 * 1024)
#define WRITE_IOV_MAX 64

/* ------------------------------------------------------------------ */
/* ring helpers (conn->mu held unless noted) */

static void ring_append(conn_t *c, frame_t *f)
{
    f->next = NULL;
    if (c->q_tail)
        c->q_tail->next = f;
    else
        c->q_head = f;
    c->q_tail = f;
    c->q_bytes += f->len;
}

static void ring_clear(conn_t *c)
{
    frame_t *f = c->q_head;
    while (f) {
        frame_t *n = f->next;
        free(f);
        f = n;
    }
    c->q_head = c->q_tail = NULL;
    c->q_bytes = 0;
}

static void casts_clear(conn_t *c)
{
    castrec_t *r = c->cb_head;
    while (r) {
        castrec_t *n = r->next;
        free(r);
        r = n;
    }
    c->cb_head = c->cb_tail = NULL;
    c->cb_count = 0;
}

/* ------------------------------------------------------------------ */
/* cast flush: adjacent same-kind merge (mirrors wirefmt.coalesce_casts
 * + wirefmt._MERGERS) and frame assembly. No GIL required. */

typedef struct merged {
    uint8_t kind;
    uint8_t *payload; /* owned iff owns */
    size_t len;
    int owns;
} merged_t;

/* Parse a single-key map payload {key: container}; on success fills
 * the container's element-count and element-bytes span. Accepts only
 * the exact shape the runtime emits, so merged output is byte-
 * identical to the Python merger's re-encode. */
static int parse_keyed_container(const uint8_t *p, size_t n,
                                 const char *key, uint8_t want_tag,
                                 uint64_t *count, size_t *span_off)
{
    size_t off = 0;
    uint64_t cnt, klen;
    if (n < 2 || p[off++] != T_MAP)
        return -1;
    if (rd_varint(p, n, &off, &cnt) || cnt != 1)
        return -1;
    if (rd_varint(p, n, &off, &klen) || klen != strlen(key)
        || klen > n - off || memcmp(p + off, key, (size_t)klen) != 0)
        return -1;
    off += (size_t)klen;
    if (off >= n || p[off++] != want_tag)
        return -1;
    if (rd_varint(p, n, &off, count))
        return -1;
    *span_off = off;
    /* validate: elements must consume the payload exactly */
    uint64_t i;
    for (i = 0; i < *count; i++) {
        if (want_tag == T_LSTR) {
            if (skip_lp(p, n, &off))
                return -1;
        } else {
            if (skip_value(p, n, &off, 1))
                return -1;
        }
    }
    return off == n ? 0 : -1;
}

/* owner_sealed payload: {"objects": [..], "t_resolve": f}? (key order
 * free, t_resolve optional, no other keys). */
static int parse_owner_sealed(const uint8_t *p, size_t n, uint8_t *obj_tag,
                              uint64_t *count, size_t *span_off,
                              size_t *span_len, int *has_t, double *t)
{
    size_t off = 0;
    uint64_t cnt, i, klen;
    int saw_obj = 0;
    *has_t = 0;
    if (n < 2 || p[off++] != T_MAP)
        return -1;
    if (rd_varint(p, n, &off, &cnt) || cnt < 1 || cnt > 2)
        return -1;
    for (i = 0; i < cnt; i++) {
        if (rd_varint(p, n, &off, &klen) || klen > n - off)
            return -1;
        const char *k = (const char *)p + off;
        off += (size_t)klen;
        if (klen == 7 && memcmp(k, "objects", 7) == 0) {
            if (off >= n)
                return -1;
            uint8_t tag = p[off++];
            if (tag != T_LIST && tag != T_LSTR)
                return -1;
            uint64_t oc;
            if (rd_varint(p, n, &off, &oc))
                return -1;
            size_t start = off;
            uint64_t j;
            for (j = 0; j < oc; j++) {
                if (tag == T_LSTR ? skip_lp(p, n, &off)
                                  : skip_value(p, n, &off, 1))
                    return -1;
            }
            *obj_tag = tag;
            *count = oc;
            *span_off = start;
            *span_len = off - start;
            saw_obj = 1;
        } else if (klen == 9 && memcmp(k, "t_resolve", 9) == 0) {
            if (off >= n || p[off++] != T_FLOAT || n - off < 8)
                return -1;
            memcpy(t, p + off, 8);
            off += 8;
            *has_t = 1;
        } else {
            return -1;
        }
    }
    return (saw_obj && off == n) ? 0 : -1;
}

/* Try to merge a run[0..k) of same-kind casts. Returns a malloc'd
 * payload (caller owns) or NULL (emit individually). */
static uint8_t *merge_run(castrec_t **run, int k, uint8_t kind,
                          size_t *out_len)
{
    int i;
    if (kind == RT_KIND_DIRECT_ACK || kind == RT_KIND_SEAL_OBJECTS) {
        const char *key =
            (kind == RT_KIND_DIRECT_ACK) ? "task_ids" : "objects";
        uint8_t want = (kind == RT_KIND_DIRECT_ACK) ? T_LSTR : T_LIST;
        uint64_t total = 0;
        size_t bytes = 0;
        size_t offs[512];
        uint64_t cnts[512];
        if (k > 512)
            return NULL;
        for (i = 0; i < k; i++) {
            if (parse_keyed_container(run[i]->data, run[i]->len, key,
                                      want, &cnts[i], &offs[i]))
                return NULL;
            total += cnts[i];
            bytes += run[i]->len - offs[i];
        }
        size_t klen = strlen(key);
        size_t cap = 1 + 1 + 1 + klen + 1 + varint_len(total) + bytes;
        uint8_t *out = malloc(cap);
        if (out == NULL)
            return NULL;
        size_t o = 0;
        out[o++] = T_MAP;
        wr_varint(out, &o, 1);
        wr_varint(out, &o, klen);
        memcpy(out + o, key, klen);
        o += klen;
        out[o++] = want;
        wr_varint(out, &o, total);
        for (i = 0; i < k; i++) {
            size_t sl = run[i]->len - offs[i];
            memcpy(out + o, run[i]->data + offs[i], sl);
            o += sl;
        }
        *out_len = o;
        return out;
    }
    if (kind == RT_KIND_OWNER_SEALED) {
        uint64_t total = 0;
        size_t bytes = 0;
        int any_t = 0;
        double tmax = 0.0;
        uint8_t tag0 = 0;
        size_t offs[512], lens[512];
        if (k > 512)
            return NULL;
        for (i = 0; i < k; i++) {
            uint8_t tag = 0;
            uint64_t cnt;
            int has_t;
            double t;
            if (parse_owner_sealed(run[i]->data, run[i]->len, &tag, &cnt,
                                   &offs[i], &lens[i], &has_t, &t))
                return NULL;
            if (i == 0)
                tag0 = tag;
            else if (tag != tag0)
                return NULL;
            total += cnt;
            bytes += lens[i];
            /* mirror _merge_owner_sealed: max over TRUTHY stamps */
            if (has_t && t != 0.0) {
                if (!any_t || t > tmax)
                    tmax = t;
                any_t = 1;
            }
        }
        size_t cap = 1 + 1 + 1 + 7 + 1 + varint_len(total) + bytes + 1
                     + 9 + 1 + 8;
        uint8_t *out = malloc(cap);
        if (out == NULL)
            return NULL;
        size_t o = 0;
        out[o++] = T_MAP;
        wr_varint(out, &o, any_t ? 2 : 1);
        wr_varint(out, &o, 7);
        memcpy(out + o, "objects", 7);
        o += 7;
        out[o++] = tag0;
        wr_varint(out, &o, total);
        for (i = 0; i < k; i++) {
            memcpy(out + o, run[i]->data + offs[i], lens[i]);
            o += lens[i];
        }
        if (any_t) {
            wr_varint(out, &o, 9);
            memcpy(out + o, "t_resolve", 9);
            o += 9;
            out[o++] = T_FLOAT;
            memcpy(out + o, &tmax, 8);
            o += 8;
        }
        *out_len = o;
        return out;
    }
    return NULL;
}

static int kind_mergeable(uint8_t kind)
{
    return kind == RT_KIND_DIRECT_ACK || kind == RT_KIND_SEAL_OBJECTS
           || kind == RT_KIND_OWNER_SEALED;
}

static frame_t *frame_for_payload(uint8_t kind, const uint8_t *payload,
                                  size_t plen)
{
    /* [u32 le len][A9][ver][kind][flags=0][msg_id varint = 0][payload] */
    size_t body = 5 + plen;
    frame_t *f = malloc(sizeof(frame_t) + 4 + body);
    if (f == NULL)
        return NULL;
    f->len = (uint32_t)(4 + body);
    uint8_t *d = f->data;
    d[0] = (uint8_t)(body & 0xFF);
    d[1] = (uint8_t)((body >> 8) & 0xFF);
    d[2] = (uint8_t)((body >> 16) & 0xFF);
    d[3] = (uint8_t)((body >> 24) & 0xFF);
    d[4] = WIRE_MAGIC;
    d[5] = WIRE_VERSION;
    d[6] = kind;
    d[7] = 0;
    d[8] = 0;
    memcpy(d + 9, payload, plen);
    return f;
}

/* Flush the cast buffer of one conn: detach, merge, frame, append to
 * ring. Caller must NOT hold mu; takes fl_mu for ordering (a Python
 * flush_casts and the background flusher must not interleave their
 * detach->append windows, or a later call frame could overtake
 * buffered casts). */
static void conn_flush_casts(conn_t *c)
{
    pthread_mutex_lock(&c->fl_mu);
    pthread_mutex_lock(&c->mu);
    castrec_t *head = c->cb_head;
    int count = c->cb_count;
    c->cb_head = c->cb_tail = NULL;
    c->cb_count = 0;
    int closed = c->closed;
    pthread_mutex_unlock(&c->mu);
    if (head == NULL || closed) {
        castrec_t *r = head;
        while (r) {
            castrec_t *n = r->next;
            free(r);
            r = n;
        }
        pthread_mutex_unlock(&c->fl_mu);
        return;
    }

    /* collect into an array for run detection */
    castrec_t *arr[CAST_BATCH_MAX + 64];
    int n = 0;
    castrec_t *r = head;
    while (r && n < CAST_BATCH_MAX + 64) {
        arr[n++] = r;
        r = r->next;
    }
    /* overflow defensively: flush the tail separately afterwards */
    castrec_t *tail_rest = r;

    merged_t out[CAST_BATCH_MAX + 64];
    int m = 0;
    int i = 0;
    (void)count;
    while (i < n) {
        int j = i;
        while (j + 1 < n && arr[j + 1]->kind == arr[i]->kind)
            j++;
        int runlen = j - i + 1;
        if (runlen > 1 && kind_mergeable(arr[i]->kind)) {
            size_t ml = 0;
            uint8_t *mp = merge_run(&arr[i], runlen, arr[i]->kind, &ml);
            if (mp != NULL) {
                out[m].kind = arr[i]->kind;
                out[m].payload = mp;
                out[m].len = ml;
                out[m].owns = 1;
                m++;
                i = j + 1;
                continue;
            }
        }
        /* unmerged: one entry per record */
        int k2;
        for (k2 = i; k2 <= j; k2++) {
            out[m].kind = arr[k2]->kind;
            out[m].payload = arr[k2]->data;
            out[m].len = arr[k2]->len;
            out[m].owns = 0;
            m++;
        }
        i = j + 1;
    }

    frame_t *fr = NULL;
    if (m == 1) {
        fr = frame_for_payload(out[0].kind, out[0].payload, out[0].len);
    } else if (m > 1) {
        /* CAST_BATCH body: T_LIST n of T_TUPLE(2)[T_STR kind, body] —
         * each body span is already a tagged value, so splicing the
         * buffered bytes verbatim reproduces
         * wirefmt.encode(CAST_BATCH, 0, [(kind, body_dict)]) exactly */
        size_t plen = 1 + varint_len((uint64_t)m);
        for (i = 0; i < m; i++) {
            const char *kn = rt_kind_names[out[i].kind];
            size_t kl = strlen(kn);
            plen += 1 + 1 + 1 + varint_len(kl) + kl + out[i].len;
        }
        uint8_t *p = malloc(plen);
        if (p != NULL) {
            size_t o = 0;
            p[o++] = T_LIST;
            wr_varint(p, &o, (uint64_t)m);
            for (i = 0; i < m; i++) {
                const char *kn = rt_kind_names[out[i].kind];
                size_t kl = strlen(kn);
                p[o++] = T_TUPLE;
                wr_varint(p, &o, 2);
                p[o++] = T_STR;
                wr_varint(p, &o, kl);
                memcpy(p + o, kn, kl);
                o += kl;
                memcpy(p + o, out[i].payload, out[i].len);
                o += out[i].len;
            }
            fr = frame_for_payload(RT_KIND_CAST_BATCH, p, o);
            free(p);
        }
    }

    for (i = 0; i < m; i++)
        if (out[i].owns)
            free(out[i].payload);
    r = head;
    while (r) {
        castrec_t *nx = r->next;
        free(r);
        r = nx;
    }

    if (fr != NULL) {
        pthread_mutex_lock(&c->mu);
        if (c->closed) {
            free(fr);
        } else {
            ring_append(c, fr);
            c->fl_frames += 1;
            c->fl_bytes += fr->len;
            pthread_cond_broadcast(&c->cv);
        }
        pthread_mutex_unlock(&c->mu);
    }
    pthread_mutex_unlock(&c->fl_mu);
    if (tail_rest != NULL) {
        /* re-attach overflow and flush again */
        pthread_mutex_lock(&c->mu);
        castrec_t *t = tail_rest;
        int cnt2 = 0;
        castrec_t *last = t;
        while (last->next) {
            last = last->next;
            cnt2++;
        }
        cnt2++;
        last->next = c->cb_head;
        c->cb_head = t;
        if (c->cb_tail == NULL)
            c->cb_tail = last;
        c->cb_count += cnt2;
        pthread_mutex_unlock(&c->mu);
        conn_flush_casts(c);
    }
}

/* ------------------------------------------------------------------ */
/* global flusher thread: ~1 ms pass over all conns (the native
 * counterpart of rpc._CastFlusher — bounds the latency of a lone
 * buffered cast without a timer thread per connection). */

static void *flusher_main(void *arg)
{
    (void)arg;
    struct timespec ts = {0, 1000000}; /* 1 ms */
    while (1) {
        nanosleep(&ts, NULL);
        pthread_mutex_lock(&g_mu);
        conn_t *c = g_conns;
        pthread_mutex_unlock(&g_mu);
        /* conn structs are never freed (only their buffers), so the
         * unlocked walk is safe: next_all links are write-once. */
        while (c) {
            int want = 0;
            pthread_mutex_lock(&c->mu);
            want = (!c->closed && c->cb_count > 0);
            pthread_mutex_unlock(&c->mu);
            if (want)
                conn_flush_casts(c);
            c = c->next_all;
        }
    }
    return NULL;
}

/* ------------------------------------------------------------------ */
/* writer thread */

static void *writer_main(void *arg)
{
    conn_t *c = arg;
    for (;;) {
        pthread_mutex_lock(&c->mu);
        while (!c->closed && c->q_head == NULL) {
            c->writer_idle = 1;
            pthread_cond_broadcast(&c->cv); /* drain waiters */
            pthread_cond_wait(&c->cv, &c->mu);
        }
        if (c->closed && c->q_head == NULL) {
            c->writer_idle = 1;
            pthread_cond_broadcast(&c->cv);
            pthread_mutex_unlock(&c->mu);
            break;
        }
        /* pop a batch */
        frame_t *batch[WRITE_IOV_MAX];
        struct iovec iov[WRITE_IOV_MAX];
        int n = 0;
        size_t bytes = 0;
        while (c->q_head && n < WRITE_IOV_MAX) {
            frame_t *f = c->q_head;
            c->q_head = f->next;
            if (c->q_head == NULL)
                c->q_tail = NULL;
            batch[n] = f;
            iov[n].iov_base = f->data;
            iov[n].iov_len = f->len;
            bytes += f->len;
            n++;
        }
        c->writer_idle = 0;
        pthread_mutex_unlock(&c->mu);

        /* send it all (handle partial writev) */
        int err = 0;
        int idx = 0;
        while (idx < n) {
            ssize_t w = writev(c->fd, &iov[idx], n - idx);
            if (w < 0) {
                if (errno == EINTR)
                    continue;
                err = 1;
                break;
            }
            size_t left = (size_t)w;
            while (idx < n && left >= iov[idx].iov_len) {
                left -= iov[idx].iov_len;
                idx++;
            }
            if (idx < n && left > 0) {
                iov[idx].iov_base = (uint8_t *)iov[idx].iov_base + left;
                iov[idx].iov_len -= left;
            }
        }
        int i;
        for (i = 0; i < n; i++)
            free(batch[i]);
        pthread_mutex_lock(&c->mu);
        c->q_bytes -= bytes;
        pthread_cond_broadcast(&c->cv); /* highwater + drain waiters */
        if (err) {
            /* peer gone on the SEND side: mirror rpc._write_loop —
             * drop the queue and force the reader's EOF path (which
             * runs the Python _shutdown teardown) via shutdown(2). */
            ring_clear(c);
            c->closed = 1;
            pthread_cond_broadcast(&c->cv);
            pthread_mutex_unlock(&c->mu);
            shutdown(c->fd, SHUT_RDWR);
            break;
        }
        pthread_mutex_unlock(&c->mu);
    }

    /* last-thread cleanup */
    pthread_mutex_lock(&g_mu);
    int last = (--c->threads_live == 0);
    pthread_mutex_unlock(&g_mu);
    if (last) {
        pthread_mutex_lock(&c->mu);
        ring_clear(c);
        casts_clear(c);
        free(c->acks);
        c->acks = NULL;
        c->acks_len = c->acks_cap = 0;
        c->freed_bufs = 1;
        pthread_mutex_unlock(&c->mu);
        close(c->fd);
    }
    return NULL;
}

/* ------------------------------------------------------------------ */
/* direct_ack sink: parse {"task_ids": [str,...]} casts entirely in C.
 * Returns 0 when consumed, -1 when the frame must go to Python. */

static int sink_ack_frame(conn_t *c, const uint8_t *p, size_t n)
{
    /* p points at the frame body (past the length prefix):
     * [A9][01][kind=2][flags][msgid=0][payload...] */
    if (n < 6 || p[0] != WIRE_MAGIC || p[1] != WIRE_VERSION
        || p[2] != RT_KIND_DIRECT_ACK || p[4] != 0)
        return -1;
    const uint8_t *b = p + 5;
    size_t bn = n - 5;
    uint64_t cnt;
    size_t span;
    if (parse_keyed_container(b, bn, "task_ids", T_LSTR, &cnt, &span))
        return -1;
    /* append each id as [u32 len][bytes] */
    size_t off = span;
    uint64_t i;
    pthread_mutex_lock(&c->mu);
    if (!c->ack_sink) {
        pthread_mutex_unlock(&c->mu);
        return -1;
    }
    for (i = 0; i < cnt; i++) {
        uint64_t sl;
        if (rd_varint(b, bn, &off, &sl) || sl > bn - off)
            break; /* validated already; defensive */
        size_t need = c->acks_len + 4 + (size_t)sl;
        if (need > c->acks_cap) {
            size_t ncap = c->acks_cap ? c->acks_cap * 2 : 4096;
            while (ncap < need)
                ncap *= 2;
            uint8_t *na = realloc(c->acks, ncap);
            if (na == NULL)
                break;
            c->acks = na;
            c->acks_cap = ncap;
        }
        uint8_t *d = c->acks + c->acks_len;
        d[0] = (uint8_t)(sl & 0xFF);
        d[1] = (uint8_t)((sl >> 8) & 0xFF);
        d[2] = (uint8_t)((sl >> 16) & 0xFF);
        d[3] = (uint8_t)((sl >> 24) & 0xFF);
        memcpy(d + 4, b + off, (size_t)sl);
        c->acks_len += 4 + (size_t)sl;
        c->acks_sunk++;
        off += (size_t)sl;
    }
    pthread_mutex_unlock(&c->mu);
    return 0;
}

/* ------------------------------------------------------------------ */
/* reader thread: bulk recv + reassembly + batched GIL delivery */

typedef struct span {
    size_t off;
    size_t len; /* frame body length (without the 4-byte prefix) */
} span_t;

static PyObject *decode_frame_obj(const uint8_t *p, size_t n)
{
    /* Full native decode of a binary hot frame; NULL (no exception) ->
     * caller passes raw bytes through to Python. */
    if (n < 5 || p[0] != WIRE_MAGIC || p[1] != WIRE_VERSION)
        return NULL;
    uint8_t kc = p[2];
    if (kc < 1 || kc > RT_KIND_MAX)
        return NULL;
    size_t off = 4;
    uint64_t msg_id = 0;
    if (p[4] == 0) {
        off = 5;
    } else {
        if (rd_varint(p, n, &off, &msg_id))
            return NULL;
    }
    PyObject *body = dec_value(p, n, &off, 0);
    if (body == NULL)
        return NULL;
    if (off != n) {
        Py_DECREF(body);
        return NULL;
    }
    PyObject *kind = PyUnicode_FromString(rt_kind_names[kc]);
    PyObject *mid = PyLong_FromUnsignedLongLong(msg_id);
    if (kind == NULL || mid == NULL) {
        PyErr_Clear();
        Py_XDECREF(kind);
        Py_XDECREF(mid);
        Py_DECREF(body);
        return NULL;
    }
    PyObject *t = PyTuple_Pack(3, kind, mid, body);
    Py_DECREF(kind);
    Py_DECREF(mid);
    Py_DECREF(body);
    if (t == NULL)
        PyErr_Clear();
    return t;
}

/* deliver a batch of frame spans to the Python callback.
 * Returns 0 to continue, -1 to stop the reader. */
static int deliver_batch(conn_t *c, const uint8_t *buf, span_t *spans,
                         int nspans)
{
    PyGILState_STATE g = PyGILState_Ensure();
    PyObject *list = PyList_New(nspans);
    int stop = 0;
    if (list == NULL) {
        PyErr_Clear();
        PyGILState_Release(g);
        return -1;
    }
    int i;
    for (i = 0; i < nspans; i++) {
        const uint8_t *p = buf + spans[i].off;
        size_t n = spans[i].len;
        PyObject *it = NULL;
        if (n > 0 && p[0] == WIRE_MAGIC)
            it = decode_frame_obj(p, n);
        if (it == NULL) {
            /* pickle frame / exotic / corrupt: raw passthrough — the
             * Python side replays the decode and owns error handling */
            it = PyBytes_FromStringAndSize((const char *)p,
                                           (Py_ssize_t)n);
            if (it == NULL) {
                PyErr_Clear();
                stop = 1;
                Py_DECREF(list);
                PyGILState_Release(g);
                return -1;
            }
        }
        PyList_SET_ITEM(list, i, it);
    }
    PyObject *res = PyObject_CallFunctionObjArgs(c->callback, list, NULL);
    Py_DECREF(list);
    if (res == NULL) {
        PyErr_Print();
        stop = 1;
    } else {
        stop = !PyObject_IsTrue(res);
        Py_DECREF(res);
    }
    PyGILState_Release(g);
    return stop ? -1 : 0;
}

static void deliver_eof(conn_t *c)
{
    PyGILState_STATE g = PyGILState_Ensure();
    PyObject *res =
        PyObject_CallFunctionObjArgs(c->callback, Py_None, NULL);
    if (res == NULL)
        PyErr_Print();
    else
        Py_DECREF(res);
    Py_CLEAR(c->callback);
    PyGILState_Release(g);
}

static void *reader_main(void *arg)
{
    conn_t *c = arg;
    size_t cap = READ_CHUNK;
    uint8_t *buf = malloc(cap);
    size_t have = 0, pos = 0;
    span_t spans[1024];

    if (buf == NULL)
        goto out;
    for (;;) {
        pthread_mutex_lock(&c->mu);
        int closed = c->closed;
        pthread_mutex_unlock(&c->mu);
        if (closed)
            break;
        /* compact + ensure space */
        if (pos > 0) {
            memmove(buf, buf + pos, have - pos);
            have -= pos;
            pos = 0;
        }
        if (have == cap) {
            size_t ncap = cap * 2;
            uint8_t *nb = realloc(buf, ncap);
            if (nb == NULL)
                break;
            buf = nb;
            cap = ncap;
        }
        ssize_t r = recv(c->fd, buf + have, cap - have, 0);
        if (r < 0 && errno == EINTR)
            continue;
        if (r <= 0)
            break;
        have += (size_t)r;

        /* demux complete frames */
        int ns = 0;
        while (have - pos >= 4) {
            uint32_t flen = (uint32_t)buf[pos]
                            | ((uint32_t)buf[pos + 1] << 8)
                            | ((uint32_t)buf[pos + 2] << 16)
                            | ((uint32_t)buf[pos + 3] << 24);
            if ((size_t)flen + 4 > have - pos) {
                /* grow eagerly for oversized frames so the next recv
                 * can complete them in one pass */
                if ((size_t)flen + 4 > cap) {
                    size_t ncap = cap;
                    /* the spans recorded in this pass point into buf:
                     * deliver them before the buffer moves */
                    if (ns > 0) {
                        if (deliver_batch(c, buf, spans, ns))
                            goto out_free;
                        ns = 0;
                    }
                    while (ncap < (size_t)flen + 4)
                        ncap *= 2;
                    /* compact first so pos==0 */
                    if (pos > 0) {
                        memmove(buf, buf + pos, have - pos);
                        have -= pos;
                        pos = 0;
                    }
                    uint8_t *nb = realloc(buf, ncap);
                    if (nb == NULL)
                        goto out_free;
                    buf = nb;
                    cap = ncap;
                }
                break;
            }
            size_t body = pos + 4;
            int sink;
            pthread_mutex_lock(&c->mu);
            sink = c->ack_sink;
            pthread_mutex_unlock(&c->mu);
            if (sink && flen >= 6 && buf[body] == WIRE_MAGIC
                && buf[body + 2] == RT_KIND_DIRECT_ACK
                && sink_ack_frame(c, buf + body, flen) == 0) {
                pos = body + flen;
                continue;
            }
            spans[ns].off = body;
            spans[ns].len = flen;
            ns++;
            pos = body + flen;
            if (ns == 1024) {
                if (deliver_batch(c, buf, spans, ns))
                    goto out_free;
                ns = 0;
            }
        }
        if (ns > 0 && deliver_batch(c, buf, spans, ns))
            goto out_free;
    }
out_free:
    free(buf);
    buf = NULL;
out:
    /* EOF/teardown: tell Python (it runs _shutdown), then close our
     * half. */
    pthread_mutex_lock(&c->mu);
    c->closed = 1;
    ring_clear(c);
    pthread_cond_broadcast(&c->cv);
    pthread_mutex_unlock(&c->mu);
    shutdown(c->fd, SHUT_RDWR);
    if (c->callback)
        deliver_eof(c);

    pthread_mutex_lock(&g_mu);
    int last = (--c->threads_live == 0);
    pthread_mutex_unlock(&g_mu);
    if (last) {
        pthread_mutex_lock(&c->mu);
        ring_clear(c);
        casts_clear(c);
        free(c->acks);
        c->acks = NULL;
        c->acks_len = c->acks_cap = 0;
        c->freed_bufs = 1;
        pthread_mutex_unlock(&c->mu);
        close(c->fd);
    }
    return NULL;
}

/* ------------------------------------------------------------------ */
/* module functions */

static conn_t *conn_from_handle(PyObject *h)
{
    void *p = PyLong_AsVoidPtr(h);
    if (p == NULL && PyErr_Occurred())
        return NULL;
    return (conn_t *)p;
}

static PyObject *py_attach(PyObject *self, PyObject *args)
{
    int fd;
    PyObject *cb;
    unsigned long long high_water = 64ULL << 20;
    (void)self;
    if (!PyArg_ParseTuple(args, "iO|K", &fd, &cb, &high_water))
        return NULL;
    if (!PyCallable_Check(cb)) {
        PyErr_SetString(PyExc_TypeError, "callback must be callable");
        return NULL;
    }
    int dupfd = dup(fd);
    if (dupfd < 0)
        return PyErr_SetFromErrno(PyExc_OSError);
    conn_t *c = calloc(1, sizeof(conn_t));
    if (c == NULL) {
        close(dupfd);
        return PyErr_NoMemory();
    }
    c->fd = dupfd;
    c->high_water = (size_t)high_water;
    c->writer_idle = 1;
    pthread_mutex_init(&c->mu, NULL);
    pthread_mutex_init(&c->fl_mu, NULL);
    pthread_cond_init(&c->cv, NULL);
    Py_INCREF(cb);
    c->callback = cb;
    c->threads_live = 2;

    pthread_mutex_lock(&g_mu);
    c->next_all = g_conns;
    g_conns = c;
    g_live_conns++;
    if (!g_flusher_running) {
        pthread_t ft;
        pthread_attr_t at;
        pthread_attr_init(&at);
        pthread_attr_setdetachstate(&at, PTHREAD_CREATE_DETACHED);
        if (pthread_create(&ft, &at, flusher_main, NULL) == 0)
            g_flusher_running = 1;
        pthread_attr_destroy(&at);
    }
    pthread_mutex_unlock(&g_mu);

    pthread_attr_t at;
    pthread_attr_init(&at);
    pthread_attr_setdetachstate(&at, PTHREAD_CREATE_DETACHED);
    pthread_t wt, rt;
    int e1 = pthread_create(&wt, &at, writer_main, c);
    int e2 = e1 ? e1 : pthread_create(&rt, &at, reader_main, c);
    pthread_attr_destroy(&at);
    if (e1 || e2) {
        pthread_mutex_lock(&c->mu);
        c->closed = 1;
        pthread_cond_broadcast(&c->cv);
        pthread_mutex_unlock(&c->mu);
        if (e1) { /* neither thread exists: free here */
            pthread_mutex_lock(&g_mu);
            c->threads_live = 0;
            pthread_mutex_unlock(&g_mu);
            close(c->fd);
            Py_CLEAR(c->callback);
        }
        PyErr_SetString(PyExc_OSError, "evloop: thread create failed");
        return NULL;
    }
    return PyLong_FromVoidPtr(c);
}

static PyObject *py_send(PyObject *self, PyObject *args)
{
    PyObject *h;
    Py_buffer view;
    (void)self;
    if (!PyArg_ParseTuple(args, "Oy*", &h, &view))
        return NULL;
    conn_t *c = conn_from_handle(h);
    if (c == NULL) {
        PyBuffer_Release(&view);
        return NULL;
    }
    frame_t *f = malloc(sizeof(frame_t) + view.len);
    if (f == NULL) {
        PyBuffer_Release(&view);
        return PyErr_NoMemory();
    }
    f->len = (uint32_t)view.len;
    memcpy(f->data, view.buf, (size_t)view.len);
    PyBuffer_Release(&view);

    int ok = 1;
    Py_BEGIN_ALLOW_THREADS;
    pthread_mutex_lock(&c->mu);
    while (!c->closed && c->q_bytes > c->high_water) {
        struct timespec ts;
        clock_gettime(CLOCK_REALTIME, &ts);
        ts.tv_sec += 1;
        pthread_cond_timedwait(&c->cv, &c->mu, &ts);
    }
    if (c->closed) {
        ok = 0;
        free(f);
    } else {
        ring_append(c, f);
        pthread_cond_broadcast(&c->cv);
    }
    pthread_mutex_unlock(&c->mu);
    Py_END_ALLOW_THREADS;
    return PyBool_FromLong(ok);
}

static PyObject *py_cast(PyObject *self, PyObject *args)
{
    PyObject *h;
    int kind;
    Py_buffer view;
    (void)self;
    if (!PyArg_ParseTuple(args, "Oiy*", &h, &kind, &view))
        return NULL;
    conn_t *c = conn_from_handle(h);
    if (c == NULL || kind < 1 || kind > RT_KIND_MAX) {
        PyBuffer_Release(&view);
        if (c != NULL)
            PyErr_SetString(PyExc_ValueError, "bad kind code");
        return NULL;
    }
    castrec_t *r = malloc(sizeof(castrec_t) + view.len);
    if (r == NULL) {
        PyBuffer_Release(&view);
        return PyErr_NoMemory();
    }
    r->kind = (uint8_t)kind;
    r->len = (uint32_t)view.len;
    r->next = NULL;
    memcpy(r->data, view.buf, (size_t)view.len);
    PyBuffer_Release(&view);

    int full = 0, ok = 1;
    pthread_mutex_lock(&c->mu);
    if (c->closed) {
        ok = 0;
        free(r);
    } else {
        if (c->cb_tail)
            c->cb_tail->next = r;
        else
            c->cb_head = r;
        c->cb_tail = r;
        c->cb_count++;
        full = (c->cb_count >= CAST_BATCH_MAX);
    }
    pthread_mutex_unlock(&c->mu);
    if (full) {
        Py_BEGIN_ALLOW_THREADS;
        conn_flush_casts(c);
        Py_END_ALLOW_THREADS;
    }
    return PyBool_FromLong(ok);
}

static PyObject *py_flush(PyObject *self, PyObject *args)
{
    PyObject *h;
    (void)self;
    if (!PyArg_ParseTuple(args, "O", &h))
        return NULL;
    conn_t *c = conn_from_handle(h);
    if (c == NULL)
        return NULL;
    Py_BEGIN_ALLOW_THREADS;
    conn_flush_casts(c);
    Py_END_ALLOW_THREADS;
    Py_RETURN_NONE;
}

static PyObject *py_drain(PyObject *self, PyObject *args)
{
    PyObject *h;
    double timeout_s = 2.0;
    (void)self;
    if (!PyArg_ParseTuple(args, "O|d", &h, &timeout_s))
        return NULL;
    conn_t *c = conn_from_handle(h);
    if (c == NULL)
        return NULL;
    int drained = 0;
    Py_BEGIN_ALLOW_THREADS;
    conn_flush_casts(c);
    struct timespec dl;
    clock_gettime(CLOCK_REALTIME, &dl);
    dl.tv_sec += (time_t)timeout_s;
    dl.tv_nsec += (long)((timeout_s - (time_t)timeout_s) * 1e9);
    if (dl.tv_nsec >= 1000000000L) {
        dl.tv_sec += 1;
        dl.tv_nsec -= 1000000000L;
    }
    pthread_mutex_lock(&c->mu);
    while (!c->closed && (c->q_head != NULL || !c->writer_idle)) {
        if (pthread_cond_timedwait(&c->cv, &c->mu, &dl) == ETIMEDOUT)
            break;
    }
    drained = (c->q_head == NULL && c->writer_idle);
    pthread_mutex_unlock(&c->mu);
    Py_END_ALLOW_THREADS;
    return PyBool_FromLong(drained);
}

static void conn_close(conn_t *c)
{
    pthread_mutex_lock(&c->mu);
    if (c->closed) {
        pthread_mutex_unlock(&c->mu);
        return;
    }
    c->closed = 1;
    pthread_cond_broadcast(&c->cv);
    pthread_mutex_unlock(&c->mu);
    /* wake the reader out of recv; writer wakes via cv */
    shutdown(c->fd, SHUT_RDWR);
}

static PyObject *py_close(PyObject *self, PyObject *args)
{
    PyObject *h;
    (void)self;
    if (!PyArg_ParseTuple(args, "O", &h))
        return NULL;
    conn_t *c = conn_from_handle(h);
    if (c == NULL)
        return NULL;
    conn_close(c);
    Py_RETURN_NONE;
}

static PyObject *py_take_counters(PyObject *self, PyObject *args)
{
    PyObject *h;
    (void)self;
    if (!PyArg_ParseTuple(args, "O", &h))
        return NULL;
    conn_t *c = conn_from_handle(h);
    if (c == NULL)
        return NULL;
    unsigned long long fr, by;
    pthread_mutex_lock(&c->mu);
    fr = c->fl_frames;
    by = c->fl_bytes;
    c->fl_frames = 0;
    c->fl_bytes = 0;
    pthread_mutex_unlock(&c->mu);
    return Py_BuildValue("(KK)", fr, by);
}

static PyObject *py_set_ack_sink(PyObject *self, PyObject *args)
{
    PyObject *h;
    int on;
    (void)self;
    if (!PyArg_ParseTuple(args, "Op", &h, &on))
        return NULL;
    conn_t *c = conn_from_handle(h);
    if (c == NULL)
        return NULL;
    pthread_mutex_lock(&c->mu);
    c->ack_sink = on;
    pthread_mutex_unlock(&c->mu);
    Py_RETURN_NONE;
}

static PyObject *py_take_acks(PyObject *self, PyObject *args)
{
    PyObject *h;
    (void)self;
    if (!PyArg_ParseTuple(args, "O", &h))
        return NULL;
    conn_t *c = conn_from_handle(h);
    if (c == NULL)
        return NULL;
    uint8_t *data = NULL;
    size_t len = 0;
    pthread_mutex_lock(&c->mu);
    if (c->acks_len > 0 && !c->freed_bufs) {
        data = c->acks;
        len = c->acks_len;
        c->acks = NULL;
        c->acks_len = c->acks_cap = 0;
    }
    pthread_mutex_unlock(&c->mu);
    PyObject *out = PyList_New(0);
    if (out == NULL) {
        free(data);
        return NULL;
    }
    size_t off = 0;
    while (data != NULL && off + 4 <= len) {
        uint32_t sl = (uint32_t)data[off] | ((uint32_t)data[off + 1] << 8)
                      | ((uint32_t)data[off + 2] << 16)
                      | ((uint32_t)data[off + 3] << 24);
        off += 4;
        if (sl > len - off)
            break;
        PyObject *s = PyUnicode_DecodeUTF8((const char *)data + off,
                                           (Py_ssize_t)sl, NULL);
        if (s == NULL) {
            PyErr_Clear();
            off += sl;
            continue;
        }
        if (PyList_Append(out, s) < 0) {
            Py_DECREF(s);
            break;
        }
        Py_DECREF(s);
        off += sl;
    }
    free(data);
    return out;
}

static PyObject *py_queued(PyObject *self, PyObject *args)
{
    PyObject *h;
    (void)self;
    if (!PyArg_ParseTuple(args, "O", &h))
        return NULL;
    conn_t *c = conn_from_handle(h);
    if (c == NULL)
        return NULL;
    size_t q;
    int cb;
    pthread_mutex_lock(&c->mu);
    q = c->q_bytes;
    cb = c->cb_count;
    pthread_mutex_unlock(&c->mu);
    return Py_BuildValue("(ni)", (Py_ssize_t)q, cb);
}

static PyObject *py_kind_codes(PyObject *self, PyObject *args)
{
    (void)self;
    (void)args;
    PyObject *d = PyDict_New();
    if (d == NULL)
        return NULL;
    int i;
    for (i = 1; i <= RT_KIND_MAX; i++) {
        PyObject *v = PyLong_FromLong(i);
        if (v == NULL || PyDict_SetItemString(d, rt_kind_names[i], v) < 0) {
            Py_XDECREF(v);
            Py_DECREF(d);
            return NULL;
        }
        Py_DECREF(v);
    }
    return d;
}

static PyObject *py_shutdown_all(PyObject *self, PyObject *args)
{
    (void)self;
    (void)args;
    pthread_mutex_lock(&g_mu);
    conn_t *c = g_conns;
    pthread_mutex_unlock(&g_mu);
    while (c) {
        conn_close(c);
        c = c->next_all;
    }
    Py_RETURN_NONE;
}

static PyMethodDef methods[] = {
    {"attach", py_attach, METH_VARARGS,
     "attach(fd, callback, high_water=64MiB) -> handle: dup the fd and "
     "start the native reader/writer threads"},
    {"send", py_send, METH_VARARGS,
     "send(handle, frame_bytes) -> bool: enqueue one complete wire "
     "frame (blocks GIL-free past the high-water mark)"},
    {"cast", py_cast, METH_VARARGS,
     "cast(handle, kind_code, payload) -> bool: buffer one hot cast "
     "for the native coalescing flusher"},
    {"flush", py_flush, METH_VARARGS,
     "flush(handle): synchronously merge+frame the cast buffer into "
     "the send ring (ordering barrier before calls)"},
    {"drain", py_drain, METH_VARARGS,
     "drain(handle, timeout_s=2.0) -> bool: wait until the ring is "
     "empty and the writer idle"},
    {"close", py_close, METH_VARARGS,
     "close(handle): shut the lane down (threads exit, dup'd fd "
     "closes)"},
    {"take_counters", py_take_counters, METH_VARARGS,
     "take_counters(handle) -> (frames, bytes) delta of flusher-built "
     "frames since the last take"},
    {"set_ack_sink", py_set_ack_sink, METH_VARARGS,
     "set_ack_sink(handle, on): consume direct_ack casts natively"},
    {"take_acks", py_take_acks, METH_VARARGS,
     "take_acks(handle) -> list[str] of task ids acked since last take"},
    {"queued", py_queued, METH_VARARGS,
     "queued(handle) -> (ring_bytes, cast_count)"},
    {"kind_codes", py_kind_codes, METH_NOARGS,
     "kind_codes() -> {name: code} from the C enum (runtime cross-"
     "check against wirefmt.KIND_CODES)"},
    {"shutdown_all", py_shutdown_all, METH_NOARGS,
     "shutdown_all(): close every lane (atexit hook)"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_evloop",
    "Native event-loop + dispatch core for the rpc hot lane.", -1,
    methods, NULL, NULL, NULL, NULL,
};

PyMODINIT_FUNC PyInit__evloop(void)
{
    PyObject *m = PyModule_Create(&moduledef);
    if (m == NULL)
        return NULL;
    PyModule_AddIntConstant(m, "WIRE_VERSION", WIRE_VERSION);
    PyModule_AddIntConstant(m, "CAST_BATCH_MAX", CAST_BATCH_MAX);
    return m;
}
