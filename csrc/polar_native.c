/* polar_tpu native runtime: code construction + Fast-SSC compilation.
 *
 * C implementation of the host-side (non-device) components, mirroring the
 * roles of the reference's polar_freezer.hh / polar_compiler.hh but
 * redesigned for this framework:
 *
 *  - Bhattacharyya bit-channel evolution in DUAL log-domain double
 *    precision — log(pe) and log(1-pe) evolved jointly (the reference's
 *    linear long-double recursion underflows to exact 0 near pe->0 and
 *    saturates to exactly 1 near pe->1, degenerating its ranking to
 *    arbitrary ties; each log domain is exact where the other
 *    saturates, keeping the ranking total in both tails).
 *  - Fixed-K selection (argsort with stable index tie-break) and
 *    threshold freezing.
 *  - Frozen-mask -> Fast-SSC byte-program compilation (same opcodes and
 *    classification as the reference's polar_compiler.hh:11-49, written
 *    iteratively with an explicit stack so N up to 2^30 cannot overflow
 *    the C call stack).
 *
 * Exposed as a CPython extension module (no pybind11 dependency); the
 * Python layer (polar_tpu.code.native) falls back to the numpy
 * implementation when the extension is not built.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <math.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* ------------------------------------------------------------------ */
/* Bhattacharyya log-domain evolution                                  */
/* ------------------------------------------------------------------ */

/* Fill lp[0..2^level) = log(pe) and lq[0..2^level) = log(1-pe), natural
 * leaf order (left child = pe*(2-pe) owns the first half of each block).
 * Dual-domain evolution: left lq' = 2*lq (exact near pe->1), right
 * lp' = 2*lp (exact near pe->0).
 *
 * The update formulas and their pe<0.5 branch point are EXACTLY those of
 * polar_tpu.code.construction.bhattacharyya_dual (same transcendental
 * calls, same operand order). Residual differences vs numpy are last-ulp
 * diffs between numpy's SIMD exp/log1p and glibc's — amplified only in
 * the zone where that domain is not the ranking key (lq near 0 where lp
 * decides, lp near 0 where lq decides); masks agree at every tested
 * design point including extreme tails (tests/test_native.py). */
static void bhatt_logpe(int level, double log_pe0, double log_q0,
                        double *lp, double *lq)
{
	lp[0] = log_pe0;
	lq[0] = log_q0;
	for (int l = 0; l < level; ++l) {
		int n = 1 << l;
		/* expand in place from the back so children don't clobber
		 * unread parents */
		for (int i = n - 1; i >= 0; --i) {
			double p = lp[i], q = lq[i];
			double pe = exp(p);
			/* left: log(pe(2-pe)); the direct form is
			 * well-conditioned for pe < 1/2, the (1-pe)-domain
			 * identity log1p(-(1-pe)^2) for pe >= 1/2 */
			double left = (pe < 0.5)
				? p + M_LN2 + log1p(-0.5 * pe)
				: log1p(-exp(2.0 * q));
			lp[2 * i] = left;
			lp[2 * i + 1] = 2.0 * p;
			lq[2 * i] = 2.0 * q;
			lq[2 * i + 1] = q + log1p(pe);
		}
	}
}

/* argsort helper: sort indices by (lp asc, lq desc, index asc) — the
 * lq tie-break resolves channels whose lp saturated at 0 (pe -> 1) */
typedef struct { double v; double q; uint32_t i; } kv_t;

static int kv_cmp(const void *a, const void *b)
{
	const kv_t *x = (const kv_t *)a, *y = (const kv_t *)b;
	if (x->v < y->v) return -1;
	if (x->v > y->v) return 1;
	if (x->q > y->q) return -1;
	if (x->q < y->q) return 1;
	return (x->i < y->i) ? -1 : (x->i > y->i);
}

/* ------------------------------------------------------------------ */
/* Fast-SSC compiler (iterative, explicit stack)                       */
/* ------------------------------------------------------------------ */

enum {
	OP_LEFT = 0, OP_RIGHT = 1, OP_COMB = 2, OP_RATE0 = 3, OP_RATE1 = 4,
	OP_REP = 5, OP_SPC = 6, OP_RATE0_RIGHT = 7, OP_RATE0_COMB = 8,
	OP_RATE1_COMB = 9, OP_END = 255
};

/* prefix[i] = number of frozen bits in frozen[0..i) — O(1) range counts */
static int64_t *build_prefix(const uint8_t *frozen, int64_t n)
{
	int64_t *prefix = (int64_t *)malloc((size_t)(n + 1) * sizeof(int64_t));
	if (!prefix)
		return NULL;
	prefix[0] = 0;
	for (int64_t i = 0; i < n; ++i)
		prefix[i + 1] = prefix[i] + (frozen[i] ? 1 : 0);
	return prefix;
}

typedef struct { int64_t base; int level; uint8_t post; } frame_t;

/* Compile classification identical to polar_compiler.hh:21-49; `post`
 * carries the opcode to emit after a subtree returns. Returns program
 * length or -1 on error. */
static int64_t compile_program(const uint8_t *frozen, int level, uint8_t *out,
                               int64_t out_cap)
{
	int64_t n = (int64_t)1 << level;
	int64_t *prefix = build_prefix(frozen, n);
	if (!prefix)
		return -1;
		/* a "branch" descend leaves 3 frames behind per level, so the
	 * worst-case stack depth is 3*level + O(1) */
	frame_t *stack = (frame_t *)malloc((size_t)(4 * level + 8) * sizeof(frame_t));
	int64_t sp = 0, len = 0;
	if (!stack) {
		free(prefix);
		return -1;
	}
#define EMIT(op) do { \
	if (len >= out_cap) goto fail; \
	out[len++] = (uint8_t)(op); \
} while (0)
#define CNT(lo, hi) (prefix[(hi)] - prefix[(lo)])

	EMIT(level);
	stack[sp++] = (frame_t){0, level, OP_END};
	while (sp > 0) {
		frame_t f = stack[--sp];
		if (f.base < 0) { /* post-visit marker: emit the stored opcode */
			EMIT(f.post);
			continue;
		}
		int64_t base = f.base, half = (int64_t)1 << (f.level - 1);
		int64_t lcnt = CNT(base, base + half);
		int64_t rcnt = CNT(base + half, base + 2 * half);
		if (lcnt == half && rcnt == half) {
			EMIT(OP_RATE0);
		} else if (lcnt == 0 && rcnt == 0) {
			EMIT(OP_RATE1);
		} else if (lcnt == half && rcnt == half - 1 &&
		           !frozen[base + 2 * half - 1]) {
			EMIT(OP_REP);
		} else if (lcnt == 1 && rcnt == 0 && frozen[base]) {
			EMIT(OP_SPC);
		} else if (lcnt == half) {
			EMIT(OP_RATE0_RIGHT);
			stack[sp++] = (frame_t){-1, 0, OP_RATE0_COMB};
			stack[sp++] = (frame_t){base + half, f.level - 1, 0};
		} else if (rcnt == 0) {
			EMIT(OP_LEFT);
			stack[sp++] = (frame_t){-1, 0, OP_RATE1_COMB};
			stack[sp++] = (frame_t){base, f.level - 1, 0};
		} else {
			EMIT(OP_LEFT);
			stack[sp++] = (frame_t){-1, 0, OP_COMB};
			stack[sp++] = (frame_t){base + half, f.level - 1, 0};
			stack[sp++] = (frame_t){-1, 0, OP_RIGHT};
			stack[sp++] = (frame_t){base, f.level - 1, 0};
		}
	}
	EMIT(OP_END);
	free(stack);
	free(prefix);
	return len;
fail:
	free(stack);
	free(prefix);
	return -1;
}
#undef EMIT
#undef CNT

/* ------------------------------------------------------------------ */
/* Python bindings                                                     */
/* ------------------------------------------------------------------ */

static PyObject *py_bhatt_logpe(PyObject *self, PyObject *args)
{
	int level;
	double pe;
	(void)self;
	if (!PyArg_ParseTuple(args, "id", &level, &pe))
		return NULL;
	if (level < 0 || level > 30) {
		PyErr_SetString(PyExc_ValueError, "level out of range [0, 30]");
		return NULL;
	}
	if (!(pe > 0.0 && pe < 1.0)) {
		PyErr_SetString(PyExc_ValueError, "pe must be in (0, 1)");
		return NULL;
	}
	int64_t n = (int64_t)1 << level;
	PyObject *bytes = PyBytes_FromStringAndSize(NULL, n * (int64_t)sizeof(double));
	double *lq = (double *)malloc((size_t)n * sizeof(double));
	if (!bytes || !lq) {
		Py_XDECREF(bytes);
		free(lq);
		return PyErr_NoMemory();
	}
	double *buf = (double *)PyBytes_AS_STRING(bytes);
	Py_BEGIN_ALLOW_THREADS
	bhatt_logpe(level, log(pe), log1p(-pe), buf, lq);
	Py_END_ALLOW_THREADS
	free(lq);
	return bytes;
}

static PyObject *py_bhatt_dual(PyObject *self, PyObject *args)
{
	int level;
	double pe;
	(void)self;
	if (!PyArg_ParseTuple(args, "id", &level, &pe))
		return NULL;
	if (level < 0 || level > 30) {
		PyErr_SetString(PyExc_ValueError, "level out of range [0, 30]");
		return NULL;
	}
	if (!(pe > 0.0 && pe < 1.0)) {
		PyErr_SetString(PyExc_ValueError, "pe must be in (0, 1)");
		return NULL;
	}
	int64_t n = (int64_t)1 << level;
	/* layout: lp[0..n) then lq[0..n), both float64 */
	PyObject *bytes = PyBytes_FromStringAndSize(NULL, 2 * n * (int64_t)sizeof(double));
	if (!bytes)
		return NULL;
	double *buf = (double *)PyBytes_AS_STRING(bytes);
	Py_BEGIN_ALLOW_THREADS
	bhatt_logpe(level, log(pe), log1p(-pe), buf, buf + n);
	Py_END_ALLOW_THREADS
	return bytes;
}

static PyObject *py_frozen_fixed_k(PyObject *self, PyObject *args)
{
	int level;
	int64_t k;
	double pe;
	(void)self;
	if (!PyArg_ParseTuple(args, "iLd", &level, &k, &pe))
		return NULL;
	if (level < 0 || level > 30) {
		PyErr_SetString(PyExc_ValueError, "level out of range [0, 30]");
		return NULL;
	}
	int64_t n = (int64_t)1 << level;
	if (k < 0 || k > n) {
		PyErr_SetString(PyExc_ValueError, "K out of range");
		return NULL;
	}
	double *logpe = (double *)malloc((size_t)n * sizeof(double));
	double *logq = (double *)malloc((size_t)n * sizeof(double));
	kv_t *kv = (kv_t *)malloc((size_t)n * sizeof(kv_t));
	PyObject *bytes = PyBytes_FromStringAndSize(NULL, n);
	if (!logpe || !logq || !kv || !bytes) {
		free(logpe);
		free(logq);
		free(kv);
		Py_XDECREF(bytes);
		return PyErr_NoMemory();
	}
	uint8_t *mask = (uint8_t *)PyBytes_AS_STRING(bytes);
	Py_BEGIN_ALLOW_THREADS
	bhatt_logpe(level, log(pe), log1p(-pe), logpe, logq);
	for (int64_t i = 0; i < n; ++i) {
		kv[i].v = logpe[i];
		kv[i].q = logq[i];
		kv[i].i = (uint32_t)i;
	}
	qsort(kv, (size_t)n, sizeof(kv_t), kv_cmp);
	memset(mask, 1, (size_t)n);
	for (int64_t i = 0; i < k; ++i)
		mask[kv[i].i] = 0;
	Py_END_ALLOW_THREADS
	free(logpe);
	free(logq);
	free(kv);
	return bytes;
}

static PyObject *py_frozen_threshold(PyObject *self, PyObject *args)
{
	int level;
	double pe, th;
	(void)self;
	if (!PyArg_ParseTuple(args, "idd", &level, &pe, &th))
		return NULL;
	if (level < 0 || level > 30) {
		PyErr_SetString(PyExc_ValueError, "level out of range [0, 30]");
		return NULL;
	}
	int64_t n = (int64_t)1 << level;
	double *logpe = (double *)malloc((size_t)n * sizeof(double));
	double *logq = (double *)malloc((size_t)n * sizeof(double));
	PyObject *bytes = PyBytes_FromStringAndSize(NULL, n);
	if (!logpe || !logq || !bytes) {
		free(logpe);
		free(logq);
		Py_XDECREF(bytes);
		return PyErr_NoMemory();
	}
	uint8_t *mask = (uint8_t *)PyBytes_AS_STRING(bytes);
	double log_th = log(th);
	Py_BEGIN_ALLOW_THREADS
	bhatt_logpe(level, log(pe), log1p(-pe), logpe, logq);
	for (int64_t i = 0; i < n; ++i)
		mask[i] = logpe[i] > log_th;
	Py_END_ALLOW_THREADS
	free(logpe);
	free(logq);
	return bytes;
}

static PyObject *py_compile_program(PyObject *self, PyObject *args)
{
	Py_buffer frozen;
	int level;
	(void)self;
	if (!PyArg_ParseTuple(args, "y*i", &frozen, &level))
		return NULL;
	int64_t n = (int64_t)1 << level;
	if (level < 1 || level > 30 || frozen.len != n) {
		PyBuffer_Release(&frozen);
		PyErr_SetString(PyExc_ValueError, "bad level / mask length");
		return NULL;
	}
	/* worst-case program: general nodes all the way down ~ 3 ops/node */
	int64_t cap = 4 * n + 16;
	uint8_t *out = (uint8_t *)malloc((size_t)cap);
	if (!out) {
		PyBuffer_Release(&frozen);
		return PyErr_NoMemory();
	}
	int64_t len;
	Py_BEGIN_ALLOW_THREADS
	len = compile_program((const uint8_t *)frozen.buf, level, out, cap);
	Py_END_ALLOW_THREADS
	PyBuffer_Release(&frozen);
	if (len < 0) {
		free(out);
		PyErr_SetString(PyExc_RuntimeError, "compile failed");
		return NULL;
	}
	PyObject *bytes = PyBytes_FromStringAndSize((const char *)out, len);
	free(out);
	return bytes;
}

static PyMethodDef methods[] = {
	{"bhatt_logpe", py_bhatt_logpe, METH_VARARGS,
	 "bhatt_logpe(level, pe) -> bytes of float64 log erasure probabilities"},
	{"bhatt_dual", py_bhatt_dual, METH_VARARGS,
	 "bhatt_dual(level, pe) -> bytes of float64 [log pe..., log(1-pe)...]"},
	{"frozen_fixed_k", py_frozen_fixed_k, METH_VARARGS,
	 "frozen_fixed_k(level, K, pe) -> uint8 mask bytes (1 = frozen)"},
	{"frozen_threshold", py_frozen_threshold, METH_VARARGS,
	 "frozen_threshold(level, pe, th) -> uint8 mask bytes"},
	{"compile_program", py_compile_program, METH_VARARGS,
	 "compile_program(mask_bytes, level) -> Fast-SSC byte program"},
	{NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
	PyModuleDef_HEAD_INIT, "_polar_native",
	"Native code construction + Fast-SSC compiler for polar_tpu",
	-1, methods, NULL, NULL, NULL, NULL,
};

PyMODINIT_FUNC PyInit__polar_native(void)
{
	return PyModule_Create(&moduledef);
}
