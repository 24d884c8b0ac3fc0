/* C interface of piqp_tpu_torch: embeds the CPython runtime and drives
 * piqp_tpu_torch.DenseSolver / piqp_tpu_torch.SparseSolver.  The contract
 * is piqp_tpu_torch_c.h, the JAX package's C interface (csrc/capi.cpp) with
 * the port's device rule.
 *
 * Only the stable parts of the CPython API are used (no numpy C API): C
 * buffers cross into Python as memoryviews copied by numpy, and a solve's
 * result comes back through piqp_tpu_torch.capi.pack_result, one float64
 * host array read with PyObject_GetBuffer.  A Python error of any call,
 * a missing result or info field among them, becomes the call's error
 * code and piqp_tpu_last_error().
 */
#include "piqp_tpu_torch_c.h"

#include <Python.h>

#include <cmath>
#include <cstddef>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

char g_err[1024] = "";
/* the torch device of new workspaces; empty: the port's default (CUDA,
 * and an error without a GPU) */
std::string g_device;

/* An owned reference, released on scope exit. */
class Ref {
  public:
    Ref() = default;
    explicit Ref(PyObject* o) : p_(o) {}
    Ref(const Ref&) = delete;
    Ref& operator=(const Ref&) = delete;
    Ref(Ref&& o) noexcept : p_(o.p_) { o.p_ = nullptr; }
    Ref& operator=(Ref&& o) noexcept
    {
        if (this != &o) {
            Py_XDECREF(p_);
            p_ = o.p_;
            o.p_ = nullptr;
        }
        return *this;
    }
    ~Ref() { Py_XDECREF(p_); }
    PyObject* get() const { return p_; }
    PyObject* release()
    {
        PyObject* o = p_;
        p_ = nullptr;
        return o;
    }
    explicit operator bool() const { return p_ != nullptr; }

  private:
    PyObject* p_ = nullptr;
};

void set_err(const char* msg) { snprintf(g_err, sizeof(g_err), "%s", msg); }

/* Move the pending Python exception into g_err ("Type: message"). */
void set_err_from_python()
{
    PyObject *type = nullptr, *value = nullptr, *tb = nullptr;
    PyErr_Fetch(&type, &value, &tb);
    PyErr_NormalizeException(&type, &value, &tb);
    Ref t(type), v(value), trace(tb);
    if (!v) {
        set_err("unknown python error");
        return;
    }
    Ref s(PyObject_Str(v.get()));
    const char* name = type ? ((PyTypeObject*)type)->tp_name : "Error";
    const char* text = s ? PyUnicode_AsUTF8(s.get()) : nullptr;
    snprintf(g_err, sizeof(g_err), "%s: %s", name, text ? text : "?");
    PyErr_Clear();
}

bool ensure_python()
{
    if (!Py_IsInitialized()) Py_InitializeEx(0);
    return Py_IsInitialized();
}

Ref import(const char* name) { return Ref(PyImport_ImportModule(name)); }

Ref attr(PyObject* o, const char* name)
{
    return Ref(PyObject_GetAttrString(o, name));
}

/* Call o.name(**kw). */
Ref call_kw(PyObject* o, const char* name, PyObject* kw)
{
    Ref fn = attr(o, name);
    Ref args(fn ? PyTuple_New(0) : nullptr);
    return Ref(args ? PyObject_Call(fn.get(), args.get(), kw) : nullptr);
}

bool dict_set(PyObject* d, const char* key, Ref value)
{
    return value && PyDict_SetItemString(d, key, value.get()) == 0;
}

/* A member of a C struct: its name, offset and type (int or double). */
struct Field {
    const char* name;
    size_t offset;
    bool is_int;
};

/* The fields of piqp_tpu_settings, in its order. */
#define PIQP_SET_INT(f) {#f, offsetof(piqp_tpu_settings, f), true}
#define PIQP_SET_DBL(f) {#f, offsetof(piqp_tpu_settings, f), false}
const Field kSettings[] = {
    PIQP_SET_DBL(rho_init),
    PIQP_SET_DBL(delta_init),
    PIQP_SET_DBL(eps_abs),
    PIQP_SET_DBL(eps_rel),
    PIQP_SET_INT(check_duality_gap),
    PIQP_SET_DBL(eps_duality_gap_abs),
    PIQP_SET_DBL(eps_duality_gap_rel),
    PIQP_SET_DBL(infeasibility_threshold),
    PIQP_SET_DBL(reg_lower_limit),
    PIQP_SET_DBL(reg_finetune_lower_limit),
    PIQP_SET_INT(reg_finetune_primal_update_threshold),
    PIQP_SET_INT(reg_finetune_dual_update_threshold),
    PIQP_SET_INT(max_iter),
    PIQP_SET_INT(max_factor_retires),
    PIQP_SET_INT(preconditioner_scale_cost),
    PIQP_SET_INT(preconditioner_reuse_on_update),
    PIQP_SET_INT(preconditioner_iter),
    PIQP_SET_DBL(tau),
    PIQP_SET_INT(kkt_solver),
    PIQP_SET_INT(iterative_refinement_always_enabled),
    PIQP_SET_DBL(iterative_refinement_eps_abs),
    PIQP_SET_DBL(iterative_refinement_eps_rel),
    PIQP_SET_INT(iterative_refinement_max_iter),
    PIQP_SET_DBL(iterative_refinement_min_improvement_rate),
    PIQP_SET_DBL(iterative_refinement_static_regularization_eps),
    PIQP_SET_DBL(iterative_refinement_static_regularization_rel),
    PIQP_SET_INT(verbose),
    PIQP_SET_INT(compute_timings),
    PIQP_SET_INT(use_float32),
    PIQP_SET_INT(mixed_precision),
    PIQP_SET_INT(pallas_kernels),
    PIQP_SET_DBL(refine_mu_factor),
    PIQP_SET_INT(refine_static_passes),
    PIQP_SET_INT(mixed_phase_a_patience),
};
#undef PIQP_SET_INT
#undef PIQP_SET_DBL
static_assert(sizeof(piqp_tpu_kkt_solver) == sizeof(int),
              "kkt_solver is read as an int");

/* piqp_tpu_torch.Settings from the C struct: every field by name through
 * piqp_tpu_torch.capi.settings_from_fields, which holds the mapping
 * (pallas_kernels -1/0/1 -> None/False/True, use_float32 -> dtype, the
 * kkt_solver values -> KKTBackend) and refuses a value outside it.  Sets
 * g_err and returns an empty Ref on failure. */
Ref build_settings(const piqp_tpu_settings* s)
{
    Ref kw(PyDict_New());
    bool ok = bool(kw);
    for (const Field& f : kSettings) {
        if (!ok) break;
        const char* at = (const char*)s + f.offset;
        if (f.is_int) {
            int v;
            memcpy(&v, at, sizeof(v));
            ok = dict_set(kw.get(), f.name, Ref(PyLong_FromLong(v)));
        } else {
            double v;
            memcpy(&v, at, sizeof(v));
            ok = dict_set(kw.get(), f.name, Ref(PyFloat_FromDouble(v)));
        }
    }
    Ref capi = ok ? import("piqp_tpu_torch.capi") : Ref();
    Ref settings(capi ? PyObject_CallMethod(capi.get(), "settings_from_fields", "O",
                                            kw.get())
                      : nullptr);
    if (!settings) set_err_from_python();
    return settings;
}

/* A numpy copy of count items of a C buffer, shaped (rows, cols) when
 * cols >= 0, else 1-D. */
Ref np_copy(PyObject* np, const void* ptr, Py_ssize_t count, size_t itemsize,
            const char* dtype, int rows = -1, int cols = -1)
{
    Ref mv(PyMemoryView_FromMemory((char*)ptr, count * (Py_ssize_t)itemsize,
                                   PyBUF_READ));
    Ref view(mv ? PyObject_CallMethod(np, "frombuffer", "Os", mv.get(), dtype)
                : nullptr);
    Ref arr(view ? PyObject_CallMethod(view.get(), "copy", nullptr) : nullptr);
    if (arr && cols >= 0)
        return Ref(PyObject_CallMethod(arr.get(), "reshape", "ii", rows, cols));
    return arr;
}

Ref dense_array(PyObject* np, const double* ptr, int rows, int cols = -1)
{
    Py_ssize_t count = (Py_ssize_t)rows * (cols >= 0 ? cols : 1);
    return np_copy(np, ptr, count, sizeof(double), "float64", rows, cols);
}

/* scipy.sparse.csc_matrix((x, i, p), shape=(m, n)) over copies of the C
 * arrays. */
Ref csc_matrix(PyObject* np, PyObject* spmod, const piqp_tpu_csc* M)
{
    Ref vals = np_copy(np, M->x, M->nnz, sizeof(double), "float64");
    Ref idx = np_copy(np, M->i, M->nnz, sizeof(int), "int32");
    Ref ptr = np_copy(np, M->p, (Py_ssize_t)M->n + 1, sizeof(int), "int32");
    if (!vals || !idx || !ptr) return Ref();
    Ref args(Py_BuildValue("((OOO))", vals.get(), idx.get(), ptr.get()));
    Ref kw(Py_BuildValue("{s:(ii)}", "shape", M->m, M->n));
    Ref cls = attr(spmod, "csc_matrix");
    if (!args || !kw || !cls) return Ref();
    return Ref(PyObject_Call(cls.get(), args.get(), kw.get()));
}

struct Vec {
    const char* name;
    const double* ptr;
    int size;
};

bool add_vectors(PyObject* np, PyObject* kwargs, const Vec* vecs, int count)
{
    for (int k = 0; k < count; ++k) {
        if (!vecs[k].ptr || vecs[k].size == 0) continue;
        if (!dict_set(kwargs, vecs[k].name,
                      dense_array(np, vecs[k].ptr, vecs[k].size)))
            return false;
    }
    return true;
}

/* keyword arguments of DenseSolver.setup / update */
Ref dense_kwargs(PyObject* np, const piqp_tpu_dense_data* d)
{
    Ref kw(PyDict_New());
    if (!kw) return kw;
    struct Mat {
        const char* name;
        const double* ptr;
        int rows;
    } mats[] = {{"P", d->P, d->n}, {"A", d->A, d->p}, {"G", d->G, d->m}};
    for (const Mat& M : mats) {
        if (!M.ptr || M.rows == 0) continue;
        if (!dict_set(kw.get(), M.name, dense_array(np, M.ptr, M.rows, d->n)))
            return Ref();
    }
    const Vec vecs[] = {
        {"c", d->c, d->n},     {"b", d->b, d->p},     {"h_l", d->h_l, d->m},
        {"h_u", d->h_u, d->m}, {"x_l", d->x_l, d->n}, {"x_u", d->x_u, d->n},
    };
    if (!add_vectors(np, kw.get(), vecs, 6)) return Ref();
    return kw;
}

/* keyword arguments of SparseSolver.setup / update */
Ref sparse_kwargs(PyObject* np, PyObject* spmod,
                  const piqp_tpu_sparse_data* d)
{
    Ref kw(PyDict_New());
    if (!kw) return kw;
    struct Mat {
        const char* name;
        const piqp_tpu_csc* M;
    } mats[] = {{"P", d->P}, {"A", d->A}, {"G", d->G}};
    for (const Mat& M : mats) {
        if (!M.M) continue;
        if (!dict_set(kw.get(), M.name, csc_matrix(np, spmod, M.M)))
            return Ref();
    }
    const Vec vecs[] = {
        {"c", d->c, d->n},     {"b", d->b, d->p},     {"h_l", d->h_l, d->m},
        {"h_u", d->h_u, d->m}, {"x_l", d->x_l, d->n}, {"x_u", d->x_u, d->n},
    };
    if (!add_vectors(np, kw.get(), vecs, 6)) return Ref();
    return kw;
}

Ref problem_kwargs(bool sparse, const void* data)
{
    Ref np = import("numpy");
    if (!np) return np;
    if (!sparse)
        return dense_kwargs(np.get(), (const piqp_tpu_dense_data*)data);
    Ref spmod = import("scipy.sparse");
    if (!spmod) return spmod;
    return sparse_kwargs(np.get(), spmod.get(),
                         (const piqp_tpu_sparse_data*)data);
}

/* The result's vectors and info fields, in the order pack_result returns
 * them; the info fields are those of piqp_tpu_info, in its order. */
const char* const kVectors[] = {"x",   "y",   "z_l", "z_u",  "z_bl",
                                "z_bu", "s_l", "s_u", "s_bl", "s_bu"};
constexpr int kNumVectors = 10;

#define PIQP_INFO_INT(f) {#f, offsetof(piqp_tpu_info, f), true}
#define PIQP_INFO_DBL(f) {#f, offsetof(piqp_tpu_info, f), false}
const Field kInfo[] = {
    PIQP_INFO_INT(status),           PIQP_INFO_INT(iter),
    PIQP_INFO_DBL(rho),              PIQP_INFO_DBL(delta),
    PIQP_INFO_DBL(mu),               PIQP_INFO_DBL(sigma),
    PIQP_INFO_DBL(primal_step),      PIQP_INFO_DBL(dual_step),
    PIQP_INFO_DBL(primal_res),       PIQP_INFO_DBL(primal_res_rel),
    PIQP_INFO_DBL(dual_res),         PIQP_INFO_DBL(dual_res_rel),
    PIQP_INFO_DBL(primal_res_reg),   PIQP_INFO_DBL(primal_res_reg_rel),
    PIQP_INFO_DBL(dual_res_reg),     PIQP_INFO_DBL(dual_res_reg_rel),
    PIQP_INFO_DBL(primal_prox_inf),  PIQP_INFO_DBL(dual_prox_inf),
    PIQP_INFO_DBL(prev_primal_res),  PIQP_INFO_DBL(prev_dual_res),
    PIQP_INFO_DBL(primal_obj),       PIQP_INFO_DBL(dual_obj),
    PIQP_INFO_DBL(duality_gap),      PIQP_INFO_DBL(duality_gap_rel),
    PIQP_INFO_INT(factor_retires),   PIQP_INFO_DBL(reg_limit),
    PIQP_INFO_INT(no_primal_update), PIQP_INFO_INT(no_dual_update),
    PIQP_INFO_DBL(setup_time),       PIQP_INFO_DBL(update_time),
    PIQP_INFO_DBL(solve_time),       PIQP_INFO_DBL(kkt_factor_time),
    PIQP_INFO_DBL(kkt_solve_time),   PIQP_INFO_DBL(run_time),
};
#undef PIQP_INFO_INT
#undef PIQP_INFO_DBL
constexpr int kNumInfo = sizeof(kInfo) / sizeof(kInfo[0]);

Ref vector_names()
{
    Ref t(PyTuple_New(kNumVectors));
    for (int k = 0; t && k < kNumVectors; ++k) {
        PyObject* s = PyUnicode_FromString(kVectors[k]);
        if (!s) return Ref();
        PyTuple_SET_ITEM(t.get(), k, s);
    }
    return t;
}

Ref info_names()
{
    Ref t(PyTuple_New(kNumInfo));
    for (int k = 0; t && k < kNumInfo; ++k) {
        PyObject* s = PyUnicode_FromString(kInfo[k].name);
        if (!s) return Ref();
        PyTuple_SET_ITEM(t.get(), k, s);
    }
    return t;
}

}  // namespace

struct piqp_tpu_workspace {
    PyObject* solver = nullptr; /* DenseSolver or SparseSolver instance */
    int n = 0, p = 0, m = 0;
    piqp_tpu_settings settings; /* C mirror of the active settings */
    /* the last result: the ten vectors, back to back (5n + p + 4m) */
    std::vector<double> packed;
    piqp_tpu_info info;
    bool solved_once = false;
};

extern "C" {

const char* piqp_tpu_last_error(void) { return g_err; }

int piqp_tpu_set_device(const char* device)
{
    g_device = device ? device : "";
    return 0;
}

void piqp_tpu_settings_default(piqp_tpu_settings* s)
{
    memset(s, 0, sizeof(*s));
    s->rho_init = 1e-6;
    s->delta_init = 1e-4;
    s->eps_abs = 1e-8;
    s->eps_rel = 1e-9;
    s->check_duality_gap = 1;
    s->eps_duality_gap_abs = 1e-8;
    s->eps_duality_gap_rel = 1e-9;
    s->infeasibility_threshold = 0.9;
    s->reg_lower_limit = 1e-10;
    s->reg_finetune_lower_limit = 1e-13;
    s->reg_finetune_primal_update_threshold = 7;
    s->reg_finetune_dual_update_threshold = 7;
    s->max_iter = 250;
    s->max_factor_retires = 10;
    s->preconditioner_scale_cost = 0;
    s->preconditioner_reuse_on_update = 0;
    s->preconditioner_iter = 10;
    s->tau = 0.99;
    s->kkt_solver = PIQP_TPU_DENSE_CHOLESKY;
    s->iterative_refinement_always_enabled = 0;
    s->iterative_refinement_eps_abs = 1e-12;
    s->iterative_refinement_eps_rel = 1e-12;
    s->iterative_refinement_max_iter = 10;
    s->iterative_refinement_min_improvement_rate = 5.0;
    s->iterative_refinement_static_regularization_eps = 1e-8;
    s->iterative_refinement_static_regularization_rel = -1.0; /* default */
    s->verbose = 0;
    s->compute_timings = 0;
    s->use_float32 = 0;
    s->mixed_precision = 0;
    s->pallas_kernels = -1; /* the hand-written kernels */
    s->refine_mu_factor = 1e-2;
    s->refine_static_passes = 1;
    s->mixed_phase_a_patience = 12;
}

}  // extern "C"

namespace {

/* Build the solver object on the chosen device and run setup(**kwargs). */
piqp_tpu_workspace* setup_common(const char* solver_cls,
                                 const piqp_tpu_settings* settings,
                                 bool sparse, const void* data, int n, int p,
                                 int m)
{
    if (!ensure_python()) {
        set_err("python init failed");
        return nullptr;
    }
    piqp_tpu_settings defaults;
    if (!settings) {
        piqp_tpu_settings_default(&defaults);
        settings = &defaults;
    }
    Ref mod = import("piqp_tpu_torch");
    if (!mod) {
        set_err_from_python();
        return nullptr;
    }
    Ref py_settings = build_settings(settings);
    if (!py_settings) return nullptr;
    Ref kw(PyDict_New());
    bool ok = kw && dict_set(kw.get(), "settings", std::move(py_settings));
    if (ok && !g_device.empty())
        ok = dict_set(kw.get(), "device",
                      Ref(PyUnicode_FromString(g_device.c_str())));
    Ref solver;
    if (ok) solver = call_kw(mod.get(), solver_cls, kw.get());
    Ref problem;
    if (solver) problem = problem_kwargs(sparse, data);
    Ref done;
    if (problem) done = call_kw(solver.get(), "setup", problem.get());
    if (!done) {
        set_err_from_python();
        return nullptr;
    }
    piqp_tpu_workspace* w = new piqp_tpu_workspace();
    w->solver = solver.release();
    w->n = n;
    w->p = p;
    w->m = m;
    w->settings = *settings;
    memset(&w->info, 0, sizeof(w->info));
    w->info.status = -9; /* UNSOLVED */
    return w;
}

int update_common(piqp_tpu_workspace* w, bool sparse, const void* data)
{
    if (!w) {
        set_err("no workspace");
        return -1;
    }
    Ref problem = problem_kwargs(sparse, data);
    Ref done;
    if (problem) done = call_kw(w->solver, "update", problem.get());
    if (!done) {
        set_err_from_python();
        return -1;
    }
    return 0;
}

/* Copy the solver's result into the workspace: one pack_result call (one
 * device-to-host copy) and one buffer read. */
bool pull_result(piqp_tpu_workspace* w)
{
    Ref capi = import("piqp_tpu_torch.capi");
    Ref res = attr(w->solver, "result");
    Ref vecs = vector_names();
    Ref infos = info_names();
    if (!capi || !res || !vecs || !infos) return false;
    Ref packed(PyObject_CallMethod(capi.get(), "pack_result", "OOO", res.get(),
                                   vecs.get(), infos.get()));
    if (!packed) return false;
    Py_buffer view;
    if (PyObject_GetBuffer(packed.get(), &view, PyBUF_C_CONTIGUOUS) != 0)
        return false;
    size_t nvec = 5 * (size_t)w->n + (size_t)w->p + 4 * (size_t)w->m;
    size_t count = (size_t)view.len / sizeof(double);
    if (view.itemsize != (Py_ssize_t)sizeof(double) ||
        count != nvec + kNumInfo) {
        PyBuffer_Release(&view);
        PyErr_Format(PyExc_ValueError,
                     "result holds %zu values, expected %zu (n=%d p=%d m=%d)",
                     count, nvec + kNumInfo, w->n, w->p, w->m);
        return false;
    }
    const double* v = (const double*)view.buf;
    w->packed.assign(v, v + nvec);
    memset(&w->info, 0, sizeof(w->info));
    for (int k = 0; k < kNumInfo; ++k) {
        char* dst = (char*)&w->info + kInfo[k].offset;
        double value = v[nvec + k];
        if (kInfo[k].is_int) {
            int iv = (int)value;
            memcpy(dst, &iv, sizeof(iv));
        } else {
            memcpy(dst, &value, sizeof(value));
        }
    }
    PyBuffer_Release(&view);
    return true;
}

int solve_impl(piqp_tpu_workspace* w, bool warm_start)
{
    if (!w) {
        set_err("no workspace");
        return -100;
    }
    Ref status(PyObject_CallMethod(w->solver, "solve", "O",
                                   warm_start ? Py_True : Py_False));
    Ref num(status ? PyNumber_Long(status.get()) : nullptr);
    long code = num ? PyLong_AsLong(num.get()) : -100;
    if (!num || PyErr_Occurred()) {
        set_err_from_python();
        return -100;
    }
    if (code == -10) {
        /* INVALID_SETTINGS: the solver ran nothing and has no result */
        w->packed.assign(5 * (size_t)w->n + w->p + 4 * (size_t)w->m, NAN);
        memset(&w->info, 0, sizeof(w->info));
    } else if (!pull_result(w)) {
        set_err_from_python();
        return -100;
    }
    w->info.status = (int)code;
    w->solved_once = true;
    return (int)code;
}

}  // namespace

extern "C" {

piqp_tpu_workspace* piqp_tpu_setup_dense(const piqp_tpu_dense_data* data,
                                         const piqp_tpu_settings* settings)
{
    return setup_common("DenseSolver", settings, false, data, data->n,
                        data->p, data->m);
}

piqp_tpu_workspace* piqp_tpu_setup_sparse(const piqp_tpu_sparse_data* data,
                                          const piqp_tpu_settings* settings)
{
    return setup_common("SparseSolver", settings, true, data, data->n,
                        data->p, data->m);
}

int piqp_tpu_update_dense(piqp_tpu_workspace* w,
                          const piqp_tpu_dense_data* data)
{
    return update_common(w, false, data);
}

int piqp_tpu_update_sparse(piqp_tpu_workspace* w,
                           const piqp_tpu_sparse_data* data)
{
    return update_common(w, true, data);
}

int piqp_tpu_update_settings(piqp_tpu_workspace* w,
                             const piqp_tpu_settings* settings)
{
    if (!w || !settings) {
        set_err("no workspace or settings");
        return -1;
    }
    Ref py_settings = build_settings(settings);
    if (!py_settings) return -1;
    if (PyObject_SetAttrString(w->solver, "settings", py_settings.get()) != 0) {
        set_err_from_python();
        return -1;
    }
    w->settings = *settings;
    return 0;
}

int piqp_tpu_get_settings(piqp_tpu_workspace* w, piqp_tpu_settings* out)
{
    if (!w || !out) return -1;
    *out = w->settings;
    return 0;
}

int piqp_tpu_solve(piqp_tpu_workspace* w) { return solve_impl(w, false); }

int piqp_tpu_solve_warm(piqp_tpu_workspace* w)
{
    return solve_impl(w, w && w->solved_once);
}

int piqp_tpu_get_result(piqp_tpu_workspace* w, piqp_tpu_result* out)
{
    if (!w || !w->solved_once) {
        set_err("no solve performed yet");
        return -1;
    }
    const double* v = w->packed.data();
    const int n = w->n, p = w->p, m = w->m;
    out->x = v;
    out->y = v += n;
    out->z_l = v += p;
    out->z_u = v += m;
    out->z_bl = v += m;
    out->z_bu = v += n;
    out->s_l = v += n;
    out->s_u = v += m;
    out->s_bl = v += m;
    out->s_bu = v += n;
    out->info = w->info;
    out->status = w->info.status;
    out->iter = w->info.iter;
    out->primal_obj = w->info.primal_obj;
    out->primal_res = w->info.primal_res;
    out->dual_res = w->info.dual_res;
    return 0;
}

void piqp_tpu_free(piqp_tpu_workspace* w)
{
    if (!w) return;
    Py_XDECREF(w->solver);
    delete w;
}

}  // extern "C"
