/* Driver and test of the port's C interface.
 *
 *   test_capi [DEVICE]        the checks of the JAX package's C test
 *                             (csrc/test_capi.c): the doc QP, a warm update,
 *                             the info mirror, the settings round-trip,
 *                             compute_timings via update_settings, sparse
 *                             setup and update, dense_ldlt; and invalid
 *                             settings give INVALID_SETTINGS
 *   test_capi DEVICE DIR...   file-driven mode (below), one problem a DIR
 *
 * DEVICE is a torch device ("cuda", "cpu"); none, or "-", leaves the
 * library's default, the CUDA device.
 *
 * File-driven mode.  DIR/problem.txt reads "dense n p m" or
 * "sparse n p m".  The problem arrays are raw files: float64 row-major
 * DIR/P.f64, A.f64, G.f64 (dense), or CSC arrays DIR/P.p.i32, P.i.i32,
 * P.x.f64 (and A.*, G.*) (sparse); float64 vectors c, b, h_l, h_u, x_l,
 * x_u (.f64).  A missing file passes NULL.  DIR/c_update.f64, if present,
 * is the c of an update.  Each line of DIR/runs.txt names a run and the
 * settings it changes from the defaults, "name field=value ...", with
 * the field names of piqp_tpu_settings, and optionally "repeat=N".  A run
 * sets up, solves (and repeats that cold solve N times), and, with
 * c_update.f64, updates c and solves warm.  It writes float64
 * DIR/name.result.f64 (x, y, z_l, z_u, z_bl, z_bu of the cold solve) and
 * name.warm.result.f64, int32 name.status.i32 (status, iterations, warm
 * status, warm iterations) and float64 name.seconds.f64 (the host clock's
 * seconds of setup, solve, update, warm solve and the median repeated
 * solve, 0 without repeats).  The exit code is 0
 * when every call returned without an internal error.
 */
#define _POSIX_C_SOURCE 199309L
#include <math.h>
#include <stddef.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

#include "piqp_tpu_torch_c.h"

static int approx(double a, double b, double tol)
{
    return fabs(a - b) <= tol;
}

/* ---- the checks of the JAX package's C test --------------------------- */

static int run_checks(void)
{
    /* min 3x0^2 + 2x1^2 - x0 - 4x1  s.t. x0 - 2 x1 = 0 */
    double P[4] = {6.0, 0.0, 0.0, 4.0};
    double c[2] = {-1.0, -4.0};
    double A[2] = {1.0, -2.0};
    double b[1] = {0.0};

    piqp_tpu_dense_data data = {0};
    data.P = P;
    data.c = c;
    data.A = A;
    data.b = b;
    data.n = 2;
    data.p = 1;
    data.m = 0;

    piqp_tpu_settings settings;
    piqp_tpu_settings_default(&settings);
    if (settings.pallas_kernels != -1) {
        fprintf(stderr, "default pallas_kernels is %d, not -1\n",
                settings.pallas_kernels);
        return 1;
    }

    piqp_tpu_workspace* w = piqp_tpu_setup_dense(&data, &settings);
    if (!w) {
        fprintf(stderr, "setup failed: %s\n", piqp_tpu_last_error());
        return 1;
    }

    int status = piqp_tpu_solve(w);
    if (status != 1) {
        fprintf(stderr, "solve failed: status=%d (%s)\n", status,
                piqp_tpu_last_error());
        return 1;
    }

    piqp_tpu_result res;
    if (piqp_tpu_get_result(w, &res) != 0) {
        fprintf(stderr, "get_result failed\n");
        return 1;
    }
    printf("x = [%f, %f], iters = %d\n", res.x[0], res.x[1], res.iter);
    if (!approx(res.x[0], 3.0 / 7.0, 1e-6) ||
        !approx(res.x[1], 3.0 / 14.0, 1e-6)) {
        fprintf(stderr, "wrong solution\n");
        return 1;
    }

    /* warm update: change the linear cost, re-solve */
    double c2[2] = {-2.0, -4.0};
    piqp_tpu_dense_data upd = {0};
    upd.c = c2;
    upd.n = 2;
    upd.p = 0;
    upd.m = 0;
    if (piqp_tpu_update_dense(w, &upd) != 0) {
        fprintf(stderr, "update failed: %s\n", piqp_tpu_last_error());
        return 1;
    }
    status = piqp_tpu_solve_warm(w); /* seeds from the previous iterates */
    if (status != 1) {
        fprintf(stderr, "warm re-solve failed: status=%d\n", status);
        return 1;
    }
    piqp_tpu_get_result(w, &res);
    printf("updated x = [%f, %f]\n", res.x[0], res.x[1]);
    /* optimality of the updated problem: residuals and the constraint */
    if (res.primal_res > 1e-8 || res.dual_res > 1e-8) {
        fprintf(stderr, "bad residuals after update\n");
        return 1;
    }
    if (!approx(res.x[0] - 2.0 * res.x[1], 0.0, 1e-8)) {
        fprintf(stderr, "constraint violated after update\n");
        return 1;
    }

    /* full info mirror is populated */
    if (res.info.status != 1 || res.info.iter <= 0 ||
        res.info.primal_res > 1e-8) {
        fprintf(stderr, "info mirror wrong\n");
        return 1;
    }

    /* settings round-trip */
    piqp_tpu_settings got;
    if (piqp_tpu_get_settings(w, &got) != 0 ||
        !approx(got.eps_abs, settings.eps_abs, 0) ||
        got.max_iter != settings.max_iter || got.tau != settings.tau ||
        got.pallas_kernels != settings.pallas_kernels) {
        fprintf(stderr, "settings round-trip failed\n");
        return 1;
    }
    settings.compute_timings = 1;
    if (piqp_tpu_update_settings(w, &settings) != 0) {
        fprintf(stderr, "update_settings failed: %s\n",
                piqp_tpu_last_error());
        return 1;
    }
    status = piqp_tpu_solve(w);
    piqp_tpu_get_result(w, &res);
    if (status != 1 || res.info.solve_time <= 0.0) {
        fprintf(stderr, "compute_timings via update_settings failed\n");
        return 1;
    }

    /* a pallas_kernels value outside -1, 0, 1 is refused */
    settings.pallas_kernels = 2;
    if (piqp_tpu_update_settings(w, &settings) == 0) {
        fprintf(stderr, "pallas_kernels = 2 was accepted\n");
        return 1;
    }

    /* settings that fail verification give INVALID_SETTINGS, not an
     * internal error */
    piqp_tpu_settings_default(&settings);
    settings.eps_abs = -1.0;
    if (piqp_tpu_update_settings(w, &settings) != 0 ||
        piqp_tpu_solve(w) != -10 || piqp_tpu_get_result(w, &res) != 0 ||
        res.info.status != -10) {
        fprintf(stderr, "invalid settings did not give INVALID_SETTINGS: %s\n",
                piqp_tpu_last_error());
        return 1;
    }

    piqp_tpu_free(w);

    /* ---- sparse (CSC) interface: same QP plus an inequality ---- */
    /* P = diag(6, 4) in CSC upper-tri; A = [1, -2]; G = [1, 0] with
     * -inf <= x0 <= 0.8 */
    {
        int Pp[3] = {0, 1, 2};
        int Pi[2] = {0, 1};
        double Px[2] = {6.0, 4.0};
        piqp_tpu_csc Pm = {2, 2, 2, Pp, Pi, Px};

        int Ap[3] = {0, 1, 2};
        int Ai[2] = {0, 0};
        double Ax[2] = {1.0, -2.0};
        piqp_tpu_csc Am = {1, 2, 2, Ap, Ai, Ax};

        int Gp[3] = {0, 1, 1};
        int Gi[1] = {0};
        double Gx[1] = {1.0};
        piqp_tpu_csc Gm = {1, 2, 1, Gp, Gi, Gx};

        double h_l[1] = {-PIQP_TPU_INF};
        double h_u[1] = {0.8};

        piqp_tpu_sparse_data sd = {0};
        sd.P = &Pm;
        sd.c = c;
        sd.A = &Am;
        sd.b = b;
        sd.G = &Gm;
        sd.h_l = h_l;
        sd.h_u = h_u;
        sd.n = 2;
        sd.p = 1;
        sd.m = 1;

        piqp_tpu_settings_default(&settings);
        piqp_tpu_workspace* ws = piqp_tpu_setup_sparse(&sd, &settings);
        if (!ws) {
            fprintf(stderr, "sparse setup failed: %s\n",
                    piqp_tpu_last_error());
            return 1;
        }
        status = piqp_tpu_solve(ws);
        if (status != 1) {
            fprintf(stderr, "sparse solve failed: status=%d (%s)\n", status,
                    piqp_tpu_last_error());
            return 1;
        }
        piqp_tpu_result rs;
        piqp_tpu_get_result(ws, &rs);
        printf("sparse x = [%f, %f]\n", rs.x[0], rs.x[1]);
        /* inequality inactive at the optimum (x0 = 3/7 < 0.8): same
         * solution as the dense equality-only QP */
        if (!approx(rs.x[0], 3.0 / 7.0, 1e-6) ||
            !approx(rs.x[1], 3.0 / 14.0, 1e-6)) {
            fprintf(stderr, "wrong sparse solution\n");
            return 1;
        }
        /* slack view present: s_l/s_u sized m */
        if (rs.s_u == NULL) {
            fprintf(stderr, "missing slack views\n");
            return 1;
        }

        /* sparse value update: tighten h_u so the inequality becomes
         * active -> x0 pinned at 0.2 */
        double h_u2[1] = {0.2};
        piqp_tpu_sparse_data su = {0};
        su.h_u = h_u2;
        su.n = 2;
        su.p = 0;
        su.m = 1;
        if (piqp_tpu_update_sparse(ws, &su) != 0) {
            fprintf(stderr, "sparse update failed: %s\n",
                    piqp_tpu_last_error());
            return 1;
        }
        status = piqp_tpu_solve(ws);
        piqp_tpu_get_result(ws, &rs);
        if (status != 1 || !approx(rs.x[0], 0.2, 1e-6)) {
            fprintf(stderr, "sparse update wrong: status=%d x0=%f\n", status,
                    rs.x[0]);
            return 1;
        }
        settings.max_iter = 0;
        if (piqp_tpu_update_settings(ws, &settings) != 0 ||
            piqp_tpu_solve(ws) != -10) {
            fprintf(stderr, "sparse: invalid settings did not give "
                            "INVALID_SETTINGS: %s\n", piqp_tpu_last_error());
            return 1;
        }
        piqp_tpu_free(ws);
    }

    /* ---- backend selection: the dense_ldlt full-KKT signed Cholesky ---- */
    {
        piqp_tpu_settings_default(&settings);
        settings.kkt_solver = PIQP_TPU_DENSE_LDLT;
        piqp_tpu_workspace* wl = piqp_tpu_setup_dense(&data, &settings);
        if (!wl) {
            fprintf(stderr, "dense_ldlt setup failed: %s\n",
                    piqp_tpu_last_error());
            return 1;
        }
        status = piqp_tpu_solve(wl);
        piqp_tpu_result rl;
        piqp_tpu_get_result(wl, &rl);
        if (status != 1 || !approx(rl.x[0], 3.0 / 7.0, 1e-6)) {
            fprintf(stderr, "dense_ldlt solve wrong: status=%d x0=%f\n",
                    status, rl.x[0]);
            return 1;
        }
        piqp_tpu_free(wl);
    }

    printf("C interface test passed\n");
    return 0;
}

/* ---- file-driven mode -------------------------------------------------- */

static double now(void)
{
    struct timespec t;
    clock_gettime(CLOCK_MONOTONIC, &t);
    return (double)t.tv_sec + 1e-9 * (double)t.tv_nsec;
}

/* The whole of DIR/name, or NULL when it does not exist; *count items of
 * itemsize bytes. */
static void* read_file(const char* dir, const char* name, size_t itemsize,
                       size_t* count)
{
    char path[4096];
    snprintf(path, sizeof(path), "%s/%s", dir, name);
    FILE* f = fopen(path, "rb");
    if (!f) return NULL;
    fseek(f, 0, SEEK_END);
    long size = ftell(f);
    fseek(f, 0, SEEK_SET);
    void* buf = malloc(size > 0 ? (size_t)size : 1);
    if (buf && size > 0 && fread(buf, 1, (size_t)size, f) != (size_t)size) {
        free(buf);
        buf = NULL;
    }
    fclose(f);
    if (count) *count = (size_t)size / itemsize;
    return buf;
}

static int write_file(const char* dir, const char* name, const void* buf,
                      size_t bytes)
{
    char path[4096];
    snprintf(path, sizeof(path), "%s/%s", dir, name);
    FILE* f = fopen(path, "wb");
    if (!f) return -1;
    size_t wrote = fwrite(buf, 1, bytes, f);
    fclose(f);
    return wrote == bytes ? 0 : -1;
}

/* settings fields a run may set: name, offset, is_int */
struct field {
    const char* name;
    size_t offset;
    int is_int;
};
#define INT_FIELD(f) {#f, offsetof(piqp_tpu_settings, f), 1}
#define DBL_FIELD(f) {#f, offsetof(piqp_tpu_settings, f), 0}
static const struct field kFields[] = {
    DBL_FIELD(rho_init),
    DBL_FIELD(delta_init),
    DBL_FIELD(eps_abs),
    DBL_FIELD(eps_rel),
    INT_FIELD(check_duality_gap),
    DBL_FIELD(eps_duality_gap_abs),
    DBL_FIELD(eps_duality_gap_rel),
    DBL_FIELD(infeasibility_threshold),
    DBL_FIELD(reg_lower_limit),
    DBL_FIELD(reg_finetune_lower_limit),
    INT_FIELD(reg_finetune_primal_update_threshold),
    INT_FIELD(reg_finetune_dual_update_threshold),
    INT_FIELD(max_iter),
    INT_FIELD(max_factor_retires),
    INT_FIELD(preconditioner_scale_cost),
    INT_FIELD(preconditioner_reuse_on_update),
    INT_FIELD(preconditioner_iter),
    DBL_FIELD(tau),
    INT_FIELD(kkt_solver),
    INT_FIELD(iterative_refinement_always_enabled),
    DBL_FIELD(iterative_refinement_eps_abs),
    DBL_FIELD(iterative_refinement_eps_rel),
    INT_FIELD(iterative_refinement_max_iter),
    DBL_FIELD(iterative_refinement_min_improvement_rate),
    DBL_FIELD(iterative_refinement_static_regularization_eps),
    DBL_FIELD(iterative_refinement_static_regularization_rel),
    INT_FIELD(verbose),
    INT_FIELD(compute_timings),
    INT_FIELD(use_float32),
    INT_FIELD(mixed_precision),
    INT_FIELD(pallas_kernels),
    DBL_FIELD(refine_mu_factor),
    INT_FIELD(refine_static_passes),
    INT_FIELD(mixed_phase_a_patience),
};
#undef INT_FIELD
#undef DBL_FIELD

static int set_field(piqp_tpu_settings* s, const char* assignment)
{
    const char* eq = strchr(assignment, '=');
    if (!eq) return -1;
    size_t len = (size_t)(eq - assignment);
    for (size_t k = 0; k < sizeof(kFields) / sizeof(kFields[0]); ++k) {
        if (strlen(kFields[k].name) != len ||
            strncmp(kFields[k].name, assignment, len) != 0)
            continue;
        char* dst = (char*)s + kFields[k].offset;
        if (kFields[k].is_int) {
            int v = atoi(eq + 1);
            memcpy(dst, &v, sizeof(v));
        } else {
            double v = atof(eq + 1);
            memcpy(dst, &v, sizeof(v));
        }
        return 0;
    }
    return -1;
}

/* one problem's arrays, as read from DIR */
struct problem {
    int sparse, n, p, m;
    double *P, *A, *G; /* dense */
    int *Pp, *Pi, *Ap, *Ai, *Gp, *Gi;
    double *Px, *Ax, *Gx; /* sparse */
    piqp_tpu_csc Pc, Ac, Gc;
    double *c, *b, *h_l, *h_u, *x_l, *x_u, *c_update;
};

static piqp_tpu_csc* read_csc(const char* dir, const char* name, int rows,
                              int cols, int** p, int** i, double** x,
                              piqp_tpu_csc* out)
{
    char file[64];
    size_t nnz = 0;
    snprintf(file, sizeof(file), "%s.p.i32", name);
    *p = read_file(dir, file, sizeof(int), NULL);
    snprintf(file, sizeof(file), "%s.i.i32", name);
    *i = read_file(dir, file, sizeof(int), &nnz);
    snprintf(file, sizeof(file), "%s.x.f64", name);
    *x = read_file(dir, file, sizeof(double), NULL);
    if (!*p || !*i || !*x) return NULL;
    out->m = rows;
    out->n = cols;
    out->nnz = (int)nnz;
    out->p = *p;
    out->i = *i;
    out->x = *x;
    return out;
}

static int read_problem(const char* dir, struct problem* q)
{
    memset(q, 0, sizeof(*q));
    char path[4096], kind[16];
    snprintf(path, sizeof(path), "%s/problem.txt", dir);
    FILE* f = fopen(path, "r");
    if (!f) return -1;
    int got = fscanf(f, "%15s %d %d %d", kind, &q->n, &q->p, &q->m);
    fclose(f);
    if (got != 4) return -1;
    q->sparse = strcmp(kind, "sparse") == 0;
    if (q->sparse) {
        if (!read_csc(dir, "P", q->n, q->n, &q->Pp, &q->Pi, &q->Px, &q->Pc))
            return -1;
        if (q->p)
            read_csc(dir, "A", q->p, q->n, &q->Ap, &q->Ai, &q->Ax, &q->Ac);
        if (q->m)
            read_csc(dir, "G", q->m, q->n, &q->Gp, &q->Gi, &q->Gx, &q->Gc);
    } else {
        q->P = read_file(dir, "P.f64", sizeof(double), NULL);
        q->A = read_file(dir, "A.f64", sizeof(double), NULL);
        q->G = read_file(dir, "G.f64", sizeof(double), NULL);
        if (!q->P) return -1;
    }
    q->c = read_file(dir, "c.f64", sizeof(double), NULL);
    q->b = read_file(dir, "b.f64", sizeof(double), NULL);
    q->h_l = read_file(dir, "h_l.f64", sizeof(double), NULL);
    q->h_u = read_file(dir, "h_u.f64", sizeof(double), NULL);
    q->x_l = read_file(dir, "x_l.f64", sizeof(double), NULL);
    q->x_u = read_file(dir, "x_u.f64", sizeof(double), NULL);
    q->c_update = read_file(dir, "c_update.f64", sizeof(double), NULL);
    return 0;
}

static piqp_tpu_workspace* setup(const struct problem* q,
                                 const piqp_tpu_settings* s)
{
    if (q->sparse) {
        piqp_tpu_sparse_data d = {0};
        d.P = &q->Pc;
        d.A = q->Ax ? &q->Ac : NULL;
        d.G = q->Gx ? &q->Gc : NULL;
        d.c = q->c;
        d.b = q->b;
        d.h_l = q->h_l;
        d.h_u = q->h_u;
        d.x_l = q->x_l;
        d.x_u = q->x_u;
        d.n = q->n;
        d.p = q->p;
        d.m = q->m;
        return piqp_tpu_setup_sparse(&d, s);
    }
    piqp_tpu_dense_data d = {0};
    d.P = q->P;
    d.A = q->A;
    d.G = q->G;
    d.c = q->c;
    d.b = q->b;
    d.h_l = q->h_l;
    d.h_u = q->h_u;
    d.x_l = q->x_l;
    d.x_u = q->x_u;
    d.n = q->n;
    d.p = q->p;
    d.m = q->m;
    return piqp_tpu_setup_dense(&d, s);
}

static int update_c(piqp_tpu_workspace* w, const struct problem* q)
{
    if (q->sparse) {
        piqp_tpu_sparse_data d = {0};
        d.c = q->c_update;
        d.n = q->n;
        return piqp_tpu_update_sparse(w, &d);
    }
    piqp_tpu_dense_data d = {0};
    d.c = q->c_update;
    d.n = q->n;
    return piqp_tpu_update_dense(w, &d);
}

/* x, y, z_l, z_u, z_bl, z_bu of the last solve into DIR/file */
static int write_result(const char* dir, const char* file,
                        piqp_tpu_workspace* w, const struct problem* q)
{
    piqp_tpu_result r;
    if (piqp_tpu_get_result(w, &r) != 0) return -1;
    const int n = q->n, p = q->p, m = q->m;
    size_t total = (size_t)(3 * n + p + 2 * m);
    double* out = malloc(total * sizeof(double) + 1);
    double* o = out;
    memcpy(o, r.x, n * sizeof(double)), o += n;
    memcpy(o, r.y, p * sizeof(double)), o += p;
    memcpy(o, r.z_l, m * sizeof(double)), o += m;
    memcpy(o, r.z_u, m * sizeof(double)), o += m;
    memcpy(o, r.z_bl, n * sizeof(double)), o += n;
    memcpy(o, r.z_bu, n * sizeof(double));
    int rc = write_file(dir, file, out, total * sizeof(double));
    free(out);
    return rc;
}

static int cmp_double(const void* a, const void* b)
{
    double x = *(const double*)a, y = *(const double*)b;
    return (x > y) - (x < y);
}

static int run_one(const char* dir, const char* name,
                   const piqp_tpu_settings* s, const struct problem* q,
                   int repeat)
{
    char file[256];
    int stats[4] = {0, 0, 0, 0};
    double secs[5] = {0.0, 0.0, 0.0, 0.0, 0.0};
    double t = now();
    piqp_tpu_workspace* w = setup(q, s);
    secs[0] = now() - t;
    if (!w) {
        fprintf(stderr, "[%s] setup failed: %s\n", name,
                piqp_tpu_last_error());
        return 1;
    }
    t = now();
    stats[0] = piqp_tpu_solve(w);
    secs[1] = now() - t;
    piqp_tpu_result r;
    if (stats[0] == -100 || piqp_tpu_get_result(w, &r) != 0) {
        fprintf(stderr, "[%s] solve failed: %s\n", name,
                piqp_tpu_last_error());
        piqp_tpu_free(w);
        return 1;
    }
    stats[1] = r.info.iter;
    snprintf(file, sizeof(file), "%s.result.f64", name);
    int rc = write_result(dir, file, w, q);
    if (repeat > 0) {
        /* the same cold solve again: the median of repeat calls */
        double* times = malloc((size_t)repeat * sizeof(double));
        for (int k = 0; k < repeat && rc == 0; ++k) {
            t = now();
            rc = piqp_tpu_solve(w) == -100 ? -1 : 0;
            times[k] = now() - t;
        }
        qsort(times, (size_t)repeat, sizeof(double), cmp_double);
        secs[4] = times[repeat / 2];
        free(times);
    }
    if (rc == 0 && q->c_update) {
        t = now();
        rc = update_c(w, q);
        secs[2] = now() - t;
        if (rc == 0) {
            t = now();
            stats[2] = piqp_tpu_solve_warm(w);
            secs[3] = now() - t;
            rc = stats[2] == -100 ? -1 : piqp_tpu_get_result(w, &r);
        }
        if (rc == 0) {
            stats[3] = r.info.iter;
            snprintf(file, sizeof(file), "%s.warm.result.f64", name);
            rc = write_result(dir, file, w, q);
        } else {
            fprintf(stderr, "[%s] update or warm solve failed: %s\n", name,
                    piqp_tpu_last_error());
        }
    }
    piqp_tpu_free(w);
    snprintf(file, sizeof(file), "%s.status.i32", name);
    rc |= write_file(dir, file, stats, sizeof(stats));
    snprintf(file, sizeof(file), "%s.seconds.f64", name);
    rc |= write_file(dir, file, secs, sizeof(secs));
    printf("[%s] status %d, %d iterations; warm %d, %d iterations; setup "
           "%.6f s, solve %.6f s, update %.6f s, warm solve %.6f s, repeated "
           "solve %.6f s\n",
           name, stats[0], stats[1], stats[2], stats[3], secs[0], secs[1],
           secs[2], secs[3], secs[4]);
    return rc != 0;
}

static int run_files(const char* dir)
{
    struct problem q;
    if (read_problem(dir, &q) != 0) {
        fprintf(stderr, "cannot read the problem in %s\n", dir);
        return 1;
    }
    char path[4096], line[4096];
    snprintf(path, sizeof(path), "%s/runs.txt", dir);
    FILE* f = fopen(path, "r");
    if (!f) {
        fprintf(stderr, "cannot read %s\n", path);
        return 1;
    }
    int failed = 0, runs = 0;
    while (fgets(line, sizeof(line), f)) {
        char* name = strtok(line, " \t\r\n");
        if (!name) continue;
        piqp_tpu_settings s;
        piqp_tpu_settings_default(&s);
        int repeat = 0;
        for (char* tok = strtok(NULL, " \t\r\n"); tok;
             tok = strtok(NULL, " \t\r\n")) {
            if (strncmp(tok, "repeat=", 7) == 0) {
                repeat = atoi(tok + 7);
                continue;
            }
            if (set_field(&s, tok) != 0) {
                fprintf(stderr, "[%s] unknown setting %s\n", name, tok);
                fclose(f);
                return 1;
            }
        }
        failed |= run_one(dir, name, &s, &q, repeat);
        ++runs;
    }
    fclose(f);
    printf("file-driven mode: %d runs, %s\n", runs,
           failed ? "failed" : "all returned");
    return failed || runs == 0;
}

int main(int argc, char** argv)
{
    if (argc > 1 && strcmp(argv[1], "-") != 0) piqp_tpu_set_device(argv[1]);
    if (argc <= 2) return run_checks();
    int failed = 0;
    for (int k = 2; k < argc; ++k) failed |= run_files(argv[k]);
    return failed;
}
