/* piqp_tpu_torch C interface.
 *
 * C-callable surface over the PyTorch/CUDA port, the same contract as the
 * JAX package's csrc/piqp_tpu_c.h: the same type names, enum values,
 * struct members in the same order and function names, so a C host written
 * against piqp_tpu_c.h switches header and library and nothing else.  Both
 * mirror PIQP's C interface (interfaces/c/include/piqp.h; the data,
 * settings, info and result structs of piqp_typedef.h).  The library
 * embeds CPython and drives piqp_tpu_torch.DenseSolver / SparseSolver
 * (capi.cpp).
 *
 * Device: workspaces are set up on the CUDA device unless
 * piqp_tpu_set_device names another.  Without a GPU, piqp_tpu_setup_*
 * returns NULL and piqp_tpu_last_error() says why; no call carries on on
 * the CPU unless the caller asked for "cpu".
 *
 * Threading: calls must come from one thread, which holds the embedded
 * interpreter's GIL.  Dense matrices are row-major double arrays; sparse
 * matrices are CSC with int indices.
 */
#ifndef PIQP_TPU_TORCH_C_H
#define PIQP_TPU_TORCH_C_H

#ifdef __cplusplus
extern "C" {
#endif

#ifndef PIQP_TPU_INF
#define PIQP_TPU_INF 1e30
#endif

typedef struct piqp_tpu_workspace piqp_tpu_workspace; /* opaque */

/* Compressed sparse column matrix.  Pointers are borrowed for the
 * duration of the setup/update call. */
typedef struct {
    int m;           /* rows */
    int n;           /* cols */
    int nnz;         /* non-zeros */
    const int* p;    /* column pointers (size n+1) */
    const int* i;    /* row indices (size nnz) */
    const double* x; /* values (size nnz) */
} piqp_tpu_csc;

typedef struct {
    /* min 0.5 x'Px + c'x  s.t. Ax=b, h_l <= Gx <= h_u, x_l <= x <= x_u.
     * P: n*n row-major (upper triangle used); A: p*n; G: m*n.
     * Any of A/b/G/h_l/h_u/x_l/x_u may be NULL (p/m 0 as applicable;
     * NULL bounds mean +/- infinity). */
    const double* P;
    const double* c;
    const double* A;
    const double* b;
    const double* G;
    const double* h_l;
    const double* h_u;
    const double* x_l;
    const double* x_u;
    int n;
    int p;
    int m;
} piqp_tpu_dense_data;

/* Sparse problem. */
typedef struct {
    const piqp_tpu_csc* P; /* upper triangle used */
    const double* c;
    const piqp_tpu_csc* A; /* may be NULL */
    const double* b;
    const piqp_tpu_csc* G; /* may be NULL */
    const double* h_l;
    const double* h_u;
    const double* x_l;
    const double* x_u;
    int n;
    int p;
    int m;
} piqp_tpu_sparse_data;

/* KKT backend selector (piqp_tpu_torch.KKTBackend).  The three sparse
 * elimination levels condense to the same device system and map to the
 * condensed backend. */
typedef enum {
    PIQP_TPU_DENSE_CHOLESKY = 0,       /* condensed, K1 */
    PIQP_TPU_SPARSE_LDLT = 1,          /* host sparse route */
    PIQP_TPU_SPARSE_LDLT_EQ_COND = 2,  /* -> condensed device backend */
    PIQP_TPU_SPARSE_LDLT_INEQ_COND = 3,/* -> condensed device backend */
    PIQP_TPU_SPARSE_LDLT_COND = 4,     /* -> condensed device backend */
    PIQP_TPU_SPARSE_MULTISTAGE = 5,    /* stage blocks, K2 */
    PIQP_TPU_DENSE_LU = 6,             /* full-KKT dense LU (library) */
    PIQP_TPU_DENSE_LDLT = 7,           /* full-KKT signed Cholesky, K3 */
    PIQP_TPU_AUTO = -1                 /* condensed; SparseSolver takes
                                        * the host route above
                                        * dense_routing_max_n */
} piqp_tpu_kkt_solver;

/* Full settings mirror (PIQP's piqp_settings) plus the extensions of
 * piqp_tpu_torch.Settings at the tail. */
typedef struct {
    double rho_init;                       /* 1e-6 */
    double delta_init;                     /* 1e-4 */
    double eps_abs;                        /* 1e-8 */
    double eps_rel;                        /* 1e-9 */
    int check_duality_gap;                 /* 1 */
    double eps_duality_gap_abs;            /* 1e-8 */
    double eps_duality_gap_rel;            /* 1e-9 */
    double infeasibility_threshold;        /* 0.9 */
    double reg_lower_limit;                /* 1e-10 */
    double reg_finetune_lower_limit;       /* 1e-13 */
    int reg_finetune_primal_update_threshold; /* 7 */
    int reg_finetune_dual_update_threshold;   /* 7 */
    int max_iter;                          /* 250 */
    int max_factor_retires;                /* 10 */
    int preconditioner_scale_cost;         /* 0 */
    int preconditioner_reuse_on_update;    /* 0 */
    int preconditioner_iter;               /* 10 */
    double tau;                            /* 0.99 */
    piqp_tpu_kkt_solver kkt_solver;        /* DENSE_CHOLESKY */
    int iterative_refinement_always_enabled;      /* 0 */
    double iterative_refinement_eps_abs;          /* 1e-12 */
    double iterative_refinement_eps_rel;          /* 1e-12 */
    int iterative_refinement_max_iter;            /* 10 */
    double iterative_refinement_min_improvement_rate;    /* 5.0 */
    double iterative_refinement_static_regularization_eps; /* 1e-8 */
    double iterative_refinement_static_regularization_rel; /* eps^2; <0 -> default */
    int verbose;                           /* 0 */
    int compute_timings;                   /* 0 */
    /* --- extensions (piqp_tpu_torch.Settings) --- */
    int use_float32;                       /* 0: float64 solver dtype */
    int mixed_precision;                   /* 0: f32 factors + refinement */
    int pallas_kernels;                    /* -1: the hand-written CUDA
                                              kernels (Settings
                                              pallas_kernels=None); 1 the
                                              same (True); 0 library
                                              factorizations with
                                              triangular solves (False) */
    double refine_mu_factor;               /* 1e-2: inexact-IPM refinement
                                              tolerance (0 = fixed 1e-12) */
    int refine_static_passes;              /* 1: fixed phase-A refinement
                                              passes (-1 = adaptive loop) */
    int mixed_phase_a_patience;            /* 12: phase-A stall exit after
                                              this many no-progress iters
                                              (0 = disabled) */
} piqp_tpu_settings;

/* Full info mirror (PIQP's piqp_info). */
typedef struct {
    int status;      /* piqp status code (1 = solved) */
    int iter;
    double rho;
    double delta;
    double mu;
    double sigma;
    double primal_step;
    double dual_step;
    double primal_res;
    double primal_res_rel;
    double dual_res;
    double dual_res_rel;
    double primal_res_reg;
    double primal_res_reg_rel;
    double dual_res_reg;
    double dual_res_reg_rel;
    double primal_prox_inf;
    double dual_prox_inf;
    double prev_primal_res;
    double prev_dual_res;
    double primal_obj;
    double dual_obj;
    double duality_gap;
    double duality_gap_rel;
    int factor_retires;
    double reg_limit;
    int no_primal_update;
    int no_dual_update;
    double setup_time;
    double update_time;
    double solve_time;
    double kkt_factor_time;
    double kkt_solve_time;
    double run_time;
} piqp_tpu_info;

/* Result views (PIQP's piqp_result): primal/dual solution plus slacks.
 * Views owned by the workspace, on the host; valid until the next
 * solve/free. */
typedef struct {
    const double* x;    /* n */
    const double* y;    /* p */
    const double* z_l;  /* m */
    const double* z_u;  /* m */
    const double* z_bl; /* n */
    const double* z_bu; /* n */
    const double* s_l;  /* m */
    const double* s_u;  /* m */
    const double* s_bl; /* n */
    const double* s_bu; /* n */
    piqp_tpu_info info;
    /* kept for source compatibility with piqp_tpu_c.h */
    int status;
    int iter;
    double primal_obj;
    double primal_res;
    double dual_res;
} piqp_tpu_result;

/* Choose the torch device of workspaces set up after this call ("cuda",
 * "cuda:1", "cpu"); NULL or "" restores the default, the CUDA device.
 * An unknown device name fails at the next setup.  Returns 0. */
int piqp_tpu_set_device(const char* device);

/* Fill settings with the library defaults (PIQP's
 * piqp_set_default_settings_dense/sparse). */
void piqp_tpu_settings_default(piqp_tpu_settings* s);

/* Create a workspace from dense problem data.  Returns NULL on error
 * (piqp_tpu_last_error() describes it). */
piqp_tpu_workspace* piqp_tpu_setup_dense(const piqp_tpu_dense_data* data,
                                         const piqp_tpu_settings* settings);

/* Create a workspace from sparse (CSC) problem data; routes through the
 * SparseSolver's structure detection (multistage / condensed-dense / host
 * backends).  Returns NULL on error. */
piqp_tpu_workspace* piqp_tpu_setup_sparse(const piqp_tpu_sparse_data* data,
                                          const piqp_tpu_settings* settings);

/* Update problem values in place (shapes must match setup; NULL fields
 * keep their current values).  Returns 0 on success. */
int piqp_tpu_update_dense(piqp_tpu_workspace* w,
                          const piqp_tpu_dense_data* data);

/* Sparse value update: CSC patterns must match the setup call.  Returns 0
 * on success. */
int piqp_tpu_update_sparse(piqp_tpu_workspace* w,
                           const piqp_tpu_sparse_data* data);

/* Replace the solver settings (PIQP's piqp_update_settings).  Returns 0
 * on success. */
int piqp_tpu_update_settings(piqp_tpu_workspace* w,
                             const piqp_tpu_settings* settings);

/* Read back the workspace's current settings.  Returns 0 on success. */
int piqp_tpu_get_settings(piqp_tpu_workspace* w, piqp_tpu_settings* out);

/* Solve; returns the status code (1 = solved) or -100 on internal error. */
int piqp_tpu_solve(piqp_tpu_workspace* w);

/* Solve seeded from the previous solve's iterates (an extension over
 * PIQP's C API, which always cold-starts).  Falls back to a cold solve
 * when no previous result exists.  Returns the status code. */
int piqp_tpu_solve_warm(piqp_tpu_workspace* w);

/* Result views for the last solve.  Returns 0 on success. */
int piqp_tpu_get_result(piqp_tpu_workspace* w, piqp_tpu_result* out);

/* Destroy the workspace. */
void piqp_tpu_free(piqp_tpu_workspace* w);

/* Last error message (static buffer). */
const char* piqp_tpu_last_error(void);

#ifdef __cplusplus
}
#endif

#endif /* PIQP_TPU_TORCH_C_H */
