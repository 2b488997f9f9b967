"""Dense and iterative linear algebra for GP solves."""

from gaussian_process_tpu_torch.linalg.blocked import (
    blocked_cholesky,
    blocked_tri_solve,
    panel_inverses,
)
from gaussian_process_tpu_torch.linalg.cholesky import (
    CholeskyResult,
    add_diagonal,
    cholesky_solve,
    logdet_from_chol,
    safe_cholesky,
    tri_solve,
)
from gaussian_process_tpu_torch.linalg.cg import CGState, cg_solve, cg_solve_grad
from gaussian_process_tpu_torch.linalg.nystrom import (
    NystromPreconditioner,
    make_nystrom_factor,
    make_nystrom_preconditioner,
)

__all__ = [
    "blocked_cholesky",
    "blocked_tri_solve",
    "panel_inverses",
    "CholeskyResult",
    "add_diagonal",
    "cholesky_solve",
    "logdet_from_chol",
    "safe_cholesky",
    "tri_solve",
    "CGState",
    "cg_solve",
    "cg_solve_grad",
    "NystromPreconditioner",
    "make_nystrom_factor",
    "make_nystrom_preconditioner",
]
