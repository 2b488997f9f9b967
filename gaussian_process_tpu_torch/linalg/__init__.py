"""Dense and iterative linear algebra for GP solves."""

from gaussian_process_tpu_torch.linalg.cholesky import (
    CholeskyResult,
    add_diagonal,
    cholesky_solve,
    logdet_from_chol,
    safe_cholesky,
    tri_solve,
)
from gaussian_process_tpu_torch.linalg.cg import CGState, cg_solve
from gaussian_process_tpu_torch.linalg.nystrom import (
    NystromPreconditioner,
    make_nystrom_factor,
    make_nystrom_preconditioner,
)

__all__ = [
    "CholeskyResult",
    "add_diagonal",
    "cholesky_solve",
    "logdet_from_chol",
    "safe_cholesky",
    "tri_solve",
    "CGState",
    "cg_solve",
    "NystromPreconditioner",
    "make_nystrom_factor",
    "make_nystrom_preconditioner",
]
