"""gaussian_process_tpu_torch: the PyTorch and CUDA port of
this repository's JAX package for NVIDIA Hopper GPUs.

Same layout as the JAX package: ``ops`` (distances, kernel algebra, and the
hand-written CUDA tile gram and matvec under ``ops.cuda``) -> ``linalg``
(jittered Cholesky, triangular solves, CG, Nyström) -> ``gp`` (regression,
Laplace classification) -> ``opt`` (LML training, exact and matrix-free) ->
``models`` (the estimator facade). ``convert`` carries kernels, params and
fitted classifier states over from the JAX package. This package never
imports JAX.
"""

from gaussian_process_tpu_torch import config  # noqa: F401
from gaussian_process_tpu_torch import ops  # noqa: F401
from gaussian_process_tpu_torch import linalg  # noqa: F401
from gaussian_process_tpu_torch import gp  # noqa: F401
from gaussian_process_tpu_torch import opt  # noqa: F401
from gaussian_process_tpu_torch import models  # noqa: F401
from gaussian_process_tpu_torch import convert  # noqa: F401
