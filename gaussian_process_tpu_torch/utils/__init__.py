"""Auxiliary subsystems: datasets, logging, checkpointing, profiling,
plotting (torch counterparts of the JAX package's ``utils``)."""

from gaussian_process_tpu_torch.utils import checkpoint  # noqa: F401
from gaussian_process_tpu_torch.utils import datasets  # noqa: F401
from gaussian_process_tpu_torch.utils import logging  # noqa: F401
from gaussian_process_tpu_torch.utils import plotting  # noqa: F401
from gaussian_process_tpu_torch.utils import profiling  # noqa: F401
from gaussian_process_tpu_torch.utils.logging import JsonlLogger, read_jsonl  # noqa: F401
from gaussian_process_tpu_torch.utils.profiling import span, time_fn  # noqa: F401
