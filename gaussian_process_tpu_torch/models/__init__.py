"""Estimator facade (fit/predict) over the functional core."""

from gaussian_process_tpu_torch.models.estimators import GPRegressor

__all__ = ["GPRegressor"]
