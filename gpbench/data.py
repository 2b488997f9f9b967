"""Inputs on the device, each in a few large calls from its own generator.

The training set is the configuration's, made from the seed its file
states (``data.seed``), as a deployment's data set is fixed; a run's seed
draws what changes from run to run: the probes of a training call and the
points of a query. So every seed gives the same work: the same data, and
calls of the same sizes."""

from __future__ import annotations

import hashlib

import torch

DTYPES = {"float32": torch.float32}


def sub_seed(seed: int, *parts) -> int:
    """A 63-bit seed for one purpose (``parts``) of a run's ``seed``."""
    text = ":".join(str(p) for p in (seed, *parts)).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1


def generator(device: torch.device, seed: int, *parts) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *parts))


def points(config: dict, count: int, gen: torch.Generator, device: torch.device) -> torch.Tensor:
    """``count`` points of the configuration's input distribution:
    uniform on [-a, a]^d, a = ``data.half_width``."""
    data = config["data"]
    if data["inputs"] != "uniform":
        raise ValueError(f"unknown input distribution {data['inputs']!r}")
    u = torch.rand((count, config["d"]), generator=gen, device=device,
                   dtype=DTYPES[config["dtype"]])
    return (2.0 * u - 1.0) * data["half_width"]


def training_set(config: dict, device: torch.device):
    """(x, y): n points and targets y = sin(f * sum(x)) + s * eps, from the
    configuration's own seed."""
    data = config["data"]
    if data["target"] != "sin_sum":
        raise ValueError(f"unknown target {data['target']!r}")
    gen = generator(device, data["seed"], "train")
    x = points(config, config["n"], gen, device)
    eps = torch.randn(config["n"], generator=gen, device=device, dtype=x.dtype)
    y = torch.sin(data["frequency"] * x.sum(dim=1)) + data["target_noise"] * eps
    return x, y
