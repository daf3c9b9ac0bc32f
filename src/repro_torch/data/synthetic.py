"""Synthetic workload and token-batch generation.

Length distributions follow the shapes published in the paper:
  * decode lengths are geometric / discrete-exponential (Fig. 5, production
    traces: "most responses terminate quickly, a non-negligible tail runs
    for many tokens");
  * prefill lengths are broad and long-tailed (Fig. 6, LongBench: prompts
    are *much* longer than outputs) — we use a clipped lognormal;
  * BurstGPT-style light traces use shorter prompts and burstier arrivals.

Also provides token batches for the training substrate.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

__all__ = [
    "WorkloadSpec",
    "LONGBENCH_LIKE",
    "BURSTGPT_LIKE",
    "UNIFORM_PREFILL",
    "prefill_sampler",
    "decode_sampler",
    "token_batches",
]


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """Parametric description of a request-length workload."""

    name: str
    # prefill (prompt-length) distribution — clipped lognormal
    prefill_log_mean: float
    prefill_log_sigma: float
    s_min: int
    s_max: int
    # decode-length distribution — geometric
    decode_p: float
    o_max: int = 4096

    @property
    def mu_s(self) -> float:
        """Empirical mean of the clipped prefill distribution (MC estimate)."""
        rng = np.random.default_rng(0)
        return float(prefill_sampler(self)(rng, 20_000).mean())

    @property
    def sigma_s(self) -> float:
        rng = np.random.default_rng(0)
        return float(prefill_sampler(self)(rng, 20_000).std())


# LongBench (Fig. 6): prompts cluster in the 2k-16k range with a heavy tail;
# outputs are short (hundreds of tokens), geometric-ish.
LONGBENCH_LIKE = WorkloadSpec(
    name="longbench",
    prefill_log_mean=np.log(6000.0),
    prefill_log_sigma=0.8,
    s_min=64,
    s_max=32_000,
    decode_p=1.0 / 256.0,
    o_max=4096,
)

# BurstGPT (lighter load): short conversational prompts, short outputs.
BURSTGPT_LIKE = WorkloadSpec(
    name="burstgpt",
    prefill_log_mean=np.log(512.0),
    prefill_log_sigma=1.0,
    s_min=8,
    s_max=8_000,
    decode_p=1.0 / 128.0,
    o_max=2048,
)

# Degenerate-ish uniform prefill (used in theory-validation benchmarks where
# sigma_s/s_max = kappa_0 must be controlled exactly).
UNIFORM_PREFILL = WorkloadSpec(
    name="uniform",
    prefill_log_mean=0.0,  # unused
    prefill_log_sigma=0.0,
    s_min=1,
    s_max=1000,
    decode_p=1.0 / 100.0,
)


def prefill_sampler(spec: WorkloadSpec) -> Callable[[np.random.Generator, int], np.ndarray]:
    """Sampler for prefill lengths s_i in [s_min, s_max]."""
    if spec.prefill_log_sigma <= 0:
        def sample_uniform(rng: np.random.Generator, n: int) -> np.ndarray:
            return rng.integers(spec.s_min, spec.s_max + 1, size=n).astype(
                np.float64)
        return sample_uniform

    def sample(rng: np.random.Generator, n: int) -> np.ndarray:
        s = rng.lognormal(spec.prefill_log_mean, spec.prefill_log_sigma, n)
        return np.clip(np.round(s), spec.s_min, spec.s_max).astype(np.float64)

    return sample


def decode_sampler(spec: WorkloadSpec) -> Callable[[np.random.Generator, int], np.ndarray]:
    """Sampler for decode lengths o_i ~ Geo(p), clipped to o_max."""

    def sample(rng: np.random.Generator, n: int) -> np.ndarray:
        o = rng.geometric(spec.decode_p, size=n)
        return np.clip(o, 1, spec.o_max).astype(np.int64)

    return sample


def token_batches(
    *,
    vocab_size: int,
    batch: int,
    seq_len: int,
    n_batches: int,
    seed: int = 0,
    pad_frac: float = 0.05,
    pad_id: int = 0,
):
    """Yield synthetic LM training batches: dict(tokens, targets, mask).

    Targets are next-token shifted; a tail fraction of each row is padding
    so the loss-mask path is exercised.
    """
    rng = np.random.default_rng(seed)
    for _ in range(n_batches):
        toks = rng.integers(1, vocab_size, size=(batch, seq_len + 1),
                            dtype=np.int32)
        n_pad = int(seq_len * pad_frac)
        if n_pad > 0:
            lens = rng.integers(seq_len - n_pad, seq_len + 1, size=batch)
            for b, L in enumerate(lens):
                toks[b, L:] = pad_id
        yield {
            "tokens": toks[:, :-1],
            "targets": toks[:, 1:],
            "mask": (toks[:, 1:] != pad_id).astype(np.float32),
        }


# Heavy-tail sensitivity variant: production traces mix short chat with
# 100k+-token agentic/document contexts; dispersion drives both the
# barrier idle (paper Fig. 1: >40 %) and the energy gap.  Used by the
# sensitivity rows of EXPERIMENTS.md §Paper-validation.
LONGBENCH_HEAVY = WorkloadSpec(
    name="longbench-heavy",
    prefill_log_mean=np.log(5000.0),
    prefill_log_sigma=1.4,
    s_min=64,
    s_max=131_072,
    decode_p=1.0 / 512.0,
    o_max=8192,
)
