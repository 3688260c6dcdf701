"""Lightweight hyper-parameter optimization harness, numpy on the host.

Counterpart of ``octa_tpu/utils/hpo.py``: ``Uniform`` (:18), ``UniformInt``
(:32), ``Choice`` (:46), ``tune`` (:61), ``_tpe_sample`` (:97) and
``tune_sha`` (:141), line for line, so that one ``seed``, space and
objective propose the same trials and return the same best result in both
packages. It stands in for the reference's Ray Tune + BOHB setup
(``utils/bayesOpt*.py``): quasi-random exploration followed by Gaussian
perturbation around the incumbent ("explore-then-refine"), and successive
halving with an optional TPE sampler.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable


@dataclass
class Uniform:
    lower: float
    upper: float

    def sample(self, rng):
        return float(rng.uniform(self.lower, self.upper))

    def perturb(self, value, rng, scale=0.15):
        span = self.upper - self.lower
        return float(min(self.upper, max(
            self.lower, value + rng.normal(0, scale * span))))


@dataclass
class UniformInt:
    lower: int
    upper: int

    def sample(self, rng):
        return int(rng.integers(self.lower, self.upper + 1))

    def perturb(self, value, rng, scale=0.15):
        span = self.upper - self.lower
        v = int(round(value + rng.normal(0, max(1.0, scale * span))))
        return int(min(self.upper, max(self.lower, v)))


@dataclass
class Choice:
    choices: list

    def sample(self, rng):
        return self.choices[int(rng.integers(0, len(self.choices)))]

    def perturb(self, value, rng, scale=0.15):
        if value in self.choices and rng.random() < 0.5:
            i = self.choices.index(value)
            j = int(min(len(self.choices) - 1, max(
                0, i + rng.integers(-2, 3))))
            return self.choices[j]
        return self.sample(rng)


def tune(space: dict[str, Any],
         eval_fn: Callable[[dict], dict[str, float]],
         metric: str,
         mode: str = "max",
         num_samples: int = 50,
         explore_frac: float = 0.5,
         seed: int = 0,
         verbose: bool = True):
    """Run the search. ``eval_fn(params) -> {metric: value, ...}``.

    Returns (best_params, best_result, history)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    sign = 1.0 if mode == "max" else -1.0
    history: list[tuple[dict, dict]] = []
    best_params, best_result, best_score = None, None, -math.inf

    n_explore = max(1, int(num_samples * explore_frac))
    for i in range(num_samples):
        if i < n_explore or best_params is None:
            params = {k: s.sample(rng) for k, s in space.items()}
        else:
            params = {k: space[k].perturb(best_params[k], rng)
                      for k in space}
        result = eval_fn(params)
        history.append((params, result))
        score = sign * result[metric]
        if score > best_score:
            best_params, best_result, best_score = params, result, score
            if verbose:
                print(f"[hpo {i + 1}/{num_samples}] new best "
                      f"{metric}={result[metric]:.4f} @ {params}")
    return best_params, best_result, history


def _tpe_sample(space: dict[str, Any], observations, rng,
                n_candidates: int = 24, gamma: float = 0.25):
    """One TPE (tree-structured Parzen estimator) draw — the surrogate
    model inside BOHB (the reference's ``TuneBOHB``,
    ``utils/bayesOpt.py:76-115``): split past observations into good/bad
    at the ``gamma`` quantile, model each set with a per-dimension kernel
    density (Gaussian for continuous, smoothed frequencies for Choice),
    draw candidates from the good density l(x) and keep the one
    maximizing l(x)/g(x)."""
    import numpy as np

    obs = sorted(observations, key=lambda o: -o[1])
    n_good = max(2, int(math.ceil(gamma * len(obs))))
    good = [o[0] for o in obs[:n_good]]
    bad = [o[0] for o in obs[n_good:]] or good

    def _logpdf(values, x, s):
        if isinstance(s, Choice):
            counts = {c: 1.0 for c in s.choices}  # Laplace smoothing
            for v in values:
                counts[v] = counts.get(v, 1.0) + 1.0
            total = sum(counts.values())
            return math.log(counts.get(x, 1.0) / total)
        span = float(s.upper - s.lower) or 1.0
        bw = max(1e-3 * span, 1.06 * span * len(values) ** -0.2 * 0.25)
        arr = np.asarray(values, float)
        z = (x - arr) / bw
        return float(np.log(np.mean(np.exp(-0.5 * z * z)) / bw + 1e-12))

    best_c, best_score = None, -math.inf
    for _ in range(n_candidates):
        cand = {}
        for k, s in space.items():
            src = good[int(rng.integers(0, len(good)))][k]
            cand[k] = s.perturb(src, rng, scale=0.2)
        score = sum(
            _logpdf([g[k] for g in good], cand[k], space[k])
            - _logpdf([b[k] for b in bad], cand[k], space[k])
            for k in space)
        if score > best_score:
            best_c, best_score = cand, score
    return best_c


def tune_sha(space: dict[str, Any],
             eval_fn: Callable[..., dict[str, float]],
             metric: str,
             mode: str = "max",
             num_samples: int = 27,
             min_budget: int = 1,
             max_budget: int = 9,
             reduction_factor: int = 3,
             seed: int = 0,
             verbose: bool = True,
             sampler: str = "random"):
    """Successive-halving bracket (the HyperBand core of the reference's
    Ray Tune + ``TuneBOHB`` setup, ``utils/bayesOpt.py:76-115``): every
    trial is evaluated at ``min_budget``; only the top
    ``1/reduction_factor`` fraction advances to the next rung with
    ``reduction_factor``× the budget, until ``max_budget`` — so bad
    configurations are stopped early instead of consuming a full-budget
    training.

    ``eval_fn(params, budget, state) -> result`` where ``state`` is the
    previous rung's result for this trial (``None`` on the first rung) —
    the callee can use it to resume a checkpointed training instead of
    restarting. ``result`` must contain ``metric``.

    ``sampler="tpe"`` draws first-rung configurations sequentially from a
    TPE surrogate fitted to the rung's completed evaluations (BOHB-style;
    the first ``2 * len(space)`` draws stay random to seed the model).

    Returns (best_params, best_result, history); history entries are
    (params, budget, result)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    sign = 1.0 if mode == "max" else -1.0

    rungs = [min_budget]
    while rungs[-1] * reduction_factor <= max_budget:
        rungs.append(rungs[-1] * reduction_factor)

    trials = [{"params": None, "state": None, "score": -math.inf,
               "result": None} for _ in range(num_samples)]
    history: list[tuple[dict, int, dict]] = []
    n_init = max(4, 2 * len(space))
    observations: list[tuple[dict, float]] = []
    alive = list(trials)
    for ri, budget in enumerate(rungs):
        for t in alive:
            if t["params"] is None:  # first rung: sample just-in-time
                if sampler == "tpe" and len(observations) >= n_init:
                    t["params"] = _tpe_sample(space, observations, rng)
                else:
                    t["params"] = {k: s.sample(rng)
                                   for k, s in space.items()}
            result = eval_fn(t["params"], budget, t["state"])
            t["state"] = result
            t["result"] = result
            t["score"] = sign * result[metric]
            observations.append((dict(t["params"]), t["score"]))
            history.append((dict(t["params"]), budget, result))
        alive.sort(key=lambda t: -t["score"])
        if ri < len(rungs) - 1:
            keep = max(1, len(alive) // reduction_factor)
            if verbose:
                print(f"[sha rung {ri} budget={budget}] "
                      f"{len(alive)} trials -> promoting {keep} "
                      f"(best {metric}="
                      f"{sign * alive[0]['score']:.4f})")
            alive = alive[:keep]
    # report the best among the trials that reached the final rung (scores
    # across different budgets are not comparable)
    best = max(alive, key=lambda t: t["score"])
    return best["params"], best["result"], history
