"""Hyperparameter search (counterpart of ``mjhmc_tpu.search``): the grid
sweep and the in-process GP/expected-improvement loop, the two halves of
what the reference outsourced to Spearmint."""

from mjhmc_tpu_torch.search.grid import grid_search, SearchResult
from mjhmc_tpu_torch.search.bayes import bayes_search, bayes_minimize, BayesResult

__all__ = [
    "grid_search",
    "SearchResult",
    "bayes_search",
    "bayes_minimize",
    "BayesResult",
]
