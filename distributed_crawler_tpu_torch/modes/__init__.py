"""The modes the port runs (the reference's `modes/`).

- `runner.launch`: the router's validate-only and random-walk branches;
- `layerless`: the random walk over the page buffer;
- `validate`: the tandem validator pod;
- `common`: the mode's state manager, the resume, the seeds'
  normalization.

The standalone, layered, YouTube and job modes wait for ROADMAP Queue 1
part C.
"""

from .common import create_state_manager, determine_crawl_id, normalize_seed_urls
from .layerless import ValidatorCircuitBreakerError, run_random_walk_layerless
from .runner import launch, seed_random_walk
from .validate import prepare_validator_state, run_validate_only

__all__ = [
    "ValidatorCircuitBreakerError",
    "create_state_manager",
    "determine_crawl_id",
    "launch",
    "normalize_seed_urls",
    "prepare_validator_state",
    "run_random_walk_layerless",
    "run_validate_only",
    "seed_random_walk",
]
