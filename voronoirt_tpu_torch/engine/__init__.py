"""Lambda-iteration engines (regular grid)."""

from .lambda_iter import NLTEResult, RegularEngine, frozen_setup

__all__ = ["NLTEResult", "RegularEngine", "frozen_setup"]
