"""Lambda-iteration engines (regular and Voronoi grid)."""

from .lambda_iter import NLTEResult, RegularEngine, VoronoiEngine, frozen_setup

__all__ = ["NLTEResult", "RegularEngine", "VoronoiEngine", "frozen_setup"]
