from .metric_utils import FeatureStats, frechet_distance

__all__ = ["FeatureStats", "frechet_distance"]
