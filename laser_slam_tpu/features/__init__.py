"""Interest-point features on 2D laser scans (FLIRT equivalent).

Batched JAX replacement for the reference's FLIRTLib-based feature
pipeline (src/mapGraph/FlirterNode.{h,cpp}): multiscale blob detection
on the range curve, a polar beta-grid descriptor, symmetric-χ²
descriptor distance, and a batched-hypothesis RANSAC SE(2) matcher.
Everything is fixed-shape (``K`` features per scan with validity masks)
and vmappable over scans / candidate pairs.
"""

from .detector import FeatureSet, detect_features
from .descriptor import describe_features, descriptor_distance
from .ransac import FeatureMatchResult, match_features

__all__ = [
    "FeatureSet",
    "detect_features",
    "describe_features",
    "descriptor_distance",
    "FeatureMatchResult",
    "match_features",
]
