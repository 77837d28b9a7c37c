"""Case setup: neighbor search, features and integration (eval half)."""

from .case import CaseSetupFn, case_builder
from .features import FeatureDict, physical_feature_builder

__all__ = [
    "case_builder",
    "CaseSetupFn",
    "physical_feature_builder",
    "FeatureDict",
]
