"""Shared enums and small typed configs.

Mirrors the reference's util/types.py (file_processing consumers expect the
same string values; see reference pyrhe/src/util/types.py:1-10).
"""
from enum import Enum


class GenoImputeMethod(Enum):
    BINARY = "binary"
    MEAN = "mean"


class CovImputeMethod(Enum):
    IGNORE = "ignore"
    MEAN = "mean"
