"""The statistics of the window's step times."""

import statistics

import numpy as np


def p95(values):
    """the 95th percentile of all ``values`` (linear between order
    statistics, numpy's default)"""
    return float(np.percentile(np.asarray(values, dtype=np.float64), 95))


def median(values):
    return float(statistics.median(values))
