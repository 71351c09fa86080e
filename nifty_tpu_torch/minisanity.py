"""Residual sanity diagnostics: per-key reduced χ² tables (counterpart of
``nifty_tpu/minisanity.py``).

For every leaf of ``func(x)`` (or of ``x``) over the samples: the mean of
its entries and its reduced χ² (``|x|² / #dof``), each as ``[mean, std]``
over the samples, and its #dof.
"""

from __future__ import annotations

import pprint
from typing import Any, NamedTuple

import torch

from .evi import Samples
from .utils.tree import get_map, tree_map

__all__ = ["ChiSqStats", "minisanity", "reduced_residual_stats"]


class ChiSqStats(NamedTuple):
    mean: Any
    reduced_chisq: Any
    ndof: Any


def _leaf_stats(x):
    ndof = 2 * x.numel() if x.is_complex() else x.numel()
    return torch.stack((x.sum() / x.numel(), torch.vdot(x.reshape(-1), x.reshape(-1)).real / ndof))


def reduced_residual_stats(position_or_samples, func=None, *, map="lmap"):
    """A tree of :class:`ChiSqStats`, shaped like ``func(x)`` (or ``x``),
    over the samples (or the one position)."""
    map = get_map(map)
    if isinstance(position_or_samples, Samples) and len(position_or_samples) > 0:
        forest = position_or_samples.samples
    else:
        if isinstance(position_or_samples, Samples):
            position_or_samples = position_or_samples.pos
        forest = tree_map(lambda x: x.unsqueeze(0), position_or_samples)
    if func is not None:
        forest = map(func)(forest)

    def stats(leaf_forest):
        per_sample = torch.stack([_leaf_stats(x) for x in leaf_forest])  # (samples, 2)
        mean, std = per_sample.mean(dim=0), per_sample.std(dim=0, correction=0)
        ndof = leaf_forest[0].numel() * (2 if leaf_forest.is_complex() else 1)
        return ChiSqStats(torch.stack((mean[0], std[0])), torch.stack((mean[1], std[1])), ndof)

    return tree_map(stats, forest)


def _pretty(tree, indent=0, key="") -> str:
    if isinstance(tree, dict):
        msg = ""
        for k, v in tree.items():
            k = f"{key}/{k}" if key else str(k)
            if isinstance(v, dict):
                msg += _pretty(v, indent, k)
            else:
                msg += "  " * indent + f"{k:24s}:: " + _pretty(v, indent + 1).lstrip()
        return msg
    return "  " * indent + (tree if isinstance(tree, str) else pprint.pformat(tree)) + "\n"


def minisanity(position_or_samples, func=None, *, map="lmap"):
    """``(stats, table)``: :func:`reduced_residual_stats` and a printable
    table of it."""
    stat_tree = reduced_residual_stats(position_or_samples, func=func, map=map)

    def fmt(s):
        rsq, m = s.reduced_chisq.tolist(), s.mean.tolist()
        return (
            f"reduced Chi²:{rsq[0]:8.2}±{rsq[1]:8.2}, avg:{m[0]:+9.2}±{m[1]:8.2}, "
            f"#dof:{int(s.ndof):7d}"
        )

    table = tree_map(fmt, stat_tree, is_leaf=lambda x: isinstance(x, ChiSqStats))
    return stat_tree, _pretty(table)
