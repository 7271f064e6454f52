"""Shared kernel utilities."""
from __future__ import annotations


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m
