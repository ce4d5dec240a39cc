"""Checkpoint conversion, the deploy tool and the CLIs' shared helpers."""

from __future__ import annotations

import argparse


def str2bool(v):
    """Reference main.py:39-51 flag convention."""
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("boolean value expected")
