"""The card a run uses: its name, count, power limit and memory peak."""

import subprocess

import torch


def power_limit_w():
    """the power limit of card 0 in W from ``nvidia-smi``, None where it
    cannot be read"""
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=False,
        )
        return float(proc.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def describe(chips):
    """the result line's ``device`` entry, less the memory peak"""
    return {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": chips,
        "power_limit_w": power_limit_w(),
    }


def cards_missing(chips):
    """why this machine cannot run a cell on ``chips`` cards, or None"""
    if not torch.cuda.is_available():
        return "torch sees no CUDA device"
    if torch.cuda.device_count() < chips:
        return f"{torch.cuda.device_count()} CUDA devices, the cell needs {chips}"
    return None
