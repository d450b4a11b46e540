"""Learning-rate schedule (JAX counterpart: models/schedules.py; reference
utils/general_utils.py:29-62).

`expon_lr` is get_expon_lr_func: log-linear from lr_init to lr_final over
max_steps with an optional sigmoid-ramped delay. The reference wires it to
the xyz group but never calls it in the SLAM loop.
"""
from __future__ import annotations

import math

import torch


def expon_lr(step, lr_init: float, lr_final: float, lr_delay_steps: int = 0,
             lr_delay_mult: float = 1.0, max_steps: int = 1000000):
    step = torch.as_tensor(step, dtype=torch.float32)
    if lr_init == lr_final == 0.0:
        return torch.zeros_like(step)
    if lr_delay_steps > 0:
        delay_rate = lr_delay_mult + (1 - lr_delay_mult) * torch.sin(
            0.5 * math.pi * torch.clamp(step / lr_delay_steps, 0, 1))
    else:
        delay_rate = 1.0
    t = torch.clamp(step / max_steps, 0, 1)
    log_lerp = torch.exp(math.log(max(lr_init, 1e-30)) * (1 - t)
                         + math.log(max(lr_final, 1e-30)) * t)
    return torch.where(step < 0, torch.zeros_like(step), delay_rate * log_lerp)
