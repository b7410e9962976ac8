"""Utilities: the step's FLOP count and profiling helpers."""

from .flops import StepFlops, deit_step_flops, swin_t_step_flops
from .profiling import AverageMeter, StepTimer, trace

__all__ = ["AverageMeter", "StepFlops", "StepTimer", "deit_step_flops",
           "swin_t_step_flops", "trace"]
