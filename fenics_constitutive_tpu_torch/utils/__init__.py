"""Utilities: conversion of JAX-package models and state, checkpoints,
profiler scopes and timers."""

from .checkpoint import load_checkpoint, load_state_dict, save_checkpoint, state_dict
from .convert import model_from_jax, params_from_numpy, state_from_numpy
from .timers import get_timings, reset_timings, scope, timed, timing

__all__ = [
    "get_timings",
    "load_checkpoint",
    "load_state_dict",
    "model_from_jax",
    "params_from_numpy",
    "reset_timings",
    "save_checkpoint",
    "scope",
    "state_dict",
    "state_from_numpy",
    "timed",
    "timing",
]
