"""Utilities: conversion of JAX-package models and state, checkpoints."""

from .checkpoint import load_checkpoint, save_checkpoint
from .convert import model_from_jax, params_from_numpy, state_from_numpy

__all__ = [
    "load_checkpoint",
    "model_from_jax",
    "params_from_numpy",
    "save_checkpoint",
    "state_from_numpy",
]
