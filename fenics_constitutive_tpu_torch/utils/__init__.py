"""Utilities: conversion of JAX-package state and parameters, checkpoints."""

from .checkpoint import load_checkpoint, save_checkpoint
from .convert import params_from_numpy, state_from_numpy

__all__ = ["load_checkpoint", "params_from_numpy", "save_checkpoint", "state_from_numpy"]
