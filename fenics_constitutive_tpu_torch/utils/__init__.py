"""Utilities: conversion of JAX-package state and parameters."""

from .convert import params_from_numpy, state_from_numpy

__all__ = ["params_from_numpy", "state_from_numpy"]
