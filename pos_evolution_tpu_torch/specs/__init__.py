"""Spec layer: containers, helpers, state transition, fork choice."""
