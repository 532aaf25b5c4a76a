"""Serving layer: continuous batching over the jitted engine."""

from kquant.serving.scheduler import ContinuousBatcher, Request  # noqa: F401
